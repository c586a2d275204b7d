"""PyTorch port, the train step as a whole on the CPU, against the JAX package
at CFFM-B0 112² (decoder map 14×14, logits 28×28, so the JAX CE backward
kernel has its even row chunk), clips of 4 frames, 7 classes, f32, drop
rates 0 on both sides, and the JAX CE kernels in interpret mode in its loss
(``torch_port_common.train_patches``):

- train-mode logits (B, T+1, h, w, C), ``loss_seg``, ``acc_seg``, every
  parameter's gradient and the BatchNorm running statistics after the
  forward, from one forward/backward on each side, in two block forms:
  composed blocks at every stage, and the JAX default (the whole-block
  train pair at stages 1-3, on the JAX side its Pallas kernels in interpret
  mode, "full-interpret");
- the optimizer: every parameter's (lr multiplier, decayed) and three AdamW
  steps through the warmup against optax;
- one whole ``make_train_step`` against the JAX ``make_train_step``, with
  the default CE and with a head configured for OHEM and class weights (the
  port's per-pixel CE route, the JAX composed CE); with the default CE also
  on 2 gloo ranks of one clip each (``parallel.spawn``), against the same
  compiled JAX step on the global batch.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from torch_port_common import (flat, index_map, perturbed_variables, to_jax_tree, to_np,
                               train_batch, train_configs, train_patches)
from vss_cffm_tpu.models import losses as jax_losses
from vss_cffm_tpu.models.losses import LossConfig as JaxLossConfig
from vss_cffm_tpu.models.losses import make_clip_loss as jax_make_clip_loss
from vss_cffm_tpu.models.segmentor import CFFMSegmentor as JaxSegmentor
from vss_cffm_tpu.train import optim as jax_optim
from vss_cffm_tpu.train.state import TrainState as JaxTrainState
from vss_cffm_tpu.train.step import device_normalize as jax_device_normalize
from vss_cffm_tpu.train.step import make_train_step as jax_make_train_step
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch import parallel
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.models.losses import make_clip_loss
from vss_cffm_tpu_torch.train import TrainState, build_optimizer, make_train_step
from vss_cffm_tpu_torch.train.optim import global_norm, paramwise_multipliers
from vss_cffm_tpu_torch.utils import state_dict_from_jax

HW = (112, 112)
CLASSES = 7
B = 2


# the block forms of the forward/backward parity, as the JAX config names them
FORMS = {"composed": None, "full": ("full-interpret",) * 3 + (None,)}


def _models(seed: int = 0, train_block_impl=None, loss: dict | None = None):
    jcfg, pc = train_configs("b0", CLASSES, depth=1, train_block_impl=train_block_impl,
                             loss=loss)
    jm = JaxSegmentor(jcfg)
    # the block forms and the loss leave the parameter tree as it is: one init
    # model (and one compiled init) serves every case
    twin = dataclasses.replace(jcfg, train_block_impl=None,
                               head=dataclasses.replace(jcfg.head, loss=JaxLossConfig()))
    variables = perturbed_variables(JaxSegmentor(twin), np.zeros((1, 4, *HW, 3), np.float32),
                                    seed)
    pm = CFFMSegmentor(pc)
    pm.load_state_dict(state_dict_from_jax(variables, jcfg), strict=True)
    return jcfg, jm, variables, pm.train()


@pytest.fixture(scope="module", params=list(FORMS))
def forward_backward(request):
    """One train forward + loss + backward on each side, same weights and
    batch, in each block form of ``FORMS``."""
    with train_patches("b0"):
        jcfg, jm, variables, pm = _models(train_block_impl=FORMS[request.param])
        assert pm.config.backbone_config.train_block_impl == (
            None if request.param == "composed" else ("full", "full", "full", None))
        imgs_u8, labels = train_batch(B, HW, CLASSES)
        imgs = np.array(jax_device_normalize(jnp.asarray(imgs_u8)))
        jloss = jax_make_clip_loss(JaxLossConfig())
        lab = jnp.asarray(labels).astype(jnp.int32)

        def loss_fn(params):
            out, mutated = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    jnp.asarray(imgs), True, mutable=["batch_stats"])
            losses = jloss(out, lab)
            return losses["loss_seg"], (out, losses, mutated["batch_stats"])

        jgrads, (jout, jlosses, jstats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            variables["params"])

        out = pm(torch.from_numpy(imgs), train=True)
        plosses = make_clip_loss(pcfg.LossConfig())(out, torch.from_numpy(labels))
        plosses["loss_seg"].backward()
        pgrads = {n: p.grad for n, p in pm.named_parameters()}
        yield dict(jcfg=jcfg, pm=pm, jout=np.asarray(jout), pout=to_np(out),
                   jlosses={k: float(v) for k, v in jlosses.items()},
                   plosses={k: v.item() for k, v in plosses.items()},
                   jgrads=flat(jax.device_get(jgrads)),
                   pgrads=flat(to_jax_tree(pm, pgrads, jcfg)["params"]),
                   jstats=flat(jax.device_get(jstats)))


def test_train_logits_match_jax(forward_backward):
    """f32 through backbone, decode and decoder with batch statistics:
    sums in other orders, 1e-4 as for the inference logits."""
    fb = forward_backward
    assert fb["pout"].shape == fb["jout"].shape == (B, 5, HW[0] // 4, HW[1] // 4, CLASSES)
    np.testing.assert_allclose(fb["pout"], fb["jout"], rtol=1e-4, atol=1e-4)


def test_train_loss_and_accuracy_match_jax(forward_backward):
    """The loss is a mean of O(1) NLLs over 10⁵ pixels: f32 sums in other
    orders, 1e-5 relative; the correct count is exact up to near-ties of
    logits that differ by 1e-6, so acc to 0.01 percentage points."""
    fb = forward_backward
    np.testing.assert_allclose(fb["plosses"]["loss_seg"], fb["jlosses"]["loss_seg"], rtol=1e-5)
    assert abs(fb["plosses"]["acc_seg"] - fb["jlosses"]["acc_seg"]) <= 0.01


def test_every_parameter_gradient_matches_jax(forward_backward):
    """Each gradient, mapped to the JAX tree by ``convert_segmentor``, within
    1e-3 of its own largest entry (f32 backward through ~100 ops whose
    forward values already differ by ~1e-6), plus 1e-5 of the largest
    gradient of the model: some gradients are zero up to rounding (the
    stage-4 norm's bias feeds only a batch-normalised sum, whose batch mean
    cancels it)."""
    fb = forward_backward
    assert sorted(fb["pgrads"]) == sorted(fb["jgrads"])
    top = max(np.abs(g).max() for g in fb["jgrads"].values())
    for name, want in fb["jgrads"].items():
        got = fb["pgrads"][name]
        assert got.shape == want.shape, name
        err = np.abs(got - want).max()
        assert err <= 1e-3 * np.abs(want).max() + 1e-5 * top, (name, err)
        assert np.abs(want).max() > 0, name


def test_batchnorm_running_stats_follow_flax(forward_backward):
    """After one train forward: running = 0.9·running + 0.1·batch, with the
    biased batch variance (flax), where ``nn.BatchNorm2d`` would use the
    unbiased one: 1e-5 relative (f32 statistics of 8·28·28 values)."""
    fb = forward_backward
    bn = fb["pm"].decode_head.linear_fuse.bn
    np.testing.assert_allclose(to_np(bn.running_mean),
                               fb["jstats"]["decode_head/decode/bn/mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(bn.running_var),
                               fb["jstats"]["decode_head/decode/bn/var"], rtol=1e-5, atol=1e-6)


def test_paramwise_multipliers_match_jax():
    """Every parameter's (lr multiplier, decayed), from the reference names,
    equals mmcv's first-match rule as the JAX package applies it to its tree."""
    jcfg, _, variables, pm = _models()
    lr_tree, wd_tree = jax_optim.paramwise_multipliers(variables["params"], 10.0)
    lr, wd = flat(lr_tree), flat(wd_tree)
    seen = set()
    for path, name in index_map(pm, jcfg).items():
        assert paramwise_multipliers(name, 10.0) == (lr[path], bool(wd[path])), (path, name)
        seen.add(paramwise_multipliers(name, 10.0))
    assert seen == {(10.0, True), (1.0, False), (1.0, True)}


def _adamw_steps_match_optax(ocfg: dict, scales=(1.0, 1.0, 1.0)) -> None:
    """Steps of the port's optimizer and of optax's from the same parameters
    with the same given gradients (N(0, 1) times each step's scale); the
    parameters after them agree as stated by the callers."""
    jcfg, _, variables, pm = _models()
    jtx = jax_optim.build_optimizer(variables["params"], jax_optim.OptimConfig(**ocfg))
    names = index_map(pm, jcfg)
    params = {n: p for n, p in pm.named_parameters()}
    opt, sched = build_optimizer(pm, pcfg.OptimConfig(**ocfg))
    jparams = variables["params"]
    jstate = jtx.init(jparams)
    jupdate = jax.jit(jtx.update)
    rng = np.random.RandomState(3)
    start = {n: to_np(p).copy() for n, p in params.items()}
    for scale in scales:
        gr = {n: torch.from_numpy(scale * rng.randn(*p.shape).astype(np.float32))
              for n, p in params.items()}
        for n, p in params.items():
            p.grad = gr[n].clone()
        opt.step()
        sched.step()
        if ocfg.get("grad_clip") is not None:
            # clipped in place before the update: the global norm is the limit
            norm = global_norm([p.grad for p in params.values()]).item()
            np.testing.assert_allclose(norm, ocfg["grad_clip"], rtol=1e-5)
        jg = to_jax_tree(pm, gr, jcfg)["params"]
        updates, jstate = jupdate(jg, jstate, jparams)
        jparams = jax.tree.map(lambda a, u: a + u, jparams, updates)
    jflat = flat(jax.device_get(jparams))
    port = flat(to_jax_tree(pm, {n: p.detach() for n, p in params.items()}, jcfg)["params"])
    before = flat(to_jax_tree(pm, {n: torch.from_numpy(v) for n, v in start.items()},
                              jcfg)["params"])
    for path in names:
        dp, dj = port[path] - before[path], jflat[path] - before[path]
        assert np.abs(dj).max() > 0, path
        atol = 1e-4 * np.abs(dj).max() + 4 * np.spacing(np.abs(before[path]).max())
        np.testing.assert_allclose(dp, dj, rtol=1e-4, atol=atol, err_msg=path)


def test_three_adamw_steps_match_optax():
    """Three steps through the warmup with the same given gradients. Updates
    agree to f32 rounding of Adam's moments and the schedule (python floats
    here, f32 in optax), 1e-4 of the largest update, and to the rounding of
    the parameters themselves (4 ulps of the largest)."""
    _adamw_steps_match_optax(dict(lr=1e-3, warmup_iters=4, max_iters=50))


def test_grad_clip_of_optim_config_matches_optax():
    """``OptimConfig.grad_clip`` clips the gradients to that global norm
    before AdamW, as optax's ``clip_by_global_norm`` at the head of the JAX
    chain: three steps whose gradient norms differ by 100× (so that Adam's
    moments see the clip), held as in the unclipped test."""
    _adamw_steps_match_optax(dict(lr=1e-3, warmup_iters=4, max_iters=50, grad_clip=1.0),
                             scales=(1.0, 30.0, 0.3))


def _start_two_ranks(pm, imgs, labels, ocfg) -> concurrent.futures.Future:
    """The port step on 2 gloo ranks on the CPU, one clip each (spawned,
    ``torch_port_ranks.train_steps``), started from a thread so that the
    ranks run while the JAX step compiles; the rank 0 result."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    run = functools.partial(ranks.train_steps, mit_drop_path=False)
    state_dict = {k: v.clone() for k, v in pm.state_dict().items()}
    future = pool.submit(lambda: parallel.spawn(run, 2, pm.config, state_dict,
                                                {"imgs": imgs, "labels": labels}, ocfg,
                                                device="cpu")[0])
    pool.shutdown(wait=False)
    return future


@pytest.fixture(scope="module")
def default_step():
    """The JAX step with the default CE, compiled and run once for the
    one-process and the 2-rank port steps (``_jax_step``), the 2 ranks
    started before the compile (``_start_two_ranks``)."""
    return _jax_step(start=_start_two_ranks)


def test_one_train_step_matches_jax(default_step):
    """``make_train_step`` against the JAX ``make_train_step`` from the same
    weights and uint8 batch, lr 1e-4 past the warmup (``_one_step_matches_jax``)."""
    _one_step_matches_jax(default_step)


def test_two_rank_train_step_matches_jax(default_step):
    """The same step on 2 gloo ranks on the CPU, one clip each (spawned,
    ``torch_port_ranks.train_steps``: the fuse BN's statistics, the loss and
    the gradients over the global batch), held to the JAX step on the global
    batch as the one-process step is."""
    js = default_step
    res = js["started"].result(timeout=600)
    _step_matches_jax(js, res["metrics"][0], res["params"])


def test_one_train_step_with_ohem_and_class_weights_matches_jax():
    """The same with the head's loss configured for OHEM and class weights:
    the port's step takes its per-pixel CE route (``ce_upsampled_nll``), the
    JAX step its composed one (CE on the upsampled logits), which
    ``tests/test_torch_port_loss_pixel.py`` holds to the JAX per-pixel route,
    whose interpreted Pallas pair would add ~10 s of compile here. OHEM at
    its defaults keeps every valid pixel here (the near-uniform
    probabilities of a fresh model lie below 0.7); that file holds a mask
    that bites. The batch's out-of-range labels become 255, which both sides
    ignore (the JAX per-pixel route would count them as class 0; the port's
    rule is pinned in that file)."""
    cw = tuple(np.random.RandomState(7).uniform(0.5, 1.5, CLASSES))
    _one_step_matches_jax(_jax_step(dict(use_ohem=True, class_weight=cw)))


def _jax_step(loss: dict | None = None, start=None) -> dict:
    """The JAX ``make_train_step`` from the perturbed weights on a uint8 batch,
    lr 1e-4 past the warmup, and the port model on the same weights with its
    state before the step; ``start(pm, imgs, labels, ocfg)``, called before
    the JAX step compiles, gives the result's "started"."""
    ocfg = dict(lr=1e-4, warmup_iters=0, max_iters=1000)
    with train_patches("b0"), pytest.MonkeyPatch.context() as mp:
        jcfg, jm, variables, pm = _models(seed=1, loss=loss)
        imgs, labels = train_batch(B, HW, CLASSES, seed=2)
        if loss is not None:
            labels[labels == CLASSES] = 255
            mp.setattr(jax_losses, "_FORCE_FUSED", False)
        started = start(pm, imgs, labels, ocfg) if start else None
        jtx = jax_optim.build_optimizer(variables["params"], jax_optim.OptimConfig(**ocfg))
        jstate = JaxTrainState.create(variables, jtx)
        jstep = jax_make_train_step(jm, jtx, donate=False)
        jnew, jmetrics = jstep(jstate, {"imgs": jnp.asarray(imgs),
                                        "labels": jnp.asarray(labels).astype(jnp.int32)},
                               jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, pm=pm, started=started,
                imgs=imgs, labels=labels, ocfg=ocfg, jstep=int(jnew.step),
                jparams=flat(jax.device_get(jnew.params)),
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                names=index_map(pm, jcfg), before=flat(to_jax_tree(pm, {}, jcfg)["params"]))


def _one_step_matches_jax(js: dict):
    """The port's one-process step on ``_jax_step``'s model and batch."""
    pm = js["pm"]
    state = TrainState.create(pm, pcfg.OptimConfig(**js["ocfg"]))
    step = make_train_step(pm, state.optimizer, state.scheduler)
    metrics = step({"imgs": torch.from_numpy(js["imgs"]),
                    "labels": torch.from_numpy(js["labels"])}, torch.Generator().manual_seed(0))
    assert state.step == js["jstep"] == 1
    _step_matches_jax(js, metrics, {n: p.detach() for n, p in pm.named_parameters()})


def _step_matches_jax(js: dict, metrics: dict, params: dict):
    """loss, acc and the gradient norm as in the forward/backward tests. The
    updated parameters: Adam's first step is ≈ lr·sign(g) per element, so an
    element whose gradient is within rounding of 0 may step the other way;
    99.9 % of the elements are held to 1e-3 of the step size lr·mult, every
    element to 2·lr·mult plus its decay."""
    jmetrics, before = js["jmetrics"], js["before"]
    np.testing.assert_allclose(float(metrics["loss_seg"]), jmetrics["loss_seg"], rtol=1e-5)
    assert abs(float(metrics["acc_seg"]) - jmetrics["acc_seg"]) <= 0.01
    np.testing.assert_allclose(float(metrics["grad_norm"]), jmetrics["grad_norm"], rtol=1e-4)
    port = flat(to_jax_tree(js["pm"], params, js["jcfg"])["params"])
    total = close = 0
    for path, name in js["names"].items():
        mult, decayed = paramwise_multipliers(name, 10.0)
        step_size = js["ocfg"]["lr"] * mult
        dp, dj = port[path] - before[path], js["jparams"][path] - before[path]
        err = np.abs(dp - dj)
        bound = 2 * step_size + step_size * 0.01 * np.abs(before[path]) * decayed + 1e-9
        assert np.all(err <= bound), path
        close += int(np.sum(err <= 1e-3 * step_size))
        total += err.size
    assert close >= 0.999 * total, (close, total)
