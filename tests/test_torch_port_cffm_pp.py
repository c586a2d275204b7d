"""PyTorch port, the CFFM++ segmentor (finetune mode) against the JAX package
on the CPU: MiT-B0 widths, decoder depth 1, 5 classes, clips of 4 frames of
64×64, 10 centres of 256, f32, head dropout 0 and no drop path on both
sides; weights from the port's init perturbed and carried to JAX
(``torch_port_common.finetune_models``):

- the weight round trip port → JAX → port, the finetune head included
  (``state_dict_from_jax`` inverts ``convert_segmentor``);
- eval logits x2 + 0.5·x3 on a ``(centres, mask)`` pair, all valid and with
  padded rows, ``prototype_features``, and a clip shorter than
  ``num_clips`` (the last frame's plain logits): 1e-4, as the inference
  logits of ``test_torch_port_segmentor.py``;
- training: the parameters with a non-zero gradient are those of JAX, only
  ``decoder_swin`` and ``linear_pred3`` (mirrors
  ``tests/test_heads_segmentor.py:94``), each within 1e-3 of its largest;
- one ``make_train_step`` against the JAX ``make_train_step`` at lr 0.1, wd
  0.1, warmup 0: the loss, every frozen parameter at w·(1 − lr·wd) or w by
  its group as in optax, the trained ones by Adam's first step, and the BN
  running statistics unchanged on both sides;
- the optimizer groups of the finetune head's names against the JAX
  classification of its tree, and a head mode the port does not know.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (EVAL_CLASSES, finetune_models, flat, index_map, no_drop_path,
                               to_jax_tree, to_np)
from vss_cffm_tpu.train import optim as jax_optim
from vss_cffm_tpu.train.state import TrainState as JaxTrainState
from vss_cffm_tpu.train.step import make_train_step as jax_make_train_step
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch.train import TrainState, make_train_step
from vss_cffm_tpu_torch.train.optim import paramwise_multipliers
from vss_cffm_tpu_torch.utils import state_dict_from_jax

HW, K, B = (64, 64), 10, 2


@pytest.fixture(scope="module")
def models():
    with no_drop_path("b0"):
        yield finetune_models()


@pytest.fixture(scope="module")
def jax_eval(models):
    """The JAX eval forward, jitted (an eager B0 forward takes ~30 s here)."""
    _, jm, _, _ = models
    return jax.jit(lambda v, x, c: jm.apply(v, x, False, c))


def _centers(seed: int, b: int = 1, pad: int = 0):
    rng = np.random.RandomState(seed)
    c = rng.randn(b, K + pad, 256).astype(np.float32)
    m = np.zeros((b, K + pad), bool)
    m[:, :K] = True
    return c, m


def _clip(seed: int, b: int = 1, t: int = 4) -> np.ndarray:
    return np.random.RandomState(seed).randn(b, t, *HW, 3).astype(np.float32)


def test_weight_round_trip(models):
    jcfg, _, variables, pm = models
    names = {n for n in pm.state_dict() if "decoder_swin" in n or "linear_pred3" in n}
    assert len(names) == 16
    sd = state_dict_from_jax(to_jax_tree(pm, {}, jcfg), jcfg)
    assert sd.keys() == pm.state_dict().keys()
    for n, v in pm.state_dict().items():
        assert torch.equal(sd[n].to(v.dtype), v), n


@pytest.mark.parametrize("valid", [K + 5, K])
def test_eval_logits_match_jax(models, jax_eval, valid):
    """(centres, mask) of K + 5 rows, all valid or the last 5 padded (one
    compile of the JAX forward serves both; ``test_torch_port_cluster_head.py``
    holds a bare centres tensor)."""
    jcfg, jm, variables, pm = models
    x = _clip(0)
    c, m = _centers(1, pad=5)
    m[:, :valid] = True
    want = np.asarray(jax_eval(variables, jnp.asarray(x), (jnp.asarray(c), jnp.asarray(m))))
    with torch.no_grad():
        got = to_np(pm(torch.from_numpy(x),
                       cluster_centers=(torch.from_numpy(c), torch.from_numpy(m))))
    assert got.shape == want.shape == (1, 16, 16, EVAL_CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_short_clip_gives_the_last_frames_plain_logits(models, jax_eval):
    """A clip shorter than ``num_clips``: the last frame's per-frame logits,
    with no cluster branch (the centres are not read)."""
    _, jm, variables, pm = models
    x = _clip(0)[:, :2]
    c, m = _centers(1, pad=5)
    want = np.asarray(jax_eval(variables, jnp.asarray(x), (jnp.asarray(c), jnp.asarray(m))))
    with torch.no_grad():
        got = to_np(pm(torch.from_numpy(x),
                       cluster_centers=(torch.from_numpy(c), torch.from_numpy(m))))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_prototype_features_match_jax(models):
    _, jm, variables, pm = models
    x = _clip(2, t=3)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, method=jm.prototype_features))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = to_np(pm.prototype_features(torch.from_numpy(x)))
    assert got.shape == want.shape == (1, 3, 8, 8, 256)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_missing_centres_and_unknown_mode_raise(models):
    _, _, _, pm = models
    with pytest.raises(ValueError, match="cluster centres"), torch.no_grad():
        pm(torch.from_numpy(_clip(0)))
    with pytest.raises(ValueError, match="mode"):
        pcfg.build_model_config("b0", mode="cffm_pp")


def _labels(seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, EVAL_CLASSES, (B, 4, *HW)).astype(np.uint8)
    lab[rng.rand(*lab.shape) < 0.05] = 255
    return lab


def test_gradient_set_matches_jax(models):
    """Gradients of the mean squared refined logits (JAX's test loss) with
    the model in train form: the same parameters move on both sides."""
    jcfg, jm, variables, pm = models
    x = _clip(3, b=B)
    c, m = _centers(4, b=B, pad=2)

    def loss_fn(params):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), True, (jnp.asarray(c), jnp.asarray(m)),
                          rngs={"dropout": jax.random.PRNGKey(1),
                                "droppath": jax.random.PRNGKey(2)},
                          mutable=["batch_stats"])
        return (out[:, -1] ** 2).mean()

    with no_drop_path("b0"):
        jgrads = flat(jax.device_get(jax.jit(jax.grad(loss_fn))(variables["params"])))
        pm.train()
        try:
            out = pm(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(0),
                     cluster_centers=(torch.from_numpy(c), torch.from_numpy(m)))
            (out[:, -1] ** 2).mean().backward()
        finally:
            pm.eval()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in pm.named_parameters()}
    for p in pm.parameters():
        p.grad = None
    pgrads = flat(to_jax_tree(pm, grads, jcfg)["params"])
    jset = {k for k, g in jgrads.items() if np.abs(g).max() > 0}
    pset = {k for k, g in pgrads.items() if np.abs(g).max() > 0}
    assert jset == pset
    assert all(k.startswith(("decode_head/decoder_swin/", "decode_head/linear_pred3/"))
               for k in pset) and len(pset) == 16
    for k in pset:
        np.testing.assert_allclose(pgrads[k], jgrads[k], rtol=0,
                                   atol=1e-3 * np.abs(jgrads[k]).max(), err_msg=k)


def test_one_finetune_step_matches_jax(models):
    """lr 0.1, weight decay 0.1, no warmup: a frozen parameter w moves to
    w·(1 − lr·wd) where its group decays (optax's ``add_decayed_weights`` on
    a zero gradient) and stays where it does not; the trained ones take
    Adam's first step ≈ lr·sign(g), held as ``test_torch_port_train.py``
    holds a step (99.9 % of elements within 1e-3 of lr, all within 2·lr plus
    the decay). The BN running statistics do not move."""
    jcfg, jm, variables, pm0 = models
    ocfg = dict(lr=0.1, weight_decay=0.1, warmup_iters=0, max_iters=1000, head_lr_mult=1.0)
    pm = type(pm0)(pm0.config)
    pm.load_state_dict(pm0.state_dict())
    pm.train()
    imgs = np.random.RandomState(5).randint(0, 256, (B, 4, *HW, 3)).astype(np.uint8)
    labels = _labels(6)
    c, m = _centers(7, b=B)
    with no_drop_path("b0"):
        jtx = jax_optim.build_optimizer(variables["params"], jax_optim.OptimConfig(**ocfg))
        jstate = JaxTrainState.create(variables, jtx)
        jnew, jmetrics = jax_make_train_step(jm, jtx, donate=False)(
            jstate, {"imgs": jnp.asarray(imgs), "labels": jnp.asarray(labels).astype(jnp.int32),
                     "cluster_centers": (jnp.asarray(c), jnp.asarray(m))},
            jax.random.PRNGKey(0))
        state = TrainState.create(pm, pcfg.OptimConfig(**ocfg))
        before = {n: v.clone() for n, v in pm.state_dict().items()}
        step = make_train_step(pm, state.optimizer, state.scheduler)
        metrics = step({"imgs": torch.from_numpy(imgs), "labels": torch.from_numpy(labels),
                        "cluster_centers": (torch.from_numpy(c), torch.from_numpy(m))},
                       torch.Generator().manual_seed(0))
    np.testing.assert_allclose(metrics["loss_seg"].item(), float(jmetrics["loss_seg"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    bn = "decode_head.linear_fuse.bn"
    for s in ("running_mean", "running_var"):
        assert torch.equal(pm.state_dict()[f"{bn}.{s}"], before[f"{bn}.{s}"])
    jstats = flat(jax.device_get(jnew.batch_stats))
    np.testing.assert_array_equal(jstats["decode_head/decode/bn/mean"],
                                  to_np(before[f"{bn}.running_mean"]))
    np.testing.assert_array_equal(jstats["decode_head/decode/bn/var"],
                                  to_np(before[f"{bn}.running_var"]))
    lr, wd = ocfg["lr"], ocfg["weight_decay"]
    names = dict(pm.named_parameters())
    port = flat(to_jax_tree(pm, {}, jcfg)["params"])
    start = flat(to_jax_tree(pm, {n: before[n] for n in names}, jcfg)["params"])
    jflat = flat(jax.device_get(jnew.params))
    index = index_map(pm, jcfg)
    total = close = 0
    for path, name in index.items():
        _, decayed = paramwise_multipliers(name, 1.0)
        w0 = start[path]
        if not name.startswith(("decode_head.decoder_swin.", "decode_head.linear_pred3.")):
            want = w0 * np.float32(1 - lr * wd) if decayed else w0
            np.testing.assert_allclose(jflat[path], want, rtol=1e-6, atol=1e-7, err_msg=path)
            np.testing.assert_allclose(port[path], want, rtol=1e-6, atol=1e-7, err_msg=path)
            assert decayed == bool(np.any(port[path] != w0)), path
            continue
        err = np.abs((port[path] - w0) - (jflat[path] - w0))
        assert np.all(err <= 2 * lr + lr * wd * np.abs(w0) + 1e-7), path
        close += int(np.sum(err <= 1e-3 * lr))
        total += err.size
    assert close >= 0.999 * total, (close, total)


def test_paramwise_groups_of_the_finetune_head_match_jax(models):
    """mmcv's first-match rule on the reference names: ``decoder_swin``'s
    norms match "head" before "norm", so they are decayed, as the JAX
    classification of its tree gives them."""
    jcfg, _, variables, pm = models
    lr_tree, wd_tree = jax_optim.paramwise_multipliers(variables["params"], 1.0)
    lr, wd = flat(lr_tree), flat(wd_tree)
    seen = set()
    for path, name in index_map(pm, jcfg).items():
        assert paramwise_multipliers(name, 1.0) == (lr[path], bool(wd[path])), (path, name)
        if "decoder_swin" in name and "norm" in name:
            seen.add(name)
            assert paramwise_multipliers(name, 1.0) == (1.0, True)
    assert len(seen) == 4
