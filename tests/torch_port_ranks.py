"""Functions that the PyTorch-port tests run on spawned ranks
(``vss_cffm_tpu_torch.parallel.spawn``), with their one-process twins.

A spawned rank imports this module to find its function, so it imports no
JAX and nothing of the JAX package: only numpy, torch and the port (the card
tests, which run without JAX, use it too). Each rank function takes the
rank's device first and returns plain tensors, arrays and numbers, which the
parent holds against the one-process run (``close_to_largest``,
``grads_close``).
"""

from __future__ import annotations

import numpy as np
import torch

from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch import parallel
from vss_cffm_tpu_torch.eval.metrics import aggregate_confusion, update_confusion
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.models import losses as plosses
from vss_cffm_tpu_torch.models.heads import MLPDecodeHead
from vss_cffm_tpu_torch.models.mit import MiTBlock
from vss_cffm_tpu_torch.ops import resize_bilinear
from vss_cffm_tpu_torch.tools.train import step_seed
from vss_cffm_tpu_torch.train import OptimConfig, TrainState, make_train_step
from vss_cffm_tpu_torch.train.step import device_normalize

THREADS = 2  # torch threads a rank: the suite runs its workers on a few cores


def close_to_largest(got, want, rel: float, what: str, floor: float = 0.0) -> None:
    """|got − want| ≤ rel · max(the largest |want|, floor)."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    err = (got - want).abs().max().item()
    assert err <= rel * max(want.abs().max().item(), floor, 1e-30), (what, err)


# per-channel constants added before the fuse BN, which takes the mean out:
# their gradients are zero but for rounding
BEFORE_BN = ("linear_c1.proj.bias", "linear_c2.proj.bias", "linear_c3.proj.bias",
             "linear_c4.proj.bias", "backbone.norm4.bias")


def grads_close(got: dict, want: dict, what: str, zero_names: tuple = BEFORE_BN) -> None:
    """Each gradient within 1e-5 of its tensor's largest value; those of
    ``zero_names`` (by default ``BEFORE_BN``), which have no scale of their
    own, below 1e-5 of the largest gradient of all the tensors (and so are
    the one process's)."""
    assert got.keys() == want.keys()
    scale = max(g.abs().max().item() for g in want.values())
    for name in want:
        zero = name.endswith(zero_names)
        if zero:
            assert want[name].abs().max().item() <= 1e-5 * scale, name
        close_to_largest(got[name], want[name], 1e-5, f"{name} {what}", scale if zero else 0.0)


def tiny_config(loss: dict | None = None, num_classes: int = 124) -> pcfg.SegmentorConfig:
    """MiT-B0 widths (stochastic depth 0.1), head and decoder 32 wide, decoder
    depth 1 with one head of 32 (a head dim the CUDA attention takes) and
    stochastic depth 0.1, head dropout 0.1, the head's
    ``LossConfig(**loss)``."""
    head = pcfg.CFFMHeadConfig(
        in_channels=tuple(pcfg.MIT_VARIANTS["mit_b0"].embed_dims), embed_dim=32,
        num_classes=num_classes, num_clips=4, dropout_ratio=0.1,
        decoder=pcfg.CFFMDecoderConfig(dim=32, depth=1, num_heads=1, drop_path=0.1),
        loss=pcfg.LossConfig(**(loss or {})))
    return pcfg.SegmentorConfig(backbone="mit_b0", head=head)


def bn_constant(model: CFFMSegmentor) -> torch.Tensor:
    """The per-channel constant that the parameters of ``BEFORE_BN`` add to the
    fuse BN's input (each level's bias, and ``norm4.bias`` through
    ``linear_c4``, through its slice of the fuse conv): the BN takes it out of
    its output, but its batch mean, and so the running mean, carries it."""
    head = model.decode_head
    f = head.cfg.embed_dim
    w = head.linear_fuse.conv.weight[:, :, 0, 0]
    c = 0.0
    for i, lvl in enumerate((4, 3, 2, 1)):  # the fuse kernel's order
        proj = getattr(head, f"linear_c{lvl}").proj
        b = proj.bias + (model.backbone.norm4.bias @ proj.weight.t() if lvl == 4 else 0.0)
        c = c + b @ w[:, i * f:(i + 1) * f].t()
    return c.detach().cpu()


def _model(cfg: pcfg.SegmentorConfig, state_dict: dict, device, mit_drop_path: bool = True,
           dtype: torch.dtype = torch.float32) -> CFFMSegmentor:
    """``mit_drop_path=False``: the backbone's stochastic depth 0, as the JAX
    parity tests set it (``torch_port_common.no_drop_path``)."""
    model = CFFMSegmentor(cfg, dtype=dtype)
    model.load_state_dict(state_dict, strict=True)
    if not mit_drop_path:
        for m in model.backbone.modules():
            if isinstance(m, MiTBlock):
                m.drop_path_rate = 0.0
    return model.to(device).train()


def train_steps(device, cfg: pcfg.SegmentorConfig, state_dict: dict, batch: dict,
                optim: dict, steps: int = 1, seed: int = 0, record_ohem: bool = False,
                mit_drop_path: bool = True, dtype: torch.dtype = torch.float32,
                frame_axis: int | None = None, infer: bool = False) -> dict:
    """``steps`` default train steps of a model of ``cfg`` from ``state_dict`` on
    this rank's rows of the global ``batch`` (numpy uint8 imgs and labels),
    step ``it`` from the generator of ``step_seed(seed, it)``, computing in
    ``dtype`` (f32 parameters). With ``frame_axis`` the ranks form a clip
    mesh (``parallel.create_clip_mesh(frame_axis)``) and the rank holds its
    share of it (``shard_clip_batch``). In one process (no group) it is the
    one-process step on the whole batch.
    Returns each step's metrics and gradients (after the average over the
    ranks), the fuse BN's running statistics after the last step and after
    each step with ``bn_constant`` after each, the parameters after the last
    step and, with ``record_ohem``, every OHEM weight map drawn; with
    ``infer``, first the eval logits of the rank's clips (whole on every rank
    of a frames group) and ``target_confusion`` of them."""
    torch.set_num_threads(THREADS)
    device = torch.device(device)
    model = _model(cfg, state_dict, device, mit_drop_path, dtype)
    state = TrainState.create(model, OptimConfig(**optim))
    mesh = parallel.create_clip_mesh(frame_axis) if frame_axis else None
    step = make_train_step(model, state.optimizer, state.scheduler, mesh=mesh)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    rows = (parallel.shard_clip_batch(tensors, mesh) if mesh is not None
            else parallel.shard_batch(tensors))
    rows = {k: v.to(device) for k, v in rows.items()}
    out = {}
    if infer:
        out.update(target_confusion(model, rows, cfg.head.num_classes, mesh))
    ohem = []
    if record_ohem:
        inner = plosses._ohem_from_gt_prob

        def recorded(*args, **kw):
            out = inner(*args, **kw)
            ohem.append(out.cpu())
            return out

        plosses._ohem_from_gt_prob = recorded
    out.update({"metrics": [], "grads": [], "bn_steps": [], "bn_consts": []})
    try:
        for it in range(steps):
            gen = torch.Generator(device).manual_seed(step_seed(seed, it))
            m = step(rows, gen)
            out["metrics"].append({k: v.item() for k, v in m.items()})
            out["grads"].append({n: p.grad.detach().cpu().clone()
                                 for n, p in model.named_parameters() if p.grad is not None})
            bn = model.decode_head.linear_fuse.bn
            out["bn_steps"].append((bn.running_mean.cpu().clone(), bn.running_var.cpu().clone()))
            out["bn_consts"].append(bn_constant(model))
    finally:
        if record_ohem:
            plosses._ohem_from_gt_prob = inner
    bn = model.decode_head.linear_fuse.bn
    out["bn"] = (bn.running_mean.cpu().clone(), bn.running_var.cpu().clone())
    out["params"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    out["ohem"] = ohem
    return out


def decode_bn(device, head_cfg: pcfg.CFFMHeadConfig, state_dict: dict, feats: list,
              cotangent: np.ndarray) -> dict:
    """The per-frame decode with its fuse BN in training on this rank's rows of
    ``feats`` (4 levels, numpy (N, h, w, C)): the output, the gradient of
    Σ(out · cotangent) with respect to the rank's inputs, the parameters'
    gradients summed over the ranks (the global sum's gradient), and the
    running statistics."""
    torch.set_num_threads(THREADS)
    head = MLPDecodeHead(head_cfg)
    head.load_state_dict(state_dict, strict=True)
    head.to(device)
    xs = [torch.from_numpy(parallel.shard_batch(f)).to(device).requires_grad_() for f in feats]
    ct = torch.from_numpy(parallel.shard_batch(cotangent)).to(device)
    out = head.decode(xs, train=True)
    (out * ct).sum().backward()
    grads = {n: p.grad for n, p in head.named_parameters() if p.grad is not None}
    for g in grads.values():
        if parallel.world_size() > 1:
            torch.distributed.all_reduce(g)
    bn = head.linear_fuse.bn
    return {"out": out.detach().cpu(), "dx": [x.grad.cpu() for x in xs],
            "grads": {n: g.cpu() for n, g in grads.items()},
            "bn": (bn.running_mean.cpu(), bn.running_var.cpu())}


def ohem_weights(device, gt_prob: np.ndarray, valid: np.ndarray, thresh: float,
                 min_kept: int) -> torch.Tensor:
    """The OHEM weights of this rank's rows of a global (N, H, W) map of
    gt-class probabilities, ``n_imgs`` the rank's row count."""
    p = torch.from_numpy(parallel.shard_batch(gt_prob)).to(device)
    v = torch.from_numpy(parallel.shard_batch(valid)).to(device)
    return plosses._ohem_from_gt_prob(p, v, thresh, min_kept, p.shape[0]).cpu()


def confusion_sum(device, matrices: list) -> np.ndarray:
    """``aggregate_confusion`` of this rank's matrix."""
    return aggregate_confusion(matrices[parallel.rank()])


@torch.no_grad()
def target_confusion(model: CFFMSegmentor, rows: dict, num_classes: int,
                     mesh: parallel.ClipMesh | None) -> dict:
    """The eval logits of the rank's clips ``rows["imgs"]`` (uint8, its frames
    on ``mesh``) and the confusion of their argmax, upsampled to the labels,
    against the target frames' labels, summed over the data group (the
    ranks of a frames group predict the same rows: each row counts once)."""
    model.eval()
    logits = model(device_normalize(rows["imgs"]), mesh=mesh)
    model.train()
    labels = rows["labels"][:, -1]
    pred = resize_bilinear(logits.float(), tuple(labels.shape[1:])).argmax(-1)
    cm = update_confusion(torch.zeros((num_classes, num_classes), dtype=torch.int64),
                          pred.cpu(), labels.cpu(), num_classes)
    group = mesh.data_group if mesh is not None else None
    return {"logits": logits.cpu(), "pred": pred.cpu(),
            "confusion": aggregate_confusion(cm.numpy(), group)}


def lovasz_grad(device, logits: np.ndarray, labels: np.ndarray) -> dict:
    """``clip_lovasz_loss`` of this rank's rows of global clip ``logits``
    (B, T+1, h, w, C) and ``labels`` (B, T, H, W): the loss, the accuracy
    and the gradient of the loss with respect to the rank's logits."""
    torch.set_num_threads(THREADS)
    x = torch.from_numpy(parallel.shard_batch(logits)).to(device).requires_grad_()
    y = torch.from_numpy(parallel.shard_batch(labels)).to(device)
    out = plosses.clip_lovasz_loss(x, y)
    out["loss_seg"].backward()
    return {"loss": out["loss_seg"].item(), "acc": out["acc_seg"].item(), "grad": x.grad.cpu()}


def evaluate(device, cfg: pcfg.SegmentorConfig, state_dict: dict, root: str,
             img_scale: tuple[int, int]) -> dict:
    """The rank's shard through each evaluator, then summed over the ranks:
    ``ClipEvaluator`` on every world-th frame from the rank, and
    ``StreamingVideoEvaluator`` on every world-th video; returns both
    confusions (the sums)."""
    from vss_cffm_tpu_torch.data import VSPWVideoDataset, iterate_eval
    from vss_cffm_tpu_torch.eval import ClipEvaluator, StreamingVideoEvaluator

    torch.set_num_threads(THREADS)
    model = _model(cfg, state_dict, device).eval()
    r, world = parallel.rank(), parallel.world_size()
    ds = VSPWVideoDataset(root, "train", img_scale=img_scale)
    ds.split = "val"  # the test items of both videos
    clip = ClipEvaluator(model, cfg.head.num_classes, device=device)
    clip.run(iterate_eval(ds, num_workers=0, shard_id=r, num_shards=world), dataset=ds)
    clip.aggregate_across_processes()
    stream = StreamingVideoEvaluator(model, cfg.head.num_classes, device=device)
    stream.run_streaming(ds, videos=ds.videos[r::world] if world > 1 else None)
    stream.aggregate_across_processes()
    return {"clip": clip.confusion, "streamed": stream.confusion}


def test_cli(device, argv: list) -> dict:
    """``tools/test.py``'s ``main(argv)`` over the group the caller started:
    its metrics and confusion (the sums over the ranks)."""
    from vss_cffm_tpu_torch.tools import test as test_cli_

    torch.set_num_threads(THREADS)
    out = test_cli_.main(argv)
    return {"metrics": out["metrics"], "confusion": out["confusion"]}


def grid_cases(device, frames: dict) -> dict:
    """The 4-rank world of ``tests/test_torch_port_parallel.py``: the
    inference, the confusion and the train steps of ``frames`` (with
    ``frame_axis=2``: a 2 × 2 grid)."""
    return {"frames": train_steps(device, **frames)}


def bn_and_step(device, bn: dict, train: dict, ohem_map: dict) -> dict:
    """The fuse BN, a train step and an OHEM map in one world (the card test)."""
    return {"bn": decode_bn(device, **bn), "train": train_steps(device, **train),
            "ohem_map": ohem_weights(device, **ohem_map)}


def cases(device, train: dict, ohem: dict, bn: dict, ohem_map: dict, matrices: list,
          evaluation: dict, cli: list, frames: dict, lovasz: dict, lovasz_loss: dict) -> dict:
    """Every 2-rank case of ``tests/test_torch_port_parallel.py`` in one
    world, so that the ranks start once."""
    return {"train": train_steps(device, **train), "ohem": train_steps(device, **ohem),
            "bn": decode_bn(device, **bn), "ohem_map": ohem_weights(device, **ohem_map),
            "confusion": confusion_sum(device, matrices), "eval": evaluate(device, **evaluation),
            "test_cli": test_cli(device, cli), "frames": train_steps(device, **frames),
            "lovasz": train_steps(device, **lovasz), "lovasz_loss": lovasz_grad(device,
                                                                                **lovasz_loss)}
