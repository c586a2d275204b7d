"""Device time by kernel of the port's clip forward (or train step), from
``torch.profiler``: the port of the JAX package's ``tools/profile_forward.py``,
whose xplane parse (``aggregate_xspace``) becomes ``key_averages()``::

    python -m vss_cffm_tpu_torch.tools.profile_forward [--variant b1] [--shape 480 480] \\
        [--iters 10] [--top 30] [--block-impl ,fused,fused,] [--dwconv-impl fused] \\
        [--train [--train-block-impl ffn] [--batch N]] [--trace-dir DIR] \\
        [--device cuda|cuda:N|cpu]

CFFM-``--variant`` with random weights from seed 0, in bf16 on the card (f32
on the CPU, where bf16 is emulated and no kernel runs), runs once outside
the trace, then ``--iters`` times inside it: clip inference on a (1, 4, H,
W, 3) clip at ``--shape``, or with ``--train`` the train step of
``configs/cffm_<variant>_vspw_160k.py`` on uint8 clips at ``--shape`` (its
crop, 480 × 480 by default) and ``--batch`` (the config's by default). The
table sums each kernel's device time (the hand-written kernels under their
CUDA names, e.g. ``attention_fwd_kernel``, ``dwconv3x3_kernel``,
``gemm_kernel``): the total, µs an iteration, the share, the top ``--top``.
On the CPU (``--device cpu``) there is no device: the table sums each
operator's host (CPU) self time instead and says so. ``--trace-dir`` also
writes the Chrome trace there.

``--block-impl`` / ``--dwconv-impl`` / ``--train-block-impl`` set the
port's ``SegmentorConfig`` fields (``none`` for None, commas for one value
a stage). ``--embed-impl im2col`` is the JAX package's TPU tuning of the
patch embeds, which the port does not carry (its embeds are cuDNN
convolutions): it is refused.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os

import numpy as np
import torch

from ..config import build_model_config, load_config
from ..models import CFFMSegmentor
from ..utils.benchmark import device_of

__all__ = ["aggregate", "main"]


def _parse_impl(s: str | None):
    if not s or s == "none":
        return None
    if "," in s:
        return tuple((t or None) for t in s.split(","))
    return s


def aggregate(prof, device: torch.device) -> dict[str, float]:
    """µs by name over the profiled window: each kernel's device time on the
    card, each operator's host self time on the CPU."""
    from torch.autograd import DeviceType

    agg: dict[str, float] = collections.defaultdict(float)
    for e in prof.key_averages():
        if e.is_user_annotation:
            continue
        if device.type == "cuda":
            if e.device_type == DeviceType.CUDA:
                agg[e.key] += e.self_device_time_total
        elif e.device_type == DeviceType.CPU:
            agg[e.key] += e.self_cpu_time_total
    return dict(agg)


def _dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _train_fn(args, overrides: dict, device: torch.device):
    from ..tools.train import step_seed
    from ..train import TrainState, make_train_step

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                        f"cffm_{args.variant}_vspw_160k.py")
    tcfg = load_config(path)
    if args.train_block_impl is not None:
        overrides["train_block_impl"] = _parse_impl(args.train_block_impl)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, **overrides))
    b = args.batch or tcfg.data.batch_size
    h, w = args.shape
    rng = np.random.RandomState(0)
    batch = {"imgs": torch.from_numpy(rng.randint(0, 256, (b, 4, h, w, 3)).astype(np.uint8)),
             "labels": torch.from_numpy(rng.randint(0, tcfg.model.head.num_classes,
                                                    (b, 4, h, w)).astype(np.int32))}
    batch = {k: v.to(device) for k, v in batch.items()}
    model = CFFMSegmentor(tcfg.model, dtype=_dtype(device))
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device).train()
    state = TrainState.create(model, tcfg.optim)
    step = make_train_step(model, state.optimizer, state.scheduler)
    count = [0]

    def fn():
        step(batch, torch.Generator(device).manual_seed(step_seed(1, count[0])))
        count[0] += 1

    return fn


def _forward_fn(cfg, shape, device: torch.device):
    model = CFFMSegmentor(cfg, dtype=_dtype(device))
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device).eval()
    imgs = torch.from_numpy(np.random.RandomState(0).randn(1, 4, *shape, 3)
                            .astype(np.float32)).to(device)

    def fn():
        with torch.inference_mode():
            model(imgs)

    return fn


def main(argv: list[str] | None = None) -> dict:
    """Prints the table; returns {"device", "kind" ("device" or "host"),
    "total_us", "per_iter_us", "top": [(name, µs an iteration, share)]}."""
    ap = argparse.ArgumentParser(description="Device time by kernel of the port's forward.")
    ap.add_argument("--variant", default="b1")
    ap.add_argument("--shape", type=int, nargs=2, default=(480, 480))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--block-impl", default=None)
    ap.add_argument("--embed-impl", default=None)
    ap.add_argument("--dwconv-impl", default=None)
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step (the config's batch) instead of clip inference")
    ap.add_argument("--train-block-impl", default=None,
                    help="train_block_impl override (e.g. 'ffn' or 'ffn,ffn,ffn,' per stage)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    if args.embed_impl not in (None, "none"):
        raise SystemExit(f"--embed-impl {args.embed_impl}: the JAX package's TPU tuning of the "
                         "patch embeds, which the port does not carry (its embeds are cuDNN "
                         "convolutions)")
    device = device_of(args.device, "profile_forward")
    overrides = {field: _parse_impl(raw) for field, raw in (("block_impl", args.block_impl),
                                                             ("dwconv_impl", args.dwconv_impl))
                 if raw is not None}
    if args.train:
        fn = _train_fn(args, overrides, device)
    else:
        cfg = dataclasses.replace(build_model_config(args.variant), **overrides)
        fn = _forward_fn(cfg, tuple(args.shape), device)
    cuda = device.type == "cuda"
    fn()  # first call outside the window: cuDNN's choices, the kernels' builds
    if cuda:
        torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.iters):
            fn()
        if cuda:
            torch.cuda.synchronize(device)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, "trace.json"))
    agg = aggregate(prof, device)
    total = sum(agg.values())
    per_iter = total / max(args.iters, 1)
    kind = "device" if cuda else "host (CPU, no device)"
    trace = os.path.join(args.trace_dir, "trace.json") if args.trace_dir else None
    print(f"trace: {trace or 'not written (no --trace-dir)'}")
    print(f"{kind} total: {total:.1f} us over {args.iters} iters = {per_iter:.1f} us/iter "
          f"({1e6 / per_iter if per_iter else 0:.1f} {'fps' if not args.train else 'steps/s'})")
    print(f"{'us/iter':>10}  {'%':>5}  {'kernel' if cuda else 'op'}")
    top = []
    for name, us in sorted(agg.items(), key=lambda kv: -kv[1])[:args.top]:
        share = 100 * us / total
        top.append((name, us / args.iters, share))
        print(f"{us / args.iters:>10.1f}  {share:>5.1f}  {name[:110]}")
    return {"device": str(device), "kind": "device" if cuda else "host", "total_us": total,
            "per_iter_us": per_iter, "top": top}


if __name__ == "__main__":
    main()
