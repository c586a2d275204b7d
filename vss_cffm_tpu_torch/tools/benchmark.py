"""Throughput of the port's model from an experiment config: clip inference,
the streamed per-frame steady state, or the train step. The port of the JAX
package's ``tools/benchmark.py`` (reference ``tools/benchmark.py:50-82``:
timed iterations after a warm-up, batch 1, device-synchronised)::

    python -m vss_cffm_tpu_torch.tools.benchmark vss_cffm_tpu_torch/configs/cffm_b1_vspw_160k.py \\
        [--shape 480 864] [--iters 200] [--batch N] [--streaming | --train] \\
        [--probs-f32 | --probs-compute-dtype] [--device cuda|cuda:N|cpu] [--options k=v ...]

- default: clips (target frames) per second of ``CFFMSegmentor`` on random
  (batch, 4, H, W, 3) clips at ``--shape``;
- ``--streaming``: ``frame_features`` on one new frame plus
  ``predict_from_features`` over a cached 4-frame window, the streamed
  evaluator's inner loop (``eval/evaluator.py``);
- ``--train``: ms a step and train frames/s of ``make_train_step`` at the
  config's crop and batch (``--batch`` overrides it), on uint8 clips that the
  step normalises on the device, as the train CLI feeds it; a finetune
  config's step gets 100 centres a video.

Weights are random from seed 0, in the config's compute dtype (``bf16``).
Timing is ``utils.benchmark.time_apply_chunked``: CUDA events around chunks
of calls on the card, the host clock on the CPU (``--device cpu``), which
times PyTorch's CPU kernels and is no device figure. ``--probs-f32`` /
``--probs-compute-dtype`` set the port's switch of the CFM backward's
probabilities dtype (``ops/cfm_attention.py:_PROBS_DTYPE``: f32, or the
compute dtype), read, as in the JAX package, only by the probabilities
backward (``_BWD="kernel"``); the default backward recomputes them. Prints
the JAX tool's line of its mode; writes nothing. This is a CLI, not the
port's benchmark.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import ExperimentConfig, apply_overrides, load_config
from ..models import CFFMSegmentor
from ..utils.benchmark import device_of, time_apply_chunked

__all__ = ["benchmark_model", "benchmark_streaming", "benchmark_train", "main"]


def _model(cfg: ExperimentConfig, device: torch.device) -> CFFMSegmentor:
    model = CFFMSegmentor(cfg.model, dtype=torch.bfloat16 if cfg.bf16 else torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    return model.to(device)


def _inference(fn):
    """``fn`` under ``torch.inference_mode`` (the model is built outside it:
    a parameter made inside would be an inference tensor)."""
    def run(*args):
        with torch.inference_mode():
            return fn(*args)
    return run


def benchmark_model(cfg: ExperimentConfig, shape=(480, 864), iters: int = 200, warmup: int = 5,
                    train_clip: int = 4, batch: int = 1,
                    device: str | torch.device = "cuda") -> float:
    """Clips (target frames) per second of clip inference."""
    device = device_of(device, "benchmark")
    model = _model(cfg, device).eval()
    h, w = shape
    imgs = torch.from_numpy(np.random.RandomState(0).randn(batch, train_clip, h, w, 3)
                            .astype(np.float32)).to(device)
    dt = time_apply_chunked(_inference(lambda: model(imgs)), device, iters=iters,
                            warmup=warmup, chunk=min(iters, 50))
    return batch / dt


def benchmark_streaming(cfg: ExperimentConfig, shape=(480, 864), iters: int = 100,
                        train_clip: int = 4, device: str | torch.device = "cuda") -> dict:
    """The streamed steady state: one backbone + decode pass on the new frame
    and one CFM pass over the cached window, each timed alone."""
    device = device_of(device, "benchmark")
    model = _model(cfg, device).eval()
    h, w = shape
    rng = np.random.RandomState(0)
    frame = torch.from_numpy(rng.randn(1, h, w, 3).astype(np.float32)).to(device)
    fused = torch.from_numpy(rng.randn(1, train_clip, h // 4, w // 4, cfg.model.head.embed_dim)
                             .astype(np.float32)).to(device, model.decode_head.compute_dtype)
    chunk = min(iters, 50)
    dt1 = time_apply_chunked(_inference(lambda: model.frame_features(frame)), device,
                             iters=iters, chunk=chunk)
    dt2 = time_apply_chunked(_inference(lambda: model.predict_from_features(fused)), device,
                             iters=iters, chunk=chunk)
    return {"frame_features_ms": round(dt1 * 1e3, 3), "predict_ms": round(dt2 * 1e3, 3),
            "frames_per_sec": round(1 / (dt1 + dt2), 1)}


def benchmark_train(cfg: ExperimentConfig, iters: int = 30, warmup: int = 3,
                    batch: int | None = None, device: str | torch.device = "cuda") -> dict:
    """ms a train step at the config's train geometry (reference: B=8 global
    batch, 480² crops, 4-frame clips), the steps chained through the
    parameters, step ``i`` drawing from ``step_seed(1, i)``."""
    from ..tools.train import step_seed
    from ..train import TrainState, make_train_step

    device = device_of(device, "benchmark")
    model = _model(cfg, device).train()
    b = batch or cfg.data.batch_size
    t = len(cfg.data.dilation) + 1
    h, w = cfg.data.crop_size
    rng = np.random.RandomState(0)
    data = {"imgs": torch.from_numpy(rng.randint(0, 256, (b, t, h, w, 3)).astype(np.uint8)),
            "labels": torch.from_numpy(rng.randint(0, cfg.model.head.num_classes, (b, t, h, w))
                                       .astype(np.int32))}
    if cfg.model.head.mode == "finetune":
        # CFFM++ finetune reads each video's k-means centres (the store pads
        # them to 100 a video: eval/prototypes.py)
        data["cluster_centers"] = torch.from_numpy(
            rng.randn(b, 100, cfg.model.head.embed_dim).astype(np.float32))
    data = {k: v.to(device) for k, v in data.items()}
    state = TrainState.create(model, cfg.optim)
    step = make_train_step(model, state.optimizer, state.scheduler)
    metrics = []

    def one_step():
        i = len(metrics)
        metrics.append(step(data, torch.Generator(device).manual_seed(step_seed(1, i))))

    dt = time_apply_chunked(one_step, device, iters=iters, warmup=warmup, chunk=iters)
    loss = metrics[-1]["loss_seg"].item()
    if not np.isfinite(loss):
        raise RuntimeError(f"benchmark --train: loss {loss} after {len(metrics)} steps")
    return {"train_ms_per_iter": round(dt * 1e3, 3), "frames_per_sec": round(b * t / dt, 1),
            "batch": b, "clip": t, "crop": f"{h}x{w}", "loss": round(loss, 3)}


def main(argv: list[str] | None = None) -> dict:
    """Prints the mode's line; returns {"mode", "device", and the mode's
    figures}."""
    ap = argparse.ArgumentParser(description="Throughput of the port's model from a config.")
    ap.add_argument("config")
    ap.add_argument("--shape", type=int, nargs=2, default=[480, 864])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--train", action="store_true",
                    help="time the train step at the config's train geometry instead of clip "
                         "inference")
    ap.add_argument("--streaming", action="store_true",
                    help="time the streamed per-frame steady state (the cached-feature "
                         "evaluator's inner loop)")
    ap.add_argument("--probs-f32", action="store_true",
                    help="the CFM probabilities backward keeps p in f32 (the default)")
    ap.add_argument("--probs-compute-dtype", action="store_true",
                    help="the CFM probabilities backward keeps p in the compute dtype")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--options", nargs="*", default=[])
    args = ap.parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.options)
    if args.probs_f32 or args.probs_compute_dtype:
        from ..ops import cfm_attention as cfm

        cfm._PROBS_DTYPE = torch.float32 if args.probs_f32 else None
    device = str(device_of(args.device, "benchmark"))
    if args.train:
        out = benchmark_train(cfg, iters=min(args.iters, 50), batch=args.batch, device=device)
        print(f"train: {out}")
        return {"mode": "train", "device": device, **out}
    if args.streaming:
        out = benchmark_streaming(cfg, tuple(args.shape), min(args.iters, 100), device=device)
        print(f"streaming: {out}")
        return {"mode": "streaming", "device": device, **out}
    b = args.batch or 1
    fps = benchmark_model(cfg, tuple(args.shape), args.iters, batch=b, device=device)
    print(f"fps: {fps:.2f} (clip inference at {args.shape[0]}x{args.shape[1]}, batch {b})")
    return {"mode": "clip", "device": device, "fps": fps}


if __name__ == "__main__":
    main()
