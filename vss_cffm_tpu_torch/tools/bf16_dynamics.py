"""bf16-vs-f32 training dynamics of the port: the port of the JAX package's
``tools/bf16_dynamics.py``::

    python -m vss_cffm_tpu_torch.tools.bf16_dynamics [--steps 300] [--variant b0] [--hw 64] \\
        [--seed 0] [--device cuda|cuda:N|cpu]

Trains the same model twice from one init (seed 0) on the same synthetic
colour-mosaic video stream (``make_color_tree``: class = block colour), with
the loader and the step generators of ``--seed``: once in f32, once in the
shipped policy, bf16 compute with f32 parameters; then evaluates both runs
(``ClipEvaluator``, mIoU of the seen classes on the val video) and prints
the loss of the first 10, middle 10 and last 20 steps of each, their
relative difference, the last step's loss and the mIoU delta, as the JAX
tool does, at a tenth of its learning rate (``LR``: the JAX tool's
diverges). This bounds what no forward or gradient parity test covers:
whether hundreds of rounded bf16 updates drift from the f32 trajectory.

On the card the bf16 run goes through the hand-written kernels. They take
bf16 only (``ops/stage_block.py``, ``ops/cfm_attention.py``), so the f32
run is the reference trajectory through the ops' plain PyTorch versions
(``force="torch"``), asked for by name and printed as such. On the CPU
(``--device cpu``) both runs take the plain versions.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from ..utils.benchmark import device_of

__all__ = ["make_color_tree", "run_once", "main", "LR"]

# The JAX tool's lr, 2e-3 (2e-2 on the head, ``head_lr_mult`` 10), diverges in
# both packages within a few steps (B0, 64x64, on the CPU: the JAX tool's f32
# loss averages 39.6 over its first 10 steps, the port's rises from 1.55 to
# 42.8 by step 4), which bounds nothing; a tenth of it learns (1.55 -> ~0.8
# in 12 steps).
LR = 2e-4


def make_color_tree(root: str, hw: int = 64, frames: int = 12,
                    videos=("vid_a", "vid_b"), block: int = 16) -> str:
    """A VSPW tree under ``root`` whose class is the colour of each
    ``block`` × ``block`` square (4 colours, ±15 noise, JPEG quality 98; masks
    hold class + 1, as VSPW's 0 is ignored), the JAX tool's recipe with PIL;
    train: ``videos``, val: the first."""
    from PIL import Image

    colors = np.array([[40, 40, 200], [40, 200, 40], [200, 40, 40], [200, 200, 40]], np.uint8)
    rng = np.random.RandomState(1)
    for split, names in (("train", videos), ("val", videos[:1])):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    for v in videos:
        odir = os.path.join(root, "data", v, "origin")
        mdir = os.path.join(root, "data", v, "mask")
        os.makedirs(odir)
        os.makedirs(mdir)
        for i in range(frames):
            cls = rng.randint(0, len(colors), (hw // block, hw // block))
            cls_full = np.kron(cls, np.ones((block, block), int))
            img = colors[cls_full]
            noise = rng.randint(-15, 15, img.shape)
            img = np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)
            # colours in BGR, as the JAX tool writes them with cv2; PIL takes RGB
            Image.fromarray(np.ascontiguousarray(img[..., ::-1])).save(
                os.path.join(odir, f"{i:08d}.jpg"), quality=98)
            im = Image.fromarray((cls_full + 1).astype(np.uint8))
            im.putpalette([c for k in range(256) for c in (k, k, k)])
            im.save(os.path.join(mdir, f"{i:08d}.png"))
    return root


def run_once(root: str, dtype: torch.dtype, steps: int, variant: str, hw: int,
             device: torch.device, force: str | None = None, num_classes: int = 5,
             seed: int = 0) -> tuple[np.ndarray, float]:
    """``steps`` train steps (batch 2, lr ``LR`` without warm-up, weight decay
    0.01) computing in ``dtype`` with ``force`` on every op, then the val
    mIoU of the seen classes; returns (the losses, the mIoU)."""
    from ..config import OptimConfig, build_model_config
    from ..data import TrainLoader, VSPWVideoDataset, iterate_eval
    from ..eval import ClipEvaluator
    from ..models import CFFMSegmentor
    from ..tools.train import step_seed
    from ..train import TrainState, make_train_step

    ds = VSPWVideoDataset(root, "train", crop_size=(hw, hw), img_scale=(hw, hw))
    loader = TrainLoader(ds, batch_size=2, num_workers=1, seed=seed, device_normalize=True,
                         device=device)
    model = CFFMSegmentor(build_model_config(variant, num_classes=num_classes), dtype=dtype,
                          force=force)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device).train()
    ocfg = OptimConfig(lr=LR, warmup_iters=0, warmup_ratio=1.0, max_iters=steps * 10,
                       weight_decay=0.01)
    state = TrainState.create(model, ocfg)
    step = make_train_step(model, state.optimizer, state.scheduler)
    losses = []
    batches = iter(loader)
    try:
        for it in range(steps):
            m = step(next(batches), torch.Generator(device).manual_seed(step_seed(seed, it)))
            losses.append(m["loss_seg"].item())
    finally:
        batches.close()
    model.eval()
    val = VSPWVideoDataset(root, "val", img_scale=(hw, hw))
    ev = ClipEvaluator(model, num_classes, device=device)
    out = ev.run(iterate_eval(val, num_workers=1), dataset=val)
    return np.asarray(losses), float(out["mIoU_seen"])


def main(argv: list[str] | None = None) -> dict:
    """Prints the JAX tool's lines; returns each run's losses and mIoU."""
    ap = argparse.ArgumentParser(description="bf16-vs-f32 training dynamics of the port.")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--variant", default="b0")
    ap.add_argument("--hw", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    device = device_of(args.device, "bf16_dynamics")
    # the f32 reference asks for the plain versions by name on the card; on the
    # CPU every op takes them anyway
    f32_force = "torch" if device.type == "cuda" else None

    root = tempfile.mkdtemp(prefix="vss_bf16dyn_")
    try:
        make_color_tree(root, hw=args.hw)
        loss_f32, miou_f32 = run_once(root, torch.float32, args.steps, args.variant, args.hw,
                                      device, f32_force, seed=args.seed)
        loss_bf16, miou_bf16 = run_once(root, torch.bfloat16, args.steps, args.variant,
                                        args.hw, device, seed=args.seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def seg(a, lo, hi):
        return float(np.mean(a[max(lo, 0):hi]))

    n = args.steps
    print(f"steps={n} variant={args.variant} hw={args.hw} device={device}; f32: the reference "
          f"trajectory through the plain PyTorch ops{' (force=torch)' if f32_force else ''}; "
          f"bf16: {'the kernels' if device.type == 'cuda' else 'the plain ops (no card)'}")
    for name, lo, hi in (("first10", 0, 10), ("mid", n // 2 - 5, n // 2 + 5),
                         ("last20", n - 20, n)):
        f, b = seg(loss_f32, lo, hi), seg(loss_bf16, lo, hi)
        print(f"loss[{name:7s}]  f32 {f:.4f}  bf16 {b:.4f}  "
              f"rel-delta {abs(b - f) / max(f, 1e-9):.4f}")
    print(f"final-step loss   f32 {loss_f32[-1]:.4f}  bf16 {loss_bf16[-1]:.4f}")
    print(f"eval mIoU         f32 {miou_f32:.4f}  bf16 {miou_bf16:.4f}  "
          f"delta {miou_bf16 - miou_f32:+.4f}")
    return {"f32": {"losses": loss_f32, "mIoU_seen": miou_f32},
            "bf16": {"losses": loss_bf16, "mIoU_seen": miou_bf16}, "device": str(device)}


if __name__ == "__main__":
    main()
