"""The CE forwards, timed alone on the card: ``python -m
vss_cffm_tpu_torch.tools.bench_ce_fwd [--iters 5]``.

Row 14 (``ce_upsampled_loss``, the default loss) and row 12
(``ce_upsampled_nll``, OHEM and class weights) at the step's two branches,
on the inputs of ``tools/bench_ce_bwd.make_inputs``: logits (N, 120, 120,
124) bf16 for N 8 (the clip's frames) and N 2 (its last frames), ×4 to 480²,
uint8 labels uniform in [0, 124) with 5 % ignored (255). Then the CE
microbench's phase-layout forwards at the same inputs, row 16
(``ce_fwd_loss_v5``) and row 18 (``ce_fwd_loss_v3``), the labels w-major
from ``labels_to_phase_w``. One line each (``[row14]`` for rows 14 and 12,
``[row16]``, ``[row18]``): device µs per call (torch.profiler over
``--iters`` calls, the larger of two windows: the kernel and, for the
losses, the sum of its partials), the exp bound (C exps per valid pixel for
the losses, per pixel for row 12, at the MUFU rate of 16 a clock on 132 SMs
at 1.98 GHz), the share of the bound (bound over device time), the device µs
of the PyTorch calls that compute the same function (``F.interpolate`` and
``F.cross_entropy``, summed, the losses' yardstick, or per pixel), and a
digest of the row's output ((wsum, corr), or the three maps), so that rows
16 and 18 read against row 14, and two trees, bit for bit. Uses only what
older trees of the port also have, so the same file times an older checkout
(``PYTHONPATH=<checkout> python .../bench_ce_fwd.py``).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib

import torch
import torch.nn.functional as F

from vss_cffm_tpu_torch.tools import bench_ce_bwd as bwd

__all__ = ["measure", "main"]


def _digest(*ts: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(n: int, iters: int = 5) -> list[dict]:
    """[{row, n, us, bound_us, library_us, digest}] of rows 14, 12, 16 and 18
    at N n."""
    ops = importlib.import_module("vss_cffm_tpu_torch.ops")
    c, s = bwd.C, bwd.S
    inp = bwd.make_inputs(n)
    x, lab, valid, img_w = inp["logits"], inp["labels"], inp["valid"], inp["img_w"]
    phw = ops.labels_to_phase_w(lab, s).contiguous()
    lab64 = lab.long()

    def library(reduction: str):
        up = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(lab.shape[1:]),
                           mode="bilinear", align_corners=False)
        return F.cross_entropy(up, lab64, reduction=reduction, ignore_index=255)

    rows = []
    with torch.no_grad():
        lib_us = {r: bwd._device_us(lambda: library(r), iters) for r in ("sum", "none")}
        for row, call, pixels, reduction in (
                (14, lambda: ops.ce_upsampled_loss(x, lab, s, img_w), int(valid.sum()), "sum"),
                (12, lambda: ops.ce_upsampled_nll(x, lab, s), lab.numel(), "none"),
                (16, lambda: ops.ce_fwd_loss_v5(x, phw, s, img_w), int(valid.sum()), "sum"),
                (18, lambda: ops.ce_fwd_loss_v3(x, phw, s, img_w), int(valid.sum()), "sum")):
            rows.append(dict(row=row, n=n, us=bwd._device_us(call, iters),
                             bound_us=c * pixels / bwd.MUFU_EXP_PER_S * 1e6,
                             library_us=lib_us[reduction], digest=_digest(*call())))
    return rows


def format_row(r: dict) -> str:
    # both profiler windows may lose every event of the row's calls: no device time
    us = (f"{r['us']:.1f} us (exp bound {r['bound_us']:.1f} us, share "
          f"{r['bound_us'] / r['us']:.3f})" if r["us"] > 0 else
          f"device time not measured (exp bound {r['bound_us']:.1f} us)")
    return (f"row {r['row']} N={r['n']} logits({r['n']}, {bwd.HW[0]}, {bwd.HW[1]}, {bwd.C}) "
            f"s={bwd.S}: {us}; library {r['library_us']:.1f} us; "
            f"{'maps' if r['row'] == 12 else '(wsum, corr)'} digest {r['digest']}")


# the line's tag: rows 14 and 12 share row 14's code and tag
TAGS = {14: 14, 12: 14, 16: 16, 18: 18}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_ce_fwd: needs a CUDA device (the kernels have no CPU mode)")
    out = []
    for n in (8, 2):
        for r in measure(n, opts.iters):
            print(f"[row{TAGS[r['row']]}] {format_row(r)}", flush=True)
            out.append(r)
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
