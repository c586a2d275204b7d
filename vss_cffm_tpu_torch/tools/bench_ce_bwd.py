"""The CE backwards, timed alone on the card: ``python -m
vss_cffm_tpu_torch.tools.bench_ce_bwd [--iters 5]``.

Row 17 (``ce_upsampled_loss_bwd``, the default loss) and row 13
(``ce_upsampled_nll_bwd``, OHEM and class weights) at the step's two
branches: logits (N, 120, 120, 124) bf16 for N 8 (the clip's frames) and
N 2 (its last frames), ×4 to 480², uint8 labels uniform in [0, 124) with 5 %
ignored (255), as the train batch; row 13 with the plain forward's lse and a
cotangent of class weights in [0.5, 1.5] over the valid count, 0 on ignored
pixels. Then the CE microbench's phase-layout backwards at the same inputs,
row 15 (``ce_bwd_loss_v2``, the labels h-major from ``labels_to_phase``) and
row 19 (``ce_bwd_loss_v3``, w-major from ``labels_to_phase_w``), f32 out. One
line each (``[row17]`` for rows 17 and 13, ``[row15]``, ``[row19]``): device
µs per call (torch.profiler over ``--iters`` calls: the kernel and its
boundary pass), the bound (C exps per valid pixel, or per pixel with g ≠ 0,
at the MUFU rate of 16 a clock on 132 SMs at 1.98 GHz), and, where the
tree's kernel runs on a strip plan (``ce_bwd_plan``; for row 13 its own
``ce_nll_bwd_plan`` where the tree has it; for rows 15 and 19 the trees with
``ce_label_index``), the recompute factor: the exps the kernel executes over
C × those pixels; and a digest of the row's dlogits (for rows
15 and 19 also of their bf16 rounding, which is row 17's result at these
inputs), so that two trees' outputs compare bit for bit. Uses only what
older trees of the port also have, so the same file times an older checkout
(``PYTHONPATH=<checkout> python .../bench_ce_bwd.py``).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib

import numpy as np
import torch

__all__ = ["make_inputs", "measure", "main"]

MUFU_EXP_PER_S = 16 * 132 * 1.98e9
C, HW, S = 124, (120, 120), 4


def make_inputs(n: int, device="cuda") -> dict:
    rng = np.random.RandomState(n)
    h, w = HW
    logits = torch.from_numpy(rng.randn(n, h, w, C).astype(np.float32)).to(device, torch.bfloat16)
    lab = rng.randint(0, C, (n, h * S, w * S))
    lab[rng.rand(*lab.shape) < 0.05] = 255
    labels = torch.from_numpy(lab.astype(np.uint8)).to(device)
    valid = labels.long() < C
    cw = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(device)
    g_nll = torch.where(valid, cw[labels.long().clamp(max=C - 1)], 0.0) / valid.sum()
    return dict(logits=logits, labels=labels, valid=valid, g_nll=g_nll.float().contiguous(),
                img_w=0.5 / float(labels.numel()), g=torch.ones((), device=device))


def _device_us(fn, iters: int) -> float:
    """Device µs of one call of fn: the CUDA kernels of ``iters`` calls as
    torch.profiler traces them, over iters; the larger of two such windows,
    as the profiler now and then drops a window's events (some or all)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        best = max(best, sum(e.self_device_time_total for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
                   / iters)
    return best


ROWS = (17, 13, 15, 19)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def measure(n: int, iters: int = 5) -> list[dict]:
    """[{row, n, us, bound_us, factor or None, digest, bf16_digest or None}] of
    rows 17, 13, 15 and 19 at N n."""
    ops = importlib.import_module("vss_cffm_tpu_torch.ops")
    ce = importlib.import_module("vss_cffm_tpu_torch.ops.ce_upsampled")
    inp = make_inputs(n)
    x, lab, g, img_w = inp["logits"], inp["labels"], inp["g"], inp["img_w"]
    lse = ops.ce_upsampled_nll(x, lab, S, force="torch")[2].contiguous()
    ph = ops.labels_to_phase(lab, S).contiguous()
    phw = ops.labels_to_phase_w(lab, S).contiguous()
    live = {17: inp["valid"], 13: inp["g_nll"] != 0, 15: inp["valid"], 19: inp["valid"]}
    calls = {17: lambda: ops.ce_upsampled_loss_bwd(x, lab, g, S, img_w),
             13: lambda: ops.ce_upsampled_nll_bwd(x, lab, lse, inp["g_nll"], S),
             15: lambda: ops.ce_bwd_loss_v2(x, ph, g, S, img_w),
             19: lambda: ops.ce_bwd_loss_v3(x, phw, g, S, img_w)}
    # the trees whose kernel for the row runs on the strip plan
    planned = {17: hasattr(ce, "ce_bwd_plan"), 13: hasattr(ce, "ce_bwd_plan"),
               15: hasattr(ce, "ce_label_index"), 19: hasattr(ce, "ce_label_index")}
    rows = []
    for row in ROWS:
        factor = None
        if planned[row]:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            plan = (ce.ce_nll_bwd_plan if row == 13 and hasattr(ce, "ce_nll_bwd_plan")
                    else ce.ce_bwd_plan)(n, *HW, C, S, sms)
            exps = ce.ce_bwd_exps(live[row] if row == 13 else lab, C, S, plan, row == 13)
            factor = exps / (C * int(live[row].sum()))
        out = calls[row]()
        rows.append(dict(row=row, n=n, us=_device_us(calls[row], iters),
                         bound_us=C * int(live[row].sum()) / MUFU_EXP_PER_S * 1e6,
                         factor=factor, digest=_digest(out),
                         bf16_digest=_digest(out.to(torch.bfloat16)) if row in (15, 19) else None))
    return rows


def format_row(r: dict) -> str:
    fac = "n/a" if r["factor"] is None else f"{r['factor']:.4f}"
    return (f"row {r['row']} N={r['n']} logits({r['n']}, {HW[0]}, {HW[1]}, {C}) s={S}: "
            f"{r['us']:.1f} us (exp bound {r['bound_us']:.1f} us, {r['us'] / r['bound_us']:.1f}x); "
            f"exps executed / (C x {'g != 0' if r['row'] == 13 else 'valid'} pixels) {fac}; "
            f"dlogits digest {r['digest']}"
            + (f", bf16 {r['bf16_digest']}" if r["bf16_digest"] else ""))


# the line's tag (row 13 keeps row 17's, so that older trees' lines match)
TAGS = {17: 17, 13: 17, 15: 15, 19: 19}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_ce_bwd: needs a CUDA device (the kernels have no CPU mode)")
    out = []
    for n in (8, 2):
        for r in measure(n, opts.iters):
            print(f"[row{TAGS[r['row']]}] {format_row(r)}", flush=True)
            out.append(r)
    return out


if __name__ == "__main__":
    main()
