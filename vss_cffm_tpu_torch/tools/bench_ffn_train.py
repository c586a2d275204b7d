"""The train pairs' FFN half on the card, at the CFFM-B1 train step's stages
1-3 (8 frames of 480×480: 120², 60², 30² maps, C 64 / 128 / 320, Ch = 4·C),
random inputs from a seed: ``python -m vss_cffm_tpu_torch.tools.bench_ffn_train
[--stages 1,2,3] [--plans R,C,HC,S;...] [--iters 20]``.

For each stage, in the block-FFN pair's mode (bf16 x in and out, rows 10
and 11) and in the whole block's (f32 y in, f32 d_y and bf16 d_attn out: the
FFN half of rows 6 and 7): the forward as one launch with the branch scale
(``ffn_fused``) against the three launches it replaced, and the backward as
one launch with its dW2, dW1 row reductions (``stage_block.ffn_bwd_steps``)
against the six it replaced (``ffn_bwd_unfused_steps``), each timed in the
order new, old, old, new: device µs a call, ``--iters`` calls queued behind
a ``torch.cuda._sleep`` between two CUDA events (the host's launch cost off
the clock); beside them the bound of the half's own work (tensor-core
FLOP at 989 TFLOP/s or bytes at 3.35 TB/s, H100 SXM data sheet, 700 W), the
rise of ``torch.cuda.max_memory_allocated`` over each backward's inputs and
outputs, and the backward launch alone at each of ``--plans`` (forced tiles
of R x C pixels, chunks of HC, S splits) beside the planner's plan.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ["stage_inputs", "main"]

TENSOR_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12
_SLEEP_CYCLES = int(2e7)
STAGES = {1: (120, 64), 2: (60, 128), 3: (30, 320)}
FRAMES = 8


def _queued_us(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def _abba(new, old, iters: int) -> list:
    return [_queued_us(new, iters), _queued_us(old, iters), _queued_us(old, iters),
            _queued_us(new, iters)]


def stage_inputs(stage: int, full: bool, seed: int = 0) -> dict:
    """x (bf16, or the block's f32 y), go (M, C) bf16, the f32 parameters of
    the half (γ2, β2, W1, b1, kdw, bdw, W2, b2) and branch scales (one frame
    of each branch dropped, the rest 1/0.9), on the card."""
    hw, c = STAGES[stage]
    ch = 4 * c
    rng = np.random.RandomState(seed + stage)
    f = lambda *sh, sc=1.0: torch.from_numpy((rng.randn(*sh) * sc).astype(np.float32)).cuda()
    x = f(FRAMES, hw, hw, c)
    ffn = (1.0 + f(c, sc=0.1), f(c, sc=0.1), f(c, ch, sc=c ** -0.5), f(ch, sc=0.1),
           f(3, 3, 1, ch, sc=1 / 3), f(ch, sc=0.1), f(ch, c, sc=ch ** -0.5), f(c, sc=0.1))
    s = torch.full((FRAMES,), 1 / 0.9, device="cuda")
    s_ffn, s_attn = s.clone(), s.clone()
    s_ffn[1], s_attn[0] = 0.0, 0.0
    return dict(x=x if full else x.to(torch.bfloat16), ffn=ffn,
                go=f(FRAMES * hw * hw, c).to(torch.bfloat16), s_ffn=s_ffn,
                s_attn=s_attn if full else None, full=full)


def _rise_mib(fn, keep) -> float:
    """MiB allocated by fn beyond what it returns (``keep`` picks the returned
    tensors), over what was allocated before."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    kept = sum(t.numel() * t.element_size() for t in keep(out))
    return (torch.cuda.max_memory_allocated() - base - kept) / 2 ** 20


def _parse_plans(text: str) -> list:
    return [tuple(int(v) for v in p.split(",")) for p in text.split(";") if p.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default="1,2,3")
    ap.add_argument("--plans", default="", help="forced backward plans R,C,HC,S;...")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    from vss_cffm_tpu_torch import ops
    sb, ff, fb = ops.stage_block, ops.ffn_fused, ops.ffn_bwd

    if not torch.cuda.is_available():
        raise SystemExit("bench_ffn_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[bench_ffn_train] {torch.cuda.get_device_name(0)}", flush=True)
    for stage in (int(s) for s in args.stages.split(",")):
        for full in (False, True):
            d = stage_inputs(stage, full)
            x, ffn, go, s_ffn = d["x"], d["ffn"], d["go"], d["s_ffn"]
            b, h, w, c = x.shape
            m, ch, eps = b * h * w, 4 * c, 1e-6
            rows = x.view(m, c)
            p = dict(shape=(b, h, w, c), dt=torch.bfloat16, g2=ffn[0], be2=ffn[1], w1=ffn[2],
                     b1=ffn[3], kdw=ffn[4], bdw=ffn[5], w2=ffn[6], s_ffn=s_ffn, s_attn=d["s_attn"],
                     eps=eps)
            old_f = sb._ffn_fwd_steps(*ffn, s_ffn, eps, (b, h, w, c), torch.bfloat16, True, "b")
            hid = old_f["hid"](rows)
            t = {"y": rows, "go": go}
            t_old = dict(t, hid=hid, a=old_f["a"](hid))
            new_fwd = lambda: ff.ffn_fused_launch(x, *ffn, eps, rows, "b", scale=s_ffn)
            old_fwd = lambda: old_f["out"](old_f["a"](old_f["hid"](rows)), rows)
            new_bwd = lambda: sb.run_steps(sb.ffn_bwd_steps(p, True, full, "b"), t)
            old_bwd = lambda: sb.run_steps(sb.ffn_bwd_unfused_steps(p, full, "b"), t_old)
            tf = _abba(new_fwd, old_fwd, args.iters)
            tb = _abba(new_bwd, old_bwd, args.iters)
            outs = ("d_y", "d_attn") if full else ("dx",)
            keep = lambda o: [o[k] for k in outs + ("dw1", "dw2", "dg2", "dbe2", "db2")]
            rise_new, rise_old = _rise_mib(new_bwd, keep), _rise_mib(old_bwd, keep)
            fwd_bound = max(2 * m * c * ch * 2 / TENSOR_FLOPS,
                            (x.numel() * x.element_size() + m * c * 2) / HBM_BYTES_PER_S)
            # x and go read once, dx (d_y and d_attn) written once
            bwd_bound = max(2 * m * 5 * c * ch / TENSOR_FLOPS,
                            (x.numel() * x.element_size() + m * c * (2 + (6 if full else 2)))
                            / HBM_BYTES_PER_S)
            plan = fb.ffn_bwd_plan(b, h, w, c, ch, sms)
            mode = "whole block (f32 y)" if full else "pair (bf16 x)"
            print(f"[bench_ffn_train] stage {stage} x{tuple(x.shape)} Ch={ch} {mode}: forward "
                  f"one launch {tf[0]:.1f} / {tf[3]:.1f} device us, three launches {tf[1]:.1f} / "
                  f"{tf[2]:.1f}, bound {fwd_bound * 1e6:.1f}; backward one launch + dW2, dW1 "
                  f"{tb[0]:.1f} / {tb[3]:.1f}, six launches {tb[1]:.1f} / {tb[2]:.1f}, bound "
                  f"{bwd_bound * 1e6:.1f}; memory rise of the backward {rise_new:.2f} MiB, the "
                  f"six launches' {rise_old:.2f} (new, old, old, new)", flush=True)
            for forced in [None] + _parse_plans(args.plans):
                if forced is None:
                    fp = plan
                else:
                    r, cc, hc, sp = forced
                    nch = -(-ch // hc)
                    per = -(-nch // sp)
                    fp = fb.FfnBwdPlan(r, cc, hc, -(-nch // per), per, fb.ffn_bwd_smem(r, cc, c, hc))
                if (fp.smem > ops._dispatch.SMEM_LIMIT
                        or fp.rows * fp.cols > ff.max_pixels(c)):
                    print(f"[bench_ffn_train]   plan {fp}: does not fit", flush=True)
                    continue
                launch = lambda fp=fp: fb.ffn_bwd_launch(x, go, *ffn[:7], s_ffn, eps, "b",
                                                         s_attn=d["s_attn"], full=full, plan=fp)
                us = _queued_us(launch, args.iters)
                print(f"[bench_ffn_train]   backward launch alone, plan (rows {fp.rows}, cols "
                      f"{fp.cols}, hc {fp.hc}, splits {fp.splits}){' (planner)' if forced is None else ''}: "
                      f"{us:.1f} device us", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
