"""Every ``block_gemm`` launch of a CFFM-B1 default train step and of one
inference clip, each timed alone on the card: ``python -m
vss_cffm_tpu_torch.tools.bench_gemm [--iters 5]``.

The launches are recorded from one train step (2 clips of 4 frames of
480×480, ``train_block_impl=("full", "full", "full", None)``: the block
pair's forward, rows 6, and backward, row 7) and one 4-frame clip through
``inference_segmentor`` (row 1 at stages 2 and 3), random weights from seed
0. One line per distinct launch (M, N, K, LayerNorm, A dtype, output dtype,
residual, scales): how often a step or a clip makes it, the kernel's device
µs per launch (torch.profiler over ``--iters`` calls of the wrapper, whose
weight is handed over in bf16 so that the kernel is its only launch), the
bytes bound at 3.35 TB/s (A, W, bias, LayerNorm parameters, residual, scales
and output each once), the share of that rate the kernel reaches, and the
device µs of ``torch.matmul`` on the same operands in bf16 (no LayerNorm, no
epilogue) as a yardstick. The tool uses only what every tree of the port
since its train step has (``stage_block._gemm``, ``apis``, ``train``), so the
same file times an older checkout: ``PYTHONPATH=<checkout> python
.../bench_gemm.py``.
"""

from __future__ import annotations

import argparse
import importlib

import numpy as np
import torch

__all__ = ["record_launches", "time_launches", "main"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, 700 W
_SEED = 0


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


def _key(a, w, kw) -> tuple:
    ln, res = kw.get("ln"), kw.get("res")
    return (a.shape[0], w.shape[1], a.shape[1], ln is not None, str(a.dtype).split(".")[-1],
            str(kw["out_dtype"]).split(".")[-1],
            None if res is None else str(res.dtype).split(".")[-1],
            kw.get("a_scale") is not None, kw.get("o_scale") is not None)


def _role(key: tuple) -> str:
    _, n, k, ln, _, out, res, a_sc, o_sc = key
    if ln:
        return "q = LN1(x)·Wq" if out == "bfloat16" else "hid = LN2(y)·W1"
    if res is not None:
        return "y = x + ctx·Wproj" if out == "float32" else "out = y + a·W2"
    if a_sc:
        return "d_a = bf16(go·s)·W2ᵀ"
    if out == "bfloat16":
        return "d_ctx = d_attn·Wprojᵀ" if not o_sc else "out = a·W2"
    return "d_ln2 = d_hid·W1ᵀ" if k > n else "d_ln1 = d_q·Wqᵀ"


def record_launches(path: str) -> dict:
    """{key: [calls, (args, kwargs) of the first call, cloned]} of the
    ``_gemm`` calls of one default train step ("train") or one clip
    ("clip")."""
    apis = importlib.import_module("vss_cffm_tpu_torch.apis")
    sb = importlib.import_module("vss_cffm_tpu_torch.ops.stage_block")
    real = sb._gemm
    seen: dict = {}

    def recorder(a, w, bias, **kw):
        key = _key(a, w, kw)
        if key not in seen:
            copy = lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t
            seen[key] = [0, ((copy(a), copy(w), copy(bias)),
                             {k: (tuple(copy(x) for x in v) if isinstance(v, tuple) else copy(v))
                              for k, v in kw.items()})]
        seen[key][0] += 1
        return real(a, w, bias, **kw)

    rng = np.random.RandomState(_SEED)
    if path == "clip":
        bundle = apis.init_segmentor("b1", device="cuda", dtype=torch.bfloat16, seed=_SEED)
        clip = [rng.randint(0, 256, (480, 480, 3), dtype=np.uint8) for _ in range(4)]
        apis.inference_segmentor(bundle, clip)
        sb._gemm = recorder
        try:
            apis.inference_segmentor(bundle, clip)
        finally:
            sb._gemm = real
    else:
        from vss_cffm_tpu_torch.config import OptimConfig
        from vss_cffm_tpu_torch.train import TrainState, make_train_step

        bundle = apis.init_segmentor("b1", device="cuda", dtype=torch.bfloat16, seed=_SEED)
        model = bundle.model.train()
        shape = (2, 4, 480, 480)
        labels = rng.randint(0, 124, shape).astype(np.uint8)
        labels[rng.rand(*shape) < 0.05] = 255
        batch = {"imgs": torch.from_numpy(rng.randint(0, 256, (*shape, 3), dtype=np.uint8)).cuda(),
                 "labels": torch.from_numpy(labels).cuda()}
        state = TrainState.create(model, OptimConfig())
        step = make_train_step(model, state.optimizer, state.scheduler)
        gen = torch.Generator("cuda").manual_seed(_SEED)
        step(batch, gen)
        sb._gemm = recorder
        try:
            step(batch, gen)
        finally:
            sb._gemm = real
    torch.cuda.synchronize()
    return seen


def _launch_bytes(args, kw) -> int:
    a, w, bias = args
    m, n = a.shape[0], w.shape[1]
    nb = lambda t: 0 if t is None else t.numel() * t.element_size()
    out = m * n * torch.empty((), dtype=kw["out_dtype"]).element_size()
    ln = kw.get("ln")
    return (nb(a) + w.numel() * 2 + (0 if bias is None else bias.numel() * 4)
            + (0 if ln is None else 2 * a.shape[1] * 4) + nb(kw.get("res")) + out
            + nb(kw.get("a_scale")) + nb(kw.get("o_scale")))


def time_launches(seen: dict, iters: int = 5) -> list[dict]:
    """One row per recorded launch: its calls, device µs, bytes bound µs,
    share of 3.35 TB/s and torch.matmul's device µs."""
    sb = importlib.import_module("vss_cffm_tpu_torch.ops.stage_block")
    rows = []
    for key, (calls, (args, kw)) in seen.items():
        a, w, bias = args
        wb = w.to(torch.bfloat16).contiguous()
        kw = dict(kw)
        if kw.get("ln") is not None:
            g, b, eps = kw["ln"]
            kw["ln"] = (g.float().contiguous(), b.float().contiguous(), eps)
        bb = None if bias is None else bias.float().contiguous()
        us = _device_us(lambda: sb._gemm(a, wb, bb, **kw), iters)
        ab = a.to(torch.bfloat16)
        mm_us = _device_us(lambda: torch.matmul(ab, wb), iters)
        bound = _launch_bytes(args, kw) / HBM_BYTES_PER_S * 1e6
        rows.append(dict(key=key, role=_role(key), calls=calls, us=us, bound_us=bound,
                         share=bound / us if us else 0.0, matmul_us=mm_us))
    return rows


def format_row(path: str, r: dict) -> str:
    m, n, k, ln, adt, odt, res, a_sc, o_sc = r["key"]
    return (f"{path} {r['role']}: M={m} N={n} K={k} LN={int(ln)} A {adt} out {odt} residual "
            f"{res} scales {int(a_sc)}{int(o_sc)}, {r['calls']} a {path}: {r['us']:.1f} us "
            f"(bytes bound {r['bound_us']:.1f} us, {100 * r['share']:.1f} % of 3.35 TB/s); "
            f"torch.matmul bf16 {r['matmul_us']:.1f} us")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm: needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for path in ("train", "clip"):
        rows = time_launches(record_launches(path), opts.iters)
        for r in rows:
            print(f"[gemm] {format_row(path, r)}", flush=True)
        total = sum(r["calls"] * r["us"] for r in rows)
        bound = sum(r["calls"] * r["bound_us"] for r in rows)
        print(f"[gemm] {path}: {sum(r['calls'] for r in rows)} launches, {total:.1f} us of "
              f"kernel time a {path} (bytes bound {bound:.1f} us)", flush=True)
        out[path] = rows
    return out


if __name__ == "__main__":
    main()
