"""Where the FFN half's backward launch spends its time, on the card:
``python -m vss_cffm_tpu_torch.tools.probe_ffn_bwd [variant ...] [--stages 1,2,3]
[--plans R,C,HC,S;...]``.

Builds variants of ``csrc/ffn_bwd.cu`` with ``nvcc`` (all at once) into
directories of the (git-ignored) build directory: the source copied, a few
lines replaced, the package's own flags; loads each in place of the
library and times the launch alone (``ops.ffn_bwd.ffn_bwd_launch``, the
pair's mode, bf16 x) at the CFFM-B1 train step's stages 1-3
(``bench_ffn_train.stage_inputs``) with the planner's plan or each of
``--plans``: device µs a call, calls queued behind a sleep between CUDA
events, the variants timed in turn and then in reverse order (each twice).
A variant leaves one phase out, so that its time is what the rest costs
(its outputs are wrong by design):

- ``base``: the source as it is;
- ``no_mma``: no fc1 or d_a products (their m-tile loops);
- ``no_dw``: no z / d_z / a pass over the one-pixel halo (nor its tap sums);
- ``no_dh``: no d_hid pass;
- ``no_dln``: no d_ln product;
- ``no_red``: no reduction of the chunk's partial sums (the compiler then
  drops their accumulation too);
- ``no_ln``: no LayerNorm of the halo tile;
- ``no_epi``: no LayerNorm backward of the tile's pixels;
- ``no_wload``: no weight chunk loads (zeros are not written either).

It prints each variant's ptxas lines (registers, spills, C75xx advisories).
The replacements match the source's text: a change to those lines of
``ffn_bwd.cu`` needs the same change here.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import tempfile

import torch

__all__ = ["main", "VARIANTS"]

VARIANTS = {
    "base": [],
    "no_mma": [("      for (int mt = wg; mt < T2; mt += 2) {", "      for (int mt = wg; mt < 0; mt += 2) {"),
               ("    for (int mt = da0; mt < T2 + T1; mt += 2) {",
                "    for (int mt = da0; mt < 0; mt += 2) {")],
    "no_dw": [("      for (int it = tid; it < P1 * Q4; it += THREADS) {",
               "      for (int it = tid; it < 0; it += THREADS) {")],
    "no_dh": [("    for (int it = tid; it < pout * Q4; it += THREADS) {",
               "    for (int it = tid; it < 0; it += THREADS) {")],
    "no_dln": [("        for (int j = 0; j < NA; ++j) {\n          const int atom = min(",
                "        for (int j = 0; j < 0; ++j) {\n          const int atom = min(")],
    "no_red": [("      for (int o = Q4; o < 32; o <<= 1)", "      for (int o = 32; o < 32; o <<= 1)"),
               ("      if (lane < Q4) {", "      if (false) {"),
               ("    for (int e = tid; e < 11 * HC; e += THREADS) {",
                "    for (int e = tid; e < 0; e += THREADS) {")],
    "no_ln": [("    for (int p0 = warp * ppw * LN_PASSES; p0 < P2; p0 += WARPS * ppw * LN_PASSES) {",
               "    for (int p0 = warp * ppw * LN_PASSES; p0 < 0; p0 += WARPS * ppw * LN_PASSES) {")],
    "no_epi": [("  for (int p0 = warp * ppw * EPI_PASSES; p0 < np; p0 += WARPS * ppw * EPI_PASSES) {",
                "  for (int p0 = warp * ppw * EPI_PASSES; p0 < 0; p0 += WARPS * ppw * EPI_PASSES) {")],
    "no_wload": [("    if (ck < c_hi) {", "    if (false) {")],
}


def _start(build, name: str, subs):
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    d = tempfile.mkdtemp(prefix=f"probe_ffn_bwd_{name}_", dir=build.BUILD_DIR)
    for f in os.listdir(build.CSRC):
        shutil.copy(os.path.join(build.CSRC, f), d)
    path = os.path.join(d, "ffn_bwd.cu")
    with open(path) as fh:
        src = fh.read()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"variant {name}: the line to replace is gone: {old[:60]!r}")
        src = src.replace(old, new)
    with open(path, "w") as fh:
        fh.write(src)
    lib = os.path.join(d, "libffn_bwd.so")
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def _load(build, name: str, job) -> ctypes.CDLL:
    proc, path = job
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{out[-3000:]}")
    kernel = ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        kernel = m.group(1) if m else kernel
        if "C75" in line or "Used" in line or "spill" in line:
            short = re.sub(r".*(ffn_bwd\w*kernel\w*).*", r"\1", kernel)
            print(f"[probe_ffn_bwd] {name} {short}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(path)
    for fn, sig in build._SIGNATURES["ffn_bwd"].items():
        f = getattr(lib, fn)
        f.argtypes = [build._CTYPES[k] for k in sig]
        f.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--stages", default="1,2,3")
    ap.add_argument("--plans", default="", help="forced plans R,C,HC,S;... (else the planner's)")
    ap.add_argument("--iters", type=int, default=20)
    opts = ap.parse_args(argv)
    from vss_cffm_tpu_torch.ops import _build as build
    from vss_cffm_tpu_torch.ops import ffn_bwd as fb
    from vss_cffm_tpu_torch.ops._dispatch import SMEM_LIMIT
    from vss_cffm_tpu_torch.tools.bench_ffn_train import _queued_us, stage_inputs

    if not torch.cuda.is_available():
        raise SystemExit("probe_ffn_bwd needs a CUDA device")
    jobs = {n: _start(build, n, VARIANTS[n]) for n in opts.variants}
    libs = {n: _load(build, n, job) for n, job in jobs.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    forced = [tuple(int(v) for v in p.split(",")) for p in opts.plans.split(";") if p.strip()]
    for stage in (int(s) for s in opts.stages.split(",")):
        d = stage_inputs(stage, False)
        x, ffn, go, s_ffn = d["x"], d["ffn"], d["go"], d["s_ffn"]
        b, h, w, c = x.shape
        ch = 4 * c
        plans = [fb.ffn_bwd_plan(b, h, w, c, ch, sms)]
        for r, cc, hc, sp in forced:
            nch = -(-ch // hc)
            per = -(-nch // sp)
            plans.append(fb.FfnBwdPlan(r, cc, hc, -(-nch // per), per, fb.ffn_bwd_smem(r, cc, c, hc)))
        for plan in plans:
            if plan.smem > SMEM_LIMIT or plan.rows * plan.cols > fb.max_pixels(c):
                continue
            us = {n: [] for n in libs}
            for order in (list(libs), list(libs)[::-1]):
                for n in order:
                    build._libs["ffn_bwd"] = libs[n]
                    us[n].append(_queued_us(lambda: fb.ffn_bwd_launch(
                        x, go, *ffn[:7], s_ffn, 1e-6, "probe", plan=plan), opts.iters))
            print(f"[probe_ffn_bwd] stage {stage} x{tuple(x.shape)} Ch={ch} plan (rows "
                  f"{plan.rows}, cols {plan.cols}, hc {plan.hc}, splits {plan.splits}): "
                  + "; ".join(f"{n} {u[0]:.1f} / {u[1]:.1f}" for n, u in us.items())
                  + " device us", flush=True)
    build._libs.pop("ffn_bwd", None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
