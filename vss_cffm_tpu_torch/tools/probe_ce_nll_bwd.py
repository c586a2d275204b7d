"""Where row 13's kernel spends its time, on the card: ``python -m
vss_cffm_tpu_torch.tools.probe_ce_nll_bwd [variant ...] [--plans TW,NSEG;...]
[--n 8,2]``.

Builds variants of ``csrc/ce_nll_bwd.cu`` with ``nvcc`` (all at once) into
directories of the (git-ignored) build directory: the source copied, a few
lines replaced, the package's own flags; loads each in place of the library
and times ``ops.ce_upsampled_nll_bwd`` at the "ohem" step's branches (N 8
and N 2 of logits (N, 120, 120, 124) bf16, ×4, ``bench_ce_bwd.make_inputs``)
with the planner's plan or each of ``--plans``: device µs a call, calls
queued behind a sleep between CUDA events, the variants timed in turn and
then in reverse order. A variant leaves one piece out, so that its time is
what the rest costs (its outputs are wrong by design):

- ``base``: the source as it is;
- ``no_onehot``: the label's class not subtracted;
- ``no_exp``: the exponent's argument in place of its ``ex2`` (no MUFU);
- ``no_pixel``: no pixel computed (what is left: the ring's copies, the
  staging and its list, the windows' register sums, the writes);
- ``lb4``: launch bounds of 4 blocks an SM (128 registers a thread);
- ``tw5_lb4``: strips of at most 5 columns (the row adjoint in 40
  registers, not 56) and launch bounds of 4 blocks an SM (run it with
  ``--plans 5,NSEG``: the planner's strips of 7 are refused);
- ``clocks``: the source with its ``clock64()`` phase counters compiled in
  (``VSS_NLL_CLOCKS``); besides its time, one call's cycles a warp by phase
  (row set-up, window loads, the pixels' classes, the unit's last rows) and
  a live pixel's cycles are printed.

It prints each variant's ptxas lines (registers, spills). The replacements
match the source's text: a change to those lines of ``ce_nll_bwd.cu`` needs
the same change here.
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
    "no_onehot": [("(rel == jj ? 1.f : 0.f)", "0.f")],
    "no_exp": [(" = ex2(", " = (")],
    "no_pixel": [("      if (kp < nlive && (meta >> 8) == u) {  // the same for every lane",
                  "      if (false) {")],
    "lb4": [("__launch_bounds__(32 * kWarps, 3)", "__launch_bounds__(32 * kWarps, 4)")],
    "tw5_lb4": [("__launch_bounds__(32 * kWarps, 3)", "__launch_bounds__(32 * kWarps, 4)"),
                ("return C <= 128 ? 7 : 3; }", "return C <= 128 ? 5 : 3; }"),
                ("  return launch<4, 7, L>(", "  return launch<4, 5, L>(")],
    "clocks": [('#include "common.cuh"', '#define VSS_NLL_CLOCKS\n#include "common.cuh"')],
}


def _start(build, name: str, subs):
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    d = tempfile.mkdtemp(prefix=f"probe_ce_nll_bwd_{name}_", dir=build.BUILD_DIR)
    for f in os.listdir(build.CSRC):
        shutil.copy(os.path.join(build.CSRC, f), d)
    path = os.path.join(d, "ce_nll_bwd.cu")
    with open(path) as fh:
        src = fh.read()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"variant {name}: the line to replace is gone: {old[:60]!r}")
        src = src.replace(old, new)
    with open(path, "w") as fh:
        fh.write(src)
    lib = os.path.join(d, "libce_nll_bwd.so")
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
        tw_of = re.search(r"ILi4ELi(\d)EhE", kernel)
        if tw_of and tw_of.group(1) in "57" and ("Used" in line or "spill" in line):
            print(f"[probe_ce_nll_bwd] {name} (CPL 4, TW {tw_of.group(1)}, uint8 labels): "
                  f"{line.strip()}", flush=True)
    lib = ctypes.CDLL(path)
    for fn, sig in build._SIGNATURES["ce_nll_bwd"].items():
        f = getattr(lib, fn)
        f.argtypes = [build._CTYPES[k] for k in sig]
        f.restype = ctypes.c_int
    if name == "clocks":
        lib.ce_nll_bwd_clocks.argtypes = [ctypes.c_void_p]
        lib.ce_nll_bwd_clocks.restype = ctypes.c_int
    return lib


def _clocks(lib, call, units: int) -> str:
    """One call's phase clocks, a warp's mean cycles."""
    buf = (ctypes.c_ulonglong * 6)()
    torch.cuda.synchronize()
    lib.ce_nll_bwd_clocks(buf)
    call()
    torch.cuda.synchronize()
    if lib.ce_nll_bwd_clocks(buf):
        raise RuntimeError("ce_nll_bwd_clocks failed")
    unit, setup, window, pixel, end, live = (buf[i] for i in range(6))
    return (f"a warp {unit / units:.0f} cycles: row set-up {setup / units:.0f}, window loads "
            f"{window / units:.0f}, pixels {pixel / units:.0f}, last rows {end / units:.0f}; "
            f"{live / units:.0f} live pixels a warp, {unit / max(live, 1):.1f} cycles each "
            f"({pixel / max(live, 1):.1f} in their classes, {window / max(live, 1):.1f} in "
            f"window loads)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--plans", default="", help="forced plans TW,NSEG;... (else the planner's)")
    ap.add_argument("--n", default="8,2", help="frames of the branches timed")
    ap.add_argument("--iters", type=int, default=20)
    opts = ap.parse_args(argv)
    from vss_cffm_tpu_torch import ops
    from vss_cffm_tpu_torch.ops import _build as build
    from vss_cffm_tpu_torch.ops import ce_upsampled as ce
    from vss_cffm_tpu_torch.tools.bench_ce_bwd import C, HW, S, make_inputs
    from vss_cffm_tpu_torch.tools.bench_ffn_train import _queued_us

    if not torch.cuda.is_available():
        raise SystemExit("probe_ce_nll_bwd needs a CUDA device")
    jobs = {n: _start(build, n, VARIANTS[n]) for n in opts.variants}
    libs = {n: _load(build, n, job) for n, job in jobs.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    forced = [tuple(int(v) for v in p.split(",")) for p in opts.plans.split(";") if p.strip()]
    planner, kept = ce.ce_nll_bwd_plan, build._libs.get("ce_nll_bwd")
    try:
        for n in (int(v) for v in opts.n.split(",")):
            inp = make_inputs(n)
            x, lab, g = inp["logits"], inp["labels"], inp["g_nll"]
            lse = ops.ce_upsampled_nll(x, lab, S, force="torch")[2].contiguous()
            for plan in [planner(n, *HW, C, S, sms)] + forced:
                ce.ce_nll_bwd_plan = lambda *a, plan=plan: plan
                us = {v: [] for v in libs}
                order = list(libs) + list(libs)[::-1]
                for v in order:
                    build._libs["ce_nll_bwd"] = libs[v]
                    try:
                        us[v].append(_queued_us(
                            lambda: ops.ce_upsampled_nll_bwd(x, lab, lse, g, S, force="kernel"),
                            opts.iters))
                    except RuntimeError:  # a variant that refuses the plan
                        us[v].append(float("nan"))
                smem = ce.ce_nll_bwd_smem(C, S, plan[0])
                for v, ts in us.items():
                    print(f"[probe_ce_nll_bwd] N={n} plan (tw {plan[0]}, nseg {plan[1]}, "
                          f"{smem} B smem) {v}: {sum(ts) / len(ts):.1f} device us "
                          f"({', '.join(f'{t:.1f}' for t in ts)})", flush=True)
                if "clocks" in libs and plan[0] <= 7:
                    build._libs["ce_nll_bwd"] = libs["clocks"]
                    units = n * plan[1] * -(-HW[1] // plan[0])
                    print(f"[probe_ce_nll_bwd] N={n} plan (tw {plan[0]}, nseg {plan[1]}) clocks: "
                          + _clocks(libs["clocks"], lambda: ops.ce_upsampled_nll_bwd(
                              x, lab, lse, g, S, force="kernel"), units), flush=True)
    finally:
        ce.ce_nll_bwd_plan = planner
        if kept is None:
            build._libs.pop("ce_nll_bwd", None)
        else:
            build._libs["ce_nll_bwd"] = kept
    return 0


if __name__ == "__main__":
    main()
