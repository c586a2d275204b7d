"""Where the key-tiled attention's time goes, on the card: ``python -m
vss_cffm_tpu_torch.tools.probe_tiled_attention [--counters] [variant ...]``.

Builds variants of ``csrc/attention.cu`` with ``nvcc`` into directories of
the (git-ignored) build directory (the source copied, a few lines replaced,
the package's own flags),
loads each in place of the attention library, and times the key-tiled
instance (``attention_launch(..., tiled=True)``, K scaled by the wrapper
included) at ``chip_smoke.py``'s ``TILED_CASES`` and at N 405 with CUDA
events, the variants in ABBA order (each variant's ``us`` twice), beside
its largest error against the plain attention. Variants:

- ``base``: the source as it is;
- ``no_exp_pass1`` / ``no_exp_pass2``: the statistics' exps (pass 1) or
  p's exp and division (pass 2) replaced by one f32 operation, to attribute
  the time (their outputs are wrong by design: the error is printed, not
  held);
- ``one_warpgroup``: blocks of 64 query rows (one consumer warpgroup), two
  blocks an SM;
- ``stages_3`` / ``stages_6``: a ring of 3 or 6 stages instead of 4.

``--counters`` adds, for the first variant named, clock64 and globaltimer
counters around the consumers' waits and passes, read back per block at N
1269 on stage 3 and N 920 on stage 2: cycles a consumer warp spends in all,
in pass 1, waiting for a tile (full barrier) and waiting for wgmma; block
durations, blocks per SM, the SMs' busy share of the kernel's span and the
gaps between blocks on an SM. The replacements match the source's text: a
change to those lines of ``attention.cu`` needs the same change here.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import re
import shutil
import subprocess
import tempfile

import numpy as np
import torch

__all__ = ["main"]

# (N, C, heads, query rows a frame) of chip_smoke.py's TILED_CASES, 4 frames,
# and stage 2 at 480x864 (where the resident instance also runs)
CASES = ((920, 128, 2, 92 * 160), (1269, 128, 2, 108 * 188), (1269, 320, 5, 54 * 94),
         (2048, 320, 5, 4 * 2048), (405, 128, 2, 60 * 108))

VARIANTS = {
    "base": [],
    "no_exp_pass1": [
        ("        vss::softmax_step(mx, sm, sg);\n",
         "        mx[0] = fmaxf(mx[0], fmaxf(sg[0][0], sg[0][1]));\n"
         "        mx[1] = fmaxf(mx[1], fmaxf(sg[1][2], sg[1][3]));\n"
         "        sm[0] += sg[1][0];\n        sm[1] += sg[0][2];\n")],
    "no_exp_pass2": [
        ("            sg[j][e] = vss::div_rn(expf(sg[j][e] - mx[e >> 1]), sm[e >> 1], "
         "inv[e >> 1]);",
         "            sg[j][e] = sg[j][e] * inv[e >> 1];")],
    "one_warpgroup": [
        ("constexpr int kConsumerWGs = 2;", "constexpr int kConsumerWGs = 1;"),
        ("constexpr int kProducerRegs = 24, kConsumerRegs = 240;\n"
         "constexpr int kTiledBlocksPerSM = 1;",
         "constexpr int kProducerRegs = 24, kConsumerRegs = 232;\n"
         "constexpr int kTiledBlocksPerSM = 2;")],
    "stages_3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "stages_6": [("constexpr int kStages = 4;", "constexpr int kStages = 6;")],
}

# the counters: 8 per consumer warp of every block (globaltimer at the
# consumers' start and end, SM id, cycles in all, waiting for tiles, waiting
# for wgmma in pass 1 and pass 2, pass 1), read by the export probe_read
COUNTERS = [
    ("namespace {\n\nconstexpr int kWarps = 4;",
     "__device__ unsigned long long probe_buf[1 << 17];\n"
     "__device__ __forceinline__ unsigned long long probe_ns() {\n"
     "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\nnamespace {\n\nconstexpr int kWarps = 4;"),
    ("  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\" ::\"n\"(kConsumerRegs));\n",
     "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\" ::\"n\"(kConsumerRegs));\n"
     "  long long cw = 0, cp1 = 0, cp2 = 0, c_p1 = 0;\n  const long long c0 = clock64();\n"
     "  const unsigned long long g0 = probe_ns();\n"),
    ("  auto wait_full = [&](int i) { vss::mbar_wait(&full[i % kStages], (i / kStages) & 1); };",
     "  auto wait_full = [&](int i) {\n    const long long c = clock64();\n"
     "    vss::mbar_wait(&full[i % kStages], (i / kStages) & 1);\n    cw += clock64() - c;\n  };"),
    ("    vss::wgmma_wait<0>();\n    vss::fence_regs(nxt);\n  };",
     "    const long long c = clock64();\n    vss::wgmma_wait<0>();\n    cp1 += clock64() - c;\n"
     "    vss::fence_regs(nxt);\n  };"),
    ("    vss::wgmma_wait<1>();\n    vss::fence_regs(nxt);",
     "    const long long c = clock64();\n    vss::wgmma_wait<1>();\n    cp2 += clock64() - c;\n"
     "    vss::fence_regs(nxt);"),
    ("  vss::softmax_rows(mx, sm);\n  inv[0] = vss::recip(sm[0]);",
     "  c_p1 = clock64();\n  vss::softmax_rows(mx, sm);\n  inv[0] = vss::recip(sm[0]);"),
    ("  // ---- out rows, one bf16 cast ---------------------------------------------\n"
     "  __nv_bfloat16* og = out + (long long)g * Lq * C + h * HD;",
     "  if (lane == 0) {\n    unsigned smid;\n    asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(smid));\n"
     "    const long long e = (blockIdx.x + gridDim.x * (blockIdx.y + (long long)gridDim.y *\n"
     "                         blockIdx.z)) * 8 + (tid >> 5);\n"
     "    if (e < (1 << 14)) {\n      unsigned long long* d = probe_buf + e * 8;\n"
     "      d[0] = g0; d[1] = probe_ns(); d[2] = smid; d[3] = clock64() - c0; d[4] = cw;\n"
     "      d[5] = cp1; d[6] = cp2; d[7] = c_p1 - c0;\n    }\n  }\n"
     "  // ---- out rows, one bf16 cast ---------------------------------------------\n"
     "  __nv_bfloat16* og = out + (long long)g * Lq * C + h * HD;"),
    ("// One tile's products through wgmma and through mma.sync (mma_check_kernel):",
     "VSS_EXPORT int probe_read(void* dst, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, probe_buf, (size_t)n * 8);\n}\n\n"
     "// One tile's products through wgmma and through mma.sync (mma_check_kernel):"),
]


def _build_variant(build, name: str, subs) -> ctypes.CDLL:
    """The attention library built from a copy of csrc/ with subs applied
    to attention.cu; prints the tiled instances' ptxas lines."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    d = tempfile.mkdtemp(prefix=f"probe_{name}_", dir=build.BUILD_DIR)
    for f in os.listdir(build.CSRC):
        shutil.copy(os.path.join(build.CSRC, f), d)
    path = os.path.join(d, "attention.cu")
    with open(path) as fh:
        src = fh.read()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"variant {name}: the line to replace is gone: {old[:60]!r}")
        src = src.replace(old, new)
    with open(path, "w") as fh:
        fh.write(src)
    lib_path = os.path.join(d, "libattention.so")
    run = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path, path],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{(run.stdout + run.stderr)[-3000:]}")
    kernel = ""
    for line in (run.stdout + run.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        kernel = m.group(1) if m else kernel
        if "C75" in line or ("Used" in line and "tiled" in kernel):
            print(f"[probe] {name}: {line.strip()[:150]}", flush=True)
    lib = ctypes.CDLL(lib_path)
    for fn, sig in build._SIGNATURES["attention"].items():
        f = getattr(lib, fn)
        f.argtypes = [build._CTYPES[k] for k in sig]
        f.restype = ctypes.c_int
    return lib


def _inputs(i: int, n: int, c: int, lq: int):
    g = torch.Generator(device="cuda").manual_seed(i)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
    return r(4, lq, c), r(4, n, c), r(4, n, c)


def _event_us(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def _counters(build, cfm, name: str, subs) -> None:
    lib = _build_variant(build, f"{name}+counters", list(subs) + COUNTERS)
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    build._libs["attention"] = lib
    for ci in (2, 0):
        n, c, nh, lq = CASES[ci]
        q, k, v = _inputs(ci, n, c, lq)
        ks = cfm.scale_in(torch.bfloat16, (c // nh) ** -0.5)
        for _ in range(3):
            cfm.attention_launch(q, k, v, None, None, nh, 1.0, ks, "probe", tiled=True)
        torch.cuda.synchronize()
        wgs = 1 if name == "one_warpgroup" else cfm.TILED_WGS
        blocks = -(-lq // (64 * wgs)) * nh * 4
        buf = np.zeros(blocks * 8 * 8, dtype=np.uint64)
        if lib.probe_read(buf.ctypes.data, buf.size) != 0:
            raise RuntimeError("probe_read failed")
        d = buf.reshape(blocks, 8, 8).astype(np.float64)[:, :4 * wgs]
        span = d[:, :, 1].max() - d[:, :, 0].min()
        start, end = d[:, :, 0].min(1), d[:, :, 1].max(1)
        sm = d[:, 0, 2].astype(int)
        busy = np.bincount(sm, weights=end - start)
        count = np.bincount(sm)
        gaps = []
        for s in np.unique(sm):
            order = np.argsort(start[sm == s])
            gaps += list(start[sm == s][order][1:] - end[sm == s][order][:-1])
        used = count > 0
        print(f"[probe] {name} N={n} C={c} rows={lq}: {blocks} blocks over {used.sum()} SMs "
              f"({count[used].min()}-{count.max()} each), span {span / 1e3:.1f} us, SM busy "
              f"share {(busy[used] / span).mean():.3f}; per block {(end - start).mean() / 1e3:.2f} "
              f"us, gap between blocks on an SM {np.mean(gaps) / 1e3:.2f} us; cycles a consumer "
              f"warp: all {d[:, :, 3].mean():.0f}, pass 1 {d[:, :, 7].mean():.0f}, pass 2 "
              f"{(d[:, :, 3] - d[:, :, 7]).mean():.0f}, waiting for tiles {d[:, :, 4].mean():.0f}, "
              f"for wgmma {d[:, :, 5].mean() + d[:, :, 6].mean():.0f}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=["base"], choices=sorted(VARIANTS))
    ap.add_argument("--counters", action="store_true")
    opts = ap.parse_args(argv)
    build = importlib.import_module("vss_cffm_tpu_torch.ops._build")
    cfm = importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention")
    print(f"[probe] {torch.cuda.get_device_name(0)}", flush=True)
    libs = {name: _build_variant(build, name, VARIANTS[name]) for name in opts.variants}
    inputs = [_inputs(i, n, c, lq) for i, (n, c, _, lq) in enumerate(CASES)]
    us = {name: [[] for _ in CASES] for name in libs}
    outs = {}
    with torch.no_grad():
        for name in list(libs) + list(libs)[::-1]:
            build._libs["attention"] = libs[name]
            for ci, ((q, k, v), (_, c, nh, _)) in enumerate(zip(inputs, CASES)):
                ks = cfm.scale_in(torch.bfloat16, (c // nh) ** -0.5)
                fn = lambda: cfm.attention_launch(q, k, v, None, None, nh, 1.0, ks, "probe",
                                                  tiled=True)
                outs[name, ci] = fn()
                us[name][ci].append(_event_us(fn))
        for ci, ((q, k, v), (n, c, nh, lq)) in enumerate(zip(inputs, CASES)):
            plain = cfm.attention_torch(q, k, v, None, None, nh, 1.0,
                                        cfm.scale_in(torch.bfloat16, (c // nh) ** -0.5)).float()
            for name in libs:
                err = (outs[name, ci].float() - plain).abs().max().item() / plain.abs().max().item()
                print(f"[probe] {name} N={n} C={c} rows={lq} nh={nh}: us "
                      f"{' '.join(f'{t:.1f}' for t in us[name][ci])}, error {err:.2e} of the "
                      f"largest output", flush=True)
        if opts.counters:
            _counters(build, cfm, opts.variants[0], VARIANTS[opts.variants[0]])
    build._libs.pop("attention", None)


if __name__ == "__main__":
    main()
