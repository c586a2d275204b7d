"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Nothing is
built at import: a library is built the first time a wrapper needs it
(``library(name)``), or all at once, in parallel, by ``build_all()``.

The library file is named by a hash of the sources it depends on (the ``.cu``
file, every shared ``.cuh`` header and the compiler flags), so a changed
source rebuilds and an unchanged one is loaded as it is. The build directory
``vss_cffm_tpu_torch/_build/`` is listed in ``.gitignore``; a library is
written to a temporary name and renamed into place, so two processes
building at once cannot load a half-written file.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check(rc, what)`` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

__all__ = ["library", "build_all", "check", "ptxas_usage", "SOURCES", "BUILD_DIR"]

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
SOURCES = ("dwconv", "attention", "block_gemm", "attention_bwd", "ce_upsampled", "gemm_tn",
           "block_bwd", "sra_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# argument kinds of each C entry point: "p" pointer / stream, "i" int, "l" 64-bit
# int, "f" float
_SIGNATURES = {
    "dwconv": {
        "dwconv3x3_nhwc": "pppppiiiiiiiip",
        "dwconv3x3_nhwc_nolaunch": "pppppiiiiiiiip",
    },
    "attention": {
        "attention_fwd": "pppppppiiiiiiiffip",
        "attention_fwd_smem_bytes": "iii",
        "attention_fwd_tiled": "ppppppiiiiiiffip",
        "attention_fwd_tiled_smem_bytes": "i",
        "attention_fwd_blocks_per_sm": "iiiii",
        "attention_div_check": "ppppiip",
    },
    "block_gemm": {
        "gemm_ln_bias_res": "pppppppppiiiiiiiifiiiip",
        "gemm_smem_bytes": "iii",
    },
    "attention_bwd": {
        "attention_bwd": "ppppppppppiiiiiifiip",
        "attention_bwd_probs": "ppppipppppiiiiiifiip",
        "attention_bwd_smem_bytes": "ii",
        "attention_bwd_blocks_per_sm": "iiii",
    },
    "ce_upsampled": {
        "ce_fwd_loss": "pppiiiiiifiiip",
        "ce_fwd_loss_phase": "pppiiiiiifiiip",
        "ce_bwd_loss": "pppppiiiiiifiiiip",
        "ce_bwd_loss_phase": "pppppiiiiiiifiiiip",
        "ce_bwd_blocks_per_sm": "iiii",
        "ce_fwd_nll": "pppppiiiiiiiip",
        "ce_fwd_smem_bytes": "iiii",
        "ce_fwd_blocks_per_sm": "iiii",
        "ce_fwd_phase_blocks_per_sm": "iii",
        "ce_bwd_nll": "ppppppiiiiiiiiiip",
    },
    "gemm_tn": {
        "gemm_tn": "ppppiiiiiip",
    },
    "block_bwd": {
        "dz_dhid": "ppppppiiiiiip",
        "ln_bwd": "pppppppppppiiiiiiifip",
    },
    "sra_attention_bwd": {
        "sra_attention_bwd": "pppppppiiiiiifiip",
        "sra_attention_bwd_smem_bytes": "ii",
        "sra_attention_bwd_blocks_per_sm": "iii",
    },
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong, "f": ctypes.c_float}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    deps = [f"{name}.cu"] + sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in deps:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode())
            h.update(fh.read())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}_{_digest(name)}.so")


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp, dst) or None if built."""
    dst = _lib_path(name)
    if os.path.exists(dst):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{dst}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, dst


def _finish_build(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, dst = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{out}")
    with open(f"{dst}.log", "w") as fh:  # ptxas -v: registers, spills per kernel
        fh.write(out)
    os.replace(tmp, dst)


def build_all(names=SOURCES) -> None:
    """Compile every listed source that is not built yet, all nvcc at once."""
    with _lock:
        jobs = {n: _start_build(n) for n in names}
        try:
            for n, job in jobs.items():
                _finish_build(n, job)
        finally:
            for job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(_lib_path(name))
            for fn, sig in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = [_CTYPES[k] for k in sig]
                f.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def ptxas_usage(name: str) -> list[dict]:
    """Per kernel of ``csrc/<name>.cu`` as ``ptxas -v`` reported it when the
    library was built: {"kernel" (mangled), "registers", "stack",
    "spill_stores", "spill_loads", "smem" (static bytes)}; [] when the
    library was built without its log."""
    path = f"{_lib_path(name)}.log"
    if not os.path.exists(path):
        return []
    out, cur = [], None
    with open(path) as fh:
        for line in fh:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = {"kernel": m.group(1), "registers": 0, "stack": 0, "spill_stores": 0,
                       "spill_loads": 0, "smem": 0}
                out.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc} launching {what}")
