"""3×3 depthwise conv + bias (+ exact GELU), NHWC.

``dwconv3x3(x, kernel, bias, gelu, force=None)`` with x (B, H, W, C) and
kernel (3, 3, 1, C) in the JAX package's layout. Its CUDA kernel
(``csrc/dwconv.cu``) replaces the TPU kernel
``vss_cffm_tpu/ops/dwconv.py:_dwconv3x3_pallas``; ``dwconv3x3_torch`` is the
plain version with the same arithmetic: taps accumulated in f32, f32 bias,
exact erf GELU, one cast to x's dtype.

The op is differentiable: a ``torch.autograd.Function`` whose forward is the
kernel (which then also writes the pre-activation z in x's dtype, the
residual ``vss_cffm_tpu/ops/dwconv.py:_shifts_cvjp_fwd`` keeps) and whose
backward is ``dwconv3x3_bwd_torch``, plain PyTorch with ``_shifts_cvjp_bwd``'s
math: gz = g·GELU′(z) in f32, rounded once to x's dtype; dx the correlation
of gz with the flipped taps; dk and dbias f32 reductions. The JAX backward
is XLA, not a TPU kernel; a CUDA backward is open work.

The host path of a call is kept short, as at the stage-4 maps the kernel
takes as long as the host's work around it: with nothing for autograd to
record the op launches without the Function, as the custom op
``vss_cffm::dwconv3x3`` (one node of an exported graph); the model's taps
(``DWConv.kernel``, made once per parameter value) and bias are already
f32 and contiguous and pass without a copy; the strip plan and the SM
count are cached per shape; the C entry point is looked up once and sets
the device only when it is not current.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from . import _build
from ._dispatch import custom_op, ptr, records_grad, require, stream_of, use_kernel

__all__ = ["dwconv3x3", "dwconv3x3_torch", "dwconv3x3_bwd_torch", "dwconv3x3_launch"]


def _preact(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """f32 taps + bias."""
    b, h, w, c = x.shape
    k = kernel.reshape(3, 3, c).float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = None
    for di in range(3):
        for dj in range(3):
            term = xp[:, di:di + h, dj:dj + w, :] * k[di, dj]
            acc = term if acc is None else acc + term
    return acc + bias.float()


def dwconv3x3_torch(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                    gelu: bool = False) -> torch.Tensor:
    acc = _preact(x, kernel, bias)
    return (F.gelu(acc) if gelu else acc).to(x.dtype)


def _gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz of the exact-erf GELU: Φ(z) + z·φ(z)."""
    phi = torch.exp(-0.5 * z * z) * 0.3989422804014327
    return 0.5 * (1.0 + torch.erf(z * 0.7071067811865476)) + z * phi


def dwconv3x3_bwd_torch(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                        z: torch.Tensor | None, g: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dkernel, dbias) for the cotangent g; z is the saved pre-activation
    (None without GELU)."""
    b, h, w, c = x.shape
    k = kernel.reshape(3, 3, c).float()
    gz_f = g.float()
    if z is not None:
        gz_f = gz_f * _gelu_grad(z.float())
    gp = F.pad(gz_f.to(x.dtype), (0, 0, 1, 1, 1, 1)).float()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    dx = None
    taps = []
    for di in range(3):
        for dj in range(3):
            term = gp[:, 2 - di:2 - di + h, 2 - dj:2 - dj + w, :] * k[di, dj]
            dx = term if dx is None else dx + term
            taps.append((xp[:, di:di + h, dj:dj + w, :] * gz_f).sum(dim=(0, 1, 2)))
    dk = torch.stack(taps).reshape(kernel.shape).to(kernel.dtype)
    return dx.to(x.dtype), dk, gz_f.sum(dim=(0, 1, 2)).to(bias.dtype)


# threads a kernel block (csrc/dwconv.cu kThreads), and the blocks one SM
# holds at its 168 registers a thread
_THREADS = 128
_BLOCKS_PER_SM = 3


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def strip_plan(b: int, h: int, w: int, c: int, sms: int) -> tuple[int, int]:
    """(rows, strips) of the kernel's row strips: a thread walks ``rows``
    output rows of one column and 8 channels; ``strips`` = ceil(h / rows)
    strips cover the map, the last one short when rows does not divide h.
    Of the strip counts, the one with the least waves of resident blocks
    (``_BLOCKS_PER_SM`` on each of ``sms`` SMs) times a thread's rows plus
    its two halo rows and a fixed cost of about four rows, as a second,
    part-filled wave costs more than longer strips save
    (``python -m vss_cffm_tpu_torch.tools.bench_dwconv`` times every strip
    length at the B1 path's shapes beside the plan's)."""
    blocks_per_strip = -(-b * w * (c // 8) // _THREADS)
    slots = _BLOCKS_PER_SM * sms
    best = None
    for strips in range(1, h + 1):
        rows = -(-h // strips)
        if best is not None and rows == best[1]:
            continue
        waves = -(-blocks_per_strip * -(-h // rows) // slots)
        cost = waves * (rows + 2 + 4)
        if best is None or cost < best[0]:
            best = (cost, rows)
    rows = best[1]
    return rows, -(-h // rows)


def _f32_on(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """t as a contiguous f32 tensor on dev, without a copy when it is one
    (the model's taps and bias are: ``models/mit.py:DWConv.kernel``)."""
    if t.dtype == torch.float32 and t.device == dev and t.is_contiguous():
        return t
    return t.to(device=dev, dtype=torch.float32).contiguous()


_entry = {}


def _c_entry():
    """The C entry point, looked up once. ``chip_smoke.py`` puts its no-launch
    twin ``dwconv3x3_nhwc_nolaunch`` in its place to time the host path."""
    fn = _entry.get("dwconv3x3_nhwc")
    if fn is None:
        fn = _entry["dwconv3x3_nhwc"] = _build.library("dwconv").dwconv3x3_nhwc
    return fn


def dwconv3x3_launch(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                     gelu: bool, op: str = "dwconv3x3", z: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Launch the CUDA kernel: x bf16 or f32 (B, H, W, C) → bf16; also writes
    the pre-activation into z (bf16, x's shape) when given. No count."""
    require(x.is_cuda and x.dim() == 4 and x.dtype in (torch.bfloat16, torch.float32), op,
            lambda: f"x {x.dtype} {tuple(x.shape)} on {x.device} (bf16 or f32 NHWC on CUDA)")
    b, h, w, c = x.shape
    require(c % 8 == 0 and kernel.shape == (3, 3, 1, c) and bias.shape == (c,), op,
            lambda: f"C={c} (a multiple of 8), kernel {tuple(kernel.shape)}, "
                    f"bias {tuple(bias.shape)}")
    dev = x.device
    wk, bb = _f32_on(kernel, dev), _f32_on(bias, dev)
    if z is not None:
        require(z.dtype == torch.bfloat16 and z.shape == x.shape, op,
                lambda: f"z {z.dtype} {tuple(z.shape)}")
    out = torch.empty(x.shape, device=dev, dtype=torch.bfloat16)
    devi, stream = stream_of(x)
    rows, _ = strip_plan(b, h, w, c, _sm_count(devi))
    rc = _c_entry()(
        ptr(x, op), ptr(wk, op), ptr(bb, op), ptr(out, op), ptr(z, op), b, h, w, c, rows,
        int(x.dtype == torch.float32), int(gelu), devi, stream)
    _build.check(rc, op)
    return out


class _DWConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, gelu, kernel_path):
        keep_z = gelu and any(ctx.needs_input_grad[:3])
        if kernel_path:
            z = torch.empty(x.shape, device=x.device, dtype=torch.bfloat16) if keep_z else None
            out = dwconv3x3_launch(x.contiguous(), kernel, bias, gelu, z=z)
            dwconv3x3.launches += 1
        else:
            acc = _preact(x, kernel, bias)
            z = acc.to(x.dtype) if keep_z else None
            out = (F.gelu(acc) if gelu else acc).to(x.dtype)
        ctx.save_for_backward(x, kernel, bias, z)
        return out

    @staticmethod
    def backward(ctx, g):
        x, kernel, bias, z = ctx.saved_tensors
        dx, dk, db = dwconv3x3_bwd_torch(x, kernel, bias, z, g)
        return dx, dk, db, None, None


def _kernel_path(x: torch.Tensor, force: str | None) -> bool:
    kernel_path = use_kernel(force, x, "dwconv3x3")
    if kernel_path:
        require(x.dtype == torch.bfloat16, "dwconv3x3", lambda: f"x of dtype {x.dtype} (bf16 only)")
    return kernel_path


@custom_op("dwconv3x3")
def _dwconv3x3_op(x: Tensor, kernel: Tensor, bias: Tensor, gelu: bool,
                  force: Optional[str]) -> Tensor:
    """The forward with nothing for autograd to record: the launch alone."""
    if not _kernel_path(x, force):
        return dwconv3x3_torch(x, kernel, bias, gelu)
    out = dwconv3x3_launch(x.contiguous(), kernel, bias, gelu)
    dwconv3x3.launches += 1
    return out


def dwconv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
              gelu: bool = False, force: str | None = None) -> torch.Tensor:
    """force: None (kernel on CUDA, plain on CPU) | 'torch' | 'kernel'. While
    autograd records, a ``torch.autograd.Function``; else the custom op
    ``vss_cffm::dwconv3x3``, which ``torch.export`` keeps as one node."""
    if records_grad((x, kernel, bias)):
        return _DWConv3x3.apply(x, kernel, bias, gelu, _kernel_path(x, force))
    return _dwconv3x3_op(x, kernel, bias, gelu, force)


dwconv3x3.launches = 0
