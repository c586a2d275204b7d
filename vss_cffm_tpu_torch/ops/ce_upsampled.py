"""Cross-entropy on ×s bilinear-upsampled logits: fully reduced, or per pixel.

``ce_upsampled_loss(logits, labels, s, img_w, count_acc=True, force=None)``
with logits (N, h, w, C) and labels (N, h·s, w·s) in natural layout
(uint8 or int32 on the kernel path) returns ``(wsum, corr)``:

- ``wsum = img_w · Σ_valid (lse(up) − up[label])`` over the pixels of the
  ``align_corners=False`` bilinear upsample ``up`` of the logits;
- ``corr`` = the count of valid pixels whose label's logit equals the
  pixel's largest logit (the kernel's tie rule, not a first-max argmax);
  0 when ``count_acc`` is False.

A label is valid when ``0 ≤ label < C``. The op is differentiable with
respect to ``logits`` only; ``corr`` carries no gradient.

Its CUDA kernels (``csrc/ce_upsampled.cu``) replace the TPU kernels
``vss_cffm_tpu/ops/ce_upsampled.py:_ce_fwd_loss_pallas`` (``_fwd_loss_kernel``)
and ``_ce_bwd_loss_pallas5`` (``_bwd_loss_kernel5``): neither writes anything
the size of the upsampled map. The JAX package feeds them labels in phase
layouts, which answered TPU tiling questions; the port takes natural labels.
The forward (and the per-pixel one below) runs on a plan of strips of source
columns and bands of output rows (``ce_fwd_plan``, its units
``ce_fwd_units``): each output pixel's softmax is computed exactly once.
The backward (and the per-pixel one below) runs on a plan of strips of
source columns and segments of source rows (``ce_bwd_plan``, its units
``ce_bwd_units``, the exps they execute ``ce_bwd_exps``): each output
pixel's softmax is computed once for its strip, and the two source rows at
each segment boundary meet as f32 partials added in a fixed order.

``ce_upsampled_loss_torch`` / ``ce_upsampled_loss_bwd_torch`` are the plain
versions: an f32 ``F.interpolate``, ``logsumexp − picked``; the backward
applies the adjoint of that upsample to ``img_w·g·(softmax − onehot)`` on
the valid pixels.

``ce_upsampled_nll(logits, labels, s, force=None)`` returns the per-pixel
maps ``(nll, pred, lse)``, each (N, h·s, w·s) in natural
layout: ``nll = lse(up) − up[safe]`` (f32), ``pred`` the first maximum in
torch's tie order (int32) and ``lse`` (f32), where ``safe`` is the label, or
class 0 for a label outside [0, C): the caller masks those pixels and gives
them a zero cotangent. It is the OHEM and class-weight route of the clip
loss, whose per-pixel weights the caller applies. Differentiable with
respect to ``logits``: the backward ``ce_upsampled_nll_bwd(logits, labels,
lse, g_nll, s)`` applies the adjoint of the upsample to ``g_nll·(exp(up −
lse) − onehot(safe))`` with the forward's lse. Its CUDA kernels replace the
TPU kernels ``_ce_fwd_pallas`` (``_fwd_kernel``), which writes the same three
maps in a phase layout, and ``_ce_bwd_pallas`` (``_bwd_kernel``);
``ce_upsampled_nll_torch`` / ``ce_upsampled_nll_bwd_torch`` are the plain
versions.

The CE microbench's variants (``tools/bench_ce.py``) take the labels in the
TPU kernels' phase layouts, h-major (N, h, s², w) (``labels_to_phase``) or
w-major (N, h, w, s²) (``labels_to_phase_w``), and are not differentiable:

- ``ce_bwd_loss_v2(logits, labels_ph, ct, s, img_w)``: f32 dlogits (N, h, w,
  C) for the 0-d cotangent ``ct`` of wsum, h-major labels, the phases unrolled
  (``_ce_bwd_loss_pallas``, ``_bwd_loss_kernel``);
- ``ce_fwd_loss_v5(logits, labels_phw, s, img_w, count_acc)``: (wsum, corr),
  w-major labels, the phases unrolled (``_ce_fwd_loss_pallas5``,
  ``_fwd_loss_kernel5``);
- ``ce_fwd_loss_v3`` / ``ce_bwd_loss_v3``: the forward and the f32 backward
  with w-major labels and the phases as a runtime loop
  (``_ce_fwd_loss_pallas3`` / ``_ce_bwd_loss_pallas3``, ``_fwd_loss_kernel3``
  / ``_bwd_loss_kernel3``).

The two backwards run on the loss backward's kernel (``ce_bwd_loss_phase`` in
``csrc/ce_upsampled.cu``) and its plan: only where a pixel's label lies
(``ce_label_index``) and the output's dtype differ from
``ce_upsampled_loss_bwd``. The two forwards run on the loss forward's kernel
(``ce_fwd_loss_phase``) and its plan (``ce_fwd_plan``): only where a pixel's
label lies differs from ``ce_upsampled_loss``. The runtime loops
(``ce_fwd_loss_v3``, ``ce_bwd_loss_v3``) take the phase coefficients in f32
from the phase index as the TPU's runtime loop does (``ce_bwd_coeffs``; equal
to the double rule at s 1, 2, 4 and 8). The kernels read uint8 labels
(the bench's and the train batch's); labels of any other integer dtype are
first mapped by ``phase_labels_u8`` (outside [0, C) → 255, ignored as
before), as the JAX kernels take any integer labels; the unrolled ones take s
in {2, 4}, the runtime loops 1 ≤ s ≤ 8. Their plain versions are the loss
pair's, applied after the labels are put back in natural layout
(``phase_to_natural``), the backward's result kept in f32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build
from ._dispatch import SMEM_LIMIT, ptr, require, sm_count, stream_of, use_kernel

__all__ = ["ce_upsampled_loss", "ce_upsampled_loss_bwd", "ce_upsampled_loss_torch",
           "ce_upsampled_loss_bwd_torch", "ce_upsampled_nll", "ce_upsampled_nll_bwd",
           "ce_upsampled_nll_torch", "ce_upsampled_nll_bwd_torch", "valid_safe",
           "labels_to_phase", "labels_to_phase_w", "phase_to_natural", "ce_bwd_loss_v2",
           "ce_fwd_loss_v5", "ce_fwd_loss_v3", "ce_bwd_loss_v3", "phase_labels_u8",
           "ce_bwd_groups", "ce_bwd_plan", "ce_bwd_units", "ce_bwd_exps", "ce_bwd_coeffs",
           "ce_label_index", "ce_fwd_plan", "ce_fwd_units", "ce_fwd_smem"]

# classes one warp lane holds: a warp covers up to 32·CPL classes
_MAX_CLASSES = 256
# the kernels' largest upsampling factor
_MAX_SCALE = 8


def _check_shapes(logits: torch.Tensor, labels: torch.Tensor, s: int, op: str) -> None:
    if logits.dim() != 4 or labels.dim() != 3:
        raise ValueError(f"{op}: logits (N, h, w, C) and labels (N, H, W), got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    n, h, w, _ = logits.shape
    if tuple(labels.shape) != (n, h * s, w * s):
        raise ValueError(f"{op}: labels {tuple(labels.shape)} are not logits "
                         f"{tuple(logits.shape)} upsampled ×{s}")


def _upsample(x: torch.Tensor, s: int) -> torch.Tensor:
    """(N, h, w, C) → f32 (N, C, h·s, w·s)."""
    n, h, w, _ = x.shape
    return F.interpolate(x.float().permute(0, 3, 1, 2), size=(h * s, w * s),
                         mode="bilinear", align_corners=False)


def valid_safe(labels: torch.Tensor, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The port's label rule: (valid = 0 ≤ label < C, the label or class 0)."""
    lbl = labels.long()
    valid = (lbl >= 0) & (lbl < c)
    return valid, torch.where(valid, lbl, 0)


def ce_upsampled_loss_torch(logits: torch.Tensor, labels: torch.Tensor, s: int,
                            img_w: float, count_acc: bool = True
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    _check_shapes(logits, labels, s, "ce_upsampled_loss")
    c = logits.shape[-1]
    up = _upsample(logits, s)
    valid, safe = valid_safe(labels, c)
    lse = torch.logsumexp(up, dim=1)
    picked = up.gather(1, safe[:, None])[:, 0]
    # the per-pixel terms summed in f64 over one contiguous run: an f32 sum
    # moves by ulps with the order the reduction takes, an f64 sum rounded
    # once to f32 does not, so equal labels give one answer
    terms = torch.where(valid, lse - picked, 0.0).contiguous()
    wsum = (terms.double().sum() * img_w).float()
    if count_acc:
        corr = (valid & (picked == up.amax(dim=1))).sum().float()
    else:
        corr = torch.zeros((), device=logits.device)
    return wsum, corr


def ce_upsampled_loss_bwd_torch(logits: torch.Tensor, labels: torch.Tensor,
                                g: torch.Tensor, s: int, img_w: float) -> torch.Tensor:
    """dlogits (logits' dtype) for the cotangent g of ``wsum``."""
    return _loss_bwd_f32(logits, labels, g, s, img_w).to(logits.dtype)


def _loss_bwd_f32(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor, s: int,
                  img_w: float) -> torch.Tensor:
    _check_shapes(logits, labels, s, "ce_upsampled_loss_bwd")
    c = logits.shape[-1]
    x = logits.detach().float().requires_grad_(True)
    with torch.enable_grad():
        up = _upsample(x, s)
    with torch.no_grad():
        valid, safe = valid_safe(labels, c)
        t = torch.softmax(up.detach(), dim=1)
        t.scatter_add_(1, safe[:, None], -torch.ones_like(t[:, :1]))
        t = t * torch.where(valid, g.float() * img_w, 0.0)[:, None]
    (dx,) = torch.autograd.grad(up, x, t)
    return dx


# ---- the backward's plan (csrc/ce_upsampled.cu ce_bwd_kernel) ---------------
#
# A unit (one warp) is a frame, a segment [k_lo, k_hi) of source rows and a
# strip [v0, v1) of source columns: it computes the output rows of its
# segment (each output row once) at the output columns that reach its strip,
# [s·v0 − s//2, s·v1 + s//2), its 32 / G lane groups walking runs of L
# columns of one row in lockstep; it writes its own rows of dlogits, and the
# two rows at each segment boundary as f32 partials that the combine pass
# adds, upper segment first.

# units (warps) a block; blocks of the kernel an SM holds at most (its
# launch bounds: 168 registers; a cap of 128 for 4 blocks spills and
# measured 24 % slower)
CE_BWD_WARPS = 4
_CE_BWD_BLOCKS_PER_SM = 3
# strip widths tried, widest first: tw + 1 spans of s output columns divide
# evenly among 2, 4 or 8 lane groups
_CE_BWD_STRIPS = (15, 7, 3)


def ce_bwd_groups(c: int) -> tuple[int, int]:
    """(lanes a pixel G, classes a lane) of the backward at c classes
    (``launch_bwd``'s table): 8 lanes of 16 classes at C 124."""
    for g, cpl in ((4, 8), (8, 8), (8, 16), (16, 16)):
        if c <= g * cpl:
            return g, cpl
    raise ValueError(f"{c} classes (at most {_MAX_CLASSES})")


def _run_spans(span_count: int, ng: int) -> int:
    """Column spans of s in one lane group's run (at least 2, so that two
    groups' windows of two source columns never meet)."""
    return max(2, -(-span_count // ng))


@functools.lru_cache(maxsize=None)
def ce_bwd_plan(n: int, h: int, w: int, c: int, s: int, sms: int) -> tuple[int, int, int]:
    """(tw, nseg, cs) of the backward: strips of tw source columns (the
    widest whose blocks still fit 3 an SM: narrower strips raise the
    recompute at their edges), nseg segments of at least 2
    source rows a frame (the count that takes the least time in waves of
    blocks, a unit costing its rows plus one), and cs, the column stride of
    the f32 shared-memory rows: the classes' padded width plus a pad that
    puts the lane groups' simultaneous flushes in distinct banks."""
    g, cpl = ce_bwd_groups(c)
    ng = 32 // g
    for tw in _CE_BWD_STRIPS:
        run = _run_spans(tw + 1, ng)
        cs = g * cpl + (g // run if g % run == 0 else 1)
        smem = CE_BWD_WARPS * 2 * tw * cs * 4
        if _CE_BWD_BLOCKS_PER_SM * (smem + 1024) <= SMEM_LIMIT:
            break
    per_sm = max(1, min(_CE_BWD_BLOCKS_PER_SM, SMEM_LIMIT // (smem + 1024)))
    nstrip = -(-w // tw)
    best = None
    for nseg in range(1, max(1, h // 2) + 1):
        blocks = -(-n * nstrip * nseg // CE_BWD_WARPS)
        cost = -(-blocks // (sms * per_sm)) * (-(-h // nseg) + 1)
        if best is None or cost < best[0]:
            best = (cost, nseg)
    return tw, best[1], cs


def ce_bwd_units(n: int, h: int, w: int, c: int, s: int, plan: tuple) -> list:
    """Each unit of the backward in the kernel's order, as it derives them
    from its warp index: (frame, k_lo, k_hi, v0, v1, xa, xb, run), computing
    output rows [s·k_lo, s·k_hi) at output columns [xa, xb), each lane group
    a run of ``run`` columns (the last groups' runs may pass xb: idle)."""
    tw, nseg, _ = plan
    ng = 32 // ce_bwd_groups(c)[0]
    nstrip = -(-w // tw)
    units = []
    for u in range(n * nseg * nstrip):
        strip, seg, f = u % nstrip, u // nstrip % nseg, u // nstrip // nseg
        v0, v1 = strip * tw, min(strip * tw + tw, w)
        xa, xb = max(0, s * v0 - s // 2), min(w * s, s * v1 + s // 2)
        units.append((f, seg * h // nseg, (seg + 1) * h // nseg, v0, v1, xa, xb,
                      s * _run_spans(-(-(xb - xa) // s), ng)))
    return units


def ce_bwd_exps(live: torch.Tensor, c: int, s: int, plan: tuple, pixel: bool) -> int:
    """The exps the backward executes for its inputs, labels or g of shape
    (N, H, W) → live (N, H, W) bool: with ``pixel`` (row 13) C at each live
    pixel (g ≠ 0) of each unit that computes it; else (row 17) C at every
    column of every lane group's run, idle and ignored pixels included (the
    softmax's shuffles run in lockstep)."""
    n, hh, ww = live.shape
    h, w = hh // s, ww // s
    units = ce_bwd_units(n, h, w, c, s, plan)
    if not pixel:
        return c * sum(s * (k1 - k0) * (32 // ce_bwd_groups(c)[0]) * run
                       for _, k0, k1, _, _, _, _, run in units)
    mult = torch.zeros(ww, dtype=torch.long)
    for f, k0, _, _, _, xa, xb, _ in units:
        if f == 0 and k0 == 0:            # one row of strips: every strip once
            mult[xa:xb] += 1
    return c * int((live.cpu().long().sum(dim=(0, 1)) * mult).sum())


def ce_bwd_coeffs(s: int, loop: bool = False) -> list[tuple[int, float]]:
    """(delta, f) of each output phase p < s as the backward's shared-memory
    fill takes them (output row s·k + p lerps source rows k + delta and
    k + delta + 1 with weights 1 − f, f): d = (p + 0.5)/s − 0.5 in double,
    f rounded once to f32 (rows 13, 15, 17), or with ``loop`` every step in
    f32 from the phase index, as the TPU's runtime phase loop computes them
    (row 19; ``_phase_coeff_dyn``). The two agree at s 1, 2, 4 and 8."""
    out = []
    for p in range(s):
        if loop:
            d = (torch.tensor(float(p), dtype=torch.float32) + 0.5) / s - 0.5
            delta = -1 if d < 0 else 0
            out.append((delta, float(d - delta)))
        else:
            d = (p + 0.5) / s - 0.5
            delta = -1 if d < 0 else 0
            out.append((delta, float(torch.tensor(d - delta, dtype=torch.float32))))
    return out


def ce_label_index(layout: str, n: int, h: int, w: int, s: int) -> torch.Tensor:
    """int64 (N, h·s, w·s): where the backward reads the label of each output
    pixel (Y = s·k + ph, X = s·v + pw) in flat labels of ``layout``, as its
    row base plus column offset: "natural" (N, H, W) (n·H + Y)·W + X;
    "h-major" (N, h, s², w) ((n·h + k)·s² + ph·s)·w + pw·w + v; "w-major"
    (N, h, w, s²) (n·h + k)·w·s² + ph·s + v·s² + pw."""
    f = torch.arange(n)[:, None, None]
    y = torch.arange(h * s)[None, :, None]
    x = torch.arange(w * s)[None, None, :]
    k, ph, v, pw = y // s, y % s, x // s, x % s
    if layout == "natural":
        return (f * h * s + y) * (w * s) + x
    if layout == "h-major":
        return ((f * h + k) * s * s + ph * s) * w + (pw * w + v)
    if layout == "w-major":
        return (f * h + k) * w * s * s + ph * s + (v * s * s + pw)
    raise ValueError(f"label layout {layout!r} (natural, h-major or w-major)")


# ---- the forward's plan (csrc/ce_upsampled.cu ce_fwd_kernel) ----------------
#
# A unit (one warp) is a frame, a band of 32 / G consecutive output rows (one
# a lane group) and a strip [v0, v1) of source columns: it computes its rows'
# pixels at the output columns [s·v0, s·v1), each output pixel in exactly one
# unit. No halo: the forward has no adjoint to gather, so the recompute
# factor is 1.

# units (warps) a block; blocks an SM holds at most (its launch bounds: 128
# registers)
CE_FWD_WARPS = 4
_CE_FWD_BLOCKS_PER_SM = 4
# strip widths tried, widest first (the kernel takes 1..15)
_CE_FWD_STRIPS = (15, 12, 10, 8, 6, 5, 4, 3, 2, 1)
# the dynamic shared memory a block of the kernel may take
_CE_FWD_SMEM = 200 * 1024


def ce_fwd_smem(c: int, s: int, tw: int, pixel: bool = True) -> int:
    """Bytes of dynamic shared memory a block of the forward takes (the
    kernel's ``fwd_warp_bytes``, four warps): each warp's source rows, bf16
    [rows][(tw + 2)·C rounded up to 8] (rows = ⌈(band − 1) / s⌉ + 2), its
    staged per-pixel values, 4 B [3, or 4 for the maps][band][s·tw], and its
    labels, int16 [band][s·tw], rounded up to 16."""
    band = 32 // ce_bwd_groups(c)[0]
    rows = (band + s - 2) // s + 2
    at = (rows * -(-(tw + 2) * c // 8) * 8 * 2 + (4 if pixel else 3) * band * s * tw * 4
          + band * s * tw * 2)
    return CE_FWD_WARPS * (-(-at // 16) * 16)


@functools.lru_cache(maxsize=None)
def ce_fwd_plan(n: int, h: int, w: int, c: int, s: int, sms: int) -> tuple[int, int]:
    """(tw, band) of the forward: strips of tw source columns and bands of
    ``band`` = 32 / G output rows. tw takes the least time in waves of warps
    (the card's ``sms`` SMs holding up to 4 blocks of 4 warps, as their
    shared memory allows: the maps' at the widest), a unit costing its
    columns plus two (its copy into shared memory and its epilogue, which
    clock counters on the H100 put at about two columns' time); ties go to
    the wider strip."""
    band = 32 // ce_bwd_groups(c)[0]
    nband = -(-h * s // band)
    best = None
    for tw in _CE_FWD_STRIPS:
        smem = ce_fwd_smem(c, s, tw)
        if smem > _CE_FWD_SMEM:
            continue
        slots = sms * min(_CE_FWD_BLOCKS_PER_SM, SMEM_LIMIT // (smem + 1024)) * CE_FWD_WARPS
        units = n * nband * -(-w // tw)
        cost = -(-units // slots) * (min(tw, w) + 2)
        if best is None or cost < best[0]:
            best = (cost, tw)
    return best[1], band


def ce_fwd_units(n: int, h: int, w: int, c: int, s: int, plan: tuple) -> list:
    """Each unit of the forward in the kernel's order, as it derives them from
    its warp index (bands fastest, so that a block's warps share a strip's
    source rows): (frame, y0, y1, v0, v1), computing output rows [y0, y1)
    (fewer than ``band`` only in a frame's ragged last band) at output
    columns [s·v0, s·v1)."""
    tw, band = plan
    hh = h * s
    nband, nstrip = -(-hh // band), -(-w // tw)
    units = []
    for u in range(n * nband * nstrip):
        b, strip, f = u % nband, u // nband % nstrip, u // nband // nstrip
        units.append((f, b * band, min(b * band + band, hh), strip * tw,
                      min(strip * tw + tw, w)))
    return units


def _fwd_plan(logits: torch.Tensor, s: int) -> tuple[int, int]:
    """(tw, units) of a forward launch."""
    n, h, w, c = logits.shape
    tw, band = ce_fwd_plan(n, h, w, c, s, sm_count(logits))
    return tw, n * -(-h * s // band) * -(-w // tw)


def _kernel_inputs(logits: torch.Tensor, labels: torch.Tensor, s: int, op: str):
    require(logits.is_cuda and labels.is_cuda, op, "a CPU tensor")
    require(logits.dtype == torch.bfloat16, op, f"logits of dtype {logits.dtype} (bf16 only)")
    require(labels.dtype in (torch.uint8, torch.int32), op,
            f"labels of dtype {labels.dtype} (uint8 or int32)")
    c = logits.shape[-1]
    require(c <= _MAX_CLASSES, op, f"{c} classes (at most {_MAX_CLASSES})")
    require(1 <= s <= _MAX_SCALE, op, f"scale {s} (1 to {_MAX_SCALE})")
    return logits.contiguous(), labels.contiguous(), int(labels.dtype == torch.int32)


def _ce_fwd_launch(logits, labels, s: int, img_w: float, count_acc: bool):
    op = "ce_upsampled_loss"
    logits, labels, lbl32 = _kernel_inputs(logits, labels, s, op)
    n, h, w, c = logits.shape
    tw, units = _fwd_plan(logits, s)
    partial = torch.empty((units, 2), device=logits.device, dtype=torch.float32)
    dev, stream = stream_of(logits)
    rc = _build.library("ce_upsampled").ce_fwd_loss(
        ptr(logits, op), ptr(labels, op), ptr(partial, op), n, h, w, c, s, lbl32,
        float(img_w), int(count_acc), tw, dev, stream)
    _build.check(rc, op)
    sums = partial.sum(dim=0)
    return sums[0], sums[1]


def _bwd_plan(logits: torch.Tensor, s: int):
    """(plan, partial buffer or None) of a backward launch."""
    n, h, w, c = logits.shape
    plan = ce_bwd_plan(n, h, w, c, s, sm_count(logits))
    nseg = plan[1]
    part = None if nseg == 1 else torch.empty((n * (nseg - 1) * 4 * w * c,),
                                              device=logits.device, dtype=torch.float32)
    return plan, part


def _ce_bwd_launch(logits, labels, g: torch.Tensor, s: int, img_w: float) -> torch.Tensor:
    op = "ce_upsampled_loss_bwd"
    logits, labels, lbl32 = _kernel_inputs(logits, labels, s, op)
    n, h, w, c = logits.shape
    gf = g.detach().to(device=logits.device, dtype=torch.float32).reshape(1).contiguous()
    out = torch.empty_like(logits)
    (tw, nseg, cs), part = _bwd_plan(logits, s)
    dev, stream = stream_of(logits)
    rc = _build.library("ce_upsampled").ce_bwd_loss(
        ptr(logits, op), ptr(labels, op), ptr(gf, op), ptr(out, op), ptr(part, op), n, h, w, c,
        s, lbl32, float(img_w), tw, nseg, cs, dev, stream)
    _build.check(rc, op)
    return out


def ce_upsampled_loss_bwd(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor,
                          s: int, img_w: float, force: str | None = None) -> torch.Tensor:
    """The backward of ``ce_upsampled_loss``: dlogits for the cotangent g of
    ``wsum``. force: None (kernel on CUDA, plain on CPU) | 'torch' | 'kernel'."""
    if not use_kernel(force, logits, "ce_upsampled_loss_bwd"):
        return ce_upsampled_loss_bwd_torch(logits, labels, g, s, img_w)
    out = _ce_bwd_launch(logits, labels, g, s, img_w)
    ce_upsampled_loss_bwd.launches += 1
    return out


class _CEUpsampledLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, s, img_w, count_acc, force, kernel):
        if kernel:
            wsum, corr = _ce_fwd_launch(logits, labels, s, img_w, count_acc)
            ce_upsampled_loss.launches += 1
        else:
            wsum, corr = ce_upsampled_loss_torch(logits, labels, s, img_w, count_acc)
        ctx.save_for_backward(logits, labels)
        ctx.args = (s, img_w, force)
        ctx.mark_non_differentiable(corr)
        return wsum, corr

    @staticmethod
    def backward(ctx, g_wsum, g_corr):
        logits, labels = ctx.saved_tensors
        s, img_w, force = ctx.args
        dlogits = ce_upsampled_loss_bwd(logits, labels, g_wsum, s, img_w, force=force)
        return dlogits, None, None, None, None, None, None


def ce_upsampled_loss(logits: torch.Tensor, labels: torch.Tensor, s: int, img_w: float,
                      count_acc: bool = True, force: str | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """force: None (kernel on CUDA, plain on CPU) | 'torch' | 'kernel'; the
    backward follows the same rule (``ce_upsampled_loss_bwd``)."""
    _check_shapes(logits, labels, s, "ce_upsampled_loss")
    kernel = use_kernel(force, logits, "ce_upsampled_loss")
    return _CEUpsampledLoss.apply(logits, labels, s, float(img_w), count_acc, force, kernel)


ce_upsampled_loss.launches = 0
ce_upsampled_loss_bwd.launches = 0


# ---- per-pixel maps: the OHEM / class-weight route ----------------------------


def ce_upsampled_nll_torch(logits: torch.Tensor, labels: torch.Tensor, s: int
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nll, pred, lse), each (N, h·s, w·s): f32, int32, f32."""
    _check_shapes(logits, labels, s, "ce_upsampled_nll")
    up = _upsample(logits, s)
    _, safe = valid_safe(labels, logits.shape[-1])
    lse = torch.logsumexp(up, dim=1)
    picked = up.gather(1, safe[:, None])[:, 0]
    return lse - picked, up.argmax(dim=1).int(), lse


def ce_upsampled_nll_bwd_torch(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                               g_nll: torch.Tensor, s: int) -> torch.Tensor:
    """dlogits (logits' dtype) for the per-pixel cotangent g_nll of nll."""
    _check_shapes(logits, labels, s, "ce_upsampled_nll_bwd")
    x = logits.detach().float().requires_grad_(True)
    with torch.enable_grad():
        up = _upsample(x, s)
    with torch.no_grad():
        _, safe = valid_safe(labels, logits.shape[-1])
        t = torch.exp(up.detach() - lse.float()[:, None])
        t.scatter_add_(1, safe[:, None], -torch.ones_like(t[:, :1]))
        t = t * g_nll.float()[:, None]
    (dx,) = torch.autograd.grad(up, x, t)
    return dx.to(logits.dtype)


def _nll_fwd_launch(logits, labels, s: int):
    op = "ce_upsampled_nll"
    logits, labels, lbl32 = _kernel_inputs(logits, labels, s, op)
    n, h, w, c = logits.shape
    nll = torch.empty(labels.shape, device=logits.device, dtype=torch.float32)
    lse = torch.empty_like(nll)
    pred = torch.empty(labels.shape, device=logits.device, dtype=torch.int32)
    tw, _ = _fwd_plan(logits, s)
    dev, stream = stream_of(logits)
    rc = _build.library("ce_upsampled").ce_fwd_nll(
        ptr(logits, op), ptr(labels, op), ptr(nll, op), ptr(pred, op), ptr(lse, op), n, h, w, c,
        s, lbl32, tw, dev, stream)
    _build.check(rc, op)
    return nll, pred, lse


def ce_upsampled_nll_bwd(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                         g_nll: torch.Tensor, s: int, force: str | None = None) -> torch.Tensor:
    """The backward of ``ce_upsampled_nll``: dlogits for the per-pixel
    cotangent g_nll of nll, from the forward's lse. force: None (kernel on
    CUDA, plain on CPU) | 'torch' | 'kernel'."""
    op = "ce_upsampled_nll_bwd"
    if not use_kernel(force, logits, op):
        return ce_upsampled_nll_bwd_torch(logits, labels, lse, g_nll, s)
    _check_shapes(logits, labels, s, op)
    logits, labels, lbl32 = _kernel_inputs(logits, labels, s, op)
    for name, t in (("lse", lse), ("g_nll", g_nll)):
        require(t.is_cuda and tuple(t.shape) == tuple(labels.shape), op,
                f"{name} of shape {tuple(t.shape)} against labels {tuple(labels.shape)}")
    n, h, w, c = logits.shape
    ls = lse.detach().to(torch.float32).contiguous()
    g = g_nll.detach().to(torch.float32).contiguous()
    out = torch.empty_like(logits)
    (tw, nseg, cs), part = _bwd_plan(logits, s)
    dev, stream = stream_of(logits)
    rc = _build.library("ce_upsampled").ce_bwd_nll(
        ptr(logits, op), ptr(labels, op), ptr(ls, op), ptr(g, op), ptr(out, op), ptr(part, op), n,
        h, w, c, s, lbl32, tw, nseg, cs, dev, stream)
    _build.check(rc, op)
    ce_upsampled_nll_bwd.launches += 1
    return out


class _CEUpsampledNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, s, force, kernel):
        if kernel:
            nll, pred, lse = _nll_fwd_launch(logits, labels, s)
            ce_upsampled_nll.launches += 1
        else:
            nll, pred, lse = ce_upsampled_nll_torch(logits, labels, s)
        ctx.save_for_backward(logits, labels, lse)
        ctx.args = (s, force)
        ctx.mark_non_differentiable(pred, lse)
        return nll, pred, lse

    @staticmethod
    def backward(ctx, g_nll, g_pred, g_lse):
        logits, labels, lse = ctx.saved_tensors
        s, force = ctx.args
        dlogits = ce_upsampled_nll_bwd(logits, labels, lse, g_nll, s, force=force)
        return dlogits, None, None, None, None


def ce_upsampled_nll(logits: torch.Tensor, labels: torch.Tensor, s: int,
                     force: str | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nll, pred, lse); only nll carries a gradient. force: None (kernel on
    CUDA, plain on CPU) | 'torch' | 'kernel'; the backward follows it
    (``ce_upsampled_nll_bwd``)."""
    _check_shapes(logits, labels, s, "ce_upsampled_nll")
    kernel = use_kernel(force, logits, "ce_upsampled_nll")
    return _CEUpsampledNLL.apply(logits, labels, s, force, kernel)


ce_upsampled_nll.launches = 0
ce_upsampled_nll_bwd.launches = 0


# ---- the TPU kernels' phase layouts: the CE microbench's variants -------------


def labels_to_phase(labels: torch.Tensor, s: int) -> torch.Tensor:
    """(N, H, W) → (N, h, s·s, w), phase = ph·s + pw (h-major)."""
    n, hh, ww = labels.shape
    h, w = hh // s, ww // s
    return labels.reshape(n, h, s, w, s).permute(0, 1, 2, 4, 3).reshape(n, h, s * s, w)


def phase_to_natural(x_ph: torch.Tensor, s: int) -> torch.Tensor:
    """(N, h, s·s, w) → (N, H, W): inverse of ``labels_to_phase``."""
    n, h, _, w = x_ph.shape
    return x_ph.reshape(n, h, s, s, w).permute(0, 1, 2, 4, 3).reshape(n, h * s, w * s)


def labels_to_phase_w(labels: torch.Tensor, s: int) -> torch.Tensor:
    """(N, H, W) → (N, h, w, s·s): [n, k, v, ph·s + pw] = labels[n, s·k + ph,
    s·v + pw] (w-major)."""
    n, hh, ww = labels.shape
    h, w = hh // s, ww // s
    return labels.reshape(n, h, s, w, s).permute(0, 1, 3, 2, 4).reshape(n, h, w, s * s)


def _natural(labels: torch.Tensor, s: int, w_major: bool) -> torch.Tensor:
    return phase_to_natural(labels.transpose(2, 3) if w_major else labels, s)


def _check_phase(logits: torch.Tensor, labels: torch.Tensor, s: int, w_major: bool,
                 op: str) -> None:
    if logits.dim() != 4:
        raise ValueError(f"{op}: logits (N, h, w, C), got {tuple(logits.shape)}")
    n, h, w, _ = logits.shape
    want = (n, h, w, s * s) if w_major else (n, h, s * s, w)
    if tuple(labels.shape) != want:
        raise ValueError(f"{op}: labels {tuple(labels.shape)} are not the "
                         f"{'w' if w_major else 'h'}-major phase layout {want} of logits "
                         f"{tuple(logits.shape)} at scale {s}")


def phase_labels_u8(labels: torch.Tensor, c: int, op: str = "ce_phase") -> torch.Tensor:
    """Labels of any integer dtype as the uint8 the phase kernels read: those
    outside [0, C) become 255, which stays outside [0, C) (C ≤ 255), so a
    wider label is ignored as the JAX kernels ignore it after their int32
    cast, not cut to its low 8 bits. uint8 labels pass as they are."""
    if labels.dtype == torch.uint8:
        return labels
    require(not labels.is_floating_point() and not labels.is_complex(), op,
            lambda: f"labels of dtype {labels.dtype} (an integer dtype)")
    require(c <= 255, op, lambda: f"{c} classes with {labels.dtype} labels (255 at most, "
                                          "so that 255 stays ignored)")
    return torch.where((labels >= 0) & (labels < c), labels, 255).to(torch.uint8)


def _phase_inputs(logits, labels, s: int, unrolled: bool, op: str):
    labels = phase_labels_u8(labels, logits.shape[-1], op)
    logits, labels, _ = _kernel_inputs(logits, labels, s, op)
    if unrolled:
        require(s in (2, 4), op, f"scale {s} (the unrolled phases: 2 or 4)")
    else:
        require(1 <= s <= 8, op, f"scale {s} (1 to 8)")
    return logits, labels


def _phase_fwd_launch(logits, labels, s: int, img_w: float, count_acc: bool, unrolled: bool,
                      op: str):
    """The loss forward's kernel with w-major labels on ``_fwd_plan``'s plan;
    the runtime loop's variant (not ``unrolled``) takes its coefficients in
    f32."""
    logits, labels = _phase_inputs(logits, labels, s, unrolled, op)
    n, h, w, c = logits.shape
    tw, units = _fwd_plan(logits, s)
    partial = torch.empty((units, 2), device=logits.device, dtype=torch.float32)
    dev, stream = stream_of(logits)
    rc = _build.library("ce_upsampled").ce_fwd_loss_phase(
        ptr(logits, op), ptr(labels, op), ptr(partial, op), n, h, w, c, s, int(not unrolled),
        float(img_w), int(count_acc), tw, dev, stream)
    _build.check(rc, op)
    sums = partial.sum(dim=0)
    return sums[0], sums[1]


def _phase_bwd_launch(logits, labels, ct: torch.Tensor, s: int, img_w: float, w_major: bool,
                      unrolled: bool, op: str) -> torch.Tensor:
    """The loss backward's kernel with phase labels and f32 out; the runtime
    loop's variant (not ``unrolled``) takes its coefficients in f32."""
    logits, labels = _phase_inputs(logits, labels, s, unrolled, op)
    require(ct.numel() == 1, op, f"a cotangent of shape {tuple(ct.shape)} (one value)")
    n, h, w, c = logits.shape
    g = ct.detach().to(device=logits.device, dtype=torch.float32).reshape(1).contiguous()
    out = torch.empty(logits.shape, device=logits.device, dtype=torch.float32)
    (tw, nseg, cs), part = _bwd_plan(logits, s)
    dev, stream = stream_of(logits)
    rc = _build.library("ce_upsampled").ce_bwd_loss_phase(
        ptr(logits, op), ptr(labels, op), ptr(g, op), ptr(out, op), ptr(part, op), n, h, w, c, s,
        int(w_major), int(not unrolled), float(img_w), tw, nseg, cs, dev, stream)
    _build.check(rc, op)
    return out


def ce_bwd_loss_v2(logits: torch.Tensor, labels_ph: torch.Tensor, ct: torch.Tensor, s: int,
                   img_w: float, force: str | None = None) -> torch.Tensor:
    """f32 dlogits (N, h, w, C) for the cotangent ct of wsum, labels h-major
    (N, h, s², w). force: None (kernel on CUDA, plain on CPU) | 'torch' | 'kernel'."""
    op = "ce_bwd_loss_v2"
    _check_phase(logits, labels_ph, s, False, op)
    if not use_kernel(force, logits, op):
        return _loss_bwd_f32(logits, _natural(labels_ph, s, False), ct, s, img_w)
    out = _phase_bwd_launch(logits, labels_ph, ct, s, img_w, False, True, op)
    ce_bwd_loss_v2.launches += 1
    return out


def ce_fwd_loss_v5(logits: torch.Tensor, labels_phw: torch.Tensor, s: int, img_w: float,
                   count_acc: bool = True, force: str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(wsum, corr) with labels w-major (N, h, w, s²), the phases unrolled.
    force as for ``ce_bwd_loss_v2``."""
    op = "ce_fwd_loss_v5"
    _check_phase(logits, labels_phw, s, True, op)
    if not use_kernel(force, logits, op):
        return ce_upsampled_loss_torch(logits, _natural(labels_phw, s, True), s, img_w,
                                       count_acc)
    out = _phase_fwd_launch(logits, labels_phw, s, img_w, count_acc, True, op)
    ce_fwd_loss_v5.launches += 1
    return out


def ce_fwd_loss_v3(logits: torch.Tensor, labels_phw: torch.Tensor, s: int, img_w: float,
                   count_acc: bool = True, force: str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(wsum, corr) with labels w-major (N, h, w, s²), the phases a runtime
    loop. force as for ``ce_bwd_loss_v2``."""
    op = "ce_fwd_loss_v3"
    _check_phase(logits, labels_phw, s, True, op)
    if not use_kernel(force, logits, op):
        return ce_upsampled_loss_torch(logits, _natural(labels_phw, s, True), s, img_w,
                                       count_acc)
    out = _phase_fwd_launch(logits, labels_phw, s, img_w, count_acc, False, op)
    ce_fwd_loss_v3.launches += 1
    return out


def ce_bwd_loss_v3(logits: torch.Tensor, labels_phw: torch.Tensor, ct: torch.Tensor, s: int,
                   img_w: float, force: str | None = None) -> torch.Tensor:
    """f32 dlogits (N, h, w, C) with labels w-major (N, h, w, s²), the phases a
    runtime loop. force as for ``ce_bwd_loss_v2``."""
    op = "ce_bwd_loss_v3"
    _check_phase(logits, labels_phw, s, True, op)
    if not use_kernel(force, logits, op):
        return _loss_bwd_f32(logits, _natural(labels_phw, s, True), ct, s, img_w)
    out = _phase_bwd_launch(logits, labels_phw, ct, s, img_w, True, False, op)
    ce_bwd_loss_v3.launches += 1
    return out


ce_bwd_loss_v2.launches = 0
ce_fwd_loss_v5.launches = 0
ce_fwd_loss_v3.launches = 0
ce_bwd_loss_v3.launches = 0
