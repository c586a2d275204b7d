"""Shared helpers of the PyTorch-port parity tests (``test_torch_port_*.py``).

Both sides get the same inputs, made with numpy from a seed: the JAX package
runs on the CPU as the reference; the port runs on the CPU, where every op
takes its plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vss_cffm_tpu.models.segmentor import CFFMSegmentor as JaxSegmentor
from vss_cffm_tpu.models.segmentor import build_model_config as jax_build_model_config
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.ops import ce_upsampled as ce
from vss_cffm_tpu_torch.utils import state_dict_from_jax


def jax_config(variant: str = "b0", num_classes: int = 7, depth: int = 1,
               block_impl=(None, "fused", "fused", None), dwconv_impl=None):
    """The JAX package's CFFM config at a test size. On the CPU its "fused"
    stages run composed; "fused-interpret" runs the Pallas kernel (also as
    ``dwconv_impl``)."""
    cfg = jax_build_model_config(variant, num_classes=num_classes)
    dec = dataclasses.replace(cfg.head.decoder, depth=depth)
    return dataclasses.replace(cfg, head=dataclasses.replace(cfg.head, decoder=dec),
                               block_impl=block_impl, dwconv_impl=dwconv_impl)


def port_config(jcfg, block_impl=(None, "fused", "fused", None)) -> pcfg.SegmentorConfig:
    """The port's config with the same fields as a JAX ``SegmentorConfig`` (the
    arch, the head's dropout, mode and cluster blend included); its
    ``train_block_impl`` and ``dwconv_impl`` are the JAX ones, the interpret
    modes mapped to the port's forms ("full-interpret" → "full",
    "ffn-interpret" → "ffn", "fused-interpret" → "fused")."""
    d = jcfg.head.decoder
    dec = pcfg.CFFMDecoderConfig(
        dim=d.dim, depth=d.depth, num_heads=d.num_heads, window_size=d.window_size,
        expand_size=d.expand_size, focal_level=d.focal_level, focal_window=d.focal_window,
        focal_l_clips=tuple(d.focal_l_clips), focal_kernel_clips=tuple(d.focal_kernel_clips),
        mlp_ratio=d.mlp_ratio, qkv_bias=d.qkv_bias, norm_eps=d.norm_eps)
    h = jcfg.head
    head = pcfg.CFFMHeadConfig(in_channels=tuple(h.in_channels), embed_dim=h.embed_dim,
                               num_classes=h.num_classes, num_clips=h.num_clips,
                               dropout_ratio=h.dropout_ratio, decoder=dec, mode=h.mode,
                               cluster_blend=h.cluster_blend)
    tbi = jcfg.train_block_impl
    form = lambda i: i.removesuffix("-interpret") if isinstance(i, str) else i
    tbi = tuple(map(form, tbi)) if isinstance(tbi, tuple) else form(tbi)
    return pcfg.SegmentorConfig(backbone=jcfg.backbone, head=head, arch=jcfg.arch,
                                block_impl=block_impl, train_block_impl=tbi,
                                dwconv_impl=form(jcfg.dwconv_impl))


# jitted JAX inits by (model, its backbone config, input shape and dtype):
# the first eager init of B0 at 112² takes ~50 s on the CPU, a jitted one
# ~13 s, and a compiled one runs again in well under a second for any seed
_INITS: dict = {}


def perturbed_variables(model, sample, seed: int = 0, scale: float = 0.02):
    """JAX init (jitted, compiled once per model), then every leaf +
    scale·N(0, 1) from numpy, so that zero-initialised biases and bias tables
    are exercised; BN variances stay > 0."""
    sample = np.asarray(sample)
    backbone = getattr(getattr(model, "config", None), "backbone_config", None)
    key = (repr(model), repr(backbone), sample.shape, str(sample.dtype))
    if key not in _INITS:
        _INITS[key] = jax.jit(model.init)
    variables = jax.device_get(_INITS[key](jax.random.PRNGKey(seed), jnp.asarray(sample)))
    rng = np.random.RandomState(seed + 1)

    def bump(path, leaf):
        a = np.asarray(leaf, np.float32)
        noise = scale * rng.standard_normal(a.shape).astype(np.float32)
        if any(getattr(k, "key", None) == "var" for k in path):
            return np.abs(a + noise) + 0.5
        return a + noise

    return jax.tree_util.tree_map_with_path(bump, variables)


# the clip size of ``jax_and_port``'s JAX init
_INIT_HW = (112, 112)


def jax_and_port(variant="b0", hw=(112, 112), depth=1, num_classes=7, seed=0,
                 jax_block_impl=(None, "fused", "fused", None), dwconv_impl=None):
    """(JAX model, its variables, the port model on the same weights, the input clip)."""
    jcfg = jax_config(variant, num_classes, depth, jax_block_impl, dwconv_impl)
    jmodel = JaxSegmentor(jcfg)
    clip = np.random.RandomState(seed).randn(1, 4, *hw, 3).astype(np.float32)
    # the interpreted block and FFN kernels keep the composed parameter tree,
    # and no parameter's shape or value depends on the input's size: init
    # without them at one clip size, so that every form and geometry shares
    # one compiled init (an interpreted kernel would also make the init
    # trace slow)
    init_cfg = dataclasses.replace(jcfg, dwconv_impl=None, block_impl=(None, "fused", "fused",
                                                                       None))
    variables = perturbed_variables(JaxSegmentor(init_cfg),
                                    np.zeros((1, 4, *_INIT_HW, 3), np.float32), seed)
    pmodel = CFFMSegmentor(port_config(jcfg))
    pmodel.load_state_dict(state_dict_from_jax(variables, jcfg), strict=True)
    return jmodel, variables, pmodel.eval(), clip


@pytest.fixture(scope="module")
def few_threads():
    """At most 2 torch threads for a module's tests, restored after: the
    suite runs several workers on a few cores, where every worker's full
    thread pool contends (a CPU train step took 10-40× its time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


# ---- training ----------------------------------------------------------------


@contextlib.contextmanager
def no_drop_path(variant: str = "b0"):
    """Stochastic depth 0 on both sides (the MiT variant's ``drop_path_rate``)."""
    from vss_cffm_tpu.models import mit as jax_mit

    name = f"mit_{variant}"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_mit.MIT_VARIANTS, name,
                   dataclasses.replace(jax_mit.MIT_VARIANTS[name], drop_path_rate=0.0))
        mp.setitem(pcfg.MIT_VARIANTS, name,
                   dataclasses.replace(pcfg.MIT_VARIANTS[name], drop_path_rate=0.0))
        yield


@contextlib.contextmanager
def train_patches(variant: str = "b0"):
    """The train tests' settings on both sides: stochastic depth 0
    (``no_drop_path``), and on the JAX side the fused CE kernels in the loss,
    run in interpret mode (``losses._FORCE_FUSED``, ``ce_upsampled._INTERPRET``)."""
    from vss_cffm_tpu.models import losses as jax_losses
    from vss_cffm_tpu.ops import ce_upsampled as jax_ce

    with no_drop_path(variant), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_losses, "_FORCE_FUSED", True)
        mp.setattr(jax_ce, "_INTERPRET", True)
        yield


def train_configs(variant: str = "b0", num_classes: int = 7, depth: int = 1,
                  train_block_impl=None, loss: dict | None = None):
    """(JAX config, port config) of the train tests: the JAX block form
    ``train_block_impl`` (default None, composed blocks at every stage; the
    port takes the same form, without "-interpret"), head dropout 0, and the
    head's ``LossConfig`` fields ``loss`` on both sides. Use inside
    ``train_patches``."""
    from vss_cffm_tpu.models.losses import LossConfig as JaxLossConfig

    loss = loss or {}
    jcfg = jax_config(variant, num_classes, depth)
    jcfg = dataclasses.replace(jcfg, train_block_impl=train_block_impl,
                               head=dataclasses.replace(jcfg.head, dropout_ratio=0.0,
                                                        loss=JaxLossConfig(**loss)))
    pc = port_config(jcfg)
    return jcfg, dataclasses.replace(pc, head=dataclasses.replace(
        pc.head, dropout_ratio=0.0, loss=pcfg.LossConfig(**loss)))


def train_batch(b: int, hw: tuple[int, int], num_classes: int, seed: int = 0):
    """uint8 BGR clips (B, 4, H, W, 3) and uint8 labels (B, 4, H, W) with ~5 %
    ignored (255) and ~1 % out of range (= num_classes)."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (b, 4, *hw, 3)).astype(np.uint8)
    labels = rng.randint(0, num_classes, (b, 4, *hw)).astype(np.uint8)
    labels[rng.rand(*labels.shape) < 0.05] = 255
    labels[rng.rand(*labels.shape) < 0.01] = num_classes
    return imgs, labels


def to_jax_tree(model, values: dict, jcfg):
    """The JAX variables tree of ``values`` (port parameter name → tensor, e.g.
    gradients), the model's buffers filling the rest: every transform of
    ``convert_segmentor`` is a transpose or a reshape, so it maps gradients
    as it maps weights."""
    from vss_cffm_tpu.utils.torch_convert import convert_segmentor

    sd = {k: to_np(v) for k, v in model.state_dict().items()}
    sd.update({k: to_np(v) for k, v in values.items()})
    return convert_segmentor(sd, jcfg)


def index_map(pm, jcfg) -> dict:
    """JAX parameter path → port parameter name: each port parameter filled
    with its own index, converted, read back."""
    names = [n for n, _ in pm.named_parameters()]
    vals = {n: torch.full_like(p, float(i)) for i, (n, p) in enumerate(pm.named_parameters())}
    tree = flat(to_jax_tree(pm, vals, jcfg)["params"])
    out = {}
    for path, leaf in tree.items():
        assert np.all(leaf == leaf.flat[0]), path
        out[path] = names[int(leaf.flat[0])]
    assert sorted(out.values()) == sorted(names)
    return out


def flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def assert_bf16_rounded_alike(got: torch.Tensor, want, label: str) -> None:
    """bf16 outputs rounded at the same points from f32 sums taken in other
    orders: a rounding flips one ulp only where an f32 sum lies within f32
    rounding of a bf16 boundary, and a flip upstream moves a later sum by far
    less than an ulp. So ≥ 99 % of the elements are bitwise equal (a rounding
    moved, added or dropped leaves 60-75 % equal at these sizes), and none is
    off by more than 2^-8 of the largest."""
    assert got.dtype == torch.bfloat16, label
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert np.mean(g == w) >= 0.99, (label, np.mean(g == w))
    assert np.abs(g - w).max() <= 2.0 ** -8 * np.abs(w).max(), label


# ---- the upsampled-CE backward's decomposition (csrc/ce_upsampled.cu) --------


def phase_coeff(p: int, s: int, loop: bool = False) -> tuple[int, np.float32]:
    """(delta, f) of output phase p as the backward's kernel takes them: d =
    (p + 0.5)/s − 0.5 in double, f rounded once to f32 (its Coeffs), or with
    ``loop`` every step in f32 (the runtime phase loop's rule, row 19)."""
    if loop:
        d = (np.float32(p) + np.float32(0.5)) / np.float32(s) - np.float32(0.5)
        delta = -1 if d < 0 else 0
        return delta, np.float32(d - np.float32(delta))
    d = (p + 0.5) / s - 0.5
    delta = -1 if d < 0 else 0
    return delta, np.float32(d - delta)


def col_shares(x: int, s: int, w: int) -> list[tuple[int, np.float32]]:
    """The source columns output column x adds to and its weights, the
    kernel's way: at the image edge both shares go to the edge column."""
    v, pw = divmod(x, s)
    delta, f = phase_coeff(pw, s)
    c0, wl = v + delta, np.float32(1) - f
    if c0 < 0:
        return [(0, wl + f)]
    if c0 + 1 >= w:
        return [(c0, wl + f)]
    return [(c0, wl), (c0 + 1, f)]


def row_shares(y: int, s: int, h: int) -> list[tuple[int, np.float32]]:
    k, ph = divmod(y, s)
    delta, f = phase_coeff(ph, s)
    clamp = lambda r: min(max(r, 0), h - 1)
    return [(clamp(k + delta), np.float32(1) - f), (clamp(k + delta + 1), f)]


def unit_rows(k_lo: int, k_hi: int, h: int) -> tuple[list[int], list[int], list[int]]:
    """(rows written whole, top partial rows, bottom partial rows) of a unit."""
    rows = list(range(max(k_lo - 1, 0), min(k_hi, h - 1) + 1))
    top = [r for r in rows if k_lo > 0 and r <= k_lo]
    bottom = [r for r in rows if k_hi < h and r >= k_hi - 1]
    return [r for r in rows if r not in top and r not in bottom], top, bottom


def ce_terms(logits, labels, s, g, img_w=None, lse=None):
    """(N, H, W, C) f32 terms whose upsample adjoint is dlogits: the loss's
    img_w·g·(softmax − onehot) on valid pixels (img_w given), or the per-pixel
    g·(exp(up − lse) − onehot(safe label))."""
    n, h, w, c = logits.shape
    up = F.interpolate(logits.permute(0, 3, 1, 2), size=(h * s, w * s), mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1)
    valid, safe = ce.valid_safe(labels, c)
    onehot = F.one_hot(safe, c).float()
    if lse is None:
        t = (torch.softmax(up, dim=-1) - onehot) * (g * img_w)
        return torch.where(valid[..., None], t, 0.0)
    return (torch.exp(up - lse[..., None]) - onehot) * g[..., None]


def replay(logits, labels, s, plan, **kw) -> torch.Tensor:
    """f32 dlogits built unit by unit as the kernel builds them: each unit's
    column and row shares (``col_shares`` restricted to its strip,
    ``row_shares``), rows written whole or kept as partials, then each
    boundary's two partials added, upper first. ``labels`` natural (N, H, W);
    the coefficients of rows 13, 15 and 17 (row 19's equal them at s 1, 2, 4
    and 8)."""
    n, h, w, c = logits.shape
    t = ce_terms(logits, labels, s, **kw)
    out = torch.full((n, h, w, c), float("nan"))
    parts: dict = {}
    for f0, k_lo, k_hi, v0, v1, xa, xb, _ in ce.ce_bwd_units(n, h, w, c, s, plan):
        r_lo, r_hi = max(k_lo - 1, 0), min(k_hi, h - 1)
        ys = range(s * k_lo, s * k_hi)
        mr = torch.zeros(len(ys), r_hi - r_lo + 1)
        for i, y in enumerate(ys):
            for r, wt in row_shares(y, s, h):
                mr[i, r - r_lo] += float(wt)
        mc = torch.zeros(xb - xa, v1 - v0)
        for i, x in enumerate(range(xa, xb)):
            for col, wt in col_shares(x, s, w):
                if v0 <= col < v1:
                    mc[i, col - v0] += float(wt)
        acc = torch.einsum("yr,yxc,xv->rvc", mr, t[f0, s * k_lo:s * k_hi, xa:xb], mc)
        rows, top, bottom = unit_rows(k_lo, k_hi, h)
        for r in rows:
            out[f0, r, v0:v1] = acc[r - r_lo]
        for side, b, rs in ((1, k_lo, top), (0, k_hi, bottom)):
            for r in rs:
                parts.setdefault((f0, b, r, side), torch.zeros(w, c))[v0:v1] = acc[r - r_lo]
    for (f0, b, r, side), p in parts.items():
        if side == 0:
            out[f0, r] = p + parts[(f0, b, r, 1)]
    assert torch.isfinite(out).all()
    return out


def ce_bwd_plans(n, h, w, c, s):
    """The plan the card takes, strips of 3 columns in segments of 2 rows (a
    ragged last strip, partials at every boundary), and strips of one column."""
    g, cpl = ce.ce_bwd_groups(c)
    return [ce.ce_bwd_plan(n, h, w, c, s, 132), (3, h // 2, g * cpl + 1), (1, 2, g * cpl + 1)]


def close_to_largest(got, want, rel=1e-5):
    """|got − want| ≤ rel of want's largest magnitude (f32 sums of the same
    terms in another order)."""
    g, w_ = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w_.shape
    err = np.abs(g - w_).max()
    assert err <= rel * np.abs(w_).max(), (err, np.abs(w_).max())


def ce_inputs(n, h, w, c, s, seed):
    """f32 logits (N, h, w, C) ·2, uint8 natural labels with ~10 % ignored
    (255), and the generator for more."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, h, w, c) * 2).astype(np.float32)
    labels = rng.randint(0, c, (n, h * s, w * s)).astype(np.uint8)
    labels[rng.rand(*labels.shape) < 0.1] = 255
    return logits, labels, rng


# ---- the upsampled-CE forward's decomposition (csrc/ce_upsampled.cu) ---------


def phase_table(size: int, s: int, n_src: int, loop: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(source index a, source index b, f) of each output index, the kernel's
    Coeffs: up = x[a] + f·(x[b] − x[a]), the indices clamped at the edges;
    with ``loop`` the coefficients of the runtime phase loop (row 18:
    ``ce_bwd_coeffs(s, loop=True)``)."""
    coeffs = ce.ce_bwd_coeffs(s, loop=True) if loop else None
    a, b, f = [], [], []
    for y in range(size):
        k, p = divmod(y, s)
        if loop:
            delta, fp = coeffs[p]
        else:
            d = (p + 0.5) / s - 0.5
            delta = -1 if d < 0 else 0
            fp = np.float32(d - delta)
        a.append(min(max(k + delta, 0), n_src - 1))
        b.append(min(max(k + delta + 1, 0), n_src - 1))
        f.append(np.float32(fp))
    return torch.tensor(a), torch.tensor(b), torch.tensor(f)


def kernel_up(logits: torch.Tensor, s: int, loop: bool = False) -> torch.Tensor:
    """(N, H, W, C) f32: the upsample the kernel's way, rows lerped first
    (x0 + fh·(x1 − x0)), then columns (xl + fw·(xr − xl))."""
    n, h, w, c = logits.shape
    x = logits.float()
    r0, r1, fh = phase_table(h * s, s, h, loop)
    xh = x[:, r0] + fh[None, :, None, None] * (x[:, r1] - x[:, r0])
    c0, c1, fw = phase_table(w * s, s, w, loop)
    return xh[:, :, c0] + fw[None, None, :, None] * (xh[:, :, c1] - xh[:, :, c0])


def pixel_stats(logits, labels, s, loop: bool = False):
    up = kernel_up(logits, s, loop)
    m = up.amax(dim=-1)
    lse = m + torch.log(torch.exp(up - m[..., None]).sum(dim=-1))
    valid, safe = ce.valid_safe(labels, logits.shape[-1])
    picked = up.gather(-1, safe[..., None])[..., 0]
    return up, m, lse, valid, picked


def replay_loss(logits, labels, s, img_w, plan, count_acc=True, loop: bool = False):
    """(wsum, corr) as the kernel forms them: a partial per unit, over its
    pixels, summed in the units' order; each pixel counted once. ``labels``
    natural (N, H, W)."""
    n, h, w, c = logits.shape
    _, m, lse, valid, picked = pixel_stats(logits, labels, s, loop)
    terms = torch.where(valid, lse - picked, 0.0)
    hits = (valid & (picked == m)).float()
    seen = torch.zeros(labels.shape, dtype=torch.int32)
    parts = []
    for f, y0, y1, v0, v1 in ce.ce_fwd_units(n, h, w, c, s, plan):
        sl = (f, slice(y0, y1), slice(s * v0, s * v1))
        seen[sl] += 1
        parts.append(torch.stack([terms[sl].sum() * img_w,
                                  hits[sl].sum() if count_acc else torch.tensor(0.0)]))
    assert (seen == 1).all()
    total = torch.stack(parts).sum(dim=0)
    return total[0], total[1]


# ---- evaluation --------------------------------------------------------------

# the fake VSPW tree of the eval tests: frames of (64, 96) with img_scale
# (96, 64), so that neither pipeline resizes (factor 1, /32 multiples)
EVAL_HW, EVAL_SCALE, EVAL_CLASSES = (64, 96), (96, 64), 5


# port_weights' results by (JAX config, seed), made once a process (the
# port's init and the two conversions take seconds)
_PORT_WEIGHTS: dict = {}


def port_weights(jcfg, seed: int = 0) -> tuple[dict, dict]:
    """(JAX variables, port state dict) of one set of weights for the JAX
    config ``jcfg``: the port's init from ``seed`` perturbed with numpy
    noise, carried to JAX (``to_jax_tree``) and back
    (``state_dict_from_jax``); no JAX init is compiled."""
    key = (repr(jcfg), seed)
    if key not in _PORT_WEIGHTS:
        pm = CFFMSegmentor(port_config(jcfg))
        pm.init_weights(torch.Generator().manual_seed(seed))
        rng = np.random.RandomState(seed + 1)
        with torch.no_grad():
            for p in pm.parameters():
                p += torch.from_numpy(0.02 * rng.standard_normal(p.shape).astype(np.float32))
        variables = to_jax_tree(pm, {}, jcfg)
        _PORT_WEIGHTS[key] = variables, state_dict_from_jax(variables, jcfg)
    return _PORT_WEIGHTS[key]


def eval_models(seed: int = 0):
    """(JAX B0 segmentor at decoder depth 1, its variables, a new port model on
    the same weights in eval mode), the weights of ``port_weights``."""
    jcfg = jax_config("b0", num_classes=EVAL_CLASSES, depth=1)
    variables, state_dict = port_weights(jcfg, seed)
    port = CFFMSegmentor(port_config(jcfg))
    port.load_state_dict(state_dict, strict=True)
    return JaxSegmentor(jcfg), variables, port.eval()


def finetune_models(seed: int = 0, num_classes: int = EVAL_CLASSES):
    """(JAX config, JAX B0 CFFM++ finetune segmentor at decoder depth 1 with
    head dropout 0 and composed train blocks, its variables, the port model
    on the same weights in eval mode): the port's init perturbed with numpy
    noise, carried to JAX (``to_jax_tree``) and back
    (``state_dict_from_jax``), as ``eval_models`` does."""
    jcfg = jax_config("b0", num_classes=num_classes, depth=1)
    jcfg = dataclasses.replace(jcfg, train_block_impl=None, head=dataclasses.replace(
        jcfg.head, mode="finetune", dropout_ratio=0.0))
    pm = CFFMSegmentor(port_config(jcfg))
    pm.init_weights(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + 1)
    with torch.no_grad():
        for p in pm.parameters():
            p += torch.from_numpy(0.02 * rng.standard_normal(p.shape).astype(np.float32))
    variables = to_jax_tree(pm, {}, jcfg)
    port = CFFMSegmentor(port_config(jcfg))
    port.load_state_dict(state_dict_from_jax(variables, jcfg), strict=True)
    return jcfg, JaxSegmentor(jcfg), variables, port.eval()


def mask_agreement(want: dict, got: dict) -> float:
    """Share of pixels on which two {frame index: mask} dicts agree."""
    assert sorted(want) == sorted(got)
    same = sum(int((np.asarray(want[i]) == np.asarray(got[i])).sum()) for i in want)
    return same / sum(np.asarray(want[i]).size for i in want)


def write_config(path, cfg: pcfg.ExperimentConfig) -> str:
    """A config file at ``path`` whose ``config()`` returns ``cfg`` (the
    dataclasses' repr is Python the port's config names evaluate)."""
    with open(path, "w") as f:
        f.write("from vss_cffm_tpu_torch.config import *  # noqa: F403\n\n\n"
                f"def config():\n    return {cfg!r}\n")
    assert pcfg.load_config(str(path)) == cfg
    return str(path)
