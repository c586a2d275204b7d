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

from vss_cffm_tpu.models.segmentor import CFFMSegmentor as JaxSegmentor
from vss_cffm_tpu.models.segmentor import build_model_config as jax_build_model_config
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch.models import CFFMSegmentor
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
    """The port's config with the same fields as a JAX ``SegmentorConfig``; its
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
                               num_classes=h.num_classes, num_clips=h.num_clips, decoder=dec)
    tbi = jcfg.train_block_impl
    form = lambda i: i.removesuffix("-interpret") if isinstance(i, str) else i
    tbi = tuple(map(form, tbi)) if isinstance(tbi, tuple) else form(tbi)
    return pcfg.SegmentorConfig(backbone=jcfg.backbone, head=head, block_impl=block_impl,
                                train_block_impl=tbi, dwconv_impl=form(jcfg.dwconv_impl))


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


def jax_and_port(variant="b0", hw=(112, 112), depth=1, num_classes=7, seed=0,
                 jax_block_impl=(None, "fused", "fused", None), dwconv_impl=None):
    """(JAX model, its variables, the port model on the same weights, the input clip)."""
    jcfg = jax_config(variant, num_classes, depth, jax_block_impl, dwconv_impl)
    jmodel = JaxSegmentor(jcfg)
    clip = np.random.RandomState(seed).randn(1, 4, *hw, 3).astype(np.float32)
    # the fused FFN keeps the composed parameter tree: init without it, as
    # its interpreted kernel would make the init trace slow
    variables = perturbed_variables(JaxSegmentor(dataclasses.replace(jcfg, dwconv_impl=None)),
                                    clip, seed)
    pmodel = CFFMSegmentor(port_config(jcfg))
    pmodel.load_state_dict(state_dict_from_jax(variables, jcfg), strict=True)
    return jmodel, variables, pmodel.eval(), clip


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
