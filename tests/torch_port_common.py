"""Shared helpers of the PyTorch-port parity tests (``test_torch_port_*.py``).

Both sides get the same inputs, made with numpy from a seed: the JAX package
runs on the CPU as the reference; the port runs on the CPU, where every op
takes its plain PyTorch version.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vss_cffm_tpu.models.segmentor import CFFMSegmentor as JaxSegmentor
from vss_cffm_tpu.models.segmentor import build_model_config as jax_build_model_config
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.utils import state_dict_from_jax


def jax_config(variant: str = "b0", num_classes: int = 7, depth: int = 1,
               block_impl=(None, "fused", "fused", None)):
    """The JAX package's CFFM config at a test size. On the CPU its "fused"
    stages run composed; "fused-interpret" runs the Pallas kernel."""
    cfg = jax_build_model_config(variant, num_classes=num_classes)
    dec = dataclasses.replace(cfg.head.decoder, depth=depth)
    return dataclasses.replace(cfg, head=dataclasses.replace(cfg.head, decoder=dec),
                               block_impl=block_impl)


def port_config(jcfg, block_impl=(None, "fused", "fused", None)) -> pcfg.SegmentorConfig:
    """The port's config with the same fields as a JAX ``SegmentorConfig``."""
    d = jcfg.head.decoder
    dec = pcfg.CFFMDecoderConfig(
        dim=d.dim, depth=d.depth, num_heads=d.num_heads, window_size=d.window_size,
        expand_size=d.expand_size, focal_level=d.focal_level, focal_window=d.focal_window,
        focal_l_clips=tuple(d.focal_l_clips), focal_kernel_clips=tuple(d.focal_kernel_clips),
        mlp_ratio=d.mlp_ratio, qkv_bias=d.qkv_bias, norm_eps=d.norm_eps)
    h = jcfg.head
    head = pcfg.CFFMHeadConfig(in_channels=tuple(h.in_channels), embed_dim=h.embed_dim,
                               num_classes=h.num_classes, num_clips=h.num_clips, decoder=dec)
    return pcfg.SegmentorConfig(backbone=jcfg.backbone, head=head, block_impl=block_impl)


def perturbed_variables(model, sample, seed: int = 0, scale: float = 0.02):
    """JAX init, then every leaf + scale·N(0, 1) from numpy, so that zero-
    initialised biases and bias tables are exercised; BN variances stay > 0."""
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(sample))
    rng = np.random.RandomState(seed + 1)

    def bump(path, leaf):
        a = np.asarray(leaf, np.float32)
        noise = scale * rng.standard_normal(a.shape).astype(np.float32)
        if any(getattr(k, "key", None) == "var" for k in path):
            return np.abs(a + noise) + 0.5
        return a + noise

    return jax.tree_util.tree_map_with_path(bump, jax.device_get(variables))


def jax_and_port(variant="b0", hw=(112, 112), depth=1, num_classes=7, seed=0,
                 jax_block_impl=(None, "fused", "fused", None)):
    """(JAX model, its variables, the port model on the same weights, the input clip)."""
    jcfg = jax_config(variant, num_classes, depth, jax_block_impl)
    jmodel = JaxSegmentor(jcfg)
    clip = np.random.RandomState(seed).randn(1, 4, *hw, 3).astype(np.float32)
    variables = perturbed_variables(jmodel, clip, seed)
    pmodel = CFFMSegmentor(port_config(jcfg))
    pmodel.load_state_dict(state_dict_from_jax(variables, jcfg), strict=True)
    return jmodel, variables, pmodel.eval(), clip


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()
