"""Weight bridge from the JAX package's variables to the port's ``state_dict``.

``state_dict_from_jax(variables, config)`` takes the JAX segmentor's
``{"params", "batch_stats"}`` tree (numpy or array-like leaves) and returns
the port's ``state_dict`` under the reference PyTorch names. It is the exact
inverse of ``vss_cffm_tpu/utils/torch_convert.py:convert_segmentor`` in
``cffm`` mode:

  dense kernel (in, out)            → Linear weight (out, in)
  conv kernel (kh, kw, in, out)     → Conv2d weight (out, in, kh, kw)
  depthwise kernel (3, 3, 1, C)     → (C, 1, 3, 3)
  norm scale / bias                 → weight / bias
  merged fuse kernel (4f, f)        → linear_fuse.conv.weight (f, 4f, 1, 1)
  neighbour bias (nh, 49, n)        → (1, nh, 49, n)
  pooling kernel (n, 1)             → pool_layers.k.weight (1, n)
  BN batch_stats mean / var         → running_mean / running_var
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..config import SegmentorConfig

__all__ = ["state_dict_from_jax"]


def _t(a: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


class _Writer:
    def __init__(self):
        self.sd: dict[str, torch.Tensor] = {}

    def linear(self, prefix: str, p: Mapping) -> None:
        self.sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
        if "bias" in p:
            self.sd[f"{prefix}.bias"] = _t(p["bias"])

    def conv(self, prefix: str, p: Mapping) -> None:
        self.sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        if "bias" in p:
            self.sd[f"{prefix}.bias"] = _t(p["bias"])

    def norm(self, prefix: str, p: Mapping) -> None:
        self.sd[f"{prefix}.weight"] = _t(p["scale"])
        self.sd[f"{prefix}.bias"] = _t(p["bias"])


def _backbone(w: _Writer, p: Mapping, depths: tuple[int, ...]) -> None:
    for s in range(4):
        i = s + 1
        w.conv(f"backbone.patch_embed{i}.proj", p[f"patch_embed{i}"]["proj"])
        w.norm(f"backbone.patch_embed{i}.norm", p[f"patch_embed{i}"]["norm"])
        for j in range(depths[s]):
            blk, pre = p[f"block{i}_{j}"], f"backbone.block{i}.{j}"
            w.norm(f"{pre}.norm1", blk["norm1"])
            for name in ("q", "kv", "proj"):
                w.linear(f"{pre}.attn.{name}", blk["attn"][name])
            if "sr" in blk["attn"]:
                w.conv(f"{pre}.attn.sr", blk["attn"]["sr"])
                w.norm(f"{pre}.attn.norm", blk["attn"]["norm"])
            w.norm(f"{pre}.norm2", blk["norm2"])
            w.linear(f"{pre}.mlp.fc1", blk["mlp"]["fc1"])
            w.conv(f"{pre}.mlp.dwconv.dwconv", blk["mlp"]["dwconv"])
            w.linear(f"{pre}.mlp.fc2", blk["mlp"]["fc2"])
        w.norm(f"backbone.norm{i}", p[f"norm{i}"])


def _cffm_block(w: _Writer, p: Mapping, pre: str) -> None:
    w.norm(f"{pre}.norm1", p["norm1"])
    w.norm(f"{pre}.norm2", p["norm2"])
    a = p["attn"]
    w.sd[f"{pre}.attn.qkv.weight"] = _t(np.asarray(a["qkv_kernel"]).T)
    if "qkv_bias" in a:
        w.sd[f"{pre}.attn.qkv.bias"] = _t(a["qkv_bias"])
    w.linear(f"{pre}.attn.proj", a["proj"])
    w.sd[f"{pre}.attn.relative_position_bias_table"] = _t(a["relative_position_bias_table"])
    w.sd[f"{pre}.attn.relative_position_bias_table_to_neighbors"] = _t(
        np.asarray(a["relative_position_bias_to_neighbors"])[None])
    for name, prefix in (("relative_position_bias_to_windows_", "to_windows"),
                         ("relative_position_bias_to_windows_clips_", "to_windows_clips")):
        ks = sorted(int(k[len(name):]) for k in a
                    if k.startswith(name) and k[len(name):].isdigit())
        for k in ks:
            w.sd[f"{pre}.attn.relative_position_bias_table_{prefix}.{k}"] = _t(a[f"{name}{k}"])
    w.linear(f"{pre}.mlp.fc1", p["mlp"]["fc1"])
    w.linear(f"{pre}.mlp.fc2", p["mlp"]["fc2"])
    for name, prefix in (("pool_layers_clips_", "pool_layers_clips"),
                         ("pool_layers_", "pool_layers")):
        ks = sorted(int(k[len(name):]) for k in p
                    if k.startswith(name) and k[len(name):].isdigit())
        for k in ks:
            w.linear(f"{pre}.{prefix}.{k}", p[f"{name}{k}"])


def state_dict_from_jax(variables: Mapping, config: SegmentorConfig) -> dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    w = _Writer()
    _backbone(w, params["backbone"], config.backbone_config.depths)
    head, h = params["decode_head"], "decode_head"
    dec = head["decode"]
    for i in (1, 2, 3, 4):
        w.linear(f"{h}.linear_c{i}.proj", dec[f"linear_c{i}"]["proj"])
    w.sd[f"{h}.linear_fuse.conv.weight"] = _t(np.asarray(dec["fuse_kernel"]).T[:, :, None, None])
    w.norm(f"{h}.linear_fuse.bn", dec["bn"])
    bn = stats["decode_head"]["decode"]["bn"]
    w.sd[f"{h}.linear_fuse.bn.running_mean"] = _t(bn["mean"])
    w.sd[f"{h}.linear_fuse.bn.running_var"] = _t(bn["var"])
    w.sd[f"{h}.linear_fuse.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    w.conv(f"{h}.linear_pred", head["linear_pred"])
    w.conv(f"{h}.linear_pred2", head["linear_pred2"])
    for i in range(config.head.decoder.depth):
        _cffm_block(w, head["decoder_focal"][f"blocks_{i}"], f"{h}.decoder_focal.blocks.{i}")
    return w.sd
