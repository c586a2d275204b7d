"""PyTorch port, CFFM++'s cluster head (``models/cluster_head.py``) against
the JAX package's ``ClusterDecoder`` on the CPU, on carried weights (the
JAX init, every leaf moved by 0.02·N(0, 1) so that zero biases count):

- the output on plain centres, on a ``(centres, mask)`` pair with padded
  rows, and on bf16-rounded inputs: f32 sums in other orders, 1e-5 of the
  largest output (the residual keeps the output O(1));
- padded centres under the mask equal the valid subset alone (mirrors
  ``tests/test_heads_segmentor.py:149``);
- the parameter names are the reference's, as the JAX converter reads
  them (``utils/torch_convert.py:178-190``), and q uses the first C rows
  of ``attn.qkv``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vss_cffm_tpu.models.cluster_head import ClusterDecoder as JaxClusterDecoder
from vss_cffm_tpu_torch.models.cluster_head import ClusterDecoder

DIM, HEADS = 32, 4


def _carried(seed: int = 0):
    """(JAX module, its params, the port module on the same weights)."""
    jm = JaxClusterDecoder(dim=DIM, num_heads=HEADS)
    x = jnp.zeros((1, 3, 3, DIM), jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), x, jnp.zeros((1, 4, DIM)))["params"])
    rng = np.random.RandomState(seed + 1)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape))
                          .astype(np.float32), params)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    lin = lambda p: {"weight": t(p["kernel"].T), "bias": t(p["bias"])}
    norm = lambda p: {"weight": t(p["scale"]), "bias": t(p["bias"])}
    parts = {"norm1": norm(params["norm1"]), "norm2": norm(params["norm2"]),
             "attn.qkv": lin(params["attn"]["qkv"]),
             "attn.qkv_cluster": lin(params["attn"]["qkv_cluster"]),
             "attn.proj_cluster": lin(params["attn"]["proj_cluster"]),
             "mlp.fc1": lin(params["mlp_fc1"]), "mlp.fc2": lin(params["mlp_fc2"])}
    sd = {f"blocks.0.{m}.{k}": v for m, p in parts.items() for k, v in p.items()}
    pm = ClusterDecoder(DIM, HEADS)
    pm.load_state_dict(sd, strict=True)
    return jm, params, pm


@pytest.fixture(scope="module")
def carried():
    return _carried()


def _inputs(seed: int, k: int, pad: int = 0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 5, 7, DIM).astype(np.float32)
    centers = rng.randn(2, k + pad, DIM).astype(np.float32)
    mask = np.zeros((2, k + pad), bool)
    mask[:, :k] = True
    return x, centers, mask


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("masked", [False, True])
def test_cluster_decoder_matches_jax(carried, masked):
    jm, params, pm = carried
    x, centers, mask = _inputs(1, 10, pad=6 if masked else 0)
    arg = (jnp.asarray(centers), jnp.asarray(mask)) if masked else jnp.asarray(centers)
    want = jm.apply({"params": params}, jnp.asarray(x), arg)
    parg = ((torch.from_numpy(centers), torch.from_numpy(mask)) if masked
            else torch.from_numpy(centers))
    _close(pm(torch.from_numpy(x), parg), want)


def test_cluster_decoder_on_bf16_rounded_inputs_matches_jax(carried):
    """Tokens and centres rounded to bf16 first (the values the card's bf16
    features hold), computed in f32 on both sides."""
    jm, params, pm = carried
    x, centers, _ = _inputs(2, 100)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    centers = np.array(jnp.asarray(centers).astype(jnp.bfloat16).astype(jnp.float32))
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(centers))
    _close(pm(torch.from_numpy(x), torch.from_numpy(centers)), want)


def test_padded_mask_equals_the_subset(carried):
    _, _, pm = carried
    x, centers, mask = _inputs(3, 9, pad=3)
    subset = pm(torch.from_numpy(x), torch.from_numpy(centers[:, :9]))
    masked = pm(torch.from_numpy(x), (torch.from_numpy(centers), torch.from_numpy(mask)))
    np.testing.assert_allclose(masked.detach().numpy(), subset.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_parameter_names_are_the_references(carried):
    _, _, pm = carried
    want = {f"blocks.0.{m}.{k}" for m in ("norm1", "norm2", "attn.qkv", "attn.qkv_cluster",
                                          "attn.proj_cluster", "mlp.fc1", "mlp.fc2")
            for k in ("weight", "bias")}
    assert set(pm.state_dict()) == want
    attn = pm.blocks[0].attn
    assert tuple(attn.qkv.weight.shape) == (3 * DIM, DIM)
    x = torch.randn(2, 6, DIM)
    np.testing.assert_allclose(attn._q(x, torch.float32).detach().numpy(),
                               torch.nn.functional.linear(x, attn.qkv.weight, attn.qkv.bias)
                               [..., :DIM].detach().numpy(), rtol=1e-6, atol=1e-6)
