"""PyTorch port, the slice as a whole: the port's CFFMSegmentor against the JAX
CFFMSegmentor (f32 logits) at two geometries, and the weight bridge."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import jax_and_port, jax_config, port_config, to_np
from vss_cffm_tpu.models.segmentor import CFFMSegmentor as JaxSegmentor
from vss_cffm_tpu.utils.torch_convert import convert_segmentor
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.utils import state_dict_from_jax

# f32 end to end through backbone, decode and decoder: sums in other orders
# leave ~1e-6 on logits of O(0.1..1); 1e-4 is two orders of margin.
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair_14x14():
    # decoder map (14, 14); JAX stages 2-3 composed (its "fused" form off-TPU)
    return jax_and_port("b0", hw=(112, 112), depth=2)


def _check_logits(jm, var, pm, clip):
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(var, jnp.asarray(clip)))
    with torch.no_grad():
        got = pm(torch.from_numpy(clip))
    h, w = clip.shape[2:4]
    assert tuple(got.shape) == want.shape == (1, h // 4, w // 4, 7)
    np.testing.assert_allclose(to_np(got), want, **TOL)


def test_segmentor_matches_jax_14x14(pair_14x14):
    _check_logits(*pair_14x14)


def test_segmentor_matches_jax_9x11_with_pallas_block():
    """Decoder map (9, 11); on the JAX side the Pallas whole-block kernel
    itself, interpreted, serves stages 2 and 3."""
    _check_logits(*jax_and_port("b0", hw=(72, 88), depth=2,
                                jax_block_impl=(None, "fused-interpret",
                                                "fused-interpret", None)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_weight_bridge_round_trips_exactly(pair_14x14):
    """JAX init → state_dict_from_jax → convert_segmentor → the same tree,
    bit for bit; the port took the state_dict with strict loading."""
    jm, variables, _, _ = pair_14x14
    sd = state_dict_from_jax(variables, jm.config)
    back = convert_segmentor({k: v.numpy() for k, v in sd.items()}, jm.config)
    want, got = _flat(jax.device_get(variables)), _flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.shape(got[k]) == np.shape(want[k]), k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_port_init_converts_to_the_jax_tree():
    """The port's own random init, converted by the JAX package's
    ``convert_segmentor``, has exactly the JAX model's parameter tree."""
    jcfg = jax_config("b1", num_classes=11, depth=2)
    pm = CFFMSegmentor(port_config(jcfg))
    pm.init_weights(torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    got = _flat(convert_segmentor(sd, jcfg))
    shapes = jax.eval_shape(JaxSegmentor(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 64, 64, 3), jnp.float32))
    want = _flat(shapes)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.shape(got[k]) == tuple(want[k].shape), k


def test_derived_weights_follow_the_parameters():
    """Weights cast, laid out or gathered once per parameter value
    (``models.mit.derived``) are reused from call to call, and made anew
    after ``load_state_dict``: the reloaded model then gives exactly the
    logits of a model built with those weights."""
    from vss_cffm_tpu_torch import apis

    a = apis.init_segmentor("b0", device="cpu", dtype=torch.bfloat16, seed=0).model
    b = apis.init_segmentor("b0", device="cpu", dtype=torch.bfloat16, seed=1).model
    clip = torch.from_numpy(np.random.RandomState(0).randn(1, 4, 64, 64, 3).astype(np.float32))
    q = a.backbone.block1[0].attn.q
    with torch.inference_mode():
        first = a(clip)
        cached = q.__dict__["_derived"][("weight", torch.bfloat16)][1]
        assert cached.dtype == torch.bfloat16
        torch.testing.assert_close(a(clip), first, rtol=0, atol=0)
        assert q.__dict__["_derived"][("weight", torch.bfloat16)][1] is cached
        a.load_state_dict(b.state_dict())
        got, want = a(clip), b(clip)
    assert q.__dict__["_derived"][("weight", torch.bfloat16)][1] is not cached
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, first)
