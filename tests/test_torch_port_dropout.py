"""PyTorch port, dropout above 0 in the MiT backbone and the CFFM decoder:

- at rate 0 the train forward is bit for bit the forward without dropout
  sites (no operation, no draw); in eval mode a rate of 0.1 is the identity
  and the inference ops keep their calls;
- in training at 0.1 the MiT blocks run composed (``mit_block_train`` not
  called, the JAX ``use_train_full`` gate) and the decoder's attention takes
  the plain probabilities path (``cfm_attention`` not called);
- ``dropout``'s kept share is within 4σ of 1 − p, kept values are x / (1 −
  p), and two ranks' shards of a draw are the one-process draw's rows;
  equal generator seeds give equal outputs, other seeds other masks;
- a B0 MiT block and a decoder block in training at 0.1 against the flax
  modules when both are handed the same numpy masks (``flax.linen.Dropout``
  and the port's ``keep_mask`` monkeypatched in this process only; the
  masks are drawn in call order, the JAX ones while the jitted apply
  traces), f32.
"""

from __future__ import annotations

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import eval_models, few_threads, to_np  # noqa: F401 (a fixture)
from vss_cffm_tpu.models.cffm_transformer import CFFMBlock as JaxCFFMBlock
from vss_cffm_tpu.models.mit import MiTBlock as JaxMiTBlock
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch import parallel
from vss_cffm_tpu_torch.models import CFFMSegmentor
from vss_cffm_tpu_torch.models import cffm_transformer as cffm
from vss_cffm_tpu_torch.models import mit
from vss_cffm_tpu_torch.models.segmentor import set_compute_dtype
from vss_cffm_tpu_torch.tools.export import op_calls

P = 0.1
HW = (64, 64)
# f32 on both sides, the same masks: sums in other orders only (as
# tests/test_torch_port_models.py)
TOL = dict(rtol=1e-4, atol=1e-4)


def _config(rate: float, backbone: str = "mit_b0") -> pcfg.SegmentorConfig:
    """B0 at decoder depth 1 with the decoder's dropout rates at ``rate``;
    the MiT rates are the registered variant's (``MIT_VARIANTS``), as in the
    JAX package."""
    cfg = pcfg.build_model_config("b0", num_classes=5)
    dec = dataclasses.replace(cfg.head.decoder, depth=1, drop=rate, attn_drop=rate,
                              drop_path=0.1)
    return dataclasses.replace(cfg, backbone=backbone,
                               head=dataclasses.replace(cfg.head, decoder=dec))


@pytest.fixture(scope="module")
def models(few_threads):
    """B0 port models at rates 0 and P (MiT ``drop_rate`` and
    ``attn_drop_rate``, the decoder's ``drop`` and ``attn_drop``) on one set
    of weights (PyTorch's default init), and a clip."""
    torch.manual_seed(0)
    m0 = CFFMSegmentor(_config(0.0))
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setitem(pcfg.MIT_VARIANTS, "mit_b0_drop", dataclasses.replace(
            pcfg.MIT_VARIANTS["mit_b0"], drop_rate=P, attn_drop_rate=P))
        mp = CFFMSegmentor(_config(P, "mit_b0_drop"))
    assert mp.backbone.block1[0].mlp.drop == mp.backbone.block4[1].attn.attn_drop == P
    mp.load_state_dict(m0.state_dict())
    clip = torch.from_numpy(np.random.RandomState(0).randn(1, 4, *HW, 3).astype(np.float32))
    return m0, mp, clip


def _train_forward(model, clip, seed: int):
    model.train()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        out = model(clip, train=True, generator=g)
    return out, g


def test_rate_zero_is_the_forward_without_dropout(models, monkeypatch):
    m0, _, clip = models
    x = torch.randn(3, 5)
    assert mit.dropout(x, 0.0, None) is x
    got, g_got = _train_forward(m0, clip, 3)
    monkeypatch.setattr(mit, "dropout", lambda x, *a, **k: x)
    monkeypatch.setattr(cffm, "dropout", lambda x, *a, **k: x)
    want, g_want = _train_forward(m0, clip, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(g_got.get_state(), g_want.get_state())


def test_eval_mode_is_the_identity(models):
    m0, mp, clip = models
    mp.load_state_dict(m0.state_dict())  # the BN statistics a train forward moved
    with torch.no_grad():
        (want, calls0) = op_calls(m0.eval(), clip)
        (got, calls) = op_calls(mp.eval(), clip)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert calls == calls0 == {"vss_cffm::cfm_attention": 1, "vss_cffm::dwconv3x3": 4,
                               "vss_cffm::mit_block_fused": 4}


def _counted(monkeypatch, module, name: str) -> list:
    calls = []
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_train_routes(models, monkeypatch):
    """At 0.1: composed MiT blocks and the probabilities path; at 0: the
    default form's pair (stages 1-3 of B0 at 64², whose gate passes) and
    the attention op."""
    m0, mp, clip = models
    counts = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": _counted(monkeypatch, mod, name)
              for mod, name in ((mit, "mit_block_train"), (cffm, "cfm_attention"),
                                (cffm, "_attention_with_dropout"), (mit, "dropout"),
                                (cffm, "dropout"))}
    assert m0.config.backbone_config.train_block_impl == ("full", "full", "full", None)
    _train_forward(mp, clip, 0)
    # 4 sites in each of the 8 MiT blocks; 4 in the decoder block: the
    # probabilities, the projection and the MLP's two
    assert {k: len(v) for k, v in counts.items()} == {
        "mit.mit_block_train": 0, "cffm_transformer.cfm_attention": 0,
        "cffm_transformer._attention_with_dropout": 1, "mit.dropout": 8 * 4,
        "cffm_transformer.dropout": 4}
    for v in counts.values():
        v.clear()
    _train_forward(m0, clip, 0)
    assert len(counts["mit.mit_block_train"]) == 6
    assert len(counts["cffm_transformer.cfm_attention"]) == 1
    assert len(counts["cffm_transformer._attention_with_dropout"]) == 0


def test_draws_keep_and_scale(monkeypatch):
    g = torch.Generator().manual_seed(0)
    n = 200_000
    x = torch.full((n // 100, 100), 3.0)
    y = mit.dropout(x, P, g)
    kept = y != 0
    share = kept.float().mean().item()
    assert abs(share - (1 - P)) <= 4 * np.sqrt(P * (1 - P) / n)
    assert torch.equal(y[kept], torch.full_like(y[kept], 3.0) / (1 - P))
    # bf16: divided by the keep probability rounded to bf16, as JAX's weak scalar
    yb = mit.dropout(x.bfloat16(), P, torch.Generator().manual_seed(0))
    assert torch.equal(yb != 0, kept)
    assert torch.equal(yb[kept], (x.bfloat16() / torch.tensor(1 - P).bfloat16().item())[kept])
    # two ranks of a data split take their rows of the one-process draw
    x = torch.randn(4, 6, 5)
    whole = mit.dropout(x, P, torch.Generator().manual_seed(5))
    for r in range(2):
        part = mit.dropout(x[2 * r:2 * r + 2], P, torch.Generator().manual_seed(5),
                           parallel.DrawShard(data=2, data_index=r))
        torch.testing.assert_close(part, whole[2 * r:2 * r + 2], rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        mit.dropout(x, 1.0, torch.Generator())
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        CFFMSegmentor(_config(1.0))


def test_equal_seeds_equal_outputs(models):
    _, mp, clip = models
    a, _ = _train_forward(mp, clip, 7)
    b, _ = _train_forward(mp, clip, 7)
    c, _ = _train_forward(mp, clip, 8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all() and not torch.equal(a, c)


# ---- against the flax modules, with the same numpy masks ----------------------


class _Masks:
    """The i-th draw of either package: RandomState(100 + i) uniforms < 1 − P."""

    def __init__(self):
        self.i = 0
        self.sizes = []

    def __call__(self, n: int) -> np.ndarray:
        self.sizes.append(n)
        u = np.random.RandomState(100 + self.i).rand(n)
        self.i += 1
        return u < 1.0 - P


@pytest.fixture(scope="module")
def jax_pair(few_threads):
    _, variables, pm = eval_models()
    return variables["params"], pm


def _with_masks(monkeypatch):
    jax_masks, port_masks = _Masks(), _Masks()

    def flax_dropout(self, inputs, deterministic=None, rng=None):
        deterministic = fnn.merge_param("deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        keep = jnp.asarray(jax_masks(inputs.size).reshape(inputs.shape))
        return jnp.where(keep, inputs / (1.0 - self.rate), jnp.zeros_like(inputs))

    monkeypatch.setattr(fnn.Dropout, "__call__", flax_dropout)
    monkeypatch.setattr(mit, "keep_mask", lambda n, rate, generator, device, shard=None:
                        torch.from_numpy(port_masks(n)))
    return jax_masks, port_masks


def test_mit_block_matches_flax(jax_pair, monkeypatch):
    params, pm = jax_pair
    jax_masks, port_masks = _with_masks(monkeypatch)
    blk = mit.MiTBlock(32, 1, 8, 4, True, 1e-6, fused=False, drop=P, attn_drop=P).train()
    blk.load_state_dict(pm.backbone.block1[0].state_dict())
    x = np.random.RandomState(1).randn(2, 16, 24, 32).astype(np.float32)
    jblk = JaxMiTBlock(dim=32, num_heads=1, sr_ratio=8, mlp_ratio=4, qkv_bias=True, drop=P,
                       attn_drop=P, drop_path_rate=0.0, norm_eps=1e-6)
    want = jax.jit(lambda p, x: jblk.apply({"params": p}, x, False))(
        params["backbone"]["block1_0"], jnp.asarray(x))
    with torch.no_grad():
        got = blk(torch.from_numpy(x), train=True, generator=torch.Generator())
    # attention probabilities, proj, after the GELU, after fc2
    assert port_masks.sizes == jax_masks.sizes == [2 * 384 * 6, 2 * 384 * 32,
                                                   2 * 384 * 128, 2 * 384 * 32]
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_decoder_block_matches_flax(jax_pair, monkeypatch):
    params, pm = jax_pair
    jax_masks, port_masks = _with_masks(monkeypatch)
    pdec = pm.config.head.decoder
    cfg = dataclasses.replace(pdec, drop=P, attn_drop=P, drop_path=0.0)
    blk = cffm.CFFMBlock(cfg).train()
    blk.load_state_dict(pm.decode_head.decoder_focal.blocks[0].state_dict())
    set_compute_dtype(blk, torch.float32)
    from vss_cffm_tpu.models.cffm_transformer import CFFMDecoderConfig as JaxDecoderConfig

    jcfg = JaxDecoderConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(JaxDecoderConfig) if hasattr(cfg, f.name)})
    x = np.random.RandomState(2).randn(1, 4, 9, 11, cfg.dim).astype(np.float32)
    want = jax.jit(lambda p, x: JaxCFFMBlock(jcfg).apply({"params": p}, x, False))(
        params["decode_head"]["decoder_focal"]["blocks_0"], jnp.asarray(x))
    with torch.no_grad():
        got = blk(torch.from_numpy(x), train=True, generator=torch.Generator())
    # probabilities, proj, after the GELU, after fc2
    assert port_masks.sizes == jax_masks.sizes and len(port_masks.sizes) == 4
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
