"""PyTorch port, on the CPU: the key-tiled attention (row 1's attention step
at test-time augmentation's key counts, ``attention_fwd_tiled``). K scaled
once by the wrapper, a plain-torch replay of the kernel's decomposition
(128-row blocks, 64-key tiles, statistics per 16-key group in the resident
instance's order, P·V per 16-key step) against the plain attention and,
through the port's plain block steps, against the JAX block's Pallas kernel
in interpret mode, and a mirror of the kernel's TMA ring and swizzled tiles
(``cfm_attention.tiled_plan``)."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vss_cffm_tpu.ops.stage_block import mit_block_fused as jax_mit_block_fused
from vss_cffm_tpu_torch.ops._dispatch import SMEM_LIMIT

# the modules (the package's namespace holds functions of the same names)
cfm = importlib.import_module("vss_cffm_tpu_torch.ops.cfm_attention")
stage_block = importlib.import_module("vss_cffm_tpu_torch.ops.stage_block")

FLT_MAX = float(np.finfo(np.float32).max)


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(torch.bfloat16)


def test_k_scaled_once_gives_the_kernels_bits():
    """K·k_scale rounded to bf16 by the wrapper (one elementwise pass) is
    bf16(f32(k)·k_scale), the bits the kernel's own scaling of K gave, and
    through the plain attention it gives bit for bit the output of k_scale
    applied inside, at stage 2's 920 keys (heads of 64, and of 32 where the
    scale is not a power of two)."""
    rng = np.random.RandomState(0)
    for hd in (64, 32):
        q, k, v = _bf16(rng, 2, 100, 2 * hd), _bf16(rng, 2, 920, 2 * hd), _bf16(rng, 2, 920, 2 * hd)
        ks = cfm.scale_in(torch.bfloat16, hd ** -0.5)
        want_k = torch.from_numpy(k.float().numpy() * np.float32(ks)).to(torch.bfloat16)
        assert torch.equal(k * ks, want_k)
        inside = cfm.attention_torch(q, k, v, None, None, 2, 1.0, ks)
        outside = cfm.attention_torch(q, k * ks, v, None, None, 2, 1.0, 1.0)
        assert torch.equal(inside, outside)


def replay_tiled(q, k, v, bias, mask, nh: int, q_scale: float, k_scale: float) -> torch.Tensor:
    """The key-tiled kernel's decomposition in plain torch, on q (G, Lq, C)
    and K, V (G, N, C): blocks of 128 query rows; 64-key tiles; pass 1 keeps
    each row's running max and sum of exps per quad lane t (keys 2t, 2t + 1,
    8 + 2t, 9 + 2t of every 16-key group below round16(N), in
    ``vss::softmax_step``'s order), combined across the lanes as
    ``vss::softmax_rows`` does (xor 1, then xor 2); pass 2 forms p = exp(s -
    max) / sum, rounded to q's dtype, and sums P·V in f32 per 16-key step in
    key order; one cast at the end."""
    dt = q.dtype
    g, lq, c = q.shape
    n, hd = k.shape[1], c // nh
    qh = cfm._heads(q * q_scale if q_scale != 1.0 else q, nh).float()
    kh = cfm._heads(k * k_scale if k_scale != 1.0 else k, nh).float()
    vh = cfm._heads(v, nh).float()
    np16, tiles = -(-n // 16) * 16, -(-n // cfm.TILED_KEYS)
    out = torch.empty(g, nh, lq, hd)
    lanes = torch.arange(4)
    cols = torch.stack([2 * lanes, 2 * lanes + 1, 8 + 2 * lanes, 9 + 2 * lanes], -1)  # (4, 4)
    for r0 in range(0, lq, cfm.TILED_ROWS):
        rows = slice(r0, min(r0 + cfm.TILED_ROWS, lq))
        s = qh[:, :, rows] @ kh.transpose(-1, -2)                      # (G, nh, R, N)
        if bias is not None:
            s = (s + bias.float()[None, :, rows]) + mask.float()[:, None, None, :]
        s = torch.cat([s, torch.full((*s.shape[:3], tiles * cfm.TILED_KEYS - n), -torch.inf)], -1)
        mx = torch.full((*s.shape[:3], 4), -FLT_MAX)
        sm = torch.zeros_like(mx)
        for t in range(tiles):
            for n0 in range(t * cfm.TILED_KEYS, (t + 1) * cfm.TILED_KEYS, 16):
                if n0 >= np16:
                    continue
                sg = s[..., n0 + cols]                                  # (G, nh, R, 4, 4)
                mt = torch.maximum(torch.maximum(sg[..., 0], sg[..., 1]),
                                   torch.maximum(sg[..., 2], sg[..., 3]))
                mn = torch.maximum(mx, mt)
                acc = sm * torch.exp(mx - mn)
                for e in range(4):
                    acc = acc + torch.exp(sg[..., e] - mn)
                mx, sm = mn, acc
        for o in (1, 2):
            m2, s2 = mx[..., lanes ^ o], sm[..., lanes ^ o]
            mn = torch.maximum(mx, m2)
            sm = sm * torch.exp(mx - mn) + s2 * torch.exp(m2 - mn)
            mx = mn
        mrow, srow = mx[..., :1], sm[..., :1]  # every lane holds the row's statistics
        acc = torch.zeros(*s.shape[:3], hd)
        for t in range(tiles):
            for n0 in range(t * cfm.TILED_KEYS, (t + 1) * cfm.TILED_KEYS, 16):
                if n0 >= np16:
                    continue
                p = (torch.exp(s[..., n0:n0 + 16] - mrow) / srow).to(dt).float()
                vs = torch.cat([vh[:, :, n0:n0 + 16], torch.zeros(g, nh, max(0, n0 + 16 - n), hd)],
                               2)[:, :, :16]
                acc = acc + p @ vs
        out[:, :, rows] = acc
    return cfm._merge(out.to(dt))


@pytest.mark.parametrize("case", [(n, lq) for n in (37, 65, 1269) for lq in (1, 63, 129)]
                         + ["jax_block"], ids=lambda c: c if isinstance(c, str) else
                         f"n{c[0]}-lq{c[1]}")
def test_tiled_replay_matches_the_plain_attention(case):
    """The replay against ``attention_torch``: in f32 within 1e-6 of the
    largest output (the statistics are taken online, in another order than
    torch.softmax's), in bf16 with >= 99 % of the elements bitwise equal
    (p rounds to bf16 at the same point; a sum in another order may move a
    rounding by one ulp). ``jax_block``: the replay as the attention step of
    the port's plain block, against the JAX block's Pallas kernel in
    interpret mode at S 150 (two of its 128-key tiles), in f32 at the block
    tests' tolerance."""
    rng = np.random.RandomState(1)
    if case == "jax_block":
        b, h, w, c, ch, s, nh = 1, 4, 5, 64, 128, 150, 2
        f = lambda *sh, sc=0.05: (rng.randn(*sh) * sc).astype(np.float32)
        p = dict(x=f(b, h, w, c, sc=1.0), g1=1.0 + f(c, sc=0.1), be1=f(c), wq=f(c, c), bq=f(c),
                 k=f(b, s, c, sc=0.2), v=f(b, s, c, sc=0.2), wproj=f(c, c), bproj=f(c),
                 g2=1.0 + f(c, sc=0.1), be2=f(c), w1=f(c, ch), b1=f(ch),
                 kdw=f(3, 3, 1, ch, sc=0.2), bdw=f(ch), w2=f(ch, c), b2=f(c))
        want = np.asarray(jax_mit_block_fused(*[jnp.asarray(a) for a in p.values()],
                                              num_heads=nh, eps=1e-6, interpret=True))
        t = {name: torch.from_numpy(a) for name, a in p.items()}
        steps = stage_block._block_steps(*t.values(), num_heads=nh, eps=1e-6, kernel=False)
        ks = cfm.scale_in(torch.float32, (c // nh) ** -0.5)
        steps["ctx"] = lambda qf: replay_tiled(qf.view(b, h * w, c), t["k"], t["v"], None, None,
                                               nh, 1.0, ks).view(b * h * w, c)
        got = stage_block._run(steps)["out"].view(b, h, w, c).numpy()
        np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
        return
    n, lq = case
    nh, hd = 2, 64
    q, k, v = _bf16(rng, 2, lq, nh * hd), _bf16(rng, 2, n, nh * hd), _bf16(rng, 2, n, nh * hd)
    ks = cfm.scale_in(torch.bfloat16, hd ** -0.5)
    qf, kf, vf = q.float(), (k * ks).float(), v.float()
    got = replay_tiled(qf, kf, vf, None, None, nh, 1.0, 1.0)
    want = cfm.attention_torch(qf, kf, vf, None, None, nh, 1.0, 1.0)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    got = replay_tiled(q, k, v, None, None, nh, 1.0, ks)
    want = cfm.attention_torch(q, k, v, None, None, nh, 1.0, ks)
    assert got.dtype == want.dtype == torch.bfloat16
    assert (got.view(torch.int16) == want.view(torch.int16)).float().mean().item() >= 0.99


def _tma_offset(row: int, col: int, row_bytes: int) -> int:
    """Where TMA puts element (row, col) of a bf16 box with rows of row_bytes
    under the swizzle of that width: the 16-byte chunk index XORed with
    address bits 7-9 (128 bytes) or 7-8 (64 bytes) of the unswizzled offset."""
    return _swizzle(row * row_bytes + col * 2, row_bytes)


def _swizzle(addr: int, row_bytes: int) -> int:
    bits = 7 if row_bytes == 128 else 3  # the XOR mask of chunk bits 4-6 or 4-5
    return addr ^ (((addr >> 7) & bits) << 4)


@pytest.mark.parametrize("n", [16, 17, 64, 65, 405, 920, 1269, 2048])
def test_tiled_ring_plan_covers_every_key_once(n):
    """The mirror of the kernel's ring at N keys, for heads of 64 and 32:
    each pass's tiles hold every key below N once (TMA zero-fills the last
    tile's rows past N); no consumer waits for an entry whose stage the
    producer cannot yet refill (a consumer holds up to three entries: pass
    2's tile t - 1 for its P·V, tile t, and tile t + 1 for the next scores);
    the rings and barriers fit a block's shared memory, tiles on 1024-byte
    boundaries; and the wgmma descriptors' addresses (K-major K: 8-row groups
    8·row bytes apart, k-steps 32 bytes; MN-major V: 16-row steps) read each
    element where TMA's swizzle wrote it."""
    for hd in (64, 32):
        plan = cfm.tiled_plan(n, hd)
        tiles, entries, stages = plan["tiles"], plan["entries"], cfm.TILED_STAGES
        assert len(entries) == 2 * tiles and stages >= 3
        for pass_ in (1, 2):
            keys = [t * cfm.TILED_KEYS + r for p_, t, _, _ in entries if p_ == pass_
                    for r in range(cfm.TILED_KEYS)]
            assert sorted(x for x in keys if x < n) == list(range(n))
            assert sum(x >= n for x in keys) == tiles * cfm.TILED_KEYS - n < cfm.TILED_KEYS
        for i, (_, _, stage, rnd) in enumerate(entries):
            assert (stage, rnd) == (i % stages, i // stages)
        # the consumers' waits: pass 1 tile t releases entry t, then waits for
        # t + 1; pass 2 tile t waits for nt + t + 1 and then releases nt + t - 1
        released = -1
        for t in range(tiles):
            released = t
            assert (t + 1) - stages <= released
        for t in range(tiles - 1):
            assert (tiles + t + 1) - stages <= released
            released = tiles + t - 1 if t > 0 else released
        assert plan["smem_bytes"] <= SMEM_LIMIT
        assert plan["tile_bytes"] % 1024 == 0 and plan["swizzle"] == hd * 2
        rb, sbo = plan["swizzle"], 8 * plan["swizzle"]
        for kk in range(hd // 16):  # q·Kᵀ: K-major, start + 32 bytes a k-step
            for key in range(cfm.TILED_KEYS):
                for j in range(16):
                    read = _swizzle(32 * kk + (key // 8) * sbo + (key % 8) * rb + 2 * j, rb)
                    assert read == _tma_offset(key, 16 * kk + j, rb)
        for step in range(cfm.TILED_KEYS // 16):  # P·V: V MN-major, 16 rows a k-step
            for key in range(16):
                for ch in range(hd):
                    read = _swizzle(step * 16 * rb + (key // 8) * sbo + (key % 8) * rb + 2 * ch,
                                    rb)
                    assert read == _tma_offset(16 * step + key, ch, rb)


def test_probe_variants_match_the_source():
    """The card-side probe (``tools/probe_tiled_attention.py``) builds its
    variants by replacing lines of ``csrc/attention.cu``: each line it
    replaces is there, once."""
    from vss_cffm_tpu_torch.ops import _build
    from vss_cffm_tpu_torch.tools import probe_tiled_attention as probe

    with open(f"{_build.CSRC}/attention.cu") as fh:
        src = fh.read()
    for subs in [*probe.VARIANTS.values(), probe.COUNTERS]:
        for old, _ in subs:
            assert src.count(old) == 1, old[:60]
