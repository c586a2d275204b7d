"""The frozen counts against sums written out by hand at small shapes."""

import json
import os

from portbench.counts import cffm
from portbench.counts import (ce_upsampled_loss, ce_upsampled_loss_bwd, cfm_attention,
                              cfm_attention_bwd, dwconv3x3, mit_block_fused, mit_block_train,
                              mit_block_train_bwd)
from portbench.tests.tiny import ROOT

SHAPE = {"n": 2, "h": 4, "w": 6, "c": 8, "ch": 32, "nh": 2, "s": 6}


def test_block_forward_work_by_hand():
    # m = 48 tokens
    nbytes, tensor, f32 = mit_block_fused.work(SHAPE)
    x_kv = 48 * 8 * 2 + 2 * 2 * 6 * 8 * 2
    weights = (2 * 64 + 2 * 256) * 2
    vectors = (7 * 8 + 11 * 32) * 4
    assert nbytes == x_kv + weights + vectors + 48 * 8 * 2
    assert tensor == 4 * 48 * 64 + 4 * 48 * 6 * 8 + 4 * 48 * 8 * 32
    assert f32 == 16 * 48 * 8 + 5 * 48 * 2 * 6 + 5 * 48 * 8 + 27 * 48 * 32


def test_block_train_pair_work_by_hand():
    fb, ft, ff = mit_block_fused.work(SHAPE, w_bytes=4)
    nbytes, tensor, f32 = mit_block_train.work(SHAPE)
    assert (nbytes, tensor, f32) == (fb + 2 * 2 * 4, ft, ff + 2 * 48 * 8)
    bb, bt, bf = mit_block_train_bwd.work(SHAPE)
    grads = 48 * 8 * 2 + 2 * 2 * 6 * 8 * 2 + (2 * 64 + 2 * 256 + 7 * 8 + 11 * 32) * 4
    assert bb == nbytes - 48 * 8 * 2 + 48 * 8 * 2 + grads
    assert (bt, bf) == (2 * tensor, 2 * f32)


def test_small_ops_by_hand():
    assert dwconv3x3.work({"n": 1, "h": 2, "w": 3, "ch": 4}) == (2 * 6 * 4 * 2 + 10 * 4 * 4,
                                                                0.0, 27.0 * 6 * 4)
    att = {"nw": 3, "lq": 49, "keys": 10, "c": 16, "nh": 2}
    nb, t, f = cfm_attention.work(att)
    assert nb == 2 * 147 * 16 * 2 + 2 * 3 * 10 * 16 * 2 + 2 * 49 * 10 * 4 + 3 * 10 * 4
    assert (t, f) == (4.0 * 147 * 10 * 16, 7.0 * 147 * 2 * 10)
    nb2, t2, f2 = cfm_attention_bwd.work(att)
    assert nb2 == nb + 147 * 16 * 2 + 2 * 3 * 10 * 16 * 2 + 2 * 49 * 10 * 4
    assert (t2, f2) == (2 * t, 2 * f)
    ce = {"n": 2, "h": 3, "w": 5, "k": 7, "s": 4}
    pixels = 2 * 12 * 20
    assert ce_upsampled_loss.work(ce) == (2 * 15 * 7 * 2 + pixels + 8, 0.0,
                                          10.0 * pixels * 7 + 4.0 * pixels)
    assert ce_upsampled_loss_bwd.work(ce) == (2 * 2 * 15 * 7 * 2 + pixels + 4, 0.0,
                                              20.0 * pixels * 7)


def _tiny_cfg():
    with open(os.path.join(ROOT, "portbench", "configs", "cffm_b1.json")) as f:
        cfg = json.load(f)
    cfg.update(embed_dims=[2, 4, 6, 8], depths=[1, 1, 1, 1], num_heads=[1, 1, 1, 1],
               mlp_ratios=[2, 2, 2, 2], sr_ratios=[2, 1, 1, 1], embed_dim=4, num_classes=3,
               decoder=dict(cfg["decoder"], dim=4, depth=1, mlp_ratio=2.0))
    return cfg


def test_backbone_flops_by_hand():
    cfg = _tiny_cfg()
    # 32 x 32 frame: stage maps 8x8, 4x4, 2x2, 1x1
    s1 = 2 * 64 * 2 * 3 * 49 + (2 * 64 * 4 * 2 + 2 * 16 * 2 * 4 + 4 * 64 * 16 * 2
                                 + 2 * 64 * 2 * 4 * 2 + 18 * 64 * 4 + 2 * 16 * 4 * 4)
    s2 = 2 * 16 * 4 * 2 * 9 + (2 * 16 * 16 * 2 + 2 * 16 * 4 * 8 + 4 * 16 * 16 * 4
                               + 2 * 16 * 4 * 8 * 2 + 18 * 16 * 8)
    s3 = 2 * 4 * 6 * 4 * 9 + (2 * 4 * 36 * 2 + 2 * 4 * 6 * 12 + 4 * 4 * 4 * 6
                              + 2 * 4 * 6 * 12 * 2 + 18 * 4 * 12)
    s4 = 2 * 1 * 8 * 6 * 9 + (2 * 64 * 2 + 2 * 8 * 16 + 4 * 8 + 2 * 8 * 16 * 2 + 18 * 16)
    assert cffm.backbone_flops(cfg, 32, 32) == s1 + s2 + s3 + s4


def test_decode_and_head_flops_by_hand():
    cfg = _tiny_cfg()
    # decode of a 32 x 32 frame: maps 8x8 (c 2), 4x4 (4), 2x2 (6), 1x1 (8), f = 4
    proj = 2 * 4 * (64 * 2 + 16 * 4 + 4 * 6 + 1 * 8)
    assert cffm.decode_flops(cfg, 32, 32, False) == proj + 3 * 7 * 64 * 4 + 2 * 64 * 16 * 4
    assert cffm.decode_flops(cfg, 32, 32, True) == cffm.decode_flops(cfg, 32, 32, False) + \
        2 * 64 * 4 * 3
    # the decoder on a 4x4 map: padded to 7x7, one window, 289 keys; sources:
    # target level 1 token (7x7 pool), clips 1, 4, 9 tokens (pools 7, 3, 2; the
    # last two resized to 6x6)
    g = cffm.decoder_geometry(cfg["decoder"], 4, 4)
    assert (g["nw"], g["keys"]) == (1, 49 + 132 + 25 + 49 + 25 + 9)
    c = 4
    block = 2 * 49 * c * 3 * c
    for tokens, pw, resized in ((1, 7, 0), (1, 7, 0), (4, 3, 36), (9, 2, 36)):
        block += 7 * resized * c + 2 * tokens * pw * pw * c + 2 * tokens * c * 2 * c
    block += 4 * 49 * 289 * c + 2 * 49 * c * c + 4 * 16 * c * 8
    head = 7 * 4 * 16 * 4 + block + 2 * 16 * 8 * 3 + 7 * 64 * 3
    assert cffm.head_clip_flops(cfg, 4, 8, 8) == head


def test_step_and_eval_totals_compose():
    cfg = _tiny_cfg()
    fwd = 2 * 4 * (cffm.backbone_flops(cfg, 32, 32) + cffm.decode_flops(cfg, 32, 32, True))
    fwd += 2 * cffm.head_clip_flops(cfg, 4, 8, 8) + 2 * 5 * 7 * 32 * 32 * 3
    assert cffm.train_step_flops(cfg, 2, 4, 32, 32) == 3 * fwd
    one = cffm.eval_clip_flops(cfg, 1, (32, 32), (32, 32))
    assert one == cffm.backbone_flops(cfg, 32, 32) + cffm.decode_flops(cfg, 32, 32, True) + \
        2 * 7 * 32 * 32 * 3


def test_call_lists_follow_the_block_forms():
    cfg = _tiny_cfg()
    cfg.update(train_block_impl=["full", "full", "full", None],
               block_impl=[None, "fused", "fused", None])
    ops = [op for op, _ in cffm.train_calls(cfg, 2, 4, 32, 32)]
    assert ops.count("mit_block_train") == ops.count("mit_block_train_bwd") == 3
    assert ops.count("dwconv3x3") == 1 and ops.count("cfm_attention_bwd") == 1
    assert ops.count("ce_upsampled_loss") == ops.count("ce_upsampled_loss_bwd") == 2
    ev = [op for op, _ in cffm.eval_calls(cfg, 4, 32, 32)]
    assert ev.count("mit_block_fused") == 2 and ev.count("dwconv3x3") == 2
    assert ev.count("cfm_attention") == 1
    assert "cfm_attention" not in [op for op, _ in cffm.eval_calls(cfg, 1, 32, 32)]
