"""PyTorch port, on the CPU: the gate of the whole-block train path, the
parse of ``ptxas -v``'s build log, and the plain CE loss giving one answer
for equal labels whatever their layout and the thread count."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vss_cffm_tpu_torch import ops
from vss_cffm_tpu_torch.ops import _build
from vss_cffm_tpu_torch.ops._dispatch import SMEM_LIMIT
from vss_cffm_tpu_torch.ops.stage_block import sra_attention_bwd_smem


@pytest.mark.parametrize("hd,n_kv,fits", [
    (32, 512, True), (32, 513, False),   # the most keys the SRA backward's block holds
    (64, 233, True), (64, 234, False),   # (the MiT stages at 480²: 225 keys)
])
def test_block_train_gate_follows_the_attention_backward(hd, n_kv, fits):
    """The whole-block gate takes a key count while the spatial-reduction
    attention backward's block fits the card's shared memory: K and V, the
    q / d_ctx ring, the p and d_s tiles and the f32 dK and dV accumulators of
    all the frame's keys (that block holds the forward's K and V and more);
    past it the MiT block runs composed."""
    assert ops.mit_block_train_fits(30, 30, 64, 256, 64 // hd, n_kv) == fits
    assert (sra_attention_bwd_smem(n_kv, hd) <= SMEM_LIMIT) == fits


_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi32EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi32EEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 78 registers, used 1 barriers, 4096 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelILi64EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEvPf
    24 bytes stack frame, 20 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_usage_parses_the_build_log(tmp_path, monkeypatch):
    lib = tmp_path / "libattention_0.so"
    monkeypatch.setattr(_build, "_lib_path", lambda name: str(lib))
    assert _build.ptxas_usage("attention") == []
    (tmp_path / "libattention_0.so.log").write_text(_LOG)
    assert _build.ptxas_usage("attention") == [
        {"kernel": "_Z6kernelILi32EEvPf", "registers": 78, "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "smem": 4096},
        {"kernel": "_Z6kernelILi64EEvPf", "registers": 255, "stack": 24, "spill_stores": 20,
         "spill_loads": 16, "smem": 0}]


@pytest.mark.parametrize("c", [7, 124])
def test_plain_ce_loss_is_bitwise_stable(c):
    """Equal labels give one loss: contiguous, as a strided view, and at 1 and
    4 threads (the per-pixel terms are summed in f64 and rounded once)."""
    rng = np.random.RandomState(c)
    logits = torch.from_numpy((rng.randn(2, 8, 8, c) * 2).astype(np.float32)).to(torch.bfloat16)
    lab = rng.randint(0, c, (2, 32, 32)).astype(np.uint8)
    lab[rng.rand(*lab.shape) < 0.1] = 255
    labels = torch.from_numpy(lab)
    strided = labels.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous() and torch.equal(strided, labels)
    threads = torch.get_num_threads()
    got = set()
    try:
        for t in (1, 4):
            torch.set_num_threads(t)
            for lb in (labels, strided):
                got.add(ops.ce_upsampled_loss_torch(logits, lb, 4, 0.5 / lab.size)[0].item())
    finally:
        torch.set_num_threads(threads)
    assert len(got) == 1, got
