"""On the card only (marker ``cuda``; skipped without one, inside a
fixture): the profiler's trace of real kernels reduced by ``trace.py``, and
one short traced run of the first cell.

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_card.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import trace as tr
from portbench.tests.tiny import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_trace_of_real_kernels(card):
    a = torch.randn(2048, 2048, device=card)

    def work():
        for _ in range(8):
            a @ a

    for ops in (False, True):
        t = tr.capture(work, ops=ops)
        assert len(t.kernels()) >= 8 and 0 < t.busy_s() <= t.window_s
        assert t.device_ops() and t.idle_gaps() and bool(t.cpu) == ops
        # every kernel is linked to the runtime call that launched it
        assert all(d[3] in t.starts for d in t.kernels())


def test_a_short_traced_run(card):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"),
                          "--workload", "cffm_b1.train_g8", "--seed", "4242", "--seconds", "2",
                          "--trace", "1"], capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert {"kernel_roofline.train", "mfu.train"} <= set(line["metrics"])
