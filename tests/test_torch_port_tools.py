"""PyTorch port, the measuring tools (``vss_cffm_tpu_torch/tools/``) on the CPU:

- ``get_flops`` prints the JAX tool's lines (``tools/get_flops.py``, loaded by
  its file path) for each of the 13 shipped configs;
- ``benchmark`` in its three modes (clip inference, ``--streaming``,
  ``--train``) and ``profile_forward`` at B0, 64², 2 iterations, ``--device
  cpu``: the JAX tool's line of each mode, finite positive figures, the
  profile's host time by operator (no device figure on the CPU);
  ``--embed-impl im2col`` is refused, and a tool asked for the card without
  one raises;
- ``benchmark_loader`` on a tiny tree: clips and frames per second over its
  batches, on threads and with ``--worker-mode process`` (spawned workers),
  with the native library's state.
"""

from __future__ import annotations

import importlib.util
import math
import os
import sys

import pytest
import torch

from torch_port_common import few_threads  # noqa: F401 (the module's fixture)
from vss_cffm_tpu_torch.tools import benchmark, benchmark_loader, get_flops, profile_forward

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "configs")) if f.endswith(".py"))
B0 = os.path.join(REPO, "vss_cffm_tpu_torch", "configs", "cffm_b0_vspw_160k.py")
SMALL = ["--device", "cpu", "--iters", "2", "--options", "bf16=false", "data.crop_size=64,64"]


def _jax_get_flops():
    spec = importlib.util.spec_from_file_location("jax_tools_get_flops",
                                                  os.path.join(REPO, "tools", "get_flops.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_shipped_configs_are_the_ports():
    assert len(CONFIGS) == 13
    port = sorted(f for f in os.listdir(os.path.join(REPO, "vss_cffm_tpu_torch", "configs"))
                  if f.endswith(".py") and f != "__init__.py")
    assert port == CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_get_flops_prints_the_jax_tools_lines(name, capsys, monkeypatch):
    jax_tool = _jax_get_flops()
    monkeypatch.setattr(sys, "argv", ["get_flops.py", os.path.join(REPO, "configs", name),
                                      "--shape", "480", "864"])
    jax_tool.main()
    want = capsys.readouterr().out.splitlines()
    got = get_flops.main([os.path.join(REPO, "vss_cffm_tpu_torch", "configs", name),
                          "--shape", "480", "864"])
    assert capsys.readouterr().out.splitlines() == want
    assert len(want) == 4 and got["total"] == got["backbone"] + got["head"] > 0


@pytest.mark.parametrize("mode", ["clip", "streaming", "train"])
def test_benchmark_modes_on_the_cpu(mode, capsys):
    flags = {"clip": ["--shape", "64", "64"], "streaming": ["--shape", "64", "64", "--streaming"],
             "train": ["--train", "--batch", "1"]}[mode]
    out = benchmark.main([B0, *flags, *SMALL])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert out["mode"] == mode and out["device"] == "cpu"
    if mode == "clip":
        assert line.startswith("fps: ") and "(clip inference at 64x64, batch 1)" in line
        assert math.isfinite(out["fps"]) and out["fps"] > 0
    elif mode == "streaming":
        assert line.startswith("streaming: {'frame_features_ms': ")
        assert out["frame_features_ms"] > 0 and out["predict_ms"] > 0
    else:
        assert line.startswith("train: {'train_ms_per_iter': ")
        assert (out["batch"], out["clip"], out["crop"]) == (1, 4, "64x64")
        assert out["train_ms_per_iter"] > 0 and math.isfinite(out["loss"])


def test_profile_forward_on_the_cpu(capsys):
    out = profile_forward.main(["--variant", "b0", "--shape", "64", "64", "--iters", "2",
                                "--top", "5", "--device", "cpu"])
    text = capsys.readouterr().out
    assert out["kind"] == "host" and "host (CPU, no device) total" in text
    assert "device total" not in text
    assert len(out["top"]) == 5 and out["per_iter_us"] > 0
    assert 0 < sum(share for *_, share in out["top"]) <= 100.0 + 1e-9
    assert any("aten::" in name for name, *_ in out["top"])


def test_tools_refuse_what_they_cannot_run():
    with pytest.raises(SystemExit, match="im2col.*does not carry"):
        profile_forward.main(["--embed-impl", "im2col", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            benchmark.main([B0, "--iters", "2"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            benchmark_loader.main(["--batches", "1"])


def test_benchmark_loader_on_a_tiny_tree(capsys):
    out = benchmark_loader.main(["--frames-hw", "48", "64", "--batches", "2",
                                 "--num-workers", "1", "--batch-size", "1", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "clips/s" in line and "frames/s" in line
    assert out["frames_per_s"] == pytest.approx(4 * out["clips_per_s"])
    proc = benchmark_loader.main(["--frames-hw", "48", "64", "--batches", "1",
                                  "--worker-mode", "process", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "native library available" in lines[-2] and "process workers" in lines[-1]
    assert proc["worker_mode"] == "process" and proc["clips_per_s"] > 0
    assert proc["frames_per_s"] == pytest.approx(4 * proc["clips_per_s"])
