"""PyTorch port, ``tools/export.py`` (``torch.export`` of the clip forward with
the inference ops as ``vss_cffm::`` custom ops) on the CPU, on the B0 model
of ``torch_port_common.eval_models`` at ``EVAL_HW``:

- ``main`` with ``--device cpu --verify`` exports, reloads and verifies;
  the graph holds each reached custom op as many times as the live forward
  calls its wrapper, and the reloaded program equals the live forward bit
  for bit and the JAX forward (``model.apply(variables, imgs, False)``)
  within the f32 tolerance of ``tests/test_torch_port_segmentor.py``;
- a process that imports only ``vss_cffm_tpu_torch.ops`` reloads and runs
  the program without importing the model code;
- a graph without the custom ops fails the tool;
- the fused-FFN forms export as ``block_ffn_fused`` / ``mixffn_fused``
  nodes; each custom op's fake implementation agrees with its real one
  (``torch.library.opcheck``);
- ``derived()`` keeps nothing while tracing and still hits its eager cache
  after an export.
"""

from __future__ import annotations

import concurrent.futures
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (EVAL_HW, eval_models, few_threads,  # noqa: F401 (a fixture)
                               to_np, write_config)
from vss_cffm_tpu_torch import config as pcfg
from vss_cffm_tpu_torch import ops
from vss_cffm_tpu_torch.models import mit
from vss_cffm_tpu_torch.tools import export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 end to end: sums in other orders (tests/test_torch_port_segmentor.py)
TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = (1, 4, *EVAL_HW, 3)


_RELOAD = """
import sys
import torch
import vss_cffm_tpu_torch.ops
program = torch.export.load(sys.argv[1]).module()
with torch.no_grad():
    out = program(torch.load(sys.argv[2]))
torch.save(out, sys.argv[3])
print(sorted(m for m in sys.modules if m.startswith("vss_cffm_tpu_torch")))
"""


@pytest.fixture(scope="module")
def exported(tmp_path_factory, few_threads):
    """The tool run on the eval model's weights, the JAX forward of the
    verify clip compiling in a thread beside it (``want``); then a process
    that imports only ``vss_cffm_tpu_torch.ops`` started on the .pt2
    (``reload``), which runs while the tests go on."""
    jm, variables, pm = eval_models()
    d = tmp_path_factory.mktemp("export")
    clip = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    want = pool.submit(lambda: np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(
        variables, jnp.asarray(clip))))
    pool.shutdown(wait=False)
    cfg = pcfg.ExperimentConfig(model=pm.config, bf16=False)
    torch.save(pm.state_dict(), d / "weights.pth")
    out = export.main([write_config(d / "cfg.py", cfg), str(d / "weights.pth"),
                       str(d / "clip.pt2"), "--shape", *map(str, EVAL_HW), "--device", "cpu",
                       "--verify"])
    torch.save(torch.from_numpy(clip), d / "x.pt")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen([sys.executable, "-c", _RELOAD, str(d / "clip.pt2"),
                             str(d / "x.pt"), str(d / "y.pt")], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    yield types.SimpleNamespace(pm=pm, out=out, clip=clip, want=want, reload=(proc, d / "y.pt"))
    proc.kill()
    proc.communicate()


_RELOADED: dict = {}


def _reloaded(ex) -> tuple[torch.Tensor, list]:
    """(the reloaded program's logits, the package's modules the reloading
    process imported), waited for at first use."""
    proc, y = ex.reload
    if proc.pid not in _RELOADED:
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-3000:]
        _RELOADED[proc.pid] = torch.load(y), eval(stdout.strip().splitlines()[-1])
    return _RELOADED[proc.pid]


def test_the_tool_exports_and_verifies(exported):
    out = exported.out
    assert out["shape"] == SHAPE and out["mb"] > 1.0 and os.path.getsize(out["output"]) > 1e6
    assert out["graph_ops"] == {"vss_cffm::cfm_attention": 1, "vss_cffm::dwconv3x3": 4,
                                "vss_cffm::mit_block_fused": 4}
    assert out["live_calls"] == out["reloaded_calls"] == out["graph_ops"]
    assert out["live_launches"] == out["reloaded_launches"] == {}  # the CPU: no kernel
    assert out["bitwise"] and out["max_abs_err"] == 0.0


def test_graph_counts_are_the_wrappers_calls(exported, monkeypatch):
    from vss_cffm_tpu_torch.models import cffm_transformer as cffm

    calls = {}
    for mod, name in ((mit, "mit_block_fused"), (mit, "dwconv3x3"), (mit, "block_ffn_fused"),
                      (mit, "mixffn_fused"), (cffm, "cfm_attention")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _fn(*a, **k))[1])
    with torch.no_grad():
        exported.pm(torch.from_numpy(exported.clip))
    assert {f"vss_cffm::{k}": v for k, v in sorted(calls.items())} == exported.out["graph_ops"]


def test_a_graph_without_the_ops_fails(exported, tmp_path, monkeypatch):
    pm = exported.pm
    cfg = pcfg.ExperimentConfig(model=pm.config, bf16=False)
    torch.save(pm.state_dict(), tmp_path / "w.pth")
    monkeypatch.setattr(export, "export_clip_forward", lambda model, sample: None)
    monkeypatch.setattr(export, "graph_ops", lambda program: {})
    with pytest.raises(RuntimeError, match="holds no vss_cffm:: custom op"):
        export.main([write_config(tmp_path / "cfg.py", cfg), str(tmp_path / "w.pth"),
                     str(tmp_path / "x.pt2"), "--shape", "32", "32", "--device", "cpu"])
    assert not os.path.exists(tmp_path / "x.pt2")


def test_fused_ffn_forms_export_as_their_ops(exported):
    """A stage-1 block of the eval model in the ``dwconv_impl="fused"`` form
    (``block_ffn_fused``), and its MixFFN alone (``mixffn_fused``)."""
    pm = exported.pm
    src = pm.backbone.block1[0]
    blk = mit.MiTBlock(32, 1, 8, 4, True, 1e-6, fused=False, dwconv_impl="fused").eval()
    blk.load_state_dict(src.state_dict())
    x = torch.randn(2, 16, 24, 32)
    program = export.export_clip_forward(blk, x)
    assert export.graph_ops(program) == {"vss_cffm::block_ffn_fused": 1}
    with torch.no_grad():
        torch.testing.assert_close(program.module()(x), blk(x), rtol=0, atol=0)
    mlp_program = export.export_clip_forward(blk.mlp, x)
    assert export.graph_ops(mlp_program) == {"vss_cffm::mixffn_fused": 1}


def test_fake_implementations_agree_with_the_real_ones():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    x, k, b = r(2, 5, 6, 16), r(3, 3, 1, 16), r(16)
    w1, b1, kdw, bdw, w2, b2 = r(8, 16), r(16), k, b, r(16, 8), r(8)
    xs = r(2, 5, 6, 8)
    cases = {
        "dwconv3x3": (x, k, b, True, None),
        "block_ffn_fused": (xs, r(8), r(8), w1, b1, kdw, bdw, w2, b2, 1e-6, None),
        "mixffn_fused": (xs, w1, b1, kdw, bdw, w2, b2, None),
        "cfm_attention": (r(3, 49, 16), r(3, 20, 16), r(3, 20, 16), r(2, 49, 20), r(3, 20), 2,
                          None),
        "mit_block_fused": (xs, r(8), r(8), r(8, 8), r(8), r(2, 4, 8), r(2, 4, 8), r(8, 8),
                            r(8), r(8), r(8), w1, b1, kdw, bdw, w2, b2, 2, 1e-6, None),
    }
    for name, args in cases.items():
        torch.library.opcheck(getattr(torch.ops.vss_cffm, name).default, args,
                              test_utils=("test_schema", "test_faketensor"))
    assert sorted(cases) == sorted(n for n in ops.KERNEL_OPS
                                   if hasattr(torch.ops.vss_cffm, n))


class _Doubled(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.arange(4.0))

    def forward(self, x):
        return x * mit.derived(self, "doubled", (self.w,), lambda: self.w * 2)


def test_derived_keeps_nothing_while_tracing_and_hits_after(exported):
    m = _Doubled().eval()
    program = export.export_clip_forward(m, torch.ones(4))
    assert "_derived" not in m.__dict__
    torch.testing.assert_close(program.module()(torch.ones(4)), torch.arange(4.0) * 2)
    # the eval model: its eager cache is kept through an export and still hit
    pm = exported.pm
    attn = pm.backbone.block1[0].attn
    x = torch.randn(1, 16, 16, 32)
    with torch.no_grad():
        attn(x)
    cached = {k: v for k, v in attn.q._derived.items()}
    export.export_clip_forward(attn, x)
    assert attn.q._derived == cached
    made = []
    with torch.no_grad():
        hit = mit.derived(attn.q, ("weight", attn.compute_dtype), (attn.q.weight,),
                          lambda: made.append(1))
    assert hit is cached[("weight", attn.compute_dtype)][1] and not made


# last in the file: the reloading process runs while the tests above do


def test_reloaded_program_matches_jax(exported):
    want = exported.want.result(timeout=300)
    got, _ = _reloaded(exported)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(to_np(got), want, **TOL)


def test_a_process_with_the_ops_alone_reloads_it(exported):
    """It imports no module of the package but the ops, and its program
    gives the live forward's logits bit for bit."""
    got, modules = _reloaded(exported)
    assert modules and all(m == "vss_cffm_tpu_torch" or m.startswith("vss_cffm_tpu_torch.ops")
                           for m in modules), modules
    with torch.no_grad():
        live = exported.pm(torch.from_numpy(exported.clip))
    torch.testing.assert_close(got, live, rtol=0, atol=0)
