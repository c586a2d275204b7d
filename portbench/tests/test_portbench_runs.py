"""Whole runs of a tiny cell on the CPU (the card's checks skipped): the
reference against the program's plain path, the control and the planted
faults coming out not correct under the tiny cell's limits (set at that size
as the real cells' are), a new cell found from new files alone, and the
modules a run loads."""

import dataclasses
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import compare, harness
from portbench.reference import cffm as ref
from portbench.tests import tiny
from portbench.weights import make_params

SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory, few_threads):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _run(root, workload, **kw):
    return harness.execute(root, workload, SEED, 0.5, False, time.perf_counter(),
                           device="cpu", **kw)


def test_a_new_cell_is_found_from_new_files_alone(root):
    cell = harness.load_cell(root, "tiny.train")
    assert cell.config["port_config"] == "portbench.tests.tiny_port_config"
    assert cell.driver().__name__.endswith("train")
    assert {m["name"] for m in cell.per_layer()} >= {"mfu.train", "host_ms_per_step.train"}
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        assert "tiny.train" not in f.read()


def test_reference_agrees_with_the_programs_plain_path(few_threads):
    from vss_cffm_tpu_torch.apis import init_segmentor
    from vss_cffm_tpu_torch.train import build_optimizer, make_train_step

    from portbench.tests import tiny_port_config

    cfg = tiny.tiny_config()
    exp = dataclasses.replace(tiny_port_config.config(), bf16=False)
    params = make_params(cfg, 7, torch.device("cpu"))
    model = init_segmentor(exp, state_dict=params, device="cpu").model
    frames = torch.randint(0, 256, (4, 60, 90, 3), generator=torch.Generator().manual_seed(1),
                           dtype=torch.uint8)
    from vss_cffm_tpu_torch.eval import ClipEvaluator

    ev = ClipEvaluator(model, 16, device="cpu")
    for t in (4, 1):
        with torch.no_grad():
            got = model(ev._input(frames[-t:].numpy(), (96, 64)))
            want = ref.segmentor(ref.eval_input(frames[-t:], (96, 64)), params, cfg)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    model.train()
    opt, sched = build_optimizer(model, exp.optim)
    sched.last_epoch = 15999
    sched.step()
    step = make_train_step(model, opt, sched)
    g = torch.Generator().manual_seed(5)
    batches = [{"imgs": torch.randint(0, 256, (2, 4, 64, 64, 3), generator=g, dtype=torch.uint8),
                "labels": torch.randint(0, 16, (2, 4, 64, 64), generator=g, dtype=torch.uint8)}
               for _ in range(3)]
    named = dict(model.named_parameters())
    draws = torch.Generator().manual_seed(9)
    losses, grad1 = [], None
    for i, b in enumerate(batches):
        losses.append(float(step(b, draws)["loss_seg"]))
        if i == 0:
            grad1 = {n: opt.state[p]["exp_avg"] / 0.1 for n, p in named.items()}
    prog = {"losses": losses, "grad1": grad1,
            "params": {n: p.detach().clone() for n, p in named.items()}}
    want = ref.train_steps(params, cfg, batches, torch.Generator().manual_seed(9), 16000)
    numbers = compare.train_numbers(prog, want, params)
    # float32 on both sides: only the order of the sums differs
    assert numbers["loss_rel"] < 1e-5
    assert numbers["_grad_worst"] < 1e-3 and numbers["delta_leaf_rel"] < 1e-3


def test_a_sound_tiny_run_is_correct(root):
    line = _run(root, "tiny.train")
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["attempted"] > 0


def test_the_control_is_not_correct(root):
    line = _run(root, "tiny.train", control=True)
    assert not line["correct"], line["checks"]


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(root, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    line = _run(root, "tiny.train")
    assert not line["correct"], line["checks"]


def test_half_the_batch_left_out_is_not_correct(root, monkeypatch):
    import vss_cffm_tpu_torch.train as train

    real = train.make_train_step

    def halves(*a, **kw):
        step = real(*a, **kw)
        return lambda batch, g: step({k: v[: v.shape[0] // 2] for k, v in batch.items()}, g)

    monkeypatch.setattr(train, "make_train_step", halves)
    line = _run(root, "tiny.train")
    assert not line["correct"], line["checks"]


def test_an_altered_loss_is_not_correct(root, monkeypatch):
    import vss_cffm_tpu_torch.train as train

    real = train.make_train_step

    def altered(*a, **kw):
        step = real(*a, **kw)

        def wrong(batch, g):
            out = step(batch, g)
            return dict(out, loss_seg=out["loss_seg"] * (1.0 + 1e-4))

        return wrong

    monkeypatch.setattr(train, "make_train_step", altered)
    line = _run(root, "tiny.train")
    assert not line["correct"], line["checks"]


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program(root):
    code = f"""
import sys, time
sys.path.insert(0, {tiny.ROOT!r})
import torch
torch.set_num_threads(2)
from portbench import harness
harness.execute({root!r}, "tiny.train", 3, 0.2, False, time.perf_counter(), device="cpu")
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(out.stdout.split())
    assert "vss_cffm_tpu_torch" in tops and not tops & set(harness.FORBIDDEN)
    code = f"""
import sys
sys.path.insert(0, {tiny.ROOT!r})
import torch
from portbench.reference import cffm
from portbench.tests.tiny import tiny_config
from portbench.weights import make_params
cfg = tiny_config()
p = make_params(cfg, 1, torch.device("cpu"))
cffm.segmentor(torch.zeros(1, 4, 64, 64, 3), p, cfg)
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(out.stdout.split())
    assert not tops & {"vss_cffm_tpu_torch", *harness.FORBIDDEN}, tops


def test_the_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(tiny.ROOT, "portbench", "run.py"),
                          "--workload", "cffm_b1.train_g8", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_trace_reduction_on_synthetic_intervals():
    from portbench.trace import Trace

    # k1 and k3 are launched (at 9, 40) after the device fell idle (at 0, 30),
    # k2 (at 12) while k1 runs; the host waits in a synchronize from 65
    t = Trace(window=(0, 100), device=[(10, 20, "void gemm_kernel<1>(Args)", 7),
                                       (15, 30, "k2", 8), (60, 70, "k3", 9)],
              cpu=[(5, 50, "Optimizer.step#AdamW.step", 2, 1), (6, 10, "aten::mul", 3, 1),
                   (40, 90, "aten::copy_", 4, 1)],
              launches={}, starts={7: 9, 8: 12, 9: 40},
              runtime=[(9, 10, "cudaLaunchKernel"), (12, 13, "cudaLaunchKernel"),
                       (40, 41, "cudaLaunchKernel"), (65, 100, "cudaDeviceSynchronize")])
    assert t.busy() == [(10, 30), (60, 70)]
    assert t.busy_s() == pytest.approx(30e-9) and t.window_s == pytest.approx(100e-9)
    assert t.gaps() == [(0, 10), (30, 60), (70, 100)]
    assert t.host_op_at(45) == "aten::copy_" and t.host_op_at(2) == "host idle"
    assert t.range_device_s("Optimizer.step#") == (pytest.approx(35e-9), 1)
    assert t.device_ops()[0] == ["k2", pytest.approx(15e-9)]
    assert dict(t.idle_gaps()) == {"launch of k3": pytest.approx(30e-9),
                                   "launch of gemm_kernel<1>": pytest.approx(10e-9),
                                   "host in cudaDeviceSynchronize": pytest.approx(30e-9)}
    # named by the host op that launched each kernel in a trace with the ops,
    # the k-th run of a kernel matched to its k-th run there; a kernel that
    # trace lacks keeps its own name
    assert dict(t.idle_gaps(ops=t)) == {"launch of aten::copy_": pytest.approx(30e-9),
                                        "launch of aten::mul": pytest.approx(10e-9),
                                        "host in cudaDeviceSynchronize": pytest.approx(30e-9)}
    ops = Trace(window=(0, 100), device=[(1, 2, "k3", 9), (3, 4, "k2", 8)], cpu=t.cpu,
                launches={}, starts=t.starts)
    assert dict(t.idle_gaps(ops=ops)) == {
        "launch of aten::copy_": pytest.approx(30e-9),
        "launch of gemm_kernel<1>": pytest.approx(10e-9),
        "host in cudaDeviceSynchronize": pytest.approx(30e-9)}
    from portbench.trace import kernel_pattern

    pat = kernel_pattern(tiny.ROOT)
    assert pat.search("void gemm_kernel<128>(Args)") and not pat.search("xmma_gemm_kernel<1>(")
    assert not pat.search("void gemm_tn_x(") and pat.search("_Z11gemm_kernelILi1EEvv")


def test_busy_and_idle_are_held_against_the_untraced_pace():
    from portbench import readers
    from portbench.trace import Trace

    # two profiled steps of 100 ns with 60 ns busy each; untraced, ten steps
    # took 700 ns: 600 ns busy, 1/7 idle
    t = Trace(window=(0, 200), device=[(0, 60, "k", 1), (100, 160, "k", 2)], cpu=[],
              launches={})
    ctx = {"trace": t, "traced_steps": 2, "steps": 10, "window_s": 700e-9}
    assert readers.device_busy_s(ctx) == pytest.approx(600e-9)
    assert readers.device_idle(ctx) == pytest.approx(100.0 / 7)
    assert readers.device_idle({"steps": 10, "window_s": 1.0}) is None
