"""Closed-loop training at a fixed global batch.

Traffic parameters (``traffic/<name>.json``): ``clips`` x ``frames`` of
``crop`` (h, w) uint8 BGR frames a step, labels in [0, classes) with
``ignore_share`` of them 255; ``pool`` distinct batches in pinned host
memory, made from the seed, each step copying its batch to the card as the
program's ``TrainLoader`` hands it over (``non_blocking``); the schedule
started at ``start_iter`` (past the warmup, where the recipe spends its
steps); ``warmup_steps`` steps after the three that are checked;
``traced_steps`` in each of the two profiled windows of a ``--trace 1`` run
(one of CUDA activities alone, for the device's busy time a step and the
kernels; one with the host's ops, for host ranges and the names of the
host ops behind idle gaps);
``ref_remat``: the reference recomputes each backbone block in its backward.

The program: ``apis.init_segmentor(config, state_dict=...)`` on the card,
``train.build_optimizer`` and ``train.make_train_step``; every step,
``step(batch, generator)``. Set-up drives that same step through its first
three steps (batches 0-2, one generator from the seed) and keeps the losses,
the first gradient (from AdamW's first moment after one step) and the
parameters after three; after the window the reference follows the same
three steps from the same weights, batches and draws.
"""

from __future__ import annotations

import warnings

import torch

from portbench import compare, harness
from portbench.trace import capture_all
from portbench.weights import make_params


def make_pool(r: harness.Run, p: dict, classes: int) -> list[dict]:
    """The pool of distinct batches, drawn on the device and kept in pinned
    host memory."""
    dev = r.device
    g = torch.Generator(device=dev).manual_seed(r.seed_for("data"))
    shape = (p["clips"], p["frames"], *p["crop"])
    pool = []
    for _ in range(p["pool"]):
        imgs = torch.randint(0, 256, (*shape, 3), generator=g, device=dev, dtype=torch.uint8)
        labels = torch.randint(0, classes, shape, generator=g, device=dev, dtype=torch.uint8)
        ignored = torch.rand(shape, generator=g, device=dev) < p["ignore_share"]
        labels = torch.where(ignored, torch.full_like(labels, 255), labels)
        if dev.type == "cuda":
            imgs, labels = imgs.cpu().pin_memory(), labels.cpu().pin_memory()
        pool.append({"imgs": imgs, "labels": labels})
    return pool


class Program:
    """The program's train step, built from the seed's weights."""

    def __init__(self, r: harness.Run, params: dict):
        from vss_cffm_tpu_torch.apis import init_segmentor
        from vss_cffm_tpu_torch.train import build_optimizer, make_train_step

        p = r.cell.traffic["params"]
        exp = r.port_config()
        self.model = init_segmentor(exp, state_dict=params, device=r.device).model.train()
        self.opt, sched = build_optimizer(self.model, exp.optim)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sched.last_epoch = p["start_iter"] - 1
            sched.step()
        self.step = make_train_step(self.model, self.opt, sched)
        self.gen = torch.Generator(device=r.device).manual_seed(r.seed_for("draws"))
        self.beta1 = exp.optim.betas[0]

    def first_steps(self, feed) -> dict:
        """Steps 1-3: losses, first gradient, parameters after three."""
        named = dict(self.model.named_parameters())
        losses = []
        grad1 = None
        for i in range(3):
            losses.append(self.step(feed(i), self.gen)["loss_seg"])
            if i == 0:  # a parameter whose state holds no first moment got none
                grad1 = {n: self.opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                         / (1.0 - self.beta1) for n, p in named.items()}
        return {"losses": [float(x) for x in losses], "grad1": grad1,
                "params": {n: p.detach().clone() for n, p in named.items()}}


def reference(r: harness.Run, params: dict, pool: list[dict], kind: str) -> dict:
    """The reference's three steps from the same weights, batches and draws,
    in float32 ("f32") or fp8 operands ("fp8")."""
    ref = r.cell.reference()
    p = r.cell.traffic["params"]
    gen = torch.Generator(device=r.device).manual_seed(r.seed_for("draws"))
    batches = [{k: v.to(r.device) for k, v in pool[i].items()} for i in range(3)]
    with ref.exact_math():
        return ref.train_steps(params, r.cell.config, batches, gen, p["start_iter"],
                               q=ref.Quant(kind), remat=p["ref_remat"])


def readings(r: harness.Run, kind: str = "program") -> dict:
    """The compared numbers of one seed without a window: the program's
    first three steps against the reference's; or the reference in fp8 in
    the program's place ("control"); or the program with a fault planted:
    "half", every step on the first half of its batch (the mean over it)."""
    params = make_params(r.cell.config, r.seed_for("weights"), r.device)
    pool = make_pool(r, r.cell.traffic["params"], r.cell.config["num_classes"])
    if kind == "control":
        got = reference(r, params, pool, "fp8")
    else:
        prog = Program(r, params)
        if kind == "half":
            step = prog.step
            prog.step = lambda b, g: step({k: v[: v.shape[0] // 2] for k, v in b.items()}, g)
        got = prog.first_steps(lambda i: feed(pool, i, r.device))
        del prog
    harness.free()
    ref = reference(r, params, pool, "f32")
    return compare.train_numbers(got, ref, params)


def feed(pool: list[dict], i: int, dev) -> dict:
    b = pool[i % len(pool)]
    return {k: v.to(dev, non_blocking=True) for k, v in b.items()}


def run(r: harness.Run) -> harness.Outcome:
    from vss_cffm_tpu_torch import ops

    cfg, p = r.cell.config, r.cell.traffic["params"]
    if r.control:
        numbers = readings(r, "control")
        return harness.Outcome(0, 0, {}, 0.0, 0,
                               compare.checks(numbers, r.cell.limits, present_only=True),
                               {"numbers": numbers})
    dev = r.device
    params = make_params(cfg, r.seed_for("weights"), dev)
    pool = make_pool(r, p, cfg["num_classes"])
    prog = Program(r, params)
    got = prog.first_steps(lambda i: feed(pool, i, dev))
    at = 3
    for _ in range(p["warmup_steps"]):
        prog.step(feed(pool, at, dev), prog.gen)
        at += 1
    harness.sync(dev)
    setup_s = harness.now() - r.t0

    steps, host = 0, 0.0
    start = harness.now()
    while harness.now() - start < r.seconds:
        t = harness.now()
        prog.step(feed(pool, at, dev), prog.gen)
        host += harness.now() - t
        at += 1
        steps += 1
    harness.sync(dev)
    window_s = harness.now() - start
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    frames = steps * p["clips"] * p["frames"]
    counts = r.cell.counts()
    h, w = p["crop"]
    ctx = {"steps": steps, "window_s": window_s, "host_s": host, "frames": frames,
           "model_flops": steps * counts.train_step_flops(cfg, p["clips"], p["frames"], h, w),
           "device": dev, "root": r.cell.root, "cell": r.cell}
    trace = None
    if r.trace:
        def traced():
            nonlocal at
            for _ in range(p["traced_steps"]):
                prog.step(feed(pool, at, dev), prog.gen)
                at += 1

        calls = counts.train_calls(cfg, p["clips"], p["frames"], h, w) * p["traced_steps"]
        trace = capture_all(traced, ops.launches, r.cell.root, ops=False)
        ops_trace = capture_all(traced, ops.launches, r.cell.root, ops=True)
        ctx.update(trace=trace, ops_trace=ops_trace, calls=calls, traced_steps=p["traced_steps"])
    del prog
    harness.free()
    ref = reference(r, params, pool, "f32")
    numbers = compare.train_numbers(got, ref, params)
    ctx["numbers"] = numbers
    return harness.Outcome(steps, 0, {"train_frames_per_s": frames / window_s}, setup_s,
                           memory_peak, compare.checks(numbers, r.cell.limits), ctx, trace)
