"""The harness: finds a cell's configuration, traffic, driver, limits and
metric readers by name, runs the driver, checks, and prints the result.

Layout under ``portbench/`` (everything found by the names in
``BENCHMARK.json``, so that a new cell, configuration or per-layer metric is
new files and new entries, never an edit):

- ``configs/<config>.json``: the configuration as it is run (its ``file``
  in ``BENCHMARK.json``), naming the program's config module
  (``port_config``), the model family (``model``: the plain reference
  ``reference/<model>.py`` and the counts ``counts/<model>.py``);
- ``traffic/<traffic>.json``: a traffic mix, the driver that generates it
  (``drivers/<driver>.py``) and its parameters;
- ``workloads/<workload>.json``: the cell's correctness limits;
- ``metrics/<metric>.py`` or ``metrics/<quantity>.py``: a per-layer metric's
  reader, ``read(ctx) -> float | None`` (the quantity: the metric's name up
  to its first dot, for a reader that serves several cells' metrics).

A driver's ``run(r: Run) -> Outcome`` builds the program from the seed,
warms it, measures ``r.seconds``, and checks its outputs against the
reference after the window.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any

FORBIDDEN = ("jax", "jaxlib", "flax", "vss_cffm_tpu")
# intra-op threads of the run's process: the host work of a run is one
# Python thread launching kernels, and the default (a thread a core) made
# the CPU-side set-up 2-3x slower and the host-bound cells noisier
THREADS = 2


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the Python file at ``path`` under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _module_name(kind: str, name: str) -> str:
    return "portbench_" + kind + "_" + "".join(c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass
class Cell:
    root: str
    bench: dict
    name: str
    entry: dict          # the workload's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    limits: dict         # workloads/<name>.json

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def path(self, *parts: str) -> str:
        return os.path.join(self.root, "portbench", *parts)

    def driver(self):
        d = self.traffic["driver"]
        return load_module(self.path("drivers", d + ".py"), _module_name("driver", d))

    def reference(self):
        m = self.config["model"]
        return importlib.import_module(f"portbench.reference.{m}")

    def counts(self):
        m = self.config["model"]
        return importlib.import_module(f"portbench.counts.{m}")

    def op_work(self, op: str):
        return importlib.import_module(f"portbench.counts.{op}").work

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list[dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, metric: str):
        """``metrics/<metric>.py``, else ``metrics/<quantity>.py``, the quantity
        being the metric's name up to its first dot (one reader serves
        ``mfu.train`` and ``mfu.train_b5``)."""
        path = self.path("metrics", metric + ".py")
        if not os.path.isfile(path):
            path = self.path("metrics", metric.split(".")[0] + ".py")
        return load_module(path, _module_name("metric", metric))


def load_cell(root: str, workload: str) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"workload {workload!r} is not in BENCHMARK.json "
                       f"({', '.join(sorted(entries))})")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = _load_json(os.path.join(root, "portbench", "traffic", entry["traffic"] + ".json"))
    limits = _load_json(os.path.join(root, "portbench", "workloads", workload + ".json"))
    return Cell(root, bench, workload, entry, config, traffic, limits)


def sub_seed(seed: int, label: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    digest = hashlib.sha256(f"{seed}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any            # torch.device
    t0: float              # process start, on the host clock
    control: bool = False  # the reference in the program's place, in lower precision

    def seed_for(self, label: str) -> int:
        return sub_seed(self.seed, label)

    def port_config(self):
        """The program's ExperimentConfig for this configuration, checked
        against the configuration file."""
        mod = importlib.import_module(self.cell.config["port_config"])
        exp = mod.config()
        check_port_config(self.cell.config, exp)
        return exp


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float
    passed: bool


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict[str, float]        # the driver's end-to-end values (no setup_s)
    setup_s: float
    memory_peak_bytes: int
    checks: list[Check]
    ctx: dict                           # what the per-layer readers read
    trace: Any = None                   # trace.Trace of a --trace 1 run (CUDA activities)


def check_port_config(cfg: dict, exp) -> None:
    """Raise unless the program's config runs the sizes the file states."""
    from vss_cffm_tpu_torch.config import MIT_VARIANTS

    model = exp.model
    mit = MIT_VARIANTS[model.backbone]
    head, dec = model.head, model.head.decoder
    pairs = {
        "embed_dims": mit.embed_dims, "depths": mit.depths, "num_heads": mit.num_heads,
        "sr_ratios": mit.sr_ratios, "mlp_ratios": mit.mlp_ratios,
        "patch_sizes": mit.patch_sizes, "patch_strides": mit.patch_strides,
        "drop_path_rate": mit.drop_path_rate, "norm_eps": mit.norm_eps,
        "drop_rate": mit.drop_rate, "attn_drop_rate": mit.attn_drop_rate,
        "embed_dim": head.embed_dim, "num_classes": head.num_classes,
        "num_clips": head.num_clips, "dropout_ratio": head.dropout_ratio,
        "block_impl": model.block_impl, "train_block_impl": model.train_block_impl,
        "compute_dtype": "bfloat16" if exp.bf16 else "float32",
        "crop_size": exp.data.crop_size, "img_scale": exp.data.img_scale,
        "dilation": exp.data.dilation, "samples_per_gpu": exp.data.batch_size,
    }
    for key in ("dim", "depth", "num_heads", "window_size", "expand_size", "focal_level",
                "focal_window", "focal_l_clips", "focal_kernel_clips", "mlp_ratio", "norm_eps",
                "drop", "attn_drop", "drop_path"):
        pairs[f"decoder.{key}"] = getattr(dec, key)
    for key in ("lr", "betas", "weight_decay", "max_iters", "power", "min_lr", "warmup_iters",
                "warmup_ratio", "head_lr_mult", "grad_clip"):
        pairs[f"optim.{key}"] = getattr(exp.optim, key)
    pairs["loss"] = {"type": head.loss.type, "use_ohem": head.loss.use_ohem,
                     "class_weight": head.loss.class_weight,
                     "loss_weight": head.loss.loss_weight}
    bad = []
    for key, want in pairs.items():
        node = cfg
        for part in key.split("."):
            node = node[part]
        norm = lambda v: json.loads(json.dumps(v))
        if norm(node) != norm(want):
            bad.append(f"{key}: file {node!r}, program {want!r}")
    if bad:
        raise ValueError("the configuration file does not state what the program runs: "
                         + "; ".join(bad))


def card_line() -> str:
    """The card's name, power limit and clocks, from nvidia-smi."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,power.draw"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return f"[card] {query}: {out.stdout.strip() or out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"[card] nvidia-smi unavailable: {exc}"


def forbidden_modules() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def set_cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def result(cell: Cell, run: Run, out: Outcome) -> dict:
    """The result line: the cell's end-to-end metrics (``--trace 0``) or its
    per-layer metrics (``--trace 1``), the device, the checks last."""
    import torch

    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"] + cell.bench["per_layer"]}
    metrics = {}
    if run.control:
        pass
    elif not run.trace:
        values = dict(out.end_to_end, setup_s=out.setup_s)
        for m in cell.end_to_end():
            quantity = m["name"].split(".")[0]  # <quantity>.<suffix>: the driver's quantity
            if quantity not in values:
                raise KeyError(f"the {cell.traffic['driver']} driver gives no {quantity}")
            metrics[m["name"]] = {"value": values[quantity], "unit": m["unit"]}
    else:
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(out.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": all(c.passed for c in out.checks), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if run.trace and out.trace is not None:
        from .readers import device_busy_s

        device["busy_s"] = device_busy_s(out.ctx)
        device["window_s"] = out.ctx["window_s"]
        line["breakdown"] = {"device_ops": out.trace.device_ops(),
                             "idle_gaps": out.trace.idle_gaps(ops=out.ctx.get("ops_trace"))}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line


def execute(root: str, workload: str, seed: int, seconds: float, trace: bool, t0: float,
            device=None, control: bool = False) -> dict:
    """Run one cell once and return its result line (a dict). ``device``:
    None for the card (refused without enough CUDA devices), or a torch
    device for a run without the card's checks (the harness tests)."""
    import torch

    torch.set_num_threads(THREADS)
    cell = load_cell(root, workload)
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < cell.chips:
            raise SystemExit(f"portbench: {workload} needs {cell.chips} CUDA device(s); "
                             f"found {found}")
        device = torch.device("cuda", 0)
    run = Run(cell, seed, float(seconds), bool(trace), torch.device(device), t0, control)
    out = cell.driver().run(run)
    return result(cell, run, out)


def now() -> float:
    return time.perf_counter()


def sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def free() -> None:
    """Release the program's memory before the reference runs."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
