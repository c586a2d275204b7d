"""Export a segmentor's clip forward as a serialized program that runs its
hand-written kernels, the port's copy of the JAX package's
``tools/export.py`` (which stands in for the reference's
``tools/pytorch2onnx.py``)::

    python -m vss_cffm_tpu_torch.tools.export vss_cffm_tpu_torch/configs/cffm_b1_vspw_160k.py \\
        CKPT out.pt2 [--shape 480 480] [--verify] [--device cuda|cpu] [--options k=v ...]

The model is ``init_segmentor(cfg, checkpoint=CKPT)`` in eval mode, in bf16
where ``cfg.bf16`` is set; its forward of one clip of
``len(cfg.data.dilation) + 1`` frames at the fixed ``--shape`` (the target
frame's refined logits, as the JAX tool exports ``model.apply(..., imgs,
False)``) is traced by ``torch.export.export`` under ``torch.no_grad()``
and written with ``torch.export.save`` (weights inside). It runs on the
card unless ``--device cpu`` is asked for, and the program runs on the
device it was exported on.

The inference ops (``ops.mit_block_fused``, ``cfm_attention``,
``dwconv3x3``, ``block_ffn_fused``, ``mixffn_fused``) are custom ops of the
``vss_cffm`` namespace, so each stays one node of the graph and the
reloaded program launches their kernels (plain PyTorch on a CPU tensor, as
their ``force=None`` rule says). The tool prints the custom ops it finds in
the graph with their counts, and fails on a graph without them.

``--verify`` reloads the file with ``torch.export.load``, holds the
reloaded program against the live forward on a random clip at the JAX
tool's rtol / atol 1e-2, and holds the graph's count of each custom op to
the live forward's calls of it and to the reloaded program's (on the card
also to both runs' kernel launches).

The one difference from the JAX tool's StableHLO module: the program's
custom ops must be registered in the process that reloads it, so that
process runs ``import vss_cffm_tpu_torch.ops`` before
``torch.export.load``. It needs no model code.
"""

from __future__ import annotations

import argparse
import collections
import os

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import ops
from ..ops._dispatch import NAMESPACE

__all__ = ["export_clip_forward", "graph_ops", "op_calls", "main"]

_PREFIX = f"{NAMESPACE}::"


def _op_name(target) -> str | None:
    """``vss_cffm::<op>`` of a custom op overload, else None."""
    name = getattr(target, "name", None)
    name = name() if callable(name) else None
    if name is None or not name.startswith(_PREFIX):
        return None
    return name


def graph_ops(program: torch.export.ExportedProgram) -> dict[str, int]:
    """{``vss_cffm::<op>``: the nodes of the program's graph that call it}."""
    counts = collections.Counter(
        _op_name(n.target) for n in program.graph.nodes if n.op == "call_function")
    counts.pop(None, None)
    return dict(sorted(counts.items()))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = _op_name(func)
        if name is not None:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def op_calls(fn, *args) -> tuple[object, dict[str, int]]:
    """(fn(*args), {``vss_cffm::<op>``: its calls in that run})."""
    with _CountOps() as mode:
        out = fn(*args)
    return out, dict(sorted(mode.counts.items()))


def export_clip_forward(model: torch.nn.Module, sample: torch.Tensor
                        ) -> torch.export.ExportedProgram:
    """The eval forward of ``model`` (in eval mode) at ``sample``'s shape,
    traced without autograd."""
    if model.training:
        raise ValueError("export_clip_forward: the model must be in eval mode")
    with torch.no_grad():
        return torch.export.export(model, (sample,))


def _launches_during(fn, *args) -> tuple[object, dict[str, int]]:
    """(fn(*args), each kernel's launches in that run), synchronised."""
    before = ops.launches()
    out = fn(*args)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out, {k: v - before[k] for k, v in ops.launches().items() if v - before[k]}


def _held_counts(graph: dict, got: dict, what: str) -> None:
    if got != graph:
        raise RuntimeError(f"export: {what} {got} differ from the graph's custom ops {graph}")


def main(argv: list[str] | None = None) -> dict:
    """Export (and with ``--verify`` check) the clip forward; returns the
    readings: the file and its MB, the graph's custom ops, and with
    ``--verify`` the live and reloaded calls and launches, the largest
    |reloaded − live|, whether the two are bitwise equal, and the reloaded
    program (``program``, an ``nn.Module``)."""
    ap = argparse.ArgumentParser(description="Export a segmentor's clip forward "
                                             "(torch.export, the kernels as custom ops).")
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("output")
    ap.add_argument("--shape", type=int, nargs=2, default=[480, 480])
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--options", nargs="*", default=[])
    args = ap.parse_args(argv)

    from ..apis import init_segmentor
    from ..config import apply_overrides, load_config
    from ..utils.logging import get_logger

    cfg = apply_overrides(load_config(args.config), args.options)
    logger = get_logger()
    bundle = init_segmentor(cfg, checkpoint=args.checkpoint, device=args.device)
    model = bundle.model
    t = len(cfg.data.dilation) + 1
    shape = (1, t, *args.shape, 3)
    sample = torch.zeros(shape, dtype=torch.float32, device=bundle.device)
    program = export_clip_forward(model, sample)
    found = graph_ops(program)
    if not found:
        raise RuntimeError(f"export: the graph holds no {NAMESPACE}:: custom op, so the "
                           "program would launch none of the kernels")
    torch.export.save(program, args.output)
    mb = os.path.getsize(args.output) / 1e6
    logger.info(f"wrote {args.output} ({mb:.1f} MB, input {tuple(shape)} on "
                f"{bundle.device.type}, {'bf16' if cfg.bf16 else 'f32'})")
    logger.info("graph custom ops: " + ", ".join(f"{k} x{v}" for k, v in found.items()))
    out = {"output": args.output, "mb": mb, "shape": shape, "graph_ops": found}
    if not args.verify:
        return out

    reloaded = torch.export.load(args.output).module()
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32))
    x = x.to(bundle.device)
    with torch.no_grad():
        (live, live_launches), live_calls = op_calls(_launches_during, model, x)
        (got, got_launches), got_calls = op_calls(_launches_during, reloaded, x)
    _held_counts(found, live_calls, "the live forward's custom-op calls")
    _held_counts(found, got_calls, "the reloaded program's custom-op calls")
    if bundle.device.type == "cuda":
        kernels = {k.removeprefix(_PREFIX): v for k, v in found.items()}
        for what, launched in (("live", live_launches), ("reloaded", got_launches)):
            launched = {k: v for k, v in launched.items() if k in kernels}
            _held_counts(kernels, launched, f"the {what} forward's kernel launches")
    np.testing.assert_allclose(got.float().cpu().numpy(), live.float().cpu().numpy(),
                               rtol=1e-2, atol=1e-2)
    err = (got.float() - live.float()).abs().max().item()
    bitwise = bool(torch.equal(got, live))
    logger.info(f"verify: reloaded program matches the live forward (max |diff| {err:.3e}, "
                f"{'bitwise equal' if bitwise else 'not bitwise equal'}); custom-op calls "
                f"{got_calls}, kernel launches {got_launches}")
    out.update(live_calls=live_calls, reloaded_calls=got_calls, live_launches=live_launches,
               reloaded_launches=got_launches, max_abs_err=err, bitwise=bitwise,
               max_abs_live=live.float().abs().max().item(), program=reloaded)
    return out


if __name__ == "__main__":
    main()
