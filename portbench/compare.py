"""The numbers that decide ``correct``, and their checks against a cell's
limits (``workloads/<cell>.json``).

Training (the first three steps against the reference's three):
- ``loss_rel``: the widest relative gap of a step's loss;
- ``grad_median_rel``: the first gradient, leaf by leaf: the gap between
  the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf; the median over the
  leaves. (The worst leaf, ``_grad_worst``, is printed beside it and not
  compared: it is always a bias whose gradient is a sum over all tokens
  that the batch-statistic BatchNorm downstream nearly cancels, where the
  program's bf16 cotangents leave a residue of rounding; see PERF.md.)
- ``delta_leaf_rel``: the parameters' change after three steps, leaf by
  leaf as above; the worst leaf;
- ``delta_median_rel``: the same change, the median leaf (where the worst
  leaf is the noise of a small leaf, as on CFFM-B5: see PERF.md).

Both leave out, on both sides, the entries whose first reference gradient
is under a thousandth of the median leaf's root mean square: their gradient
is nought but for rounding (a key's bias under softmax, a bias before the
batch-statistics BatchNorm), so the program's is its rounding noise, and
under Adam they move by that noise alone. A leaf with no entry left is left
out.
"""

from __future__ import annotations

import torch

from .harness import Check

SKIP_BELOW = 1e-3  # of the median leaf's gradient RMS: rounding alone


def _median(values: list[float]) -> float:
    return float(torch.tensor(values, dtype=torch.float64).median())


def _leaf_gaps(prog: dict, ref: dict, keep: dict) -> dict[str, float]:
    """Per leaf with an entry kept: the gap of the kept entries' norms over
    the larger of the reference's norm of the leaf and of the median leaf."""
    names = [n for n in ref if bool(keep[n].any())]
    norm = lambda t, n: float(torch.linalg.vector_norm(t[keep[n]].double()))
    ref_n = {n: norm(ref[n], n) for n in names}
    med = _median(list(ref_n.values()))
    return {n: abs(norm(prog[n], n) - ref_n[n]) / max(ref_n[n], med, 1e-30) for n in names}


def train_numbers(prog: dict, ref: dict, theta0: dict) -> dict:
    """prog / ref: {"losses": [3 floats], "grad1": {name: tensor},
    "params": {name: tensor after three steps}}."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    rms = {n: float(g.double().square().mean().sqrt()) for n, g in ref["grad1"].items()}
    floor = SKIP_BELOW * _median(list(rms.values()))
    keep = {n: g.abs() >= floor for n, g in ref["grad1"].items()}
    grad = _leaf_gaps(prog["grad1"], ref["grad1"], keep)
    d_prog = {n: prog["params"][n].float() - theta0[n].float() for n in ref["params"]}
    d_ref = {n: ref["params"][n].float() - theta0[n].float() for n in ref["params"]}
    delta = _leaf_gaps(d_prog, d_ref, keep)
    worst = lambda gaps: max(gaps, key=gaps.get)
    diff = lambda a, b: float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm((a[n] - b[n])[keep[n]].double()) for n in keep])))
    total = lambda a: float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(a[n][keep[n]].double()) for n in keep])))
    return {"loss_rel": max(losses), "grad_median_rel": _median(list(grad.values())),
            "delta_leaf_rel": max(delta.values()), "_grad_worst": max(grad.values()),
            "delta_median_rel": _median(list(delta.values())), "_loss1_rel": losses[0],
            "_grad_diff_rel": diff(prog["grad1"], ref["grad1"]) / total(ref["grad1"]),
            "_delta_diff_rel": diff(d_prog, d_ref) / total(d_ref),
            "_losses": prog["losses"], "_ref_losses": ref["losses"],
            "_grad_at": worst(grad), "_delta_at": worst(delta),
            "_left_out": sum(int((~k).sum()) for k in keep.values()),
            "_entries": sum(k.numel() for k in keep.values())}


def checks(numbers: dict, limits: dict, present_only: bool = False) -> list[Check]:
    """Every number that has a limit: passed when it is at most the limit.
    ``present_only``: only the limits of the numbers given."""
    return [Check(name, float(numbers[name]), float(limit), bool(numbers[name] <= limit))
            for name, limit in limits["limits"].items()
            if not present_only or name in numbers]
