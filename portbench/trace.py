"""A profiled window and its reduction: device intervals, busy time, idle
gaps labelled by what the device waited for, device time by kernel, and
device time of the kernels launched inside named host ranges.

``capture(fn, launches_fn, ops)`` runs ``fn`` under ``torch.profiler``
between two synchronizes, which bound the window, and returns a ``Trace``.
With ``ops`` it records the host's ops too (CPU and CUDA activities), which
names the host ranges. Without it only the CUDA activities are traced
(kernels, copies and the runtime calls that launched them). Either slows
the host's launches (a B1 train step: +35 % with CUDA activities alone,
+86 % with the ops), so a profiled window's own idle time is mostly the
profiler's; the device's busy time a step does not depend on that (the
readers hold it against the untraced window). A kernel belongs to a named
range when the host op it is linked to (its launch) started inside one of
that range's intervals.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
from collections import defaultdict

import torch

_RUNTIME = re.compile(r"^(cuda|cu[A-Z])")
_SYNC = "cudaDeviceSynchronize"
# runtime calls during which the host waits on the device or the driver
_BLOCKING = re.compile(r"Synchronize|cudaMemcpy(?!Async)|cudaMalloc|cudaFree|cudaHostAlloc")


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]                     # host ns of the traced window
    device: list[tuple[int, int, str, int]]     # (start ns, end ns, name, linked op id)
    cpu: list[tuple[int, int, str, int, int]]   # host ops: (start, end, name, op id, thread)
    launches: dict[str, int]                    # the program's op launches in the window
    starts: dict[int, int] = dataclasses.field(default_factory=dict)  # host id -> start
    runtime: list[tuple[int, int, str]] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy(self) -> list[tuple[int, int]]:
        """Union of the device intervals inside the window, sorted."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for s, e, _, _ in self.device if e > lo and s < hi)
        merged: list[list[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9

    def gaps(self) -> list[tuple[int, int]]:
        lo, hi = self.window
        out, at = [], lo
        for s, e in self.busy():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if hi > at:
            out.append((at, hi))
        return out

    def host_op_at(self, t: int) -> str:
        """The innermost host op running at host time t on any thread (the
        latest-starting op that contains t, the shortest across threads);
        none: "host idle"."""
        if not hasattr(self, "_by_thread"):
            by: dict[int, list] = defaultdict(list)
            for ev in sorted(self.cpu):
                by[ev[4]].append(ev)
            self._by_thread = {k: ([ev[0] for ev in v], v) for k, v in by.items()}
        best = None
        for starts, evs in self._by_thread.values():
            i = bisect.bisect_right(starts, t) - 1
            for j in range(i, max(i - 4000, -1), -1):
                s, e, name = evs[j][:3]
                if e > t:
                    if best is None or e - s < best[1] - best[0]:
                        best = (s, e, name)
                    break
        return best[2] if best else "host idle"

    def kernels(self, pattern: re.Pattern | None = None) -> list[tuple[int, int, str, int]]:
        return [d for d in self.device if pattern is None or pattern.search(d[2])]

    def range_device_s(self, prefix: str) -> tuple[float, int]:
        """(device seconds, intervals) of the kernels launched inside the host
        ranges whose name starts with ``prefix``."""
        spans = sorted((s, e) for s, e, name, _, _ in self.cpu if name.startswith(prefix))
        if not spans:
            return 0.0, 0
        starts = self.starts or {op: s for s, _, _, op, _ in self.cpu}
        lo = [s for s, _ in spans]
        total = 0
        for s, e, _, op in self.device:
            t = starts.get(op)
            if t is None:
                continue
            i = bisect.bisect_right(lo, t) - 1
            if i >= 0 and t < spans[i][1]:
                total += e - s
        return total * 1e-9, len(spans)

    def device_ops(self, top: int = 10) -> list[list]:
        by: dict[str, int] = defaultdict(int)
        for s, e, name, _ in self.device:
            by[short_name(name)] += e - s
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def launch_op(self, i: int) -> str:
        """The host op that launched the i-th device op in start order."""
        if not hasattr(self, "_sorted"):
            self._sorted = sorted(self.device)
        op = self._sorted[i][3]
        return self.host_op_at(self.starts[op]) if op in self.starts else "not linked"

    def blocking_at(self, t: int) -> str | None:
        """The blocking runtime call the host was in at host time t, if any."""
        if not hasattr(self, "_blocking"):
            self._blocking = sorted(r for r in self.runtime if _BLOCKING.search(r[2]))
            self._blocking_starts = [r[0] for r in self._blocking]
        i = bisect.bisect_right(self._blocking_starts, t) - 1
        if i >= 0 and t < self._blocking[i][1]:
            return self._blocking[i][2]
        return None

    def idle_gaps(self, top: int = 10, ops: Trace | None = None) -> list[list]:
        """Idle device time by what the device waited for: the blocking
        runtime call the host was in; else the next device op, "launch of"
        it where the host launched it after the device fell idle, "queued"
        where the launch came first; or the window's end. The op is named by
        the host op that launched it in ``ops``, a trace of as many steps
        with the host's ops (the k-th run of a kernel here is its k-th run
        there); else, or where ``ops`` lacks that run, by its kernel."""
        devs = sorted(self.device)
        firsts = [d[0] for d in devs]
        there: dict[str, list[int]] = defaultdict(list)
        for j, d in enumerate(sorted(ops.device) if ops is not None else []):
            there[d[2]].append(j)
        runs: dict[str, int] = defaultdict(int)
        match = []
        for d in devs:
            k = runs[d[2]]
            runs[d[2]] += 1
            match.append(there[d[2]][k] if k < len(there[d[2]]) else None)
        by: dict[str, int] = defaultdict(int)
        for s, e in self.gaps():
            label = self.blocking_at(s)
            i = bisect.bisect_left(firsts, e)
            if label is not None:
                label = "host in " + label
            elif i == len(devs):
                label = "window end"
            else:
                launched = self.starts.get(devs[i][3])
                what = ops.launch_op(match[i]) if match[i] is not None else short_name(devs[i][2])
                label = ("launch of " if launched is None or launched >= s else "queued ") + what
            by[label] += e - s
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def short_name(name: str, limit: int = 96) -> str:
    """A kernel name without its argument list, cut to ``limit``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:limit]


def kernel_pattern(root: str) -> re.Pattern:
    """Regex of the program's kernel names (``kernels.json``): the function
    name followed by a template or argument list, or mangled with its length."""
    with open(os.path.join(root, "portbench", "kernels.json")) as f:
        names = [n for n in json.load(f) if not n.startswith("_")]
    alts = [rf"(?<![A-Za-z0-9_]){re.escape(n)}\s*[<(]|{len(n)}{re.escape(n)}" for n in names]
    return re.compile("|".join(alts))


def capture(fn, launches_fn=None, ops: bool = True) -> Trace:
    """Run ``fn()`` under the profiler between two synchronizes, and reduce.
    ``launches_fn()`` gives the program's launch counts, read before and
    after; ``ops``: record the host's ops too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ops else [])
    before = launches_fn() if launches_fn else {}
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    after = launches_fn() if launches_fn else {}
    device, cpu, runtime, starts, launched = [], [], [], {}, {}
    events = prof.profiler.kineto_results.events()
    host_names = {e.name() for e in events if str(e.device_type()).endswith("CPU")}
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        kind = str(e.device_type())
        if kind.endswith("CUDA"):
            # the device-side spans of host ranges (named as the range) are no
            # device work
            if not e.is_user_annotation() and e.name() not in host_names:
                device.append((s, s + d, e.name(), e.linked_correlation_id()))
        elif kind.endswith("CPU"):
            name = e.name()
            if _RUNTIME.match(name):
                runtime.append((s, s + d, name))
                launched[e.correlation_id()] = s
            else:
                starts[e.correlation_id()] = s
                cpu.append((s, s + d, name, e.correlation_id(), e.start_thread_id()))
    syncs = sorted((s, e) for s, e, name in runtime if name == _SYNC)
    if len(syncs) < 2:
        raise RuntimeError(f"the profiler recorded {len(syncs)} synchronizes, not the window's two")
    runtime.sort()
    # a kernel's link is the runtime call that launched it: its start is the launch
    return Trace((syncs[0][1], syncs[-1][1]), device, cpu,
                 {k: after[k] - before.get(k, 0) for k in after}, {**starts, **launched}, runtime)


def capture_all(fn, launches_fn, root: str, ops: bool = True, tries: int = 3) -> Trace:
    """A profiled window that caught every launch the program counted: the
    profiler has dropped windows, so up to ``tries`` windows."""
    pattern = kernel_pattern(root)
    for _ in range(tries):
        t = capture(fn, launches_fn, ops)
        caught, counted = len(t.kernels(pattern)), sum(t.launches.values())
        if counted and caught >= counted:
            return t
    raise RuntimeError(f"the profiler caught {caught} of the program's kernels for "
                       f"{counted} launches in {tries} windows")
