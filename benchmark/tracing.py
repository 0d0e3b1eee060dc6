"""Spans around the program's layers, the profiled stretch of a traced run,
and the reduction of its trace to what the per-layer readers take.

Spans are recorded from the benchmark's side: each target, a function or an
operator class's method named ``module:qualname``, is replaced wherever the
loaded port refers to it by a wrapper that opens a
``torch.profiler.record_function`` range ``bench:<label>`` and counts its
outermost calls. Operator products add their shape to the range's name
(``bench:spmm|n|nnz|b|value size|x size``), so the roofline reads its work
from n, nnz, b and the value type, never from the kernels. A target the
program no longer has is reported and its readers read nothing.

The profiler (CPU and CUDA activities, kept in memory) runs over a bounded
stretch of the window: from the first commit after ``start_fraction`` of the
window until ``units`` more units have been committed, synchronizing the
device at both ends. Device activity is attributed to the spans open on the
host when it was launched.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import sys
import time
from collections import defaultdict

import torch

PORT = "krylov_robustness_torch"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 160  # of a device operation's name in the breakdown


def _kinds(events) -> list[str]:
    """Kineto's activity type of each event: from the event where this
    PyTorch exposes it, else from its device and name (a device event named
    as a host range, or as one of the benchmark's own ``bench:`` spans whose
    host range began before the profiler did, is that range's mirror on the
    device, not work; a host event named ``cu…`` without ``::`` is a CUDA
    runtime or driver call)."""
    if events and hasattr(events[0], "activity_type"):
        return [e.activity_type() for e in events]
    cpu = torch.autograd.DeviceType.CPU
    host_names = {e.name() for e in events if e.device_type() == cpu}
    out = []
    for e in events:
        name = e.name()
        if e.device_type() != cpu:
            mirror = name in host_names or name.startswith("bench:")
            out.append("gpu_user_annotation" if mirror else "kernel")
        elif name.startswith("cu") and "::" not in name:
            out.append("cuda_runtime")
        else:
            out.append("cpu_op")
    return out


def _resolve(target: str):
    """(owner, attribute, current object) of ``module:qualname``; raises
    LookupError when the program has no such thing."""
    mod_name, _, qual = target.partition(":")
    try:
        owner = importlib.import_module(mod_name)
    except ImportError as e:
        raise LookupError(f"{target}: {e}") from None
    *path, attr = qual.split(".")
    for part in path:
        owner = getattr(owner, part, None)
        if owner is None:
            raise LookupError(f"{target}: no {part}")
    if not hasattr(owner, attr):
        raise LookupError(f"{target}: no {attr}")
    return owner, attr, getattr(owner, attr)


def _shape_tag(args) -> str:
    """'|n|nnz|b|value size|x size' of an operator product op @ x."""
    op, x = args[0], args[1]
    b = 1 if x.ndim == 1 else x.shape[1]
    value_size = torch.empty((), dtype=op.dtype).element_size()
    return f"|{op.n}|{op.nnz}|{b}|{value_size}|{x.element_size()}"


class Spans:
    """The wrappers of one traced run, keyed by label."""

    def __init__(self, targets: dict[str, list[str]]):
        self.targets = targets
        self.counts = defaultdict(int)
        self.missing: list[str] = []
        self._undo = []
        self._depth = defaultdict(int)

    def _wrap(self, label: str, fn, shaped: bool):
        depth, counts = self._depth, self.counts
        prefix = f"bench:{label}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            name = prefix + _shape_tag(args) if shaped else prefix
            if depth[label] == 0:
                counts[label] += 1
            depth[label] += 1
            try:
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            finally:
                depth[label] -= 1

        return wrapper

    def install(self, extra_modules=()) -> list[str]:
        """Wrap every target; returns the targets that are missing."""
        for label, targets in self.targets.items():
            for target in targets:
                try:
                    owner, attr, obj = _resolve(target)
                except LookupError as e:
                    self.missing.append(str(e))
                    continue
                shaped = attr in ("matmul", "__matmul__")
                new = self._wrap(label, obj, shaped)
                if isinstance(owner, type):
                    self._undo.append((owner, attr, obj))
                    setattr(owner, attr, new)
                    continue
                # a function: replace it wherever a loaded module holds it
                for mod in list(sys.modules.values()) + list(extra_modules):
                    name = getattr(mod, "__name__", "") or ""
                    if not (name.startswith(PORT) or mod in extra_modules):
                        continue
                    for key, val in list(vars(mod).items()):
                        if val is obj:
                            self._undo.append((mod, key, obj))
                            setattr(mod, key, new)
        return self.missing

    def uninstall(self):
        for owner, attr, obj in reversed(self._undo):
            setattr(owner, attr, obj)
        self._undo.clear()


class Stretch:
    """The profiled stretch of a traced run; ``committed`` is called by the
    driver after every commit of units. Two empty ``bench:mark`` ranges, one
    after the start and one before the end, bound the traced window on the
    profiler's clock."""

    def __init__(self, seconds: float, start_fraction: float, units: int,
                 device: torch.device):
        self.seconds, self.start_fraction = seconds, start_fraction
        self.units_wanted = units
        self.device = device
        self.prof = None
        self.units = 0
        self.total = 0  # units committed in the window so far
        self.profiled = (0, 0)  # [first, last) unit index in the stretch
        self.t0 = None
        self.done = False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def begin(self):
        self.t0 = time.perf_counter()

    def committed(self, n: int):
        self.total += n
        if self.done:
            return
        if self.prof is None:
            if time.perf_counter() - self.t0 < self.start_fraction * \
                    self.seconds:
                return
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._sync()
            self.prof = profile(activities=acts)
            self.prof.start()
            with torch.profiler.record_function("bench:mark"):
                pass
            self.profiled = (self.total, self.total)
            return
        self.units += n
        self.profiled = (self.profiled[0], self.total)
        if self.units >= self.units_wanted:
            self.stop()

    def stop(self):
        if self.prof is None or self.done:
            return
        self._sync()
        with torch.profiler.record_function("bench:mark"):
            pass
        self.prof.stop()
        self.done = True


class Trace:
    """The reduced trace of a stretch: bench spans (label, tag, start, end,
    parent), device intervals (name, start, end, enclosing spans), the
    traced window (ns on the profiler's clock)."""

    def __init__(self, prof, units: int):
        self.units = units
        ev = list(prof.profiler.kineto_results.events())
        ops_by_id = {}
        runtime_by_corr = {}
        spans = []
        device = []
        for e, kind in zip(ev, _kinds(ev)):
            if kind in DEVICE_KINDS:
                device.append(e)
                continue
            if e.device_type() != torch.autograd.DeviceType.CPU:
                continue
            if kind in RUNTIME_KINDS:
                runtime_by_corr[e.correlation_id()] = e
                continue
            ops_by_id[e.correlation_id()] = e
            name = e.name()
            if name.startswith("bench:"):
                label, _, tag = name[6:].partition("|")
                spans.append([label, tag, e.start_ns(), e.end_ns(), -1])
        marks = [s for s in spans if s[0] == "mark"]
        spans = [s for s in spans if s[0] != "mark"]
        spans.sort(key=lambda s: (s[2], -s[3]))
        stack = []
        for k, s in enumerate(spans):
            while stack and spans[stack[-1]][3] <= s[2]:
                stack.pop()
            s[4] = stack[-1] if stack else -1
            stack.append(k)
        self.spans = spans
        starts = [s[2] for s in spans]
        self.unattributed = 0
        self.device = []
        for e in device:
            # the launch on the host: its runtime call, else the operator
            host = runtime_by_corr.get(e.correlation_id()) or \
                ops_by_id.get(e.linked_correlation_id())
            chain = ()
            if host is None:
                self.unattributed += 1
            else:
                chain = self._enclosing(starts, host.start_ns())
            self.device.append((e.name(), e.start_ns(), e.end_ns(), chain))
        if len(marks) >= 2:
            self.t_start, self.t_stop = min(m[2] for m in marks), \
                max(m[3] for m in marks)
        else:
            ends = [s[2] for s in spans] + [s[3] for s in spans]
            self.t_start, self.t_stop = min(ends), max(ends)
        self.busy = self._union([(d[1], d[2]) for d in self.device])

    def _enclosing(self, starts, t) -> tuple:
        """Indices of the spans open at host time t, innermost first. The
        spans nest (one thread), so the innermost open one is the last to
        start before t or an ancestor of it."""
        k = bisect.bisect_right(starts, t) - 1
        while k >= 0 and self.spans[k][3] <= t:
            k = self.spans[k][4]
        out = []
        while k >= 0:
            out.append(k)
            k = self.spans[k][4]
        return tuple(out)

    @staticmethod
    def _union(intervals):
        out = []
        for a, b in sorted(intervals):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def window_s(self) -> float:
        return (self.t_stop - self.t_start) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(min(b, self.t_stop) - max(a, self.t_start)
                   for a, b in self.busy
                   if b > self.t_start and a < self.t_stop) * 1e-9

    def labels(self, chain) -> list[str]:
        return [self.spans[k][0] for k in chain]

    def device_s(self, inside: str, excluding=()) -> float:
        """Device seconds of everything launched inside a ``inside`` span,
        less what was launched inside an ``excluding`` span nested in it."""
        total = 0
        for _, a, b, chain in self.device:
            labels = self.labels(chain)
            if inside not in labels:
                continue
            outer = labels.index(inside)
            if any(x in labels[:outer] for x in excluding):
                continue
            total += b - a
        return total * 1e-9

    def outermost(self, label: str) -> list[int]:
        """Indices of the ``label`` spans not nested in another one."""
        out = []
        for k, s in enumerate(self.spans):
            if s[0] != label:
                continue
            p = s[4]
            while p >= 0 and self.spans[p][0] != label:
                p = self.spans[p][4]
            if p < 0:
                out.append(k)
        return out

    def host_s(self, label: str) -> float:
        """Host seconds in outermost ``label`` spans."""
        return sum(self.spans[k][3] - self.spans[k][2]
                   for k in self.outermost(label)) * 1e-9

    def self_s(self, label: str) -> float:
        """Host seconds in ``label`` spans less their child spans."""
        total = 0
        children = defaultdict(int)
        for s in self.spans:
            if s[4] >= 0:
                children[s[4]] += s[3] - s[2]
        for k, s in enumerate(self.spans):
            if s[0] == label:
                total += s[3] - s[2] - children[k]
        return total * 1e-9

    def per_span_device_s(self, label: str, excluding=()) -> dict:
        """Device seconds of each outermost ``label`` span (by index), less
        what nested ``excluding`` spans launched."""
        keep = set(self.outermost(label))
        out = defaultdict(int)
        for _, a, b, chain in self.device:
            for pos, k in enumerate(chain):
                if k in keep:
                    if not any(self.spans[c][0] in excluding
                               for c in chain[:pos]):
                        out[k] += b - a
                    break
        return {k: v * 1e-9 for k, v in out.items()}

    def breakdown(self, top: int = 10, samples: int = 8) -> dict:
        """The device operations that took most time, and the device's idle
        time by what the host was doing: each gap between busy intervals is
        shared among the innermost spans open on the host at ``samples``
        points across it."""
        by_name = defaultdict(int)
        for name, a, b, _ in self.device:
            by_name[name] += b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        starts = [s[2] for s in self.spans]
        gaps = defaultdict(float)
        edges = [self.t_start] + [x for ab in self.busy for x in ab] + \
            [self.t_stop]
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, self.t_start), min(b, self.t_stop)
            if b <= a:
                continue
            for k in range(samples):
                chain = self._enclosing(starts, a + (b - a) * (k + 0.5) /
                                        samples)
                label = self.spans[chain[0]][0] if chain else \
                    "between_layers"
                gaps[label] += (b - a) / samples
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:NAME_CHARS], v * 1e-9] for n, v in ops],
                "idle_gaps": [[n, v * 1e-9] for n, v in idle]}
