"""The profiler's reading of the window: every device operation
(kernels, copies, sets) that ``torch.profiler`` records through CUPTI,
on the host's ``perf_counter`` clock.

The profiler's clock is not ``perf_counter``'s, and it records host
spans only of the thread that started it, not the server's.  So the
main thread, right after starting it, opens a marker span
(``portbench.clock``) whose start it also reads on ``perf_counter``;
the difference puts every device operation on the clock of the call
record, and the call record names what the host was doing.
"""
from __future__ import annotations

import bisect
import re
import time

MARKER = "portbench.clock"


class Tracer:
    """The profiler over the whole window: started in set-up, once the
    device is idle, and stopped once the clients have stopped, so that
    it never starts or stops while the server captures or replays a
    CUDA graph."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self._marker_ns = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()
        self._marker_ns = time.perf_counter_ns()
        with self.torch.profiler.record_function(MARKER):
            pass

    def stop(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.prof.stop()

    def read(self, lo: float, hi: float) -> "Trace":
        """The device operations within [lo, hi] (``perf_counter``)."""
        events = self.prof.profiler.kineto_results.events()
        marker = [e for e in events if e.name() == MARKER]
        if not marker:
            raise RuntimeError("the profiler lost the clock marker")
        offset = marker[0].start_ns() - self._marker_ns
        cuda = self.torch.autograd.DeviceType.CUDA
        ops = [(e.name(), (e.start_ns() - offset) / 1e9,
                (e.end_ns() - offset) / 1e9)
               for e in events if e.device_type() == cuda]
        self.prof = None
        return Trace(ops, lo, hi)


class Trace:
    """Device operations ``(name, start, end)`` in ``perf_counter``
    seconds, clipped to the window [``lo``, ``hi``]."""

    def __init__(self, ops, lo: float, hi: float):
        self.lo, self.hi = lo, hi
        self.ops = [(n, max(a, lo), min(b, hi)) for n, a, b in ops
                    if b > lo and a < hi]
        self.busy = self._merge([(a, b) for _, a, b in self.ops])

    @staticmethod
    def _merge(spans):
        out = []
        for a, b in sorted(spans):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        """Seconds in which at least one operation ran on the device."""
        return sum(b - a for a, b in self.busy)

    def top_ops(self, n: int = 10):
        """``[name, seconds]`` of the ``n`` operations (by name) that took
        the most device time."""
        by = {}
        for name, a, b in self.ops:
            by[name[:120]] = by.get(name[:120], 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def gaps(self):
        """``(start, end)`` of every stretch with no device operation."""
        edges = [self.lo] + [x for a, b in self.busy for x in (a, b)] + [
            self.hi]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def idle_by_host(self, calls, n: int = 10):
        """The idle stretches summed by what the host was doing in their
        middle, from the call record: inside a call (its kind), between
        two decode steps of one generation (the host's argmax and token
        feed), or between generations (the server and the clients).
        ``[label, seconds]``, the ``n`` largest."""
        calls = sorted(calls, key=lambda c: c["start"])
        starts = [c["start"] for c in calls]
        by = {}
        for a, b in self.gaps():
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid)  # calls[i - 1] began before
            if i and calls[i - 1]["end"] >= mid:
                label = "inside " + calls[i - 1]["kind"]
            elif i and i < len(calls) and calls[i]["kind"] != "prefill":
                label = "between decode steps (host argmax, token feed)"
            else:
                label = "between generations (server, clients)"
            by[label] = by.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def kernel_seconds(self, patterns, spans) -> float:
        """Device seconds of the operations whose names match one of the
        regular expressions ``patterns`` and which lie inside one of the
        host ``spans`` ``(start, end)``."""
        rx = [re.compile(p) for p in patterns]
        total = 0.0
        for name, a, b in self.ops:
            if any(r.search(name) for r in rx) and any(
                    lo <= a and b <= hi for lo, hi in spans):
                total += b - a
        return total
