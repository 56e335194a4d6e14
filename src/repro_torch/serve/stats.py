"""Rolling server observability: latency percentiles, throughput,
queue/batch counters (the port's copy of the JAX package's
``serve/stats.py``).

One :class:`ServerStats` instance per server, shared by every worker
thread; all mutation happens under one lock (the critical sections are
a few appends — contention is negligible next to a model forward).
Samples live in bounded deques so a long-running server reports
*recent* behavior, not its lifetime average.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np


def _pct(samples, q: float) -> float:
    if not samples:
        return float("nan")
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


class ServerStats:
    """Counters + rolling windows for :class:`repro_torch.serve.InferenceServer`.

    Latency samples are microseconds, split per stage:

    * ``queue_wait`` — submit -> picked up by a worker
    * ``exec``       — worker batch-forward wall time (per request)
    * ``total``      — submit -> result ready (what the client feels)
    """

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self.window = int(window)
        self._total_us = deque(maxlen=self.window)
        self._queue_wait_us = deque(maxlen=self.window)
        self._exec_us = deque(maxlen=self.window)
        self._batch_sizes = deque(maxlen=self.window)
        self._done_at = deque(maxlen=self.window)   # completion stamps
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.timeouts = 0
        self.rejected_queue_full = 0
        self.rejected_closed = 0
        self.batches = 0

    # -- recording (called by server/workers) -----------------------------

    def on_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def on_reject(self, *, closed: bool) -> None:
        with self._lock:
            if closed:
                self.rejected_closed += 1
            else:
                self.rejected_queue_full += 1

    def on_timeout(self) -> None:
        with self._lock:
            self.timeouts += 1

    def on_failure(self) -> None:
        with self._lock:
            self.failed += 1

    def on_batch(self, size: int) -> None:
        with self._lock:
            self.batches += 1
            self._batch_sizes.append(size)

    def on_complete_batch(self, totals_us, queue_waits_us, exec_us: float,
                          now: Optional[float] = None) -> None:
        """Record a whole batch under one lock acquisition — the server
        hot path calls this once per batch, not once per request."""
        if now is None:
            now = time.perf_counter()
        with self._lock:
            self.completed += len(totals_us)
            self._total_us.extend(totals_us)
            self._queue_wait_us.extend(queue_waits_us)
            self._exec_us.extend(exec_us for _ in totals_us)
            self._done_at.extend(now for _ in totals_us)

    # -- reading -----------------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            total = list(self._total_us)
            qwait = list(self._queue_wait_us)
            execu = list(self._exec_us)
            sizes = list(self._batch_sizes)
            done = list(self._done_at)
            counters = dict(
                submitted=self.submitted, completed=self.completed,
                failed=self.failed, timeouts=self.timeouts,
                rejected_queue_full=self.rejected_queue_full,
                rejected_closed=self.rejected_closed, batches=self.batches)
        qps = 0.0
        if len(done) >= 2:
            span = done[-1] - done[0]
            if span > 0:
                # the window holds len(done) completions over `span`
                # seconds between the first and last stamp
                qps = (len(done) - 1) / span
        out: Dict[str, float] = dict(counters)
        out.update(
            latency_p50_us=_pct(total, 50), latency_p99_us=_pct(total, 99),
            queue_wait_p50_us=_pct(qwait, 50),
            queue_wait_p99_us=_pct(qwait, 99),
            exec_p50_us=_pct(execu, 50), exec_p99_us=_pct(execu, 99),
            batch_size_mean=float(np.mean(sizes)) if sizes else float("nan"),
            batch_size_max=float(max(sizes)) if sizes else float("nan"),
            qps=qps,
            window=self.window,
        )
        return out
