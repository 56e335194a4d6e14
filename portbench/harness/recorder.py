"""A record of the backend calls that the server makes, taken by
wrapping the session backend's ``prefill`` and ``decode`` on the
instance (``LMBackend.generate`` calls them through ``self``).

Each call returns its logits on the host (the backend ends it with
``.cpu()``), so its host-clock span covers its device work.  A call is
logged with its kind: ``prefill``; ``decode.eager``, ``decode.capture``
or ``decode.replay`` for a handle's first, second and later decode
steps (the graphed decode's warm-up, capture, and replays).  Each
prefill opens a batch, which keeps the prompts as the program got them,
the tokens fed to each decode step, and the logits every call returned
(references to the arrays the backend made, not copies).

One server worker makes the calls, one generation at a time, so the
handle of the newest prefill is the one the decode steps advance (the
record keeps its ``id``, not the handle, whose caches the server frees).
"""
from __future__ import annotations

import threading
import time

import numpy as np

DECODE_KINDS = ("decode.eager", "decode.capture")


class Batch:
    __slots__ = ("prompts", "fed", "logits")

    def __init__(self, prompts: np.ndarray):
        self.prompts = prompts
        self.fed = []
        self.logits = []


class Recorder:
    def __init__(self, backend):
        self.backend = backend
        self.calls = []    # dicts: kind, start, end, batch, start_pos, stop_pos
        self.batches = []
        self._handle = None
        self._lock = threading.Lock()
        self._orig = None

    def install(self) -> "Recorder":
        be = self.backend
        prefill, decode = be.prefill, be.decode
        self._orig = (prefill, decode)

        def rec_prefill(tokens):
            t0 = time.perf_counter()
            logits, handle = prefill(tokens)
            t1 = time.perf_counter()
            prompts = np.asarray(tokens)
            batch = Batch(prompts)
            batch.logits.append(logits)
            with self._lock:
                self._handle = (id(handle), batch)
                self.batches.append(batch)
                self.calls.append(dict(
                    kind="prefill", start=t0, end=t1, batch=prompts.shape[0],
                    start_pos=0, stop_pos=prompts.shape[1]))
            return logits, handle

        def rec_decode(handle, tokens):
            with self._lock:
                cur, batch = self._handle
            if cur != id(handle):
                raise RuntimeError("a decode step on a handle other than "
                                   "the newest prefill's")
            step = len(batch.fed)
            pos = handle.pos
            t0 = time.perf_counter()
            logits = decode(handle, tokens)
            t1 = time.perf_counter()
            batch.fed.append(np.array(tokens, np.int32).reshape(-1))
            batch.logits.append(logits)
            kind = DECODE_KINDS[step] if step < 2 else "decode.replay"
            with self._lock:
                self.calls.append(dict(
                    kind=kind, start=t0, end=t1, batch=len(batch.fed[-1]),
                    start_pos=pos, stop_pos=pos + 1))
            return logits

        be.prefill, be.decode = rec_prefill, rec_decode
        return self

    def uninstall(self) -> None:
        if self._orig is not None:
            del self.backend.prefill, self.backend.decode
        self._orig = self._handle = self.backend = None
