"""The general traffic generator: a mix file's clients against the
server.

``loop: "closed"``: ``clients`` threads, each sending its next request
as soon as its reply arrives, from the window's start until its end.  A
request is a prompt of ``prompt_tokens`` ids drawn uniformly over the
vocabulary from the run's seed (one stream a client) and ``max_new``
new tokens.  Each request is timed on the client, from before
``submit`` to after ``result``.  A request sent in the window and
still running at its close is waited for, up to ``GRACE_S`` past the
close; one that fails or does not come by then is failed.
"""
from __future__ import annotations

import threading
import time

import numpy as np

GRACE_S = 60.0


def prompt_stream(seed: int, stream: int, length: int, vocab: int):
    """Prompts of ``length`` ids drawn uniformly from ``[0, vocab)``, from
    stream ``stream`` of the seed (0: set-up's warm-up; 1 + c: client c)."""
    rng = np.random.default_rng([int(seed), 1, stream])
    while True:
        yield rng.integers(0, vocab, length, dtype=np.int32)


class ClosedLoop:
    def __init__(self, server, mix: dict, seed: int, vocab: int):
        if mix["loop"] != "closed":
            raise ValueError(f"unknown loop {mix['loop']!r}")
        self.server = server
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.requests = []
        self.errors = []
        self._go = threading.Event()
        self._end = None
        self._threads = [threading.Thread(target=self._client, args=(c,),
                                          name=f"client-{c}", daemon=True)
                         for c in range(mix["clients"])]
        for t in self._threads:
            t.start()

    def prompts(self, client: int):
        """The prompts client ``client`` sends, in order."""
        return prompt_stream(self.seed, 1 + client, self.mix["prompt_tokens"],
                             self.vocab)

    def start(self, seconds: float) -> float:
        """Release the clients; returns the window's start."""
        t0 = time.perf_counter()
        self._end = t0 + seconds
        self._go.set()
        return t0

    def join(self) -> None:
        """Wait for every client to stop (each does by the close plus the
        grace)."""
        for t in self._threads:
            t.join(max(0.0, self._end + GRACE_S + 5.0 - time.perf_counter()))
            if t.is_alive():
                raise RuntimeError(f"{t.name} did not stop")

    def _client(self, c: int) -> None:
        self._go.wait()
        max_new = self.mix["max_new"]
        for prompt in self.prompts(c):
            if time.perf_counter() >= self._end:
                return
            fut = tokens = None
            t0 = time.perf_counter()
            try:
                fut = self.server.submit(prompt, max_new)
                tokens = fut.result(timeout=max(
                    0.0, self._end + GRACE_S - time.perf_counter()))
                ok = True
            except Exception as e:  # a failed request: counted, not fatal
                ok = False
                self.errors.append(repr(e))
            t1 = time.perf_counter()
            stamps = fut.timestamps if fut is not None else {}
            self.requests.append(dict(
                client=c, submit=t0, end=t1, ok=ok, key=prompt.tobytes(),
                tokens=tokens, queue_wait=(stamps["dequeue"] - stamps["submit"]
                                           if "dequeue" in stamps else None)))
            if not ok:
                return
