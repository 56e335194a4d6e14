"""Spans and counters of the port's LM serving path: a process-wide
recorder, off by default.

An operator turns it on around a stretch of serving, beside
``server.stats()``, and reads what it kept::

    from repro_torch import spans
    spans.enable()
    ...                      # serve
    spans.disable()
    records = spans.drain()  # returns and clears what was recorded

It records only between :func:`enable` and :func:`disable`.  Off, each
site costs a flag test: no record, no clock read, no CUDA call.  Records
stay in memory until :func:`drain`.

A host span is a dict: ``name``; ``start`` and ``end`` in
``time.perf_counter()`` seconds, the clock of the server's request
stamps; ``id``; ``parent``, the id of the span open around it on the
same thread (or ``None``); ``thread``, the ident of that thread;
``attrs``; ``counts``, what :func:`count` added while it was the
innermost open span.  A device span has ``name``, ``id``, ``parent``,
``thread`` and ``device_ms``: the device time between two CUDA events on
the stream that ran the work, which :func:`drain` waits for.

The serving path's spans, from the generation down:

* ``lm.generate``: one greedy generation of a batch (the server's
  worker thread runs one a batch); the host's argmax of each step's
  logits runs under it, between the backend's calls.
* ``backend.prefill``, ``backend.decode``: one call of the ``"cuda-lm"``
  backend.  A decode's attrs: ``step``, ``eager`` for a handle's first
  step, ``capture`` for its second, ``replay`` after (``eager`` off the
  card), and ``pos``.
* ``decode.capture``: the capture of a handle's decode step into its
  CUDA graph.
* ``decode.launch``: the enqueue of a graph replay.
* ``backend.logits_to_host``: the logits' copy to the host, which first
  waits for the device's work.
* ``moe.mlp`` (device): one MoE layer, routing through the combine,
  shared experts included; counters ``moe.routed_slots`` (tokens ×
  top-k) and ``moe.buffer_slots`` (experts × capacity slots computed),
  added to the innermost host span.  A replayed graph runs no Python, so
  both come from prefills, eager steps and captures only, and no device
  span is recorded while a graph is being captured.
"""
from __future__ import annotations

import itertools
import threading
import time

import torch

_on = False
_lock = threading.Lock()
_host: list = []      # finished host spans
_device: list = []    # (record, start event, end event)
_ids = itertools.count(1)
_tls = threading.local()


def enable() -> None:
    """Record from now on, in every thread."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording (spans open now still close into the record)."""
    global _on
    _on = False


def drain() -> list:
    """The records kept so far, host spans first, and clear them; waits
    for each device span's end event."""
    global _host, _device
    with _lock:
        host, dev, _host, _device = _host, _device, [], []
    for rec, start, end in dev:
        end.synchronize()
        rec["device_ms"] = start.elapsed_time(end)
    return host + [rec for rec, _, _ in dev]


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _record(name: str, start, attrs: dict) -> dict:
    stack = _stack()
    return {"name": name, "start": start, "end": None, "id": next(_ids),
            "parent": stack[-1]["id"] if stack else None,
            "thread": threading.get_ident(), "attrs": attrs, "counts": {}}


class _HostSpan:
    __slots__ = ("name", "attrs", "rec")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.rec = _record(self.name, time.perf_counter(), self.attrs)
        _stack().append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        _stack().pop()
        self.rec["end"] = time.perf_counter()
        with _lock:
            _host.append(self.rec)
        return False


def span(name: str, **attrs):
    """A context manager over one host span; it yields the span's record
    (``None`` when off), whose ``attrs`` a site may fill in.  Off, the
    one shared no-op context."""
    if not _on:
        return _OFF
    return _HostSpan(name, attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span on this
    thread (nothing where none is open)."""
    if not _on:
        return
    stack = _stack()
    if stack:
        counts = stack[-1]["counts"]
        counts[name] = counts.get(name, 0) + n


class _DeviceSpan:
    __slots__ = ("name", "stream", "rec", "start")

    def __init__(self, name, device):
        self.name = name
        self.stream = torch.cuda.current_stream(device)

    def __enter__(self):
        stack = _stack()
        self.rec = {"name": self.name, "id": next(_ids),
                    "parent": stack[-1]["id"] if stack else None,
                    "thread": threading.get_ident(), "device_ms": None}
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)
        return self.rec

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        with _lock:
            _device.append((self.rec, self.start, end))
        return False


def device_span(name: str, device: torch.device):
    """A context manager that times its work on ``device``'s current
    stream with a CUDA event pair, its parent the innermost open host
    span.  Records nothing for a CPU device or while the stream is being
    captured into a CUDA graph."""
    if not _on or device.type != "cuda":
        return _OFF
    if torch.cuda.is_current_stream_capturing():
        return _OFF
    return _DeviceSpan(name, device)
