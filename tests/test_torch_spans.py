"""The port's span and counter recorder (``repro_torch.spans``) and the
spans of its LM serving path.

The CPU cases run a ``.smoke()`` deepseek-moe-16b session through
``LMTokenServer``; the ``cuda`` case runs the graphed decode on the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spans.py

The file imports neither JAX nor the JAX package.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.engine import LMConfig, LMSession, SessionConfig
from repro_torch.models.moe import capacity
from repro_torch.serve import LMTokenServer, ServerConfig

ARCH, PROMPT, BATCH, NEW = "deepseek-moe-16b", 12, 2, 4


@pytest.fixture(autouse=True)
def recorder_off():
    """Each case starts and ends with the recorder off and empty."""
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


@pytest.fixture(scope="module")
def session():
    return LMSession(config=SessionConfig(
        backend="cuda-lm", device="cpu", lm=LMConfig(
            arch=ARCH, smoke=True, max_context=PROMPT + NEW,
            decode_batch=BATCH)))


def _prompts(seed=3, n=BATCH):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, PROMPT)).astype(np.int32)


def _by_id(records):
    return {r["id"]: r for r in records}


def _children(records, parent, name=None):
    return sorted((r for r in records if r["parent"] == parent["id"]
                   and (name is None or r["name"] == name)),
                  key=lambda r: r.get("start") or 0.0)


def test_off_span_is_the_shared_noop_and_drain_is_empty():
    a, b = spans.span("x"), spans.span("y", k=1)
    assert a is b
    with a as rec:
        assert rec is None
        spans.count("c", 3)
    assert spans.device_span("d", torch.device("cpu")) is a
    assert spans.drain() == []


def test_spans_nest_with_parents_and_threads():
    spans.enable()
    with spans.span("outer", k="v") as outer:
        with spans.span("inner"):
            pass
        t = threading.Thread(target=_closed, args=("other",))
        t.start()
        t.join(10)
    assert not t.is_alive()
    recs = _by_id(spans.drain())
    names = {r["name"]: r for r in recs.values()}
    assert names["outer"]["parent"] is None
    assert names["outer"]["attrs"] == {"k": "v"}
    assert names["inner"]["parent"] == outer["id"]
    assert names["inner"]["thread"] == names["outer"]["thread"]
    assert names["other"]["parent"] is None  # its own thread's stack
    assert names["other"]["thread"] != names["outer"]["thread"]
    o, i = names["outer"], names["inner"]
    assert o["start"] <= i["start"] <= i["end"] <= o["end"]


def _closed(name):
    with spans.span(name):
        pass
    return True


def test_count_lands_on_the_innermost_span():
    spans.enable()
    spans.count("lost", 1)  # no span open: nowhere to add
    with spans.span("outer"):
        spans.count("n", 1)
        with spans.span("inner"):
            spans.count("n", 2)
            spans.count("n", 3)
            spans.count("m", 7)
    got = {r["name"]: r["counts"] for r in spans.drain()}
    assert got == {"inner": {"n": 5, "m": 7}, "outer": {"n": 1}}


def test_site_fills_in_attrs_and_a_span_open_at_disable_closes():
    spans.enable()
    with spans.span("call") as rec:
        rec["attrs"]["step"] = "eager"
        spans.disable()
        with spans.span("after_disable") as inner:
            assert inner is None
    recs = spans.drain()
    assert [(r["name"], r["attrs"]) for r in recs] == [
        ("call", {"step": "eager"})]
    assert recs[0]["start"] <= recs[0]["end"]


def test_drain_twice_returns_nothing_new():
    spans.enable()
    with spans.span("a"):
        pass
    assert [r["name"] for r in spans.drain()] == ["a"]
    assert spans.drain() == []
    spans.disable()
    with spans.span("b"):
        pass
    assert spans.drain() == []


def test_no_span_is_lost_between_threads_and_drains():
    """Threads record while the main thread drains: every span comes out
    of exactly one drain, under its own thread's parent."""
    import sys
    threads, per = 12, 400
    spans.enable()
    got = []

    def work():
        for _ in range(per):
            with spans.span("outer"):
                with spans.span("inner"):
                    spans.count("n", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        while any(t.is_alive() for t in ts):
            got += spans.drain()
        for t in ts:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    got += spans.drain()
    assert len(got) == 2 * threads * per
    assert len({r["id"] for r in got}) == len(got)
    byid = _by_id(got)
    inner = [r for r in got if r["name"] == "inner"]
    assert all(byid[r["parent"]]["thread"] == r["thread"] for r in inner)
    assert sum(r["counts"]["n"] for r in inner) == threads * per


def test_device_span_records_nothing_on_the_cpu():
    spans.enable()
    with spans.span("host"):
        with spans.device_span("dev", torch.device("cpu")) as rec:
            assert rec is None
    assert [r["name"] for r in spans.drain()] == ["host"]


def test_the_profiler_leaves_the_recorder_off():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with spans.span("profiled"):
            spans.count("n", 1)
    finally:
        prof.stop()
    assert spans.drain() == []


def test_server_spans_of_each_generation(session):
    prompts = _prompts()
    spans.enable()
    with LMTokenServer(session, config=ServerConfig(
            workers=1, max_batch=BATCH, batch_deadline_ms=500.0,
            request_timeout_ms=None)) as srv:
        futs = [srv.submit(p, max_new=NEW) for p in prompts]
        for f in futs:
            f.result(timeout=120)
    spans.disable()
    recs = spans.drain()
    byid = _by_id(recs)
    gen, = [r for r in recs if r["name"] == "lm.generate"]
    assert gen["parent"] is None  # the worker thread's outermost span
    assert gen["thread"] != threading.get_ident()
    f = futs[0]
    assert f.timestamps["dequeue"] <= gen["start"] <= gen["end"] <= (
        f.timestamps["done"])
    steps = [r["name"] for r in _children(recs, gen)]
    assert steps == ["backend.prefill"] + ["backend.decode"] * (NEW - 1)
    decodes = _children(recs, gen, "backend.decode")
    assert [d["attrs"]["step"] for d in decodes] == ["eager"] * (NEW - 1)
    assert [d["attrs"]["pos"] for d in decodes] == [
        PROMPT + i for i in range(NEW - 1)]
    for call in _children(recs, gen, "backend.prefill") + decodes:
        copy, = _children(recs, call, "backend.logits_to_host")
        assert call["start"] <= copy["start"] <= copy["end"] <= call["end"]
    for r in recs:  # every parent is a recorded span that encloses it
        assert r["thread"] == gen["thread"]
        if r["parent"] is not None:
            p = byid[r["parent"]]
            assert p["start"] <= r["start"] <= r["end"] <= p["end"]


def test_moe_counters_on_each_prefill_and_eager_step(session):
    cfg = ARCHS[ARCH].smoke()
    spans.enable()
    session.generate(_prompts(), max_new=2)
    spans.disable()
    recs = spans.drain()
    prefill, = [r for r in recs if r["name"] == "backend.prefill"]
    decode, = [r for r in recs if r["name"] == "backend.decode"]
    for call, s in ((prefill, BATCH * PROMPT), (decode, BATCH)):
        c = capacity(s, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        assert call["counts"] == {
            "moe.routed_slots": cfg.n_layers * s * cfg.top_k,
            "moe.buffer_slots": cfg.n_layers * cfg.n_experts * c}
    # the MoE's host work records no device span off the card
    assert not [r for r in recs if r["name"] == "moe.mlp"]


def test_tokens_equal_with_the_recorder_on_and_off(session):
    prompts = _prompts(seed=11)
    off = session.generate(prompts, max_new=NEW)
    spans.enable()
    on = session.generate(prompts, max_new=NEW)
    spans.disable()
    assert spans.drain()
    np.testing.assert_array_equal(on, off)


def test_server_with_the_recorder_off_records_nothing(session):
    with LMTokenServer(session, config=ServerConfig(
            workers=1, max_batch=BATCH, request_timeout_ms=None)) as srv:
        futs = [srv.submit(p, max_new=2) for p in _prompts(n=4)]
        for f in futs:
            f.result(timeout=120)
    assert spans.drain() == []


@pytest.mark.cuda
def test_graphed_decode_spans_on_the_card():
    """A 4-token generate on the card: steps eager, capture, replay,
    replay; one ``decode.capture``, a ``decode.launch`` a graphed step;
    positive ``moe.mlp`` device spans under the prefill and the eager
    step, none under the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    sess = LMSession(config=SessionConfig(
        backend="cuda-lm", device="cuda", lm=LMConfig(
            arch=ARCH, smoke=True, max_context=PROMPT + NEW,
            decode_batch=BATCH)))
    cfg = ARCHS[ARCH].smoke()
    prompts = _prompts()
    off = sess.generate(prompts, max_new=NEW)
    spans.enable()
    on = sess.generate(prompts, max_new=NEW)
    spans.disable()
    np.testing.assert_array_equal(on, off)
    recs = spans.drain()
    decodes = sorted((r for r in recs if r["name"] == "backend.decode"),
                     key=lambda r: r["start"])
    assert [d["attrs"]["step"] for d in decodes] == [
        "eager", "capture", "replay"]
    capture, = [r for r in recs if r["name"] == "decode.capture"]
    assert capture["parent"] == decodes[1]["id"]
    launches = [r for r in recs if r["name"] == "decode.launch"]
    assert sorted(r["parent"] for r in launches) == sorted(
        d["id"] for d in decodes[1:])
    prefill, = [r for r in recs if r["name"] == "backend.prefill"]
    moe = [r for r in recs if r["name"] == "moe.mlp"]
    for parent in (prefill, decodes[0]):
        mine = [r for r in moe if r["parent"] == parent["id"]]
        assert len(mine) == cfg.n_layers
        assert all(r["device_ms"] > 0 for r in mine)
    assert len(moe) == 2 * cfg.n_layers  # none under the capture
    assert capture["counts"]["moe.routed_slots"] == (
        cfg.n_layers * BATCH * cfg.top_k)
