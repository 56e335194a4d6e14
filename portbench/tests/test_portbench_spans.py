"""The readers of the program's own spans and counters
(``harness/program_spans.py`` and the four span metrics), on a synthetic
span record and, through ``spans_probe.py``, on a traced run at the
``.smoke()`` size on the CPU."""
import json
import time
from types import SimpleNamespace

import pytest

from conftest import ROOT, smoke_cell
from portbench.harness.bench import Bench
from portbench.spans_probe import SPAN_METRICS, probe

DEEPSEEK = json.loads((ROOT / "portbench/configs/deepseek-moe-16b-port.json"
                       ).read_text())["as_run"]
WORKER = 11


class Record:
    """Builds a span record as ``repro_torch.spans.drain`` returns it."""

    def __init__(self):
        self.spans = []

    def host(self, name, start, end, parent=None, thread=WORKER, **attrs):
        s = dict(name=name, start=start, end=end, id=len(self.spans) + 1,
                 parent=None if parent is None else parent["id"],
                 thread=thread, attrs=attrs, counts={})
        self.spans.append(s)
        return s

    def device(self, name, parent, ms):
        self.spans.append(dict(name=name, id=len(self.spans) + 1,
                               parent=parent["id"], thread=WORKER,
                               device_ms=ms))


def _generation(rec, t0, routed=96, buffer=1024, moe_ms=(0.2, 0.3)):
    """One batch: a prefill of 1 s, then eager, capture and two replays
    of 0.1 s each; between two steps 0.01 s of argmax and feed."""
    gen = rec.host("lm.generate", t0, t0 + 1.5)
    pre = rec.host("backend.prefill", t0, t0 + 1.0, gen)
    pre["counts"] = {"moe.routed_slots": routed, "moe.buffer_slots": buffer}
    for ms in moe_ms:
        rec.device("moe.mlp", pre, ms)
    rec.host("backend.logits_to_host", t0 + 0.9, t0 + 1.0, pre)
    t = t0 + 1.0
    for step, pos in (("eager", 8), ("capture", 9), ("replay", 10),
                      ("replay", 11)):
        d = rec.host("backend.decode", t + 0.01, t + 0.11, gen, step=step,
                     pos=pos)
        if step == "capture":
            rec.host("decode.capture", t + 0.012, t + 0.062, d)
        if step != "eager":  # the launch begins 0.003 s into the call
            rec.host("decode.launch", t + 0.013 + (step == "capture") * 0.05,
                     t + 0.014 + (step == "capture") * 0.05, d)
        rec.host("backend.logits_to_host", t + 0.1, t + 0.11, d)
        t += 0.11
    return gen


def _run(spans, lo=0.0, hi=10.0, trace=None):
    return SimpleNamespace(spans=spans, lo=lo, hi=hi, trace=trace)


def test_span_readers_on_a_synthetic_record():
    bench = Bench(ROOT)
    rec = Record()
    _generation(rec, 1.0)
    _generation(rec, 3.0, routed=32, buffer=1024, moe_ms=(0.5,))
    read = {m: bench.reader(m)(_run(rec.spans)) for m in SPAN_METRICS}
    # copy end (t + 0.11) to the next step's launch (t + 0.11 + 0.013);
    # the pair whose second step is the capture is left out
    assert read["backend.decode_gap_ms"] == pytest.approx(13.0)
    assert read["backend.capture_ms"] == pytest.approx(50.0)
    assert read["model.moe_prefill_ms.chat"] == pytest.approx(
        ((0.2 + 0.3) + 0.5) / 2)
    assert read["model.moe_slot_fill.chat"] == pytest.approx(
        100 * (96 + 32) / 2048)
    # a window that ends inside the second batch counts the first only
    first = {m: bench.reader(m)(_run(rec.spans, hi=2.5))
             for m in SPAN_METRICS}
    assert first["model.moe_prefill_ms.chat"] == pytest.approx(0.5)
    assert first["model.moe_slot_fill.chat"] == pytest.approx(
        100 * 96 / 1024)


def test_span_readers_report_nothing_without_spans():
    bench = Bench(ROOT)
    untraced = SimpleNamespace(lo=0.0, hi=10.0, trace=None)
    for run in (_run(None), _run([]), untraced):
        for m in SPAN_METRICS:
            assert bench.reader(m)(run) is None


def test_slot_fill_reads_9_302_at_deepseeks_shapes():
    """A prefill of 64 prompts of 256: 98,304 routed slots a layer over
    64 experts of 16,512 slots."""
    from repro_torch.models.moe import capacity
    s, k, e = 64 * 256, DEEPSEEK["top_k"], DEEPSEEK["n_experts"]
    c = capacity(s, k, e, DEEPSEEK["capacity_factor"])
    assert (s * k, e * c) == (98_304, 1_056_768)
    rec = Record()
    _generation(rec, 1.0, routed=DEEPSEEK["n_layers"] * s * k,
                buffer=DEEPSEEK["n_layers"] * e * c)
    fill = Bench(ROOT).reader("model.moe_slot_fill.chat")(_run(rec.spans))
    assert round(fill, 3) == 9.302


def _smoke_probe(recorder):
    cell = smoke_cell("deepseek-moe-16b-port.chat")
    out = probe(Bench(ROOT), cell, 3_200_000_001, 2.0, recorder,
                t_process=time.perf_counter(), device="cpu", smoke=True,
                log=lambda *a, **k: None)
    return cell, out


def test_probe_with_the_recorder_reports_the_slot_fill():
    """On the CPU the prefills' counters reach the slot fill, while the
    graph's spans and the device spans exist only on the card."""
    from repro_torch.configs.lm_archs import ARCHS
    from portbench.harness.cell import program_config
    from repro_torch.models.moe import capacity
    cell, out = _smoke_probe(True)
    assert out["correct"] and out["spans"] > 0
    cfg = program_config(cell["config"], dict(ARCHS)).smoke()
    s = cell["mix"]["clients"] * cell["mix"]["prompt_tokens"]
    c = capacity(s, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    got = out["metrics"]
    assert got["model.moe_slot_fill.chat"]["value"] == pytest.approx(
        100 * s * cfg.top_k / (cfg.n_experts * c))
    for m in ("backend.decode_gap_ms", "backend.capture_ms",
              "model.moe_prefill_ms.chat"):
        assert m not in got


def test_traced_run_leaves_the_recorder_off():
    """The benchmark's own traced run, as the probe's with the recorder
    off, records no span."""
    _, out = _smoke_probe(False)
    assert out["correct"] and out["spans"] == 0
    assert not set(SPAN_METRICS) & set(out["metrics"])
