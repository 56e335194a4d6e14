"""Window arithmetic, FLOP and byte counts, and the readers on a
synthetic call record."""
import json
from types import SimpleNamespace

import pytest

from conftest import ROOT
from portbench.harness import flops, stats
from portbench.harness.bench import Bench
from portbench.harness.peaks import H100_SXM
from portbench.harness.trace import Trace

DEEPSEEK = json.loads((ROOT / "portbench/configs/deepseek-moe-16b-port.json"
                       ).read_text())["as_run"]
# a Mamba2 hybrid's sizes (the program's zamba2-2.7b), for the FLOP
# count of a block kind that no cell runs yet
HYBRID = dict(n_layers=54, prologue="", pattern="MMMMMS", d_model=2560,
              n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240,
              vocab_size=32000, n_experts=0, n_shared_experts=0, top_k=0,
              moe_d_ff=None, mlp_gated=True, ssm_state=64, ssm_head_dim=64,
              conv_kernel=4)


def call(kind, start, end, batch=4, start_pos=0, stop_pos=1):
    return dict(kind=kind, start=start, end=end, batch=batch,
                start_pos=start_pos, stop_pos=stop_pos)


def test_rate_counts_the_share_of_a_call_inside_the_window():
    calls = [call("prefill", -1.0, 1.0, batch=10),   # half inside
             call("decode.replay", 1.0, 2.0, batch=10),
             call("decode.replay", 9.0, 11.0, batch=10),  # half inside
             call("decode.replay", 11.0, 12.0, batch=10)]  # outside
    assert stats.rate(calls, 0.0, 10.0, "batch") == pytest.approx(
        (5 + 10 + 5) / 10)
    assert [c["end"] for c in stats.ended_in(calls, 0.0, 10.0)] == [1.0, 2.0]


def test_rate_moves_smoothly_with_the_window():
    calls = [call("prefill", i * 1.0, (i + 1) * 1.0, batch=1)
             for i in range(20)]
    rates = [stats.rate(calls, lo, lo + 5.0, "batch")
             for lo in (0.0, 0.25, 0.5, 0.75)]
    assert rates == pytest.approx([1.0] * 4)


def test_percentile_by_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(xs[:20], 95) == 19
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_flash_ops_and_bytes_as_chip_smoke_counts_them():
    # deepseek-moe-16b's attention at q [4, 16, 1536, 128]
    assert flops.flash_ops(4, 16, 1536, 128) == 38_679_871_488
    assert flops.flash_bytes(4, 16, 16, 1536, 128) == 100_663_296
    bound = flops.flash_bound_s(DEEPSEEK, 4, 1536, H100_SXM)
    assert bound == pytest.approx(28 * 38_679_871_488 / 989e12)


def test_call_flops_add_up_over_positions():
    for cfg in (DEEPSEEK, HYBRID):
        head = 2 * cfg["d_model"] * cfg["vocab_size"]
        whole = flops.call_flops(cfg, 3, 0, 50) - 3 * head
        steps = sum(flops.call_flops(cfg, 3, p, p + 1) - 3 * head
                    for p in range(50))
        assert whole == steps
    # the MoE counts six routed and two shared experts, not 64
    per_token = flops._linear_flops(DEEPSEEK, "A")
    assert per_token == (2 * 2048 * 2048 * 4 + 2 * 2048 * 64
                         + 6 * 2048 * 1408 * 8)


def _run(calls, requests=(), trace=None, lo=0.0, hi=10.0):
    return SimpleNamespace(calls=list(calls), requests=list(requests),
                           lo=lo, hi=hi, stats=stats, flops=flops,
                           cfg=DEEPSEEK, peaks=H100_SXM, trace=trace,
                           bench=Bench(ROOT), setup_s=12.5)


def test_readers_on_a_synthetic_record():
    bench = Bench(ROOT)
    gen = [call("prefill", 0.0, 1.0, batch=8, stop_pos=256),
           call("decode.eager", 1.0, 1.2, batch=8, start_pos=256,
                stop_pos=257),
           call("decode.capture", 1.2, 1.5, batch=8, start_pos=257,
                stop_pos=258),
           call("decode.replay", 1.5, 1.6, batch=8, start_pos=258,
                stop_pos=259),
           call("decode.replay", 1.6, 1.7, batch=8, start_pos=259,
                stop_pos=260)]
    reqs = [dict(ok=True, submit=0.0, end=1.0 + i / 100, queue_wait=0.002)
            for i in range(100)] + [dict(ok=False, submit=0.0, end=9.0,
                                         queue_wait=None)]
    run = _run(gen, reqs)
    read = {m: bench.reader(m)(run) for m in (
        "output_tokens_per_s",
        "request_latency_p95_ms", "serve.queue_wait_ms",
        "backend.handle_warmup_ms", "model.prefill_ms.chat",
        "model.decode_step_ms.chat", "setup_s", "mfu.chat")}
    assert read["output_tokens_per_s"] == pytest.approx(5 * 8 / 10)
    assert read["request_latency_p95_ms"] == pytest.approx(1940.0)
    assert read["serve.queue_wait_ms"] == pytest.approx(2.0)
    assert read["backend.handle_warmup_ms"] == pytest.approx(300.0)
    assert read["model.prefill_ms.chat"] == pytest.approx(1000.0)
    assert read["model.decode_step_ms.chat"] == pytest.approx(100.0)
    assert read["setup_s"] == 12.5
    want = sum(flops.call_flops(DEEPSEEK, c["batch"], c["start_pos"],
                                c["stop_pos"]) for c in gen)
    assert read["mfu.chat"] == pytest.approx(
        100 * want / 10 / 989e12)
    # with no trace, the trace's readers find nothing to read
    assert bench.reader("device_idle_share.chat")(run) is None
    assert bench.reader("attn_roofline.chat")(run) is None


def test_trace_busy_gaps_and_roofline():
    bench = Bench(ROOT)
    ops = [("void flash_attention_tc_kernel<80>(CUtensorMap)", 0.10, 0.30),
           ("nvjet_gemm", 0.20, 0.90), ("Memcpy DtoH", 1.30, 1.40),
           ("before the window", -2.0, -1.0)]
    tr = Trace(ops, 0.0, 2.0)
    assert tr.busy_s == pytest.approx(0.9)
    assert tr.window_s == 2.0
    assert tr.gaps() == [(0.0, 0.1), (0.9, 1.3), (1.4, 2.0)]
    assert tr.top_ops(2)[0] == ["nvjet_gemm", pytest.approx(0.7)]
    calls = [call("prefill", 0.0, 1.0, batch=8, stop_pos=256),
             call("decode.eager", 1.2, 1.5, batch=8, start_pos=256,
                  stop_pos=257)]
    idle = dict(tr.idle_by_host(calls))
    assert idle == {"inside prefill": pytest.approx(0.1),
                    "between decode steps (host argmax, token feed)":
                        pytest.approx(0.4),
                    "between generations (server, clients)":
                        pytest.approx(0.6)}
    run = _run(calls, trace=tr, hi=2.0)
    assert bench.reader("device_idle_share.chat")(run) == \
        pytest.approx(55.0)
    roof = bench.reader("attn_roofline.chat")(run)
    assert roof == pytest.approx(
        100 * flops.flash_bound_s(DEEPSEEK, 8, 256, H100_SXM) / 0.2)
