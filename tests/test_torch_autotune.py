"""The port's LM autotuner (``repro_torch.engine.autotune``) against the
JAX package's ``tune_lm_variants``.

The fingerprint and the cache key are held equal to JAX's, the raw key's
layout equal apart from the device digest (``torch:`` in the port), and
the descent to JAX's: with one table of per-policy times injected into
both tuners (each module's ``make_prefill_step`` and clock replaced by
the table), the port picks the policy JAX picks.  Real tunings run the
``.smoke()`` configs on the CPU.
"""
import glob
import json
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.lm_archs import ARCHS as JAX_ARCHS
from repro.engine import autotune as jtune
from repro.models import lm as jlm
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.engine import (LMConfig, LMSession, SessionConfig,
                                autotune)
from repro_torch.models import lm
from repro_torch.models.kernel_policy import KernelPolicy, fit_block
from repro_torch.models.stack import init_params


def _params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0))


# ------------------------------------------------------------ the keys ----

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_fingerprint_equals_jax(arch):
    assert (autotune.lm_fingerprint(ARCHS[arch])
            == jtune.lm_fingerprint(JAX_ARCHS[arch]))
    assert (autotune.lm_fingerprint(ARCHS[arch].smoke())
            == jtune.lm_fingerprint(JAX_ARCHS[arch].smoke()))


@pytest.mark.parametrize("raw", ["", "lm:abc:ctx16:b1:p8:cpu:cpu:n1:i1:v1",
                                 "ünïcode ✓"])
def test_key_raw_equals_jax(raw):
    got = autotune.TuningCache.key_raw(raw)
    assert got == jtune.TuningCache.key_raw(raw) and len(got) == 24


def test_device_digest_and_default_directory_are_the_ports():
    assert autotune.device_digest("cpu") == "torch:cpu:n1"
    assert autotune.device_digest("cpu") != jtune.device_digest()
    assert autotune.DEFAULT_CACHE_DIR != jtune.DEFAULT_CACHE_DIR
    assert autotune.TuningCache().path == autotune.DEFAULT_CACHE_DIR


def _recording(base):
    """A cache class over ``base`` that records each raw key string and
    answers every lookup with a stored record (so nothing is timed)."""

    class Recording(base):
        raws = []

        def key_raw(self, raw):
            self.raws.append(raw)
            return base.key_raw(raw)

        def get(self, key):
            return {"policy": {"attention": "reference", "scan": "chunked",
                               "block_q": 128, "block_k": 128},
                    "prefill_us": 1.0}

    return Recording


@pytest.mark.parametrize("arch,fixed", [
    ("gemma3-4b", {}), ("rwkv6-7b", {"scan": "chunked"}),
    ("zamba2-2.7b", {"attention": "reference", "block_q": 256})])
def test_raw_key_layout_matches_jax(tmp_path, arch, fixed):
    """The same string but for the device digest."""
    kw = dict(max_context=64, batch=3, prompt=16, iters=2, fixed=fixed)
    jc = _recording(jtune.TuningCache)(str(tmp_path))
    pc = _recording(autotune.TuningCache)(str(tmp_path))
    r = jtune.tune_lm_variants(JAX_ARCHS[arch].smoke(), None, cache=jc, **kw)
    p = autotune.tune_lm_variants(ARCHS[arch].smoke(), None, cache=pc,
                                  device="cpu", **kw)
    assert r.from_cache and p.from_cache and tuple(r.policy) == tuple(
        p.policy)
    (jraw,), (praw,) = jc.raws, pc.raws
    jdev, pdev = jtune.device_digest(), autotune.device_digest("cpu")
    assert jdev in jraw and pdev in praw
    assert jraw.replace(jdev, "<device>") == praw.replace(pdev, "<device>")
    assert praw.startswith("lm:") and praw.endswith(":v1")
    assert f":fx{sorted(fixed.items())}:" in praw


# ------------------------------------------------- the descent, faked ----

class _Clock:
    """A clock that only the fake prefill steps advance."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def _table(seed, prompt):
    """Per-program times in seconds, distinct: ``"flash_jax"`` programs
    keyed by their fitted tiles, the others not (they ignore them).  The
    times are whole multiples of 2**-20 s, so the clock's sums and
    differences are exact and one program always reads one time."""
    ticks = iter(np.random.default_rng(seed).permutation(np.arange(
        1000, 5000)))
    memo = {}

    def time_of(pol):
        key = ((pol.attention, pol.scan, fit_block(prompt, pol.block_q),
                fit_block(prompt, pol.block_k))
               if pol.attention == "flash_jax" else (pol.attention, pol.scan))
        if key not in memo:
            memo[key] = int(next(ticks)) * 2.0 ** -20
        return memo[key]

    return time_of


def _fake_both(monkeypatch, time_of):
    """Replace each package's prefill step and the tuners' clocks by the
    table; returns the lists of policies each tuner built a step for."""
    built = {"jax": [], "port": []}
    clocks = {"jax": _Clock(), "port": _Clock()}

    def fake(side, policy_of):
        def make_prefill_step(cfg, max_len, **kw):
            pol = policy_of(kw)
            built[side].append(pol)

            def step(params, batch):
                clocks[side].now += time_of(pol)
            return step
        return make_prefill_step

    monkeypatch.setattr(jlm, "make_prefill_step",
                        fake("jax", lambda kw: kw["par"].kernels))
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    monkeypatch.setattr(jtune, "time", types.SimpleNamespace(
        perf_counter=clocks["jax"].perf_counter))
    monkeypatch.setattr(lm, "make_prefill_step",
                        fake("port", lambda kw: kw["kernels"]))
    monkeypatch.setattr(autotune, "time", types.SimpleNamespace(
        perf_counter=clocks["port"].perf_counter))
    return built


# the axis the arch does not tune is pinned, since the two packages'
# defaults differ there (JAX: flash_jax / chunked; the port: the kernels)
_UNTUNED = {"gemma3-4b": {"scan": "chunked"},
            "zamba2-2.7b": {"scan": "linear_scan"},
            "rwkv6-7b": {"attention": "flash_jax"}}


@pytest.mark.parametrize("prompt", [16, 512])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("arch", sorted(_UNTUNED))
def test_descent_picks_the_jax_policy(tmp_path, monkeypatch, arch, seed,
                                      prompt):
    time_of = _table(seed, prompt)
    built = _fake_both(monkeypatch, time_of)
    kw = dict(max_context=512, batch=2, prompt=prompt, iters=2,
              fixed=_UNTUNED[arch])
    want = jtune.tune_lm_variants(
        JAX_ARCHS[arch].smoke(), None,
        cache=jtune.TuningCache(str(tmp_path / "jax")), **kw)
    got = autotune.tune_lm_variants(
        ARCHS[arch].smoke(), None,
        cache=autotune.TuningCache(str(tmp_path / "port")), device="cpu",
        **kw)
    assert tuple(got.policy) == tuple(want.policy)
    assert got.prefill_us == want.prefill_us
    # the port builds each distinct program once; JAX's dedup keeps the
    # fitted tiles of the variants that ignore them, so it may build more
    programs = {(p.attention, p.scan) + (
        (fit_block(prompt, p.block_q), fit_block(prompt, p.block_k))
        if p.attention == "flash_jax" else ()) for p in built["port"]}
    assert len(built["port"]) == len(programs) <= len(built["jax"])


@pytest.mark.parametrize("arch", ["gemma3-4b", "rwkv6-7b", "zamba2-2.7b"])
def test_axes_follow_the_arch_kinds(tmp_path, monkeypatch, arch):
    built = _fake_both(monkeypatch, _table(0, 512))
    autotune.tune_lm_variants(ARCHS[arch].smoke(), None, max_context=512,
                              prompt=512, cache=autotune.TuningCache(
                                  str(tmp_path)), device="cpu")
    pols = built["port"]
    attns = {p.attention for p in pols}
    blocks = {(p.block_q, p.block_k) for p in pols}
    scans = {p.scan for p in pols}
    if arch == "rwkv6-7b":  # no attention or block axis, a scan axis
        assert attns == {"flash_pallas"} and blocks == {(512, 512)}
        assert scans == {"chunked", "linear_scan"}
    else:  # attention and block axes, no scan axis
        assert attns == {"flash_jax", "flash_pallas", "reference"}
        assert scans == {"linear_scan"}


def test_fixed_pins_are_respected(tmp_path, monkeypatch):
    built = _fake_both(monkeypatch, _table(1, 512))
    cache = autotune.TuningCache(str(tmp_path))
    cfg = ARCHS["gemma3-4b"].smoke()
    r = autotune.tune_lm_variants(cfg, None, max_context=512, prompt=512,
                                  cache=cache, device="cpu",
                                  fixed={"attention": "flash_jax"})
    assert r.policy.attention == "flash_jax"
    assert {p.attention for p in built["port"]} == {"flash_jax"}
    built["port"].clear()
    r = autotune.tune_lm_variants(cfg, None, max_context=512, prompt=512,
                                  cache=cache, device="cpu",
                                  fixed={"block_q": 128, "block_k": 256})
    assert (r.policy.block_q, r.policy.block_k) == (128, 256)
    assert {(p.block_q, p.block_k) for p in built["port"]} == {(128, 256)}
    assert len(glob.glob(str(tmp_path / "*.json"))) == 2


# ------------------------------------------------------- real tunings ----

def test_first_tuning_writes_a_record_and_the_second_times_nothing(
        tmp_path, monkeypatch):
    calls = []
    real = lm.make_prefill_step

    def counting(*a, **k):
        calls.append(k["kernels"])
        return real(*a, **k)

    monkeypatch.setattr(lm, "make_prefill_step", counting)
    cfg = ARCHS["gemma3-4b"].smoke()
    params = _params(cfg)
    cache = autotune.TuningCache(str(tmp_path))
    first = autotune.tune_lm_variants(cfg, params, max_context=32, batch=2,
                                      prompt=8, cache=cache, iters=1,
                                      device="cpu")
    assert not first.from_cache and first.prefill_us > 0
    # base (the CUDA kernel's policy), flash_jax, reference; the tiles
    # fit to the 8-token prompt, so the block axis is one program
    assert len(calls) == 3
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    rec = json.load(open(files[0]))
    assert rec["device"] == "torch:cpu:n1" and rec["arch"] == cfg.name
    assert rec["shape"] == {"batch": 2, "prompt": 8, "max_context": 32}
    assert KernelPolicy(**rec["policy"]) == first.policy
    second = autotune.tune_lm_variants(cfg, params, max_context=32, batch=2,
                                       prompt=8, cache=cache, iters=1,
                                       device="cpu")
    assert second.from_cache and len(calls) == 3
    assert second.policy == first.policy
    assert second.prefill_us == round(first.prefill_us, 3)


def test_jax_and_port_records_never_share_a_key(tmp_path):
    """The same arch and shape, every axis pinned, tuned by both packages
    into one directory: two records."""
    fixed = dict(attention="reference", scan="chunked", block_q=128,
                 block_k=128)
    kw = dict(max_context=16, batch=1, prompt=8, iters=1, fixed=fixed)
    jcfg, cfg = JAX_ARCHS["gemma3-4b"].smoke(), ARCHS["gemma3-4b"].smoke()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    j = jtune.tune_lm_variants(jcfg, jparams,
                               cache=jtune.TuningCache(str(tmp_path)), **kw)
    p = autotune.tune_lm_variants(cfg, _params(cfg),
                                  cache=autotune.TuningCache(str(tmp_path)),
                                  device="cpu", **kw)
    assert not j.from_cache and not p.from_cache
    recs = [json.load(open(f)) for f in glob.glob(str(tmp_path / "*.json"))]
    assert sorted(r["device"] for r in recs) == sorted(
        [jtune.device_digest(), "torch:cpu:n1"])
    # and each package reads back its own
    assert autotune.tune_lm_variants(
        cfg, None, cache=autotune.TuningCache(str(tmp_path)), device="cpu",
        **kw).from_cache


def test_autotuned_session_gives_its_pinned_winners_tokens(tmp_path):
    lmc = LMConfig(arch="gemma3-4b", max_context=32, decode_batch=2)
    tuned = LMSession(config=SessionConfig(
        backend="cuda-lm", device="cpu", autotune=True, tune_iters=100,
        tune_cache=str(tmp_path), lm=lmc))
    assert tuned.tuned is not None and not tuned.tuned.from_cache
    info = tuned.info
    assert info["tuned_prefill_us"] == tuned.tuned.prefill_us > 0
    assert info["tuned_from_cache"] is False
    assert info["kernel_policy"] == dict(tuned.tuned.policy._asdict())
    pol = tuned.tuned.policy
    pinned = LMSession(config=SessionConfig(
        backend="cuda-lm", device="cpu", lm=LMConfig(
            arch="gemma3-4b", max_context=32, decode_batch=2,
            attn_variant=pol.attention, scan_variant=pol.scan,
            block_q=pol.block_q, block_k=pol.block_k)))
    assert pinned.tuned is None and "tuned_prefill_us" not in pinned.info
    prompts = np.random.default_rng(5).integers(0, 256, size=(2, 12)
                                                ).astype(np.int32)
    np.testing.assert_array_equal(tuned.generate(prompts, 6),
                                  pinned.generate(prompts, 6))
    again = LMSession(config=SessionConfig(
        backend="cuda-lm", device="cpu", autotune=True, tune_iters=100,
        tune_cache=autotune.TuningCache(str(tmp_path)), lm=lmc))
    assert again.info["tuned_from_cache"] is True
    assert again.kernel_policy == pol
    assert again.config.to_dict()["tune_cache"] == str(tmp_path)


def test_session_config_carries_the_tuning_knobs():
    cache = autotune.TuningCache("/some/dir")
    cfg = SessionConfig(autotune=True, tune_cache=cache, tune_iters=50)
    assert cfg.portable().tune_cache == "/some/dir"
    assert SessionConfig(**cfg.to_dict()) == cfg.portable()
    with pytest.raises(ValueError, match="tune_iters"):
        SessionConfig(tune_iters=0)
