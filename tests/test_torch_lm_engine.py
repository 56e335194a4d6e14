"""The port's LM engine (``LMSession`` over the ``"cuda-lm"`` backend, and
``LMTokenServer``) against the JAX package's ``LMSession`` over
``"pallas-lm"``.

Both sessions get the same weights (the JAX ``init_params`` tree plus
numpy noise, carried across with ``from_jax_params``) and the same
prompts from a numpy seed.  The port runs with ``device="cpu"``, where
its kernel policy runs the kernels' plain versions; the JAX session pins
the Pallas kernels (``flash_pallas`` / ``linear_scan``, interpret mode on
the CPU).  Greedy tokens must be equal; prefill logits agree at 1e-4
(fp32, as the whole-model tests).
"""
import numpy as np
import pytest
import torch

from repro.configs.lm_archs import ARCHS as JAX_ARCHS
from repro.engine import LMConfig as JaxLMConfig
from repro.engine import LMSession as JaxLMSession
from repro.engine import SessionConfig as JaxConfig
from repro_torch.configs.cnn_paper import PAPER_CNNS
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.engine import (InferenceSession, LMBackend, LMConfig,
                                LMSession, SessionConfig, available_backends,
                                get_backend)
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.models.lm import from_jax_params, param_count
from test_torch_lm_model import perturbed_jax_params

MAX_CTX, PROMPT, BATCH, STEPS = 32, 12, 2, 4


def _prompts(n=BATCH, t=PROMPT, vocab=256, seed=3):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(n, t)).astype(np.int32)


def _pair(arch):
    """(JAX session, port session) over the same perturbed weights."""
    lm = dict(arch=arch, max_context=MAX_CTX, decode_batch=BATCH)
    params = perturbed_jax_params(JAX_ARCHS[arch].smoke())
    jax_sess = JaxLMSession(config=JaxConfig(
        backend="pallas-lm", lm=JaxLMConfig(
            attn_variant="flash_pallas", scan_variant="linear_scan", **lm)),
        params=params)
    port = LMSession(config=SessionConfig(
        backend="cuda-lm", device="cpu", lm=LMConfig(**lm)),
        params=from_jax_params(ARCHS[arch].smoke(), params))
    return jax_sess, port


@pytest.fixture(scope="module")
def gemma():
    return _pair("gemma3-4b")


@pytest.mark.parametrize("arch", ["gemma3-4b", "rwkv6-7b", "deepseek-moe-16b",
                                  "zamba2-2.7b"])
def test_greedy_tokens_equal_the_jax_session(arch, request):
    jax_sess, port = (request.getfixturevalue("gemma") if arch == "gemma3-4b"
                      else _pair(arch))
    assert port.kernel_policy.attention == "flash_pallas"
    assert port.kernel_policy.scan == "linear_scan"
    toks = _prompts()
    want_logits, _ = jax_sess.prefill(toks)
    got_logits, handle = port.prefill(toks)
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-4, atol=1e-4)
    assert handle.pos == PROMPT and handle.batch == BATCH
    want = jax_sess.generate(toks, 1 + STEPS)
    got = port.generate(toks, 1 + STEPS)
    assert got.dtype == np.int32 and got.shape == (BATCH, 1 + STEPS)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1  # the perturbed weights do not collapse


def test_plain_policy_session_equals_kernel_policy_session(gemma):
    _, port = gemma
    plain = LMSession(config=SessionConfig(
        device="cpu", lm=LMConfig(arch="gemma3-4b", max_context=MAX_CTX,
                                  attn_variant="reference",
                                  scan_variant="chunked")),
        params=port.backend.params)
    toks = _prompts(seed=5)
    np.testing.assert_array_equal(plain.generate(toks, 3),
                                  port.generate(toks, 3))


def test_predict_returns_full_logits(gemma):
    jax_sess, port = gemma
    toks = _prompts(t=9)
    got = port.predict(toks)
    assert got.shape == (BATCH, 9, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_sess.predict(toks), rtol=1e-4,
                               atol=1e-4)


def test_decode_past_max_context_raises(gemma):
    _, port = gemma
    with pytest.raises(ValueError, match="max_context"):
        port.prefill(_prompts(t=MAX_CTX + 1))
    _, handle = port.prefill(_prompts(t=MAX_CTX))
    with pytest.raises(ValueError, match="max_context"):
        port.decode(handle, np.zeros(BATCH, np.int32))


def test_registry_and_info(gemma):
    _, port = gemma
    assert "cuda-lm" in available_backends()
    cls = get_backend("cuda-lm")
    assert issubclass(cls, LMBackend) and cls.workload == "lm"
    info = port.info
    assert info["backend"] == "cuda-lm" and info["workload"] == "lm"
    assert info["device"] == "cpu" and info["arch"] == "gemma3-4b-smoke"
    assert info["n_params"] == param_count(port.model_cfg)
    assert info["kernel_policy"]["attention"] == "flash_pallas"
    assert SessionConfig(**info["config"]) == port.config


def test_sessions_refuse_the_other_workload():
    with pytest.raises(TypeError, match="LMSession"):
        InferenceSession(PAPER_CNNS["ball"](0), config=SessionConfig(
            device="cpu", lm=LMConfig()))
    with pytest.raises(ValueError, match="LM contract"):
        LMSession(config=SessionConfig(backend="torch", device="cpu",
                                       lm=LMConfig()))
    with pytest.raises(TypeError, match="SessionConfig.lm"):
        LMSession(config=SessionConfig(device="cpu"))


def test_unported_options_raise():
    # autotune is ported (tests/test_torch_autotune.py); the mesh is not
    cfg = SessionConfig(autotune=True, tune_cache="somewhere")
    assert cfg.autotune and SessionConfig(**cfg.to_dict()) == cfg
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LMConfig(mesh_shape=(1, 1))


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is satisfiable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMSession(config=LMConfig())


# ------------------------------------------------------- token serving ----

def test_lm_token_server_end_to_end(gemma):
    """After tests/test_lm_session.py: requests of one shape ride one
    generate call and equal ``session.generate``; a shorter prompt with
    another max_new comes back in order."""
    from repro_torch.serve import LMTokenServer, ServerConfig
    _, port = gemma
    toks = _prompts()
    want = port.generate(toks, 6)
    before = flash_mod.launches
    with LMTokenServer(port, config=ServerConfig(
            workers=1, max_batch=4, request_timeout_ms=None)) as srv:
        futs = [srv.submit(toks[i], max_new=6) for i in range(BATCH)]
        got = np.stack([f.result(timeout=120.0) for f in futs])
        other = srv.generate(toks[0, :6], max_new=3, timeout=120.0)
        stats = srv.stats()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(other, port.generate(toks[:1, :6], 3)[0])
    assert stats["completed"] == BATCH + 1
    assert flash_mod.launches == before  # the CPU runs the plain versions
    with pytest.raises(TypeError, match="serves tokens"):
        srv.predict(toks[0])


def test_lm_token_server_validates(gemma):
    from repro_torch.serve import LMTokenServer, ServerConfig
    _, port = gemma
    with pytest.raises(TypeError, match="LMSession or LMBackend"):
        LMTokenServer(object())
    with LMTokenServer(port.backend,
                       config=ServerConfig(workers=1)) as srv:
        with pytest.raises(ValueError, match="1-D int"):
            srv.submit(np.zeros((2, 3), np.int32))
        with pytest.raises(ValueError, match="max_new"):
            srv.submit(np.zeros(3, np.int32), max_new=0)


def test_one_backend_serves_more_threads_than_cores():
    """More threads than cores generate through one backend at once, with
    a short switch interval: each gets its sequential run's tokens (the
    backend runs one call at a time; on the card that keeps another
    thread's work out of a capture)."""
    import os
    import sys
    import threading
    sess = LMSession(config=SessionConfig(
        backend="cuda-lm", device="cpu", lm=LMConfig(
            arch="gemma3-4b", max_context=MAX_CTX, decode_batch=BATCH)))
    n = (os.cpu_count() or 1) + 2
    prompts = [_prompts(seed=s % 4) for s in range(n)]
    want = [sess.generate(p, STEPS) for p in prompts[:4]]
    got = [None] * n

    def run(i):
        got[i] = sess.generate(prompts[i], STEPS)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i % 4])
