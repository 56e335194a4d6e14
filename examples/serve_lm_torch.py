"""Serving example on the PyTorch port: the LM workload through the
session API (the counterpart of ``examples/serve_lm.py``).

An autotuned ``"cuda-lm"`` session of the reduced gemma3-4b config
(local:global layers, ring caches for the sliding-window layers) times
the prefill kernel variants (the CUDA flash kernel, the blockwise
attention, the dense reference; the flash tiles) and caches the winner
on disk, so a second session with the same cache times nothing.  On the
card its decode step is captured once per cache handle as a CUDA graph
and replayed.  Its greedy tokens are held to the direct
``make_prefill_step`` / ``make_decode_step`` loop run eagerly, to
``generate()`` and to ``LMTokenServer``.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.engine import LMConfig, LMSession, SessionConfig
from repro_torch.models.lm import make_decode_step, make_prefill_step
from repro_torch.serve import LMTokenServer, ServerConfig

BATCH, PROMPT, NEW = 4, 24, 16
MAX_CTX = PROMPT + NEW


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="a torch device; default the card, cuda:0")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as cache_dir:
        def session():
            return LMSession(config=SessionConfig(
                backend="cuda-lm", device=args.device, autotune=True,
                tune_cache=cache_dir, lm=LMConfig(
                    arch="gemma3-4b", max_context=MAX_CTX,
                    decode_batch=BATCH)))

        sess = session()
        info = sess.info
        print(f"arch={info['arch']}  params={info['n_params']:,}  "
              f"backend={info['backend']}  device={info['device']}  "
              f"decode={info['decode']}")
        print(f"autotuned kernel policy: {info['kernel_policy']} "
              f"(prefill {info['tuned_prefill_us']:.0f}us, "
              f"{'cache hit' if info['tuned_from_cache'] else 'freshly timed'})")
        again = session()
        assert again.info["tuned_from_cache"], "the winner was not cached"
        assert again.kernel_policy == sess.kernel_policy
        print("second session: cache hit, same policy: OK")

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, sess.model_cfg.vocab_size,
                           (BATCH, PROMPT)).astype(np.int32)

    # -- session path: prefill + greedy decode through the cache handle --
    t0 = time.perf_counter()
    logits, handle = sess.prefill(prompts)
    t_prefill = time.perf_counter() - t0
    tok = np.argmax(logits, -1).astype(np.int32)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(NEW - 1):
        tok = np.argmax(sess.decode(handle, tok), -1).astype(np.int32)
        out.append(tok)
    t_decode = time.perf_counter() - t0
    out = np.stack(out, axis=1)
    assert out.shape == (BATCH, NEW)

    # -- oracle: the direct models/lm.py loop, eager, same policy --------
    cfg, params = sess.model_cfg, sess.backend.params
    prefill = make_prefill_step(cfg, max_len=MAX_CTX,
                                kernels=sess.kernel_policy)
    decode = make_decode_step(cfg, sess.kernel_policy)
    with torch.inference_mode():
        lg, caches, pos = prefill(params, {"tokens": torch.from_numpy(
            prompts.astype(np.int64)).to(sess.backend.device)})
        ref_tok = lg.argmax(-1)[:, None]
        ref = [ref_tok[:, 0]]
        for _ in range(NEW - 1):
            lg, caches, pos = decode(params, caches, ref_tok, pos)
            ref_tok = lg.argmax(-1)[:, None]
            ref.append(ref_tok[:, 0])
    np.testing.assert_array_equal(out, torch.stack(ref, 1).cpu().numpy())
    print("session tokens == direct model tokens: OK")

    # generate() is the same loop in one call, and the token server
    # routes it through the bounded queue / stats machinery
    np.testing.assert_array_equal(sess.generate(prompts, NEW), out)
    print("generate() tokens == session tokens: OK")
    with LMTokenServer(sess, config=ServerConfig(
            workers=1, max_batch=BATCH, request_timeout_ms=None)) as srv:
        futs = [srv.submit(prompts[i], max_new=NEW) for i in range(BATCH)]
        served = np.stack([f.result(timeout=300.0) for f in futs])
        stats = srv.stats()
    np.testing.assert_array_equal(served, out)
    print(f"served {BATCH} queued requests through LMTokenServer "
          f"(completed={stats['completed']:.0f}): OK")

    tok_s = BATCH * PROMPT / t_prefill
    ms_tok = t_decode / (BATCH * (NEW - 1)) * 1e3
    print(f"prefill: {BATCH}x{PROMPT} tokens in {t_prefill:.3f}s "
          f"({tok_s:.0f} tok/s)   decode: {ms_tok:.2f} ms/token")
    print("sample continuation token ids:", out[0][:10])
    print("serve_lm_torch: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
