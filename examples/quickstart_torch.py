"""Quickstart on the PyTorch port: the paper's flow for the ball
classifier (the counterpart of ``examples/quickstart.py``), on the card
when there is one, else on the CPU.

  1. Build the Table-I CNN and *train* it on the synthetic ball dataset.
  2. Serve it through ``InferenceSession(backend="cuda")``, which runs
     the hand-written conv2d and maxpool2d kernels (their plain versions
     on the CPU), and check it against the plain ``backend="torch"``
     session.
  3. Calibrate it on 64 frames and serve it at int8; compare float and
     int8 accuracy and their top-1 agreement.
  4. Deploy it as the paper does, as one dependency-free ANSI C file
     compiled with the host's ``cc``: ``backend="c", autotune=True``
     (the per-layer code versions timed, the winner cached on disk) and
     int8 on ``"c"``; check both against ``"torch"`` on the CPU and,
     with a card, against ``"cuda"``; print the C's latency.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.cnn_paper import trained_ball_classifier
from repro_torch.data.pipeline import ball_image_batch
from repro_torch.engine import (CalibrationConfig, InferenceSession,
                                SessionConfig)

device = "cuda" if torch.cuda.is_available() else "cpu"

# ---------------------------------------------------------------- 1. train
print(f"training ball classifier on synthetic balls on {device} ...")
trained, acc = trained_ball_classifier(steps=150, seed=0, log=print,
                                       device=device)
print(f"accuracy on held-out synthetic set: {acc:.4f} "
      f"(paper reports 99.975% on the RoboCup set)")

xs, ys = ball_image_batch(2000, seed=99, step=0)

# ------------------------------------------- 2. serve through the kernels
sess = InferenceSession(trained, config=SessionConfig(backend="cuda",
                                                      device=device))
plain = InferenceSession(trained, config=SessionConfig(backend="torch",
                                                       device=device))
np.testing.assert_allclose(sess.predict(xs[0]), plain.predict(xs[0]),
                           rtol=1e-3, atol=1e-5)
np.testing.assert_allclose(sess.predict(xs[:256]), plain.predict(xs[:256]),
                           rtol=1e-3, atol=1e-5)
print(f"cuda kernels == plain torch on {device} (allclose, single image "
      f"and batch)")


def top1(probs):
    return np.argmax(probs.reshape(len(probs), -1), -1)


# ------------------------------------------------------------- 3. int8
qsess = InferenceSession(trained, config=SessionConfig(
    backend="torch", precision="int8", device=device,
    calibration=CalibrationConfig(data=xs[:64], method="percentile")))
pred = top1(sess.predict(xs))
qpred = top1(qsess.predict(xs))
facc = float((pred == ys).mean())
qacc = float((qpred == ys).mean())
agree = float((qpred == pred).mean())
print(f"float accuracy {facc:.4f}, int8 "
      f"({qsess.info['calibration_method']}) accuracy {qacc:.4f}, top-1 "
      f"agreement {agree:.4f}")
assert facc >= 0.97, f"float accuracy {facc} < 0.97"
assert qacc >= facc - 0.02, f"int8 accuracy {qacc} < float {facc} - 0.02"

# ------------------------------------------------- 4. deploy as ANSI C
# the session runs the NNCG passes, benchmarks every per-layer code
# version (the paper's Table VII selection, cached on disk), compiles the
# winner with the host cc and serves batches through ctypes, on the host
csess = InferenceSession(trained, config=SessionConfig(
    backend="c", autotune=True, tune_iters=200))
info = csess.info
print(f"generated {info['c_source_bytes'] / 1e3:.0f} KB of C "
      f"(simd={info['simd']}), compiled to {info['so_path']}")
print(f"autotuned per-layer unroll levels: {info['levels']} "
      f"(from_cache={info['tuned_from_cache']})")
cpu = InferenceSession(trained, config=SessionConfig(backend="torch",
                                                     device="cpu"))
np.testing.assert_allclose(csess.predict(xs[0]), cpu.predict(xs[0]),
                           rtol=1e-3, atol=1e-5)
np.testing.assert_allclose(csess.predict(xs[:256]), cpu.predict(xs[:256]),
                           rtol=1e-3, atol=1e-5)
held = "plain torch on the CPU"
if device == "cuda":
    np.testing.assert_allclose(csess.predict(xs[:256]),
                               sess.predict(xs[:256]), rtol=1e-3, atol=1e-5)
    held += " and the cuda kernels"
print(f"C == {held} (allclose, single image and batch)")

# the int8 C build from the same calibration as step 3's: int8 weights
# and intermediates, int32 accumulators, a ~4x smaller arena
qc = InferenceSession(trained, config=SessionConfig(
    backend="c", precision="int8",
    calibration=CalibrationConfig(data=xs[:64], method="percentile")))
qcpu = InferenceSession(trained, config=SessionConfig(
    backend="torch", precision="int8", device="cpu",
    calibration=CalibrationConfig(data=xs[:64], method="percentile")))
qc_out = qc.predict(xs[:256])
np.testing.assert_allclose(qc_out, qcpu.predict(xs[:256]),
                           rtol=1e-5, atol=1e-6)
if device == "cuda":
    np.testing.assert_allclose(qc_out, qsess.predict(xs[:256]),
                               rtol=1e-5, atol=1e-6)
qc_acc = float((top1(qc_out) == ys[:256]).mean())
t_c, t_q = csess.benchmark(xs[0], iters=20000), qc.benchmark(xs[0],
                                                             iters=20000)
print(f"int8 C ({qc.info['simd']}): accuracy {qc_acc:.4f} on 256 frames, "
      f"arena {qc.info['arena_bytes']} B (float C: {info['arena_bytes']} B)")
print(f"latency on the host: C {t_c:.2f}us, int8 C {t_q:.2f}us "
      f"(paper: 11.81x faster than TF-XLA on an i7)")
assert qc_acc >= facc - 0.02, f"int8 C accuracy {qc_acc} < {facc} - 0.02"
