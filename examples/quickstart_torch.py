"""Quickstart on the PyTorch port: the paper's flow for the ball
classifier on the card (the counterpart of ``examples/quickstart.py``,
without its C backend, the paper's CPU artifact).

  1. Build the Table-I CNN and *train* it on the synthetic ball dataset.
  2. Serve it through ``InferenceSession(backend="cuda")``, which runs
     the hand-written conv2d and maxpool2d kernels, and check it against
     the plain ``backend="torch"`` session.
  3. Calibrate it on 64 frames and serve it at int8; compare float and
     int8 accuracy and their top-1 agreement.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs.cnn_paper import trained_ball_classifier
from repro_torch.data.pipeline import ball_image_batch
from repro_torch.engine import (CalibrationConfig, InferenceSession,
                                SessionConfig)

# ---------------------------------------------------------------- 1. train
print("training ball classifier on synthetic balls ...")
trained, acc = trained_ball_classifier(steps=150, seed=0, log=print)
print(f"accuracy on held-out synthetic set: {acc:.4f} "
      f"(paper reports 99.975% on the RoboCup set)")

xs, ys = ball_image_batch(2000, seed=99, step=0)

# ------------------------------------------- 2. serve through the kernels
sess = InferenceSession(trained, config=SessionConfig(backend="cuda"))
plain = InferenceSession(trained, config=SessionConfig(backend="torch"))
np.testing.assert_allclose(sess.predict(xs[0]), plain.predict(xs[0]),
                           rtol=1e-3, atol=1e-5)
np.testing.assert_allclose(sess.predict(xs[:256]), plain.predict(xs[:256]),
                           rtol=1e-3, atol=1e-5)
print("cuda kernels == plain torch (allclose, single image and batch)")


def top1(probs):
    return np.argmax(probs.reshape(len(probs), -1), -1)


# ------------------------------------------------------------- 3. int8
qsess = InferenceSession(trained, config=SessionConfig(
    backend="torch", precision="int8",
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
