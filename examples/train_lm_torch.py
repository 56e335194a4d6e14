"""End-to-end example on the PyTorch port: train the ~100M-parameter LM
for a few hundred steps with checkpointing, on the card (deliverable
(b); the counterpart of ``examples/train_lm.py``).

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
      (append ``--device cpu`` to run on the CPU)
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import main

if __name__ == "__main__":
    argv = sys.argv[1:] or ["--steps", "200", "--batch", "8", "--seq", "256"]
    out = main(["--arch", "lm-100m"] + argv)
    assert out["last_loss"] < out["first_loss"], "loss did not improve"
    print(f"loss {out['first_loss']:.3f} -> {out['last_loss']:.3f} over "
          f"{len(out['loss_curve'])} logged points: training works.")
