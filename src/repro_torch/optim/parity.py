"""How two training runs of the same function are held to each other
(the port against the JAX package, the card against the CPU).

The gradients are held to the tolerance of the function; the parameters
after AdamW steps are held to the same tolerance except where Adam's own
arithmetic amplifies the tolerated gradient difference past it.  Adam's
step ``m_hat / (sqrt(v_hat) + eps)`` normalizes the gradient away: where
a gradient is near ``eps``, or cancels to its rounding level, a
gradient difference far inside the gradients' tolerance moves the
parameter by a good part of the learning rate.  Such elements are found
by running one optimizer update from one state on both runs' gradients;
where the two updates differ by more than a tenth of the parameters'
atol, the element is held to the bound of Adam's steps instead, and such
elements must be rare.  Shared by the CPU tests and ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.tree import leaves_with_paths

AMPLIFIED_FRAC = 0.1   # of the parameters' atol, per step
MAX_MARKED_SHARE = 1e-3


def mark_amplified(opt, state, params, g_got, g_want,
                   into: Dict[str, np.ndarray], atol: float) -> None:
    """Mark in ``into`` (path -> bool mask, paths of ``params``) the
    elements where ``opt.update`` from ``state`` moves a parameter
    differently by more than ``AMPLIFIED_FRAC * atol`` on ``g_got`` than
    on ``g_want`` (trees of ``params``' structure, on its device)."""
    u_got, _ = opt.update(g_got, state, params)
    u_want, _ = opt.update(g_want, state, params)
    for (k, a), (_, b) in zip(leaves_with_paths(u_got),
                              leaves_with_paths(u_want)):
        off = ((a - b).abs() > AMPLIFIED_FRAC * atol).cpu().numpy()
        into[k] = into.get(k, np.zeros(off.shape, bool)) | off


def adam_step_bound(lr_sum: float, weight_decay: float,
                    max_abs_param: float) -> float:
    """The most two runs' parameters can drift apart over steps whose
    learning rates sum to ``lr_sum``: Adam's step is at most 1 in
    magnitude (Cauchy-Schwarz, as b1^2 <= b2), so each moves a parameter
    by at most ``lr * (1 + wd * |p|)``, in either direction."""
    return 2 * lr_sum * (1 + weight_decay * max_abs_param)


def hold_params(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                marks: Dict[str, np.ndarray], bound: float, rtol: float,
                atol: float) -> dict:
    """Raise unless every unmarked element is within ``rtol``/``atol``,
    every marked one within ``bound``, and the marked ones are at most
    :data:`MAX_MARKED_SHARE` of all.  Returns the counts and the largest
    error among the unmarked elements."""
    if set(got) != set(want):
        raise AssertionError(f"keys differ: {sorted(set(got) ^ set(want))}")
    n = n_marked = 0
    err = 0.0
    for k, w in want.items():
        g = got[k]
        mask = marks.get(k, np.zeros(w.shape, bool))
        n += w.size
        n_marked += int(mask.sum())
        d = np.abs(g - w)
        bad = (d > atol + rtol * np.abs(w)) & ~mask
        if bad.any() or not np.isfinite(g).all():
            raise AssertionError(
                f"{k}: {int(bad.sum())} of {w.size} outside rtol {rtol} "
                f"atol {atol}; max abs error {float(d[bad].max())}")
        if (d[mask] > bound).any():
            raise AssertionError(f"{k}: a marked element moved "
                                 f"{float(d[mask].max())} > {bound}")
        if (~mask).any():
            err = max(err, float(d[~mask].max()))
    if n_marked > MAX_MARKED_SHARE * n:
        raise AssertionError(f"{n_marked} of {n} elements marked")
    return {"elements": n, "marked": n_marked, "max_abs_err": err}
