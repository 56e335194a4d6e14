"""The check that decides ``correct``: the program's served tokens and
logits against the plain reference, on a sample of the window's
batches.

A sampled batch is rerun by the reference as the program ran it: its
prompts in the program's row order, and the tokens the program fed to
each decode step, which must be the tokens it served.  The reference
computes the whole sequence layer by layer in float32 (TF32 off), and
gives the logits at every position where the program returned a row.  Four numbers, of which the cell's limits file names those it holds
to a limit:

* ``token_gap``: the widest gap by which a served token's reference
  logit lies below the reference's best at that position, and
  ``token_gap_mean``, its mean over the positions;
* ``logit_rel_err``: the largest relative L2 distance, over the
  positions, between the logits the program returned and the
  reference's, and ``logit_rel_err_median``, its median.

Besides, every request sent in the window must have come back
(``requests_failed``), and every served request must have been
prefilled by the program from its own prompt (``requests_unmatched``).
With ``control`` the same batches also run through the reference in
float8 (the control): ``control_token_gap*`` read the reference gap of
the token the float8 reference puts first, ``control_logit_rel_err*``
its logits' distance.
"""
from __future__ import annotations

import importlib

import numpy as np


def family_module(family: str):
    return importlib.import_module(f"portbench.reference.{family}")


def sample(recorder, requests, mix, seed: int):
    """The batches to check, drawn from the seed among those whose every
    row was served in full; and the count of served requests that no
    recorded prefill holds."""
    served = {r["key"]: r for r in requests if r["ok"]}
    seen = set()
    whole = []
    for i, b in enumerate(recorder.batches):
        keys = [row.tobytes() for row in b.prompts]
        seen.update(keys)
        if (len(b.fed) == mix["max_new"] - 1
                and all(k in served for k in keys)):
            whole.append(i)
    unmatched = sum(1 for k in served if k not in seen)
    rng = np.random.default_rng([seed, 2])
    n = min(mix["check_batches"], len(whole))
    picked = sorted(rng.choice(whole, size=n, replace=False).tolist()) \
        if n else []
    return [recorder.batches[i] for i in picked], served, unmatched


def _flat(parts) -> np.ndarray:
    return np.concatenate([p.reshape(-1) for p in parts]) if parts \
        else np.zeros(0)


def summarise(gap, rel) -> dict:
    """The compared numbers of per-position readings: the widest and the
    mean token gap, the largest and the median relative distance (NaN
    reads as infinitely bad)."""
    g, r = _flat(gap), _flat(rel)
    if not g.size:
        return dict(token_gap=0.0, token_gap_mean=0.0, logit_rel_err=0.0,
                    logit_rel_err_median=0.0)
    bad = float("inf")
    return dict(
        token_gap=bad if np.isnan(g).any() else float(g.max()),
        token_gap_mean=bad if np.isnan(g).any() else float(g.mean()),
        logit_rel_err=bad if np.isnan(r).any() else float(r.max()),
        logit_rel_err_median=bad if np.isnan(r).any() else float(
            np.median(r)))


def check(torch, batches, served, params, cfg: dict, family: str,
          device, control: bool = False) -> dict:
    """The compared numbers over ``batches`` (see the module's doc)."""
    from portbench.reference.common import fp8
    fam = family_module(family)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    read = {k: [] for k in ("gap", "rel", "control_gap", "control_rel")}
    tokens_checked = inconsistent = 0
    for b in batches:
        prompts = np.asarray(b.prompts, np.int64)
        tokens = np.stack([served[row.tobytes()]["tokens"]
                           for row in b.prompts]).astype(np.int64)
        bsz, t = prompts.shape
        n = tokens.shape[1]
        fed = np.stack(b.fed, 1) if b.fed else np.zeros((bsz, 0), np.int64)
        if not np.array_equal(fed, tokens[:, :-1]):
            inconsistent += 1
        seq = torch.from_numpy(np.concatenate([prompts, tokens[:, :-1]], 1)
                               ).to(device)
        with torch.inference_mode():
            ref = fam.logits(params, cfg, seq, t - 1)
            prog = torch.from_numpy(np.stack(b.logits, 1)).to(device).float()
            tok = torch.from_numpy(tokens).to(device)
            best = ref.max(-1).values
            read["gap"].append(
                (best - ref.gather(-1, tok[..., None])[..., 0]).cpu().numpy())
            read["rel"].append(((prog - ref).norm(dim=-1)
                                / ref.norm(dim=-1)).cpu().numpy())
            tokens_checked += tok.numel()
            if control:
                low = fam.logits(params, cfg, seq, t - 1, quant=fp8)
                first = low.argmax(-1, keepdim=True)
                read["control_gap"].append(
                    (best - ref.gather(-1, first)[..., 0]).cpu().numpy())
                read["control_rel"].append(((low - ref).norm(dim=-1)
                                            / ref.norm(dim=-1)).cpu().numpy())
                del low
            del ref, prog
    out = dict(summarise(read["gap"], read["rel"]),
               tokens_checked=tokens_checked, inconsistent=inconsistent)
    if control:
        out.update({"control_" + k: v for k, v in summarise(
            read["control_gap"], read["control_rel"]).items()})
    return out


def verdict(numbers: dict, counts: dict, limits: dict):
    """``(correct, compared)``: each number that the cell's limits file
    names beside its limit, then the counts that must be nought."""
    compared = {k: (numbers[k], v["limit"])
                for k, v in limits["compare"].items()}
    compared.update({
        "requests_failed": (counts["failed"], 0),
        "requests_unmatched": (counts["unmatched"], 0),
        "batches_inconsistent": (numbers["inconsistent"], 0),
        "tokens_checked_short": (max(0, limits["min_tokens_checked"]
                                     - numbers["tokens_checked"]), 0),
    })
    ok = all(v <= lim for v, lim in compared.values())
    return ok, {k: {"value": v, "limit": lim} for k, (v, lim) in
                compared.items()}
