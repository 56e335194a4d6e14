"""The reference's head-dim attention rule in the port's ``MeshPar``
(``attn_rule``, ``src/repro_torch/launch/sharding.py``), and the query
offset of the attention functions that its prefill and training run.

* The rule table: ``dense_splits`` and ``MeshPar(attn_rule=...)``
  against the JAX package's own ``MeshPar.constraint("heads" |
  "kv_heads")`` (its layouts read off with the sharding constraint
  stubbed out) for every arch on (16, 16), (1, 8), (2, 4) and (1, 4),
  under ``"auto"`` and ``"qshard_kvrep"``; every ``.smoke()`` config
  takes ``"head_dim"`` on (1, 4) (2 kv heads, 4 q heads, head dim 16);
  an unknown rule raises.
* The plain versions' query offset: ``attention_ref(q_start=s)`` on
  rows [s, s + m) equals the JAX ``attention_ref``'s rows over the whole
  T (causal, window, GQA) at 2e-5; ``flash_mha`` and ``local_mha`` with
  an offset equal the JAX functions' rows, and so do their gradients
  (dq of the rows, dk and dv whole, the JAX upstream gradient zero off
  the rows), at ``tests/test_torch_train.py``'s tolerances.
* On four spawned gloo ranks, a (1, 4) mesh, fp32 ``.smoke()``
  configs, under the default rule:
  - the forward of gemma3-4b, qwen1.5-110b, zamba2-2.7b,
    deepseek-moe-16b and h2o-danube-3-4b at T = 16 (each rank on its 4
    rows) and T = 15 (the stream whole, the attention whole on every
    rank): logits at rtol 1e-5 / atol 1e-5 to the unmeshed port and at
    1e-4 to JAX's unmeshed ``forward``, the same on every rank; the
    collectives by kind as ``tests/test_torch_launch_tp.py`` counts them
    (one all-gather of k and v over T a head-dim layer), none of them of
    a tensor with two sequence dims; the attention's leaves read whole;
  - a prefill and 8 greedy decode steps of gemma3-4b (ring caches and
    global), qwen1.5-110b (qkv bias), qwen2-vl-72b (M-RoPE) and
    zamba2-2.7b (the shared block): the unmeshed tokens and the logits
    at 1e-5; each rank's k / v caches (b, S, Hkv, Dh / 4), the shapes
    the reference's ``cache_specs`` gives; a decode step reads this
    rank's stored attention blocks; its collectives by kind (a head-dim
    layer: two all-gathers, of q, k and v and of o, and two
    all-reduces, of the partial scores and out of ``wo``);
  - gemma3-4b's meshed train step, two steps from one carried JAX train
    state, at ``tests/test_torch_launch_tp.py``'s bars against the
    unmeshed port and JAX; each rank's gradients of the attention's
    leaves (before the reduction) whole and equal on every rank; no
    collective of the step moves a tensor with two sequence dims.

The world is spawned once (``tests/torch_worlds.py``).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_launch_tp as tp
import torch_launch_jobs as jobs
from repro.configs.lm_archs import ARCHS as JAX_ARCHS
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.launch import sharding as jsh
from repro.models.attention_vjp import flash_mha as jax_flash_mha
from repro.models.attention_vjp import local_mha as jax_local_mha
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.core.tree import leaves_with_paths
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch.sharding import (MeshPar, dense_splits, local_shape,
                                         param_specs, spec_leaves)
from repro_torch.models.attention_vjp import flash_mha, local_mha
from repro_torch.models.stack import init_cache, init_params
from test_torch_train import _hold, _jax_grads, _port_grads
from torch_worlds import run_world

SHAPE = (1, 4)
RULES = ("auto", "qshard_kvrep")
MESHES = ((16, 16), (1, 8), (2, 4), (1, 4))
FWD_ARCHS = ("gemma3-4b", "qwen1.5-110b", "zamba2-2.7b", "deepseek-moe-16b",
             "h2o-danube-3-4b")
FWD_CASES = [(a, t) for t in (16, 15) for a in FWD_ARCHS]
DECODE_ARCHS = ("gemma3-4b", "qwen1.5-110b", "qwen2-vl-72b", "zamba2-2.7b")
TRAIN_ARCH = "gemma3-4b"


def _has_attention(cfg) -> bool:
    return bool(set(cfg.prologue + cfg.pattern) & set("ALS"))


# ------------------------------------------------------ the rule table ---

def _reference_rule(mesh, arch, rule):
    """The attention layout the JAX package's ``MeshPar`` pins on q and
    on k / v, named as the port names its splits."""
    par = jsh.MeshPar(mesh, JAX_ARCHS[arch], attn_rule=rule)
    par._c = lambda x, spec: tuple(spec)  # the spec, not the constraint
    q = par.constraint(SimpleNamespace(shape=None), "heads")
    kv = par.constraint(SimpleNamespace(shape=None), "kv_heads")
    if q[2] == "model":
        return "heads" if kv[2] == "model" else "q_heads_kv_whole"
    return "head_dim" if q[3] == "model" else "whole"


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_attention_rule_follows_the_reference(arch, shape, rule):
    mesh = tp._duck(shape)
    cfg = ARCHS[arch]
    splits = dense_splits(mesh, cfg, rule)
    par = MeshPar(mesh, cfg, attn_rule=rule)
    assert par.describe()["dense"] == splits
    assert par.describe()["attn_rule"] == rule
    if not _has_attention(cfg):
        assert "attn" not in splits
        return
    assert splits["attn"] == _reference_rule(mesh, arch, rule)
    assert par.dense_split("attn") == splits["attn"]
    assert par.cache_split("attn") == (
        1 if splits["attn"] in ("whole", "q_heads_kv_whole")
        else shape[-1])


@pytest.mark.parametrize("arch", sorted(a for a in ARCHS
                                        if _has_attention(ARCHS[a])))
def test_every_smoke_config_splits_the_head_dim_on_four_ranks(arch):
    par = MeshPar(tp._duck(SHAPE), ARCHS[arch].smoke())
    assert par.describe()["dense"]["attn"] == "head_dim"
    caches = init_cache(ARCHS[arch].smoke(), 2, 16, "meta", par)
    cfg = ARCHS[arch].smoke()
    for path, t in leaves_with_paths(caches):
        if path.rpartition("/")[2] in ("k", "v"):
            assert t.shape[-2:] == (cfg.n_kv_heads, cfg.head_dim // 4), path


def test_unknown_attention_rule_raises():
    cfg = ARCHS["gemma3-4b"]
    with pytest.raises(ValueError, match="attn_rule"):
        dense_splits(tp._duck(SHAPE), cfg, "head_dim")
    with pytest.raises(ValueError, match="attn_rule"):
        MeshPar(tp._duck(SHAPE), cfg, attn_rule="qshard")


# ------------------------------------------------ the query offset ---

def _rnd(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# (b, hq, hkv, t, d, causal, window, q_start, rows)
REF_CASES = [(2, 4, 2, 64, 16, True, None, 16, 16),
             (1, 4, 1, 64, 32, True, 24, 32, 32),
             (1, 2, 2, 48, 16, False, None, 12, 12),
             (2, 8, 2, 96, 16, True, 40, 48, 24)]


@pytest.mark.parametrize("b,hq,hkv,t,d,causal,window,s,m", REF_CASES)
def test_attention_ref_rows_at_an_offset(b, hq, hkv, t, d, causal, window,
                                         s, m):
    q, k, v = (_rnd(i, (b, h, t, d)) for i, h in ((1, hq), (2, hkv),
                                                   (3, hkv)))
    want = np.asarray(jax_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
        window=window))[:, :, s:s + m]
    got = attention_ref(torch.from_numpy(q[:, :, s:s + m]),
                        torch.from_numpy(k), torch.from_numpy(v),
                        causal=causal, window=window, q_start=s)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def _rows_vs_whole(port_fn, jax_fn, arrays, s, m, seed):
    """The port on rows [s, s + m) of q against the JAX function on the
    whole T: the output rows, dq of the rows, dk and dv (the JAX upstream
    gradient zero off the rows)."""
    q, k, v = arrays
    do = _rnd(seed, q.shape)
    do[:, :s] = 0.0
    do[:, s + m:] = 0.0
    o, (dq, dk, dv) = _jax_grads(jax_fn, arrays, do)
    got = _port_grads(port_fn, (q[:, s:s + m], k, v), do[:, s:s + m])
    _hold(got, (o[:, s:s + m], [dq[:, s:s + m], dk, dv]))


# (B, T, H, Hkv, Dh, causal, window, bq, bk, q_start, rows)
FLASH_OFFSET_CASES = [(2, 128, 4, 2, 32, True, None, 32, 64, 64, 32),
                      (1, 128, 4, 4, 16, True, 48, 32, 32, 32, 64),
                      (2, 128, 4, 1, 32, False, None, 32, 64, 96, 32)]


@pytest.mark.parametrize("B,T,H,Hkv,Dh,causal,window,bq,bk,s,m",
                         FLASH_OFFSET_CASES)
def test_flash_mha_rows_at_an_offset(B, T, H, Hkv, Dh, causal, window, bq,
                                     bk, s, m):
    arrays = (_rnd(4, (B, T, H, Dh)), _rnd(5, (B, T, Hkv, Dh)),
              _rnd(6, (B, T, Hkv, Dh)))
    _rows_vs_whole(
        lambda q, k, v: flash_mha(q, k, v, causal, window, None, bq, bk, s),
        lambda q, k, v: jax_flash_mha(q, k, v, causal, window, None, bq,
                                      bk), arrays, s, m, 12)


# (B, T, H, Hkv, Dh, window, bq, q_start, rows)
LOCAL_OFFSET_CASES = [(2, 256, 4, 2, 32, 64, 64, 128, 64),
                      (1, 128, 4, 1, 32, 32, 32, 32, 64),
                      (1, 128, 2, 2, 16, 100, 32, 96, 32)]


@pytest.mark.parametrize("B,T,H,Hkv,Dh,window,bq,s,m", LOCAL_OFFSET_CASES)
def test_local_mha_rows_at_an_offset(B, T, H, Hkv, Dh, window, bq, s, m):
    arrays = (_rnd(7, (B, T, H, Dh)), _rnd(8, (B, T, Hkv, Dh)),
              _rnd(9, (B, T, Hkv, Dh)))
    _rows_vs_whole(
        lambda q, k, v: local_mha(q, k, v, window, None, bq, s),
        lambda q, k, v: jax_local_mha(q, k, v, window, None, bq), arrays,
        s, m, 13)


# --------------------------------------------------- four gloo ranks ---

def _tasks():
    tasks = []
    for arch, t in FWD_CASES:
        params, batch = tp._inputs(arch)
        tasks.append((f"fwd {arch} T{t}", "variant", dict(
            arch=arch, over={}, shape=SHAPE, moe="tp", ulysses=False,
            params=params, batch={k: v[:, :t] for k, v in batch.items()})))
    for arch in DECODE_ARCHS:
        params, batch = tp._inputs(arch)
        tasks.append((f"dec {arch}", "tp_decode", dict(
            arch=arch, shape=SHAPE, params=params,
            prompts=batch["tokens"][:2, :12], new=tp.DECODE_NEW)))
    _, _, state, batches = tp._train_inputs(TRAIN_ARCH)
    tasks.append((f"train {TRAIN_ARCH} {SHAPE}", "train", dict(
        arch=TRAIN_ARCH, over={}, shape=SHAPE, state=state,
        batches=batches, lr=(tp.LR, tp.WARMUP, tp.TOTAL))))
    return tasks


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(4, jobs.suite, (_tasks(),),
                     tmp_path_factory.mktemp("w4"))


def _no_two_sequence_dims(moved, t):
    """No collective carries a tensor with two sequence dims: a score
    or probability tensor, (b, H, T, T) or (b, Hkv, G, T, T).  (The
    smoke configs' head dim is 16, as is T: k and v, (b, T, 2 Hkv, Dh),
    are not such a tensor.)"""
    bad = [(k, s) for k, s in moved if tuple(s[-2:]) == (t, t)]
    assert not bad, bad


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: f"{c[0]}-T{c[1]}")
def test_head_dim_forward_matches_unmeshed_and_jax(case, world4):
    arch, t = case
    cfg = ARCHS[arch].smoke()
    want = tp._jax_logits(arch, t)
    splits = dense_splits(tp._duck(SHAPE), cfg)
    assert splits["attn"] == "head_dim"
    whole = {p: tuple(x.shape) for p, x in leaves_with_paths(
        init_params(cfg, device="meta"))}
    first = world4[0][f"fwd {arch} T{t}"]
    for rank, r in enumerate(world4):
        got = r[f"fwd {arch} T{t}"]
        assert got["dense"] == splits, (rank, got["dense"])
        np.testing.assert_allclose(got["meshed"], got["unmeshed"],
                                   rtol=1e-5, atol=1e-5)
        assert np.abs(got["meshed"] - want).max() < 1e-4, rank
        assert np.array_equal(got["meshed"], first["meshed"]), rank
        tp._hold_stream(got, cfg, splits, SHAPE, t)
        _no_two_sequence_dims(got["stream_collectives"], t)
        if t % SHAPE[1] == 0:  # k and v gathered over T, (b, T / n, 2 Hkv, Dh)
            assert (4, t // 4, 2 * cfg.n_kv_heads, cfg.head_dim) in [
                s for k, s in got["stream_collectives"] if k == "all-gather"]
        for path, shape in got["local_shapes"].items():
            if "/attn/" in path:  # T > 1: read whole
                assert shape == whole[path], path


def _predicted_decode(cfg, splits):
    """A decode step's collectives on (1, 4): the forward's at T = 1
    (:func:`tp._predicted`), plus two all-gathers and two all-reduces a
    head-dim attention layer and the last logits gathered over the data
    axis (a collective also on an axis of one rank)."""
    c = tp._predicted(cfg, splits, SHAPE[1], 1)
    n_attn = sum(k in "ALS" for k in cfg.prologue + cfg.pattern * cfg.n_groups)
    c["all-gather"] = c.get("all-gather", 0) + 2 * n_attn + 1
    c["all-reduce"] = c.get("all-reduce", 0) + 2 * n_attn
    return c


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_head_dim_decode_gives_the_unmeshed_tokens(arch, world4):
    cfg = ARCHS[arch].smoke()
    mesh = tp._duck(SHAPE)
    b = 2
    jspecs = tp._reference_cache_specs(mesh, JAX_ARCHS[arch].smoke(), b, 32)
    whole = {p: tuple(t.shape) for p, t in leaves_with_paths(
        init_cache(cfg, b, 32, "meta"))}
    params = init_params(cfg, device="meta")
    specs = {p: s for (p, _), s in spec_leaves(params,
                                                param_specs(mesh, params))}
    stored = {p: tuple(t.shape) for p, t in leaves_with_paths(params)}
    for r in world4:
        got = r[f"dec {arch}"]
        assert got["dense"]["attn"] == "head_dim"
        assert np.array_equal(got["meshed"]["tokens"],
                              got["unmeshed"]["tokens"])
        np.testing.assert_allclose(got["meshed"]["logits"],
                                   got["unmeshed"]["logits"], rtol=1e-5,
                                   atol=1e-5)
        n_kv = 0
        for path, s in got["meshed"]["cache_shapes"].items():
            assert s == local_shape(mesh, whole[path], jspecs[path]), path
            if path.rpartition("/")[2] in ("k", "v"):
                assert s[-3:] == (whole[path][-3], cfg.n_kv_heads,
                                  cfg.head_dim // 4), (path, s)
                n_kv += 1
        assert n_kv > 0
        for path, s in got["decode_shapes"].items():
            if "/attn/" in path:  # this rank's stored block over model
                assert s == local_shape(mesh, stored[path],
                                        tp._model_only(specs[path])), path
                assert s != stored[path], path
        kinds = {}
        for kind, _ in got["decode_collectives"]:
            kinds[kind] = kinds.get(kind, 0) + 1
        assert kinds == _predicted_decode(cfg, got["dense"]), kinds


def test_head_dim_train_step_matches_unmeshed_and_jax(request, world4):
    case = (TRAIN_ARCH, SHAPE)
    tp.test_split_train_step_matches_unmeshed_and_jax(case, request)
    cfg = ARCHS[TRAIN_ARCH].smoke()
    whole = {p: tuple(t.shape) for p, t in leaves_with_paths(
        init_params(cfg, device="meta"))}
    steps = [r[f"train {TRAIN_ARCH} {SHAPE}"] for r in world4]
    n_attn = 0
    for i in range(tp.TRAIN_STEPS):
        for path, g in steps[0][i]["raw_grads"].items():
            if "/attn/" not in path:
                continue
            n_attn += 1
            assert g.shape == whole[path], path
            for r in steps[1:]:
                assert np.array_equal(r[i]["raw_grads"][path], g), path
        for r in steps:
            _no_two_sequence_dims(r[i]["collectives"], 16)
    assert n_attn > 0
