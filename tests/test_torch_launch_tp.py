"""The port's tensor-parallel dense layers over ``model`` (``MeshPar``'s
split, ``src/repro_torch/launch/sharding.py``) across spawned gloo ranks
on the CPU, in fp32 on the ``.smoke()`` configs, held to the port's
unmeshed paths and to the JAX package.

* The forward's logits on (1, 2), (2, 2) and (1, 4) meshes for gemma3-4b
  (tied embedding, windowed and global attention), qwen1.5-110b (qkv
  bias), zamba2-2.7b (Mamba2 and the shared block), rwkv6-7b and
  deepseek-moe-16b (dense attention beside the TP-MoE), and for
  h2o-danube-3-4b at (1, 4), whose 2 kv heads do not divide 4: every
  case here runs under ``attn_rule="qshard_kvrep"``, so every smoke
  config's attention takes the reference's second rule at (1, 4): q
  heads split, k and v whole (under the default ``"auto"`` it takes the
  third, the head dim: ``tests/test_torch_attn_rule.py``), and the
  (1, 2) and (2, 2) meshes take the first under either rule: at rtol
  1e-5 / atol 1e-5 to the port's unmeshed forward
  and at 1e-4 (max abs) to JAX's unmeshed ``forward`` on the same weights
  (``from_jax_params``), as
  ``test_parallel_variant_matches_the_unmeshed_forward`` holds them, with
  each rank's ``describe()["dense"]``.  T = 16 divides every mesh's
  ``model``, so the residual stream runs split over T (sequence
  parallelism): each block's input is (b, T / n, D) on every rank, and
  the collectives past the parameters' gathers are, kind by kind, those
  counted from the layer pattern (an all-gather into each split region
  and a reduce-scatter out of it), with no all-reduce of a (b, T, D)
  tensor.  At T = 15 on (1, 2) the stream stays whole (the reference's
  fallback where T does not divide), and its regions all-reduce.
* The vocab-parallel cross entropy on (1, 2) and (1, 4) for gemma3-4b
  (tied embedding) and qwen1.5-110b (its own head): labels in every
  rank's vocabulary rows and a masked row; the loss, xent and z-loss and
  the gradients of the logits' producers (the head or tied embedding and
  the final norm) at 1e-6 to the unmeshed port and at 1e-5 to JAX's
  ``loss_fn``, and no collective of the loss or its backward moves a
  tensor with a vocabulary dim.
* Each rank's blocks as the forward reads them (``local_params``): for
  every leaf of a split dense layer the shape ``param_specs`` gives over
  ``model``, for the others the whole shape (the expert weights are
  ``tests/test_torch_launch_moe.py``'s).
* A session's prefill and 8 greedy decode steps on (1, 2), and on
  (1, 4) for zamba2-2.7b and h2o-danube-3-4b: the unmeshed session's
  tokens and its logits at 1e-5; each rank's caches of the shapes
  ``local_shape`` gives under the JAX package's own ``cache_specs`` on a
  duck-typed mesh where the split applies (its "conv" and "wkv" leaves by
  the rule its docstring states: the function itself gives them the kv
  rule), and whole where the attention takes the q-heads rule.
* The meshed train step, two steps from one carried JAX train state, on
  (1, 2) (zamba2-2.7b, rwkv6-7b) and (2, 2) (gemma3-4b): loss, grad norm
  and moments at rtol 1e-4 / atol 1e-5 against the port's unmeshed step
  and JAX's, the parameters through ``optim.parity.hold_params``
  (``tests/test_torch_launch_train.py``'s bars), and the gradients of the
  replicated leaves equal on every rank.
* On duck-typed meshes, no process group: the split each arch takes at
  full width under either attention rule, and the port's cache layout
  against the reference's ``cache_specs`` (the same dims on ``model``
  wherever the port splits, the head dim of ``k`` / ``v`` included).

Worlds of 2 and 4 ranks are spawned once each (``tests/torch_worlds.py``).
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_launch_jobs as jobs
from repro.configs.lm_archs import ARCHS as JAX_ARCHS
from repro.launch import sharding as jsh
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import lm as jlm
from repro.models.stack import DEFAULT_PAR
from repro.models.stack import init_cache as jax_init_cache
from repro.optim import AdamW as JaxAdamW
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.core.tree import leaves_with_paths, unflatten
from repro_torch.launch.mesh import DEFAULT_AXES, dp_axes
from repro_torch.launch.sharding import (MeshPar, dense_splits, local_shape,
                                         param_specs, spec_for, spec_leaves)
from repro_torch.launch.specs import cache_layout
from repro_torch.models import lm
from repro_torch.models.stack import init_cache, init_params
from repro_torch.optim import AdamW, parity, warmup_cosine
from test_torch_launch_train import _step_grads
from test_torch_lm_model import perturbed_jax_params
from test_torch_train_lm import (LR, TOTAL, WARMUP, _batch, _close, _flat,
                                 _hold_params, _jax, _port_flat, _port_grads,
                                 _torch)
from torch_worlds import run_world

# the attention rule of every meshed case here (the q-heads rule where it
# applies; see the docstring)
RULE = "qshard_kvrep"
FWD_ARCHS = ("gemma3-4b", "qwen1.5-110b", "zamba2-2.7b", "rwkv6-7b",
             "deepseek-moe-16b")
FWD_CASES = [(a, m) for m in ((1, 2), (2, 2), (1, 4)) for a in FWD_ARCHS] + [
    ("h2o-danube-3-4b", (1, 4))]
# T = 15 does not divide 2: the residual stream stays whole
FALLBACK_CASES = [("gemma3-4b", (1, 2), 15)]
LOSS_CASES = [(a, m) for m in ((1, 2), (1, 4))
              for a in ("gemma3-4b", "qwen1.5-110b")]
DECODE_CASES = [(a, (1, 2)) for a in FWD_ARCHS] + [
    ("zamba2-2.7b", (1, 4)), ("h2o-danube-3-4b", (1, 4))]
DECODE_NEW = 8
TRAIN_CASES = [("zamba2-2.7b", (1, 2)), ("rwkv6-7b", (1, 2)),
               ("gemma3-4b", (2, 2))]
TRAIN_STEPS, TRAIN_B = 2, 4
# the leaves each split layer kind reads as this rank's blocks
SPLIT_LEAVES = {
    "attn": {"wq", "wk", "wv", "wo", "bq", "bk", "bv"},
    "mlp": {"wg", "wu", "wd"},
    "mamba": {"w_in", "w_out", "conv_w", "conv_b", "w_B", "w_C", "w_dt"},
    "rwkv": {"w_r", "w_k", "w_v", "w_g", "w_o", "w_ck", "w_cv", "w_cr"},
    "vocab": {"embed", "head"}}


def _duck(shape):
    axes = DEFAULT_AXES[len(shape)]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


# The reference's ``cache_specs`` tests whether a leaf's name ends in "k"
# or "v" before it tests "ssm", "conv" and "wkv", so its "conv" and "wkv"
# caches take the kv rule, not the one its docstring states: conv on
# d_inner, wkv on its heads (ROADMAP Queue 3).  The port splits those
# two by the stated rule (after the batch dim), and is held to it.
_STATED = {"conv": (None, "model"), "wkv": ("model", None, None)}


def _reference_cache_specs(mesh, jcfg, batch, max_len):
    """{path: spec} of the reference's ``cache_specs`` for the JAX
    caches of ``jcfg``, the "conv" and "wkv" leaves by the stated rule."""
    jcaches = jax.eval_shape(lambda: jax_init_cache(jcfg, batch, max_len))
    flat = jax.tree_util.tree_flatten_with_path(jcaches)[0]
    specs = jax.tree_util.tree_leaves(
        jsh.cache_specs(mesh, jcfg, jcaches),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for (path, leaf), spec in zip(flat, specs):
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path)
        spec = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        stated = _STATED.get(path.rpartition("/")[2])
        if stated is not None:
            tail = (dp_axes(mesh),) + stated
            spec = spec_for(mesh, leaf.shape, (None,) * (
                leaf.ndim - len(tail)) + tail)
        out[path] = spec
    return out


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """The JAX smoke config's weights (numpy) and a (4, 16) token batch."""
    jcfg = JAX_ARCHS[arch].smoke()
    params = jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(FWD_ARCHS.index(arch) + 10
                                 if arch in FWD_ARCHS else 9)))
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    return params, {"tokens": tokens}


@functools.lru_cache(maxsize=None)
def _jax_logits(arch, t=16):
    jcfg = JAX_ARCHS[arch].smoke()
    params, batch = _inputs(arch)
    out, _ = jax.jit(lambda p, b: jax_forward(p, jcfg, b, DEFAULT_PAR))(
        params, {k: jnp.asarray(v[:, :t]) for k, v in batch.items()})
    return np.asarray(out)


@functools.lru_cache(maxsize=None)
def _loss_batch(arch):
    """The (4, 16) tokens, labels reaching every rank's vocabulary rows
    (one in each eighth of the vocabulary), and a mask with row 2 masked
    out."""
    _, batch = _inputs(arch)
    v = JAX_ARCHS[arch].smoke().vocab_size
    labels = np.random.default_rng(6).integers(0, v, (4, 16)).astype(np.int32)
    labels[0, :8] = np.arange(8) * (v // 8) + 3
    mask = np.ones((4, 16), np.float32)
    mask[2] = 0.0
    return {"tokens": batch["tokens"], "labels": labels, "mask": mask}


@functools.lru_cache(maxsize=None)
def _jax_loss(arch):
    """JAX's ``loss_fn`` on the unmeshed model: (loss, aux, grads)."""
    jcfg = JAX_ARCHS[arch].smoke()
    params, _ = _inputs(arch)
    batch = _jax(_loss_batch(arch))
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, batch), has_aux=True))(params)
    return ({"loss": float(loss), **{k: float(x) for k, x in aux.items()}},
            _flat(grads))


def _predicted(cfg, splits, n, t):
    """The forward's collectives past the parameters' gathers, by kind,
    counted from the layer pattern: over T when ``t`` divides ``n``
    (into a split region an all-gather, out of it a reduce-scatter; a
    layer that runs whole gathers T; head-dim attention, on this rank's
    rows, gathers its k and v over T), else the whole-T regions' all-reduce
    out; plus Mamba2's re-cut of its halves and B/C/dt sum, RWKV6's
    channel exchange, and the vocabulary's logits gathered whole."""
    chunk = t % n == 0
    c = {}

    def add(kind, k=1):
        c[kind] = c.get(kind, 0) + k

    def region():
        add("all-gather", chunk)
        add("reduce-scatter" if chunk else "all-reduce")

    def whole():
        add("all-gather", chunk)
    if cfg.embed_inputs and splits["vocab"] != "whole":
        add("reduce-scatter" if chunk else "all-reduce")
    for kind in cfg.prologue + cfg.pattern * cfg.n_groups:
        if kind in "ALS":
            if splits["attn"] in ("whole", "head_dim"):
                whole()  # the stream's, or k and v together, over T
            else:
                region()
            if cfg.n_experts and kind != "S":
                region()  # the tensor-parallel MoE
            else:
                region() if splits["mlp"] != "whole" else whole()
        elif kind == "M":
            if splits["mamba"] == "whole":
                whole()
            else:
                region()
                add("all-to-all")
                add("all-reduce")
        elif kind == "R":
            if splits["rwkv"] == "whole":
                whole(), whole()
            else:
                whole()  # the time mix's gather before the token shift
                add("reduce-scatter" if chunk else "all-reduce")
                whole()  # the channel mix's
                add("reduce-scatter")
                add("all-to-all" if chunk else "all-gather")
    if splits["vocab"] != "whole":
        add("all-gather", chunk)
        add("all-gather")
    else:
        whole()
    return {k: v for k, v in c.items() if v}


@functools.lru_cache(maxsize=None)
def _train_inputs(arch):
    jcfg = JAX_ARCHS[arch].smoke()
    params = perturbed_jax_params(jcfg)
    jopt = JaxAdamW(learning_rate=jax_warmup_cosine(LR, WARMUP, TOTAL))
    state = jax.tree.map(np.asarray, (params, jopt.init(params),
                                      jnp.int32(0)))
    cfg = ARCHS[arch].smoke()
    batches = [_batch(cfg, 40 + i, b=TRAIN_B) for i in range(TRAIN_STEPS)]
    return jcfg, jopt, state, batches


def _tasks(n):
    tasks = []
    for arch, shape in FWD_CASES:
        if shape[0] * shape[1] == n:
            params, batch = _inputs(arch)
            tasks.append((f"fwd {arch} {shape}", "variant", dict(
                arch=arch, over={}, shape=shape, moe="tp", ulysses=False,
                params=params, batch=batch, attn_rule=RULE)))
    for arch, shape, t in FALLBACK_CASES:
        if shape[0] * shape[1] == n:
            params, batch = _inputs(arch)
            tasks.append((f"fwd {arch} {shape} T{t}", "variant", dict(
                arch=arch, over={}, shape=shape, moe="tp", ulysses=False,
                params=params, batch={k: v[:, :t] for k, v in
                                      batch.items()}, attn_rule=RULE)))
    for arch, shape in LOSS_CASES:
        if shape[0] * shape[1] == n:
            tasks.append((f"loss {arch} {shape}", "vocab_loss", dict(
                arch=arch, shape=shape, params=_inputs(arch)[0],
                batch=_loss_batch(arch), attn_rule=RULE)))
    for arch, shape in DECODE_CASES:
        if shape[0] * shape[1] == n:
            params, batch = _inputs(arch)
            tasks.append((f"dec {arch} {shape}", "tp_decode", dict(
                arch=arch, shape=shape, params=params,
                prompts=batch["tokens"][:2, :12], new=DECODE_NEW,
                attn_rule=RULE)))
    for arch, shape in TRAIN_CASES:
        if shape[0] * shape[1] == n:
            _, _, state, batches = _train_inputs(arch)
            tasks.append((f"train {arch} {shape}", "train", dict(
                arch=arch, over={}, shape=shape, state=state,
                batches=batches, lr=(LR, WARMUP, TOTAL), attn_rule=RULE)))
    return tasks


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(2, jobs.suite, (_tasks(2),),
                     tmp_path_factory.mktemp("w2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(4, jobs.suite, (_tasks(4),),
                     tmp_path_factory.mktemp("w4"))


def _ranks(request, shape):
    return request.getfixturevalue(f"world{shape[0] * shape[1]}")


def _case_id(case):
    return f"{case[0]}-{case[1][0]}x{case[1][1]}"


# ------------------------------------------------------------ forward ---

@pytest.mark.parametrize("case", FWD_CASES, ids=_case_id)
def test_split_forward_matches_unmeshed_and_jax(case, request):
    arch, shape = case
    want = _jax_logits(arch)
    splits = dense_splits(_duck(shape), ARCHS[arch].smoke(), RULE)
    ranks = _ranks(request, shape)
    for rank, r in enumerate(ranks):
        got = r[f"fwd {arch} {shape}"]
        assert got["dense"] == splits, (rank, got["dense"])
        np.testing.assert_allclose(got["meshed"], got["unmeshed"],
                                   rtol=1e-5, atol=1e-5)
        assert np.abs(got["meshed"] - want).max() < 1e-4, rank
        _hold_stream(got, ARCHS[arch].smoke(), splits, shape, 16)
    for r in ranks[1:]:  # the same whole logits on every rank
        assert np.array_equal(r[f"fwd {arch} {shape}"]["meshed"],
                              ranks[0][f"fwd {arch} {shape}"]["meshed"])
    if shape == (1, 4) and "attn" in splits:  # 2 kv heads, 4 ranks
        assert splits.pop("attn") == "q_heads_kv_whole"
    assert set(splits.values()) == {"heads"}


def _hold_stream(got, cfg, splits, shape, t):
    """The residual stream entering each block in the layout T gives,
    and the forward's collectives those :func:`_predicted` counts."""
    n = shape[1]
    chunk = t % n == 0
    b = 4 // shape[0]
    assert got["describe"]["activations"] == ("sequence" if chunk
                                              else "whole")
    assert got["stream"] == [(b, t // n if chunk else t, cfg.d_model)] * (
        len(cfg.prologue) + len(cfg.pattern) * cfg.n_groups)
    kinds = {}
    for kind, _ in got["stream_collectives"]:
        kinds[kind] = kinds.get(kind, 0) + 1
    assert kinds == _predicted(cfg, splits, n, t), kinds
    wide = [s for k, s in got["stream_collectives"] if k == "all-reduce"
            and s[-1] == cfg.d_model]
    assert not wide if chunk else wide, wide


@pytest.mark.parametrize("case", FALLBACK_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-T{c[2]}")
def test_split_forward_keeps_the_stream_whole_where_t_does_not_divide(
        case, request):
    arch, shape, t = case
    want = _jax_logits(arch, t)
    splits = dense_splits(_duck(shape), ARCHS[arch].smoke(), RULE)
    ranks = _ranks(request, shape)
    for rank, r in enumerate(ranks):
        got = r[f"fwd {arch} {shape} T{t}"]
        np.testing.assert_allclose(got["meshed"], got["unmeshed"],
                                   rtol=1e-5, atol=1e-5)
        assert np.abs(got["meshed"] - want).max() < 1e-4, rank
        _hold_stream(got, ARCHS[arch].smoke(), splits, shape, t)
        assert np.array_equal(got["meshed"], ranks[0][
            f"fwd {arch} {shape} T{t}"]["meshed"])


@pytest.mark.parametrize("case", LOSS_CASES, ids=_case_id)
def test_vocab_parallel_loss_matches_unmeshed_and_jax(case, request):
    arch, shape = case
    cfg = ARCHS[arch].smoke()
    want, jgrads = _jax_loss(arch)
    producers = ("embed" if cfg.tie_embeddings else "head", "final_norm")
    for r in _ranks(request, shape):
        got = r[f"loss {arch} {shape}"]
        assert got["describe"]["logits"] == "vocab"
        assert got["describe"]["activations"] == "sequence"
        for key in ("loss", "xent", "z_loss"):
            np.testing.assert_allclose(got["meshed"][key],
                                       got["unmeshed"][key], rtol=1e-6,
                                       atol=1e-6, err_msg=key)
            np.testing.assert_allclose(got["meshed"][key], want[key],
                                       rtol=1e-5, atol=1e-5, err_msg=key)
        for path in producers:
            np.testing.assert_allclose(got["grads"][path],
                                       got["grads_unmeshed"][path],
                                       rtol=1e-6, atol=1e-6, err_msg=path)
            np.testing.assert_allclose(got["grads"][path], jgrads[path],
                                       rtol=1e-5, atol=1e-5, err_msg=path)
        # the logits never move: no tensor with a vocabulary dim crosses
        # ranks; the loss's sums over the vocabulary are (b, T) vectors
        moved = got["collectives"]
        assert not [s for _, s in moved if cfg.vocab_size in s], moved
        assert sum(s == (4, 16) for k, s in moved if k == "all-reduce") >= 3


def _model_only(spec):
    """A spec's ``model`` entries alone (the data axes are gathered)."""
    def entry(e):
        names = (e,) if isinstance(e, str) else tuple(e or ())
        return "model" if "model" in names else None
    return tuple(entry(e) for e in spec)


@pytest.mark.parametrize("case", FWD_CASES, ids=_case_id)
def test_dense_blocks_are_this_ranks_over_model(case, request):
    """Each leaf of a split dense layer is read as this rank's block over
    ``model`` (its ``param_specs`` shape there), never gathered whole;
    every other leaf whole.  Under the q-heads rule ``wk`` / ``wv`` (and
    their biases) are whole."""
    arch, shape = case
    cfg = ARCHS[arch].smoke()
    mesh = _duck(shape)
    splits = dense_splits(mesh, cfg, RULE)
    params = init_params(cfg, device="meta")
    specs = {p: s for (p, _), s in spec_leaves(params,
                                                param_specs(mesh, params))}
    whole = {p: tuple(t.shape) for p, t in leaves_with_paths(params)}
    moe = {p.rpartition("/")[0] for p in whole if p.endswith("/router")}
    n_split = 0
    for r in _ranks(request, shape):
        got = r[f"fwd {arch} {shape}"]["local_shapes"]
        assert set(got) == set(whole)
        for path, shape_ in whole.items():
            parent, _, name = path.rpartition("/")
            if parent in moe:
                continue
            kind = parent.rpartition("/")[2] if parent else "vocab"
            split = splits.get(kind, "whole")
            kept = split != "whole" and name in SPLIT_LEAVES[kind] and not (
                split == "q_heads_kv_whole" and name not in ("wq", "bq",
                                                             "wo"))
            want = (local_shape(mesh, shape_, _model_only(specs[path]))
                    if kept else shape_)
            assert got[path] == want, (path, got[path], want)
            n_split += kept and want != shape_
    assert n_split > 0


# ------------------------------------------------------------- decode ---

@pytest.mark.parametrize("case", DECODE_CASES, ids=_case_id)
def test_split_decode_gives_the_unmeshed_tokens(case, request):
    arch, shape = case
    cfg = ARCHS[arch].smoke()
    jcfg = JAX_ARCHS[arch].smoke()
    mesh = _duck(shape)
    b = 2
    jspecs = _reference_cache_specs(mesh, jcfg, b, 32)
    whole = {p: tuple(t.shape) for p, t in leaves_with_paths(
        init_cache(cfg, b, 32, "meta"))}
    for r in _ranks(request, shape):
        got = r[f"dec {arch} {shape}"]
        assert got["dense"] == dense_splits(mesh, cfg, RULE)
        assert got["meshed"]["tokens"].shape == (DECODE_NEW + 1, b)
        assert np.array_equal(got["meshed"]["tokens"],
                              got["unmeshed"]["tokens"])
        np.testing.assert_allclose(got["meshed"]["logits"],
                                   got["unmeshed"]["logits"], rtol=1e-5,
                                   atol=1e-5)
        assert got["unmeshed"]["cache_shapes"] == whole
        q_rule = got["dense"].get("attn") == "q_heads_kv_whole"
        for path, s in got["meshed"]["cache_shapes"].items():
            if q_rule and path.rpartition("/")[2] in ("k", "v"):
                assert s == whole[path], path  # the cache stays whole
            else:
                assert s == local_shape(mesh, whole[path], jspecs[path]), \
                    (path, s)


# -------------------------------------------------------------- train ---

@pytest.mark.parametrize("case", TRAIN_CASES, ids=_case_id)
def test_split_train_step_matches_unmeshed_and_jax(case, request):
    arch, shape = case
    jcfg, jopt, jstate, batches = _train_inputs(arch)
    cfg = ARCHS[arch].smoke()
    opt = AdamW(learning_rate=warmup_cosine(LR, WARMUP, TOTAL))
    state = lm.from_jax_train_state(cfg, jstate)
    step = lm.make_train_step(cfg, opt)
    jstep = jax.jit(jlm.make_train_step(jcfg, jopt))
    jgrad = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(p, jcfg, b)[0]))
    jstate = jax.tree.map(jnp.asarray, jstate)
    ranks = [r[f"train {arch} {shape}"] for r in _ranks(request, shape)]
    mesh = _duck(shape)
    specs = param_specs(mesh, init_params(cfg, device="meta"))
    replicated = [p for (p, _), s in spec_leaves(state[0], specs)
                  if "model" not in str(s)]
    assert any(p.endswith("norm") or "ln" in p for p in replicated)
    for r in ranks[1:]:  # every rank: the same whole state, and the
        for a, b in zip(r, ranks[0]):  # replicated leaves' gradients
            for key in ("params", "mu", "nu"):
                for path in a[key]:
                    assert np.array_equal(a[key][path], b[key][path])
            for path in replicated:
                assert np.array_equal(a["grads"][path], b["grads"][path]), \
                    path
    meshed = ranks[0]
    marks_port, marks_jax = {}, {}
    for i, nb in enumerate(batches):
        got = meshed[i]
        g_mesh = unflatten(state[0], [torch.from_numpy(got["grads"][p])
                                      for p, _ in leaves_with_paths(state[0])])
        g_port = _step_grads(lambda b: _port_flat(_port_grads(
            state[0], cfg, _torch(b))[2]), state[0], nb, 1)
        g_jax = _step_grads(lambda b: _flat(jgrad(jstate[0], _jax(b))),
                            state[0], nb, 1)
        parity.mark_amplified(opt, state[1], state[0], g_mesh, g_port,
                              marks_port, 1e-5)
        parity.mark_amplified(opt, state[1], state[0], g_mesh, g_jax,
                              marks_jax, 1e-5)
        state, m = step(state, _torch(nb))
        jstate, jm = jstep(jstate, _jax(nb))
        for key in ("loss", "xent", "z_loss", "grad_norm"):
            for want in (float(m[key]), float(jm[key])):
                np.testing.assert_allclose(got["metrics"][key], want,
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"step {i} {key}")
    final = meshed[-1]
    _hold_params(final["params"], _port_flat(state[0]), marks_port)
    _hold_params(final["params"], _flat(jstate[0]), marks_jax)
    for key in ("mu", "nu"):
        _close(final[key], _port_flat(getattr(state[1], key)), key)
        _close(final[key], _flat(getattr(jstate[1], key)), key)


# -------------------------------------------------- rules, no ranks ---

@pytest.mark.parametrize("arch,shape,want", [
    # 8 kv heads divide 4: every dense layer split (the four-card run)
    ("qwen1.5-110b", (1, 4), {"attn": "heads", "mlp": "heads",
                              "vocab": "heads"}),
    # 8 kv heads, 16 ranks, under "qshard_kvrep": 4 q heads a rank in one
    # group of 8
    ("qwen1.5-110b", (16, 16), {"attn_rule": "qshard_kvrep",
                                "attn": "q_heads_kv_whole",
                                "mlp": "heads", "vocab": "heads"}),
    ("grok-1-314b", (16, 16), {"attn_rule": "qshard_kvrep",
                               "attn": "q_heads_kv_whole",
                               "vocab": "heads"}),
    # 4 kv and 8 q heads do not divide 16, the head dim of 256 does
    ("gemma3-4b", (16, 16), {"attn": "head_dim", "mlp": "heads",
                             "vocab": "heads"}),
    # a vocabulary of 504 does not divide 16
    ("hubert-xlarge", (16, 16), {"attn": "heads", "mlp": "heads",
                                 "vocab": "whole"}),
    ("zamba2-2.7b", (2, 16, 16), {"attn": "heads", "mlp": "heads",
                                  "mamba": "heads", "vocab": "heads"}),
    ("rwkv6-7b", (16, 16), {"rwkv": "heads", "vocab": "heads"}),
    # 3 ranks: 4096 / 64 = 64 RWKV heads do not divide 3
    ("rwkv6-7b", (1, 3), {"rwkv": "whole", "vocab": "whole"}),
    ("deepseek-moe-16b", (1, 1), {"attn": "heads", "vocab": "heads"}),
    # under the default rule the head dim of 128 divides 16
    ("qwen1.5-110b", (16, 16), {"attn": "head_dim", "mlp": "heads",
                                "vocab": "heads"}),
    ("grok-1-314b", (16, 16), {"attn": "head_dim", "vocab": "heads"}),
    # 120 does not divide 16: whole, or the q heads under "qshard_kvrep"
    ("h2o-danube-3-4b", (16, 16), {"attn": "whole", "mlp": "heads",
                                   "vocab": "heads"}),
    ("h2o-danube-3-4b", (16, 16), {"attn_rule": "qshard_kvrep",
                                   "attn": "q_heads_kv_whole",
                                   "mlp": "heads", "vocab": "heads"}),
])
def test_dense_split_rules(arch, shape, want):
    """``want`` names the attention rule under ``"attn_rule"`` where it
    is not the default."""
    want = dict(want)
    rule = want.pop("attn_rule", "auto")
    assert dense_splits(_duck(shape), ARCHS[arch], rule) == want
    # MeshPar reads a mesh through the same functions
    par = MeshPar(_duck(shape), ARCHS[arch], attn_rule=rule)
    assert par.describe()["dense"] == want
    assert par.describe()["attn_rule"] == rule
    assert {k: par.dense_split(k) for k in want} == want


@pytest.mark.parametrize("shape", [(16, 16), (2, 4), (1, 4), (1, 1)])
@pytest.mark.parametrize("arch", sorted(a for a in ARCHS
                                        if not ARCHS[a].is_encoder))
def test_cache_layout_follows_the_reference_where_it_splits(arch, shape):
    """The port's cache layout names ``model`` on a dim only where the
    reference's ``cache_specs`` does (its stated rule for "conv" and
    "wkv"), and on every such dim where the port's layer runs split; the
    batch dim as the reference."""
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    mesh = _duck(shape)
    caches = init_cache(cfg, 128, 4096, "meta")
    jspecs = _reference_cache_specs(mesh, jcfg, 128, 4096)
    splits = dense_splits(mesh, cfg)
    kind_of = {"k": "attn", "v": "attn", "ssm": "mamba", "conv": "mamba",
               "wkv": "rwkv"}
    got = [s for _, s in spec_leaves(caches, cache_layout(mesh, caches, cfg))]
    assert len(got) == len(jspecs)
    for (path, t), spec in zip(leaves_with_paths(caches), got):
        spec = tuple(spec) + (None,) * (t.ndim - len(spec))
        jspec = jspecs[path]
        lead = 1 if path.startswith("grp") else 0
        assert spec[lead] == jspec[lead], path
        kind = kind_of.get(path.rpartition("/")[2])
        for dim in range(t.ndim):
            if spec[dim] == "model":
                assert jspec[dim] == "model", (path, spec, jspec)
            elif jspec[dim] == "model" and kind is not None \
                    and splits.get(kind) in ("heads", "head_dim"):
                raise AssertionError(f"{path}: {spec} vs {jspec}")
