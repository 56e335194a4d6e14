"""The port's launch regions across spawned gloo ranks on the CPU, held to
the JAX package.

* ``moe_mlp_ep`` against the JAX ``moe_mlp_ep`` run under
  ``jax.vmap(..., axis_name="model")`` over a leading device axis (where
  ``all_to_all`` runs inside one process), at world sizes 1, 2 and 4, at
  capacity factors 8.0 (nothing dropped) and 0.5 (tokens dropped), with
  and without shared experts, at 1e-5.
* The reference's four parallel variants (``tests/test_parallel_variants.py``:
  TP-MoE and EP-MoE on ``deepseek-moe-16b.smoke()`` at capacity factor
  8.0 on a (2, 2) mesh, Ulysses on ``hubert-xlarge.smoke()`` at (2, 2),
  Ulysses-GQA on ``h2o-danube-3-4b.smoke()`` at (1, 4), where H 4, kv 2
  and model 4 take the kv-slice branch) held at 1e-4 (max abs) to JAX's
  unmeshed ``forward`` on the same weights (``from_jax_params``), and
  at 1e-5 to the port's unmeshed forward.  The JAX meshed paths
  themselves fail on the installed JAX, so the unmeshed function is the
  reference.
* The regions' backward at (1, 2): the loss's gradients through TP-MoE,
  EP-MoE and Ulysses equal the unmeshed gradients at 1e-5.

World 1 runs in this process; worlds of 2 and 4 are spawned once each
(``tests/torch_worlds.py``: a ``FileStore`` under the test's temporary
directory, a join timeout that kills a hung rank).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_launch_jobs as jobs
from repro.configs.lm_archs import ARCHS as JAX_ARCHS
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.moe import moe_mlp_ep as jax_moe_mlp_ep
from repro.models.stack import DEFAULT_PAR
from repro_torch.configs.lm_archs import ARCHS
from torch_worlds import run_world

E, D, F, S, TOP_K = 8, 16, 8, 12, 2
CAPACITY = (8.0, 0.5)
EXPERT_KEYS = ("wg", "wu", "wd")


def _moe_params(shared: bool, seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) * shape[-2] ** -0.5).astype(np.float32)
    p = {"router": w(D, E), "wg": w(E, D, F), "wu": w(E, D, F),
         "wd": w(E, F, D)}
    if shared:
        p.update(shared_wg=w(D, 2 * F), shared_wu=w(D, 2 * F),
                 shared_wd=w(2 * F, D))
    return p


def _tokens(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n, S, D)).astype(
        np.float32)


def _moe_cases(n):
    return [(f"moe {cf} {shared}", "moe_ep",
             dict(x=_tokens(n), p=_moe_params(shared), top_k=TOP_K,
                  capacity_factor=cf))
            for cf in CAPACITY for shared in (False, True)]


def _jax_moe_ep(n, p, x, cf):
    e_loc = E // n
    ps = {k: (jnp.asarray(v).reshape(n, e_loc, *v.shape[1:])
              if k in EXPERT_KEYS else jnp.asarray(v)) for k, v in p.items()}
    axes = {k: (0 if k in EXPERT_KEYS else None) for k in p}
    f = jax.vmap(lambda xx, pp: jax_moe_mlp_ep(
        xx, pp, top_k=TOP_K, n_devices=n, axis_name="model",
        capacity_factor=cf), in_axes=(0, axes), axis_name="model")
    return np.asarray(f(jnp.asarray(x), ps))


# ------------------------------------------------------- the variants ---

VARIANT_KEYS = ("tp-moe", "ep-moe", "ulysses", "ulysses-gqa")


@functools.lru_cache(maxsize=None)
def _variant_inputs():
    """(key, arch, overrides, mesh, moe, ulysses, JAX params, batch)."""
    ds = dict(capacity_factor=8.0)
    jds = dataclasses.replace(JAX_ARCHS["deepseek-moe-16b"].smoke(), **ds)
    p_ds = jax.tree.map(np.asarray, jax_init_params(jds, jax.random.PRNGKey(0)))
    b_ds = {"tokens": (np.arange(4 * 16).reshape(4, 16)
                       % jds.vocab_size).astype(np.int32)}
    jhu = JAX_ARCHS["hubert-xlarge"].smoke()
    p_hu = jax.tree.map(np.asarray, jax_init_params(jhu, jax.random.PRNGKey(1)))
    b_hu = {"embeds": np.asarray(jax.random.normal(
        jax.random.PRNGKey(2), (2, 16, jhu.d_model)), np.float32)}
    jh2 = JAX_ARCHS["h2o-danube-3-4b"].smoke()
    p_h2 = jax.tree.map(np.asarray, jax_init_params(jh2, jax.random.PRNGKey(3)))
    b_h2 = {"tokens": (np.arange(2 * 16).reshape(2, 16)
                       % jh2.vocab_size).astype(np.int32)}
    return [
        ("tp-moe", "deepseek-moe-16b", ds, (2, 2), "tp", False, p_ds, b_ds),
        ("ep-moe", "deepseek-moe-16b", ds, (2, 2), "ep", False, p_ds, b_ds),
        ("ulysses", "hubert-xlarge", {}, (2, 2), "tp", True, p_hu, b_hu),
        ("ulysses-gqa", "h2o-danube-3-4b", {}, (1, 4), "tp", True, p_h2,
         b_h2),
    ]


def _grad_cases():
    def labelled(b):
        n, t = next(iter(b.values())).shape[:2]
        return dict(b, labels=np.random.default_rng(4).integers(
            0, 256, (n, t)).astype(np.int32))  # the smoke vocabulary
    return [(f"grads {key}", "region_grads",
             dict(arch=arch, over=over, shape=(1, 2), moe=moe,
                  ulysses=uly, params=p, batch=labelled(b)))
            for key, arch, over, _, moe, uly, p, b in _variant_inputs()[:3]]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tasks = _moe_cases(2) + _grad_cases()
    return run_world(2, jobs.suite, (tasks,), tmp_path_factory.mktemp("w2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tasks = _moe_cases(4) + [
        (key, "variant", dict(arch=arch, over=over, shape=shape, moe=moe,
                              ulysses=uly, params=p, batch=b))
        for key, arch, over, shape, moe, uly, p, b in _variant_inputs()]
    return run_world(4, jobs.suite, (tasks,), tmp_path_factory.mktemp("w4"))


@pytest.fixture(scope="module")
def world1():
    """World 1 in this process: a one-rank gloo group for its life."""
    return [jobs.suite(0, _moe_cases(1))]


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("shared", [False, True])
def test_moe_mlp_ep_matches_jax_under_vmap(world, cf, shared, request):
    ranks = request.getfixturevalue(f"world{world}")
    want = _jax_moe_ep(world, _moe_params(shared), _tokens(world), cf)
    got = np.stack([r[f"moe {cf} {shared}"] for r in ranks])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if cf == 0.5:  # C = 1 a rank: the slots past it are dropped
        assert int(S * TOP_K / E * cf) < S * TOP_K / E


@pytest.mark.parametrize("key", VARIANT_KEYS)
def test_parallel_variant_matches_the_unmeshed_forward(key, world4):
    _, arch, over, shape, moe, uly, p, b = next(
        v for v in _variant_inputs() if v[0] == key)
    jcfg = dataclasses.replace(JAX_ARCHS[arch].smoke(), **over)
    want, _ = jax.jit(lambda pp, bb: jax_forward(pp, jcfg, bb, DEFAULT_PAR))(
        p, {k: jnp.asarray(v) for k, v in b.items()})
    want = np.asarray(want)
    for rank, r in enumerate(world4):
        got = r[key]
        assert np.abs(got["meshed"] - want).max() < 1e-4, (key, rank)
        np.testing.assert_allclose(got["meshed"], got["unmeshed"],
                                   rtol=1e-5, atol=1e-5)
        kinds = got["collectives"]["count_by_kind"]
        # T = 16 divides model: the TP-MoE's sum leaves reduce-scattered
        # over T (sequence parallelism)
        region = {"tp-moe": "reduce-scatter", "ep-moe": "all-to-all",
                  "ulysses": "all-to-all", "ulysses-gqa": "all-gather"}[key]
        assert kinds.get(region, 0) > 0, (key, kinds)
    # the same whole logits on every rank
    for r in world4[1:]:
        assert np.array_equal(r[key]["meshed"], world4[0][key]["meshed"])


@pytest.mark.parametrize("key", VARIANT_KEYS[:2])
def test_moe_region_reads_its_blocks_of_the_experts(key, world4):
    """The expert weights whose ``model`` split is the region's stay this
    rank's blocks (gathered over ``data`` only); the others whole."""
    _, arch, over, shape, moe, _, _, _ = next(
        v for v in _variant_inputs() if v[0] == key)
    cfg = dataclasses.replace(ARCHS[arch].smoke(), **over)
    n = shape[1]
    fe = cfg.moe_d_ff or cfg.d_ff
    fs = fe * cfg.n_shared_experts
    e, d = cfg.n_experts, cfg.d_model
    if moe == "tp":
        want = {"wg": (e, d, fe // n), "wu": (e, d, fe // n),
                "wd": (e, fe // n, d), "shared_wg": (d, fs // n),
                "shared_wu": (d, fs // n), "shared_wd": (fs // n, d)}
    else:
        want = {"wg": (e // n, d, fe), "wu": (e // n, d, fe),
                "wd": (e // n, fe, d), "shared_wg": (d, fs),
                "shared_wu": (d, fs), "shared_wd": (fs, d)}
    want["router"] = (d, e)
    for r in world4:
        shapes = r[key]["local_shapes"]
        moe_dicts = {p.rpartition("/")[0] for p in shapes
                     if p.endswith("/router")}
        got = {}
        for path, s in shapes.items():
            parent, _, name = path.rpartition("/")
            if parent in moe_dicts:  # every MoE layer's, group dims cut
                got.setdefault(name, set()).add(s[-len(want[name]):])
        assert moe_dicts and got == {k: {v} for k, v in want.items()}, got


@pytest.mark.parametrize("key", VARIANT_KEYS[:3])
def test_region_gradients_match_the_unmeshed_ones(key, world2):
    for r in world2:
        got = r[f"grads {key}"]
        assert set(got["meshed"]) == set(got["unmeshed"])
        for path, want in got["unmeshed"].items():
            np.testing.assert_allclose(got["meshed"][path], want, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{key} {path}")


def test_gather_and_reduce_scatter_are_each_others_transpose(world1):
    """On one rank the wrappers keep their values and their backward."""
    from repro_torch.launch.collectives import Collectives
    coll = Collectives(jobs.mesh((1, 1)))
    x = torch.randn(3, 4, requires_grad=True)
    y = coll.reduce_scatter(coll.all_gather(x, "model", 1), "model", 1)
    assert torch.equal(y, x)
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert coll.count_by_kind == {"all-gather": 2, "reduce-scatter": 2}
