"""The port's meshed training, int8 gradient compression, elastic restore
and meshed LM sessions on the CPU, held to the JAX package and to the
port's unmeshed paths.

* The meshed train step on a (2, 1) mesh (two spawned gloo ranks, the
  batch split over ``data``), two steps with ``grad_accum`` 1 and 2 from
  one carried JAX train state, without a mask and with one spread
  unevenly over the ranks (a microbatch whose rows on one rank are all
  masked out): loss, grad norm and moments at
  ``tests/test_torch_train_lm.py``'s tolerance (rtol 1e-4 / atol 1e-5)
  and the parameters held by ``optim.parity.hold_params`` (elements
  whose update Adam amplifies held to its step bound), against the
  port's unmeshed step and against JAX's unmeshed ``make_train_step``.
* ``compress_allreduce``: with ``group=None`` bit for bit against JAX's
  ``axis_name=None`` (a zero leaf takes the scale-1 path); over 2 and 4
  spawned ranks against JAX's under ``jax.vmap(axis_name="pod")``, three
  steps of error feedback: residuals bit for bit, means at rtol 1e-6;
  and the error-feedback case of ``tests/test_compress.py``.
* ``restore(shardings=)``: parameters saved from a (2, 1) mesh restore
  onto (1, 1) in this process and onto (2, 2) over four ranks, every
  whole value bit for bit and each rank's blocks of the spec's shapes; a
  JAX-written checkpoint restores onto (1, 1).
* ``LMSession`` with ``mesh_shape=(1, 1)`` gives the unmeshed session's
  tokens and logits exactly; (8, 8) falls back with a
  ``RuntimeWarning``; ``to_dict`` keeps the mesh shape.

Worlds of 2 and 4 ranks are spawned once each (``tests/torch_worlds.py``);
world 1 runs in this process.
"""
import dataclasses
import functools
import json
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_launch_jobs as jobs
from repro.checkpoint.checkpoint import save as jax_save
from repro.configs.lm_archs import ARCHS as JAX_ARCHS
from repro.models import init_params as jax_init_params
from repro.models import lm as jlm
from repro.optim import AdamW as JaxAdamW
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.optim.compress import compress_allreduce as jax_compress
from repro_torch.checkpoint import restore
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.core.tree import leaves_with_paths, unflatten
from repro_torch.engine import LMConfig, LMSession, SessionConfig
from repro_torch.launch.sharding import (MeshPar, local_shape, param_specs,
                                         spec_leaves, spec_of, to_named)
from repro_torch.models import lm
from repro_torch.models.stack import init_params
from repro_torch.optim import AdamW, parity, warmup_cosine
from repro_torch.optim.compress import (compress_allreduce, dequantize_int8,
                                        quantize_int8, wire_bytes_saved)
from test_torch_lm_model import perturbed_jax_params
from test_torch_train_lm import (LR, TOTAL, WARMUP, _batch, _close, _flat,
                                 _hold_params, _jax, _port_flat, _port_grads,
                                 _torch)
from torch_worlds import run_world

TRAIN_ARCH, TRAIN_STEPS, TRAIN_B = "deepseek-moe-16b", 2, 4
ACCUM = (1, 2)
MASKS = ("none", "uneven")
# valid positions of each of the TRAIN_B rows under the "uneven" mask:
# rank 0 holds rows 0-1 and rank 1 rows 2-3 at grad_accum 1; at 2 the
# first microbatch's rank-1 row (row 1) is all masked out
MASK_ROWS = (16, 0, 3, 9)
CKPT_ARCH, CKPT_SEED = "deepseek-moe-16b", 7
COMPRESS_STEPS = 3


@functools.lru_cache(maxsize=None)
def _train_inputs(k, mask="none"):
    jcfg = dataclasses.replace(JAX_ARCHS[TRAIN_ARCH].smoke(), grad_accum=k)
    params = perturbed_jax_params(jcfg)
    jopt = JaxAdamW(learning_rate=jax_warmup_cosine(LR, WARMUP, TOTAL))
    state = jax.tree.map(np.asarray, (params, jopt.init(params),
                                      jnp.int32(0)))
    cfg = ARCHS[TRAIN_ARCH].smoke()
    batches = [_batch(cfg, 30 + i, b=TRAIN_B) for i in range(TRAIN_STEPS)]
    if mask == "uneven":
        valid = (np.arange(16)[None] < np.array(MASK_ROWS)[:, None])
        batches = [dict(b, mask=valid.astype(np.float32)) for b in batches]
    return jcfg, jopt, state, batches


def _compress_grads(n, seed=5):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(COMPRESS_STEPS, n, 32)).astype(np.float32),
            "m": (rng.normal(size=(COMPRESS_STEPS, n, 4, 3)) * 1e-3
                  ).astype(np.float32),
            "z": np.zeros((COMPRESS_STEPS, n, 8), np.float32)}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("elastic"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory, ckpt_dir):
    tasks = [(f"train {k} {m}", "train", dict(
        arch=TRAIN_ARCH, over=dict(grad_accum=k), shape=(2, 1),
        state=_train_inputs(k)[2], batches=_train_inputs(k, m)[3],
        lr=(LR, WARMUP, TOTAL))) for k in ACCUM for m in MASKS]  # (cached)
    tasks += [("compress", "compress", dict(grads=_compress_grads(2),
                                            steps=COMPRESS_STEPS)),
              ("save", "save_state", dict(arch=CKPT_ARCH, shape=(2, 1),
                                          seed=CKPT_SEED,
                                          ckpt_dir=ckpt_dir))]
    return run_world(2, jobs.suite, (tasks,), tmp_path_factory.mktemp("w2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory, ckpt_dir, world2):
    tasks = [("compress", "compress", dict(grads=_compress_grads(4),
                                           steps=COMPRESS_STEPS)),
             ("restore", "restore_state", dict(arch=CKPT_ARCH, shape=(2, 2),
                                               ckpt_dir=ckpt_dir))]
    return run_world(4, jobs.suite, (tasks,), tmp_path_factory.mktemp("w4"))


# ------------------------------------------------------- train step -----

def _step_grads(grads_of, params, nb, k):
    """The gradients a step of ``grad_accum`` k takes from the numpy
    batch ``nb``: the mean of its microbatches' (``grads_of``: numpy
    batch -> path -> array), a tree of ``params``' structure.  With an
    uneven mask it is not the whole batch's gradient."""
    parts = [grads_of(micro) for micro in lm._split(nb, k)]
    return unflatten(params, [
        torch.from_numpy(sum(np.asarray(g[p], np.float32) for g in parts) / k)
        for p, _ in leaves_with_paths(params)])


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("k", ACCUM)
def test_meshed_train_step_matches_unmeshed_and_jax(k, mask, world2):
    jcfg, jopt, jstate, batches = _train_inputs(k, mask)
    cfg = dataclasses.replace(ARCHS[TRAIN_ARCH].smoke(), grad_accum=k)
    opt = AdamW(learning_rate=warmup_cosine(LR, WARMUP, TOTAL))
    state = lm.from_jax_train_state(cfg, jstate)
    step = lm.make_train_step(cfg, opt)
    jstep = jax.jit(jlm.make_train_step(jcfg, jopt))
    jgrad = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(p, jcfg, b)[0]))
    jstate = jax.tree.map(jnp.asarray, jstate)
    meshed = world2[0][f"train {k} {mask}"]
    for r in world2[1:]:  # every rank holds the same whole state
        for a, b in zip(r[f"train {k} {mask}"], meshed):
            for key in ("params", "mu", "nu"):
                for path in a[key]:
                    assert np.array_equal(a[key][path], b[key][path])
    marks_port, marks_jax = {}, {}
    for i, nb in enumerate(batches):
        got = meshed[i]
        g_mesh = unflatten(state[0], [torch.from_numpy(got["grads"][p])
                                      for p, _ in leaves_with_paths(state[0])])
        g_port = _step_grads(lambda b: _port_flat(_port_grads(
            state[0], cfg, _torch(b))[2]), state[0], nb, k)
        g_jax = _step_grads(lambda b: _flat(jgrad(jstate[0], _jax(b))),
                            state[0], nb, k)
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


# ------------------------------------------------------- compression ----

def _jax_compress_steps(grads, n):
    f0 = jax.vmap(lambda g: jax_compress(g, axis_name="pod"),
                  axis_name="pod")
    f = jax.vmap(lambda g, r: jax_compress(g, r, axis_name="pod"),
                 axis_name="pod")
    out, residual = [], None
    for i in range(COMPRESS_STEPS):
        g = {k: jnp.asarray(v[i]) for k, v in grads.items()}
        mean, residual = f0(g) if residual is None else f(g, residual)
        out.append((jax.tree.map(np.asarray, mean),
                    jax.tree.map(np.asarray, residual)))
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_compress_allreduce_matches_jax_over_ranks(n, request):
    ranks = request.getfixturevalue(f"world{n}")
    want = _jax_compress_steps(_compress_grads(n), n)
    for i, (w_mean, w_res) in enumerate(want):
        for rank, r in enumerate(ranks):
            got = r["compress"][i]
            for key in w_mean:
                assert np.array_equal(got["residual"][key], w_res[key][rank]), \
                    (i, rank, key)
                np.testing.assert_allclose(got["mean"][key],
                                           w_mean[key][rank], rtol=1e-6,
                                           atol=0)
    assert not np.any(want[0][0]["z"])  # the zero leaf: scale 1, zeros


def test_compress_round_trip_is_bit_equal_to_jax():
    rng = np.random.default_rng(6)
    g = {"a": rng.normal(size=(64,)).astype(np.float32) * 300,
         "b": rng.normal(size=(3, 5)).astype(np.float32) * 1e-4,
         "zero": np.zeros((7,), np.float32),
         "halves": np.array([0.5, 1.5, 2.5, -0.5, 127.0], np.float32)}
    out, res = compress_allreduce({k: torch.from_numpy(v)
                                   for k, v in g.items()})
    jout, jres = jax_compress({k: jnp.asarray(v) for k, v in g.items()})
    for k in g:
        assert np.array_equal(out[k].numpy(), np.asarray(jout[k])), k
        assert np.array_equal(res[k].numpy(), np.asarray(jres[k])), k
    q, s = quantize_int8(torch.zeros(4))
    assert float(s) == 1.0 and not q.any()
    assert torch.equal(dequantize_int8(q, s), torch.zeros(4))
    assert wire_bytes_saved({"a": torch.zeros(10), "b": torch.zeros(2, 3)}) \
        == 16 * 3


def test_error_feedback_converges():
    """With error feedback the running sum of the compressed gradients
    tracks the true sum (``tests/test_compress.py``'s case)."""
    rng = np.random.default_rng(0)
    true_sum, comp_sum, residual = torch.zeros(32), torch.zeros(32), None
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.normal(0, 1, (32,)).astype(
            np.float32))}
        out, residual = compress_allreduce(g, residual)
        true_sum += g["w"]
        comp_sum += out["w"]
    assert float((true_sum - comp_sum).abs().max()) < 0.1


# ---------------------------------------------------------- restore -----

def _saved_params():
    cfg = ARCHS[CKPT_ARCH].smoke()
    return cfg, {"params": init_params(cfg, torch.Generator().manual_seed(
        CKPT_SEED))}


def test_restore_onto_one_rank_and_four(world2, world4, ckpt_dir):
    cfg, saved = _saved_params()
    want = {k: v.numpy() for k, v in leaves_with_paths(saved)}
    mesh1 = jobs.mesh((1, 1))
    like = {"params": init_params(cfg, device="meta")}
    got1 = restore(ckpt_dir, 1, like, shardings={"params": to_named(
        mesh1, MeshPar(mesh1, cfg).param_specs(like["params"]),
        like["params"])})
    for k, v in leaves_with_paths(got1):
        assert np.array_equal(v.full_tensor().numpy(), want[k]), k
    names = ("data", "model")
    mesh4 = SimpleNamespace(axis_names=names, shape=dict(zip(names, (2, 2))))
    spec_of = {path: spec for (path, _), spec in spec_leaves(
        like, {"params": param_specs(mesh4, like["params"])})}
    for r in world4:
        got = r["restore"]
        for k in want:
            assert np.array_equal(got["whole"][k], want[k]), k
            assert got["local_shapes"][k] == local_shape(
                mesh4, want[k].shape, spec_of[k]), k


def test_a_jax_checkpoint_restores_onto_a_mesh(tmp_path):
    jcfg = JAX_ARCHS["gemma3-4b"].smoke()
    params = jax_init_params(jcfg, jax.random.PRNGKey(3))
    jax_save(str(tmp_path), 5, params)
    cfg = ARCHS["gemma3-4b"].smoke()
    mesh1 = jobs.mesh((1, 1))
    like = init_params(cfg, device="meta")
    got = restore(str(tmp_path), 5, like, shardings=to_named(
        mesh1, MeshPar(mesh1, cfg).param_specs(like), like))
    want = _flat(params)
    for k, v in leaves_with_paths(got):
        assert type(v).__name__ == "DTensor"
        assert np.array_equal(v.full_tensor().numpy(), want[k]), k


# ---------------------------------------------------------- sessions ----

@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-moe-16b"])
@pytest.mark.parametrize("moe", ["tp", "ep"])
def test_one_by_one_mesh_session_equals_unmeshed(arch, moe):
    jobs.mesh((1, 1))  # this process's one-rank group
    lmc = dict(arch=arch, max_context=32, decode_batch=2)
    plain = LMSession(config=SessionConfig(backend="cuda-lm", device="cpu",
                                           lm=LMConfig(**lmc)))
    meshed = LMSession(config=SessionConfig(
        backend="cuda-lm", device="cpu", lm=LMConfig(mesh_shape=(1, 1),
                                                     **lmc)),
        params=plain.backend.params, moe=moe)
    prompts = np.random.default_rng(8).integers(0, 256, (2, 12)).astype(
        np.int32)
    assert np.array_equal(meshed.generate(prompts, 6),
                          plain.generate(prompts, 6))
    assert np.array_equal(meshed.prefill(prompts)[0], plain.prefill(prompts)[0])
    assert np.array_equal(meshed.predict(prompts), plain.predict(prompts))
    assert meshed.info["mesh"] == {"data": 1, "model": 1}
    assert plain.info["mesh"] is None


def test_an_unsatisfiable_mesh_falls_back_with_a_warning():
    jobs.mesh((1, 1))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sess = LMSession(config=SessionConfig(
            backend="cuda-lm", device="cpu",
            lm=LMConfig(max_context=16, mesh_shape=(8, 8))))
    assert any(issubclass(w.category, RuntimeWarning)
               and "falling back to single-device" in str(w.message)
               for w in caught)
    assert sess.mesh is None and sess.info["mesh"] is None


def test_mesh_shape_round_trips_and_validates():
    cfg = SessionConfig(backend="cuda-lm", device="cpu", lm=LMConfig(
        arch="gemma3-4b", max_context=64, decode_batch=2, mesh_shape=[1, 1]))
    assert cfg.lm.mesh_shape == (1, 1)
    d = json.loads(json.dumps(cfg.to_dict()))
    assert d["lm"]["mesh_shape"] == [1, 1]
    assert SessionConfig(**d) == cfg
    with pytest.raises(ValueError, match="mesh_shape"):
        LMConfig(mesh_shape=(0, 2))


# ------------------------------------------------------------ specs -----

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_are_placed_and_outputs_follow(kind):
    """``input_specs`` builds the step's arguments as DTensors on
    ``meta`` (no memory) placed by the rules, and ``output_shardings``
    names where the step's outputs lie: the train state as its input,
    metrics and logits whole, the caches in the port's layout."""
    from repro_torch.launch.specs import (cache_layout, input_specs,
                                          output_shardings)
    from repro_torch.models.stack import init_cache
    mesh = jobs.mesh((1, 1))
    cfg = ARCHS["deepseek-moe-16b"].smoke()
    par = MeshPar(mesh, cfg, moe="ep")
    args = input_specs(cfg, mesh, kind, 4, 16, par=par)
    params = args[0][0] if kind == "train" else args[0]
    pairs = [(pm, _trim(s)) for pm, s in spec_leaves(
        init_params(cfg, device="meta"),
        par.param_specs(init_params(cfg, device="meta")))]
    for ((path, meta), spec), (_, p) in zip(pairs, leaves_with_paths(params)):
        assert p.device.type == "meta" and p.shape == meta.shape, path
        assert type(p).__name__ == "DTensor"
        assert spec_of(mesh, p) == spec, path
    out = output_shardings(cfg, mesh, kind, args)
    if kind == "train":
        state_sh, metrics = out
        assert all(v.spec == () for v in metrics.values())
        got = [sh.spec for _, sh in spec_leaves(args[0], state_sh)]
        assert got[:len(pairs)] == [s for _, s in pairs]
    else:
        logits, caches, pos = out
        assert logits.spec == () and pos.spec == ()
        want = cache_layout(mesh, init_cache(cfg, 4, 16, "meta"), cfg)
        assert [_trim(sh.spec) for _, sh in spec_leaves(
            init_cache(cfg, 4, 16, "meta"), caches)] == [
            _trim(s) for _, s in spec_leaves(init_cache(cfg, 4, 16, "meta"),
                                             want)]


def _trim(spec):
    """A spec without its trailing whole dims (the same placement)."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)
