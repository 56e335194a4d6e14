"""The port's LM training (``loss_fn``, ``make_train_step``,
``make_eval_step``, the remat and chunked-scan paths under autograd)
against the JAX package's on the CPU, for every ``.smoke()`` arch the
port supports.

Weights are the JAX ``init_params`` tree plus numpy noise, carried
across with ``from_jax_params`` / ``from_jax_train_state``; batches come
from numpy seeds; both sides run in fp32 through their training policy
(``flash_jax`` + ``chunked``).  Tolerances: loss and grads rtol 1e-4 /
atol 1e-5; three train steps: loss, ``grad_norm`` and both AdamW moments
at rtol 1e-4 / atol 1e-5 in every element, and the parameters too,
except where Adam's step ``m / (sqrt(v) + eps)`` amplifies the two
packages' gradient difference (a gradient near ``eps``, or cancelled to
its rounding level) into a parameter move of more than a tenth of the
atol (``repro_torch.optim.parity``): there the parameter is held to the
bound of Adam's steps instead, and such elements must stay under one in
a thousand.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lm_archs import ARCHS as JAX_ARCHS
from repro.models import lm as jlm
from repro.optim import AdamW as JaxAdamW
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.core.tree import leaves, leaves_with_paths, unflatten
from repro_torch.engine import LMConfig, LMSession, SessionConfig
from repro_torch.models import lm, ssm
from repro_torch.models.stack import init_params
from repro_torch.optim import AdamW, parity, warmup_cosine
from test_torch_lm_model import COVERED, perturbed_jax_params

LR, WARMUP, TOTAL = 1e-3, 2, 10


def _batch(cfg, seed, t=16, b=2):
    """numpy batch: tokens or embeds, labels, and positions3 for M-RoPE."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, t)).astype(
            np.int32)
    else:
        out["embeds"] = rng.normal(size=(b, t, cfg.d_model)).astype(
            np.float32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    if cfg.mrope_sections is not None:
        out["positions3"] = (np.arange(t, dtype=np.int32)[None, None]
                             + rng.integers(0, 3, (3, b, 1)).astype(np.int32))
    return out


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _flat(tree):
    """A JAX tree as {path: numpy}, with the JAX checkpoint's keys."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", getattr(
        p, "name", p)))) for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree):
    return {k: v.detach().numpy() for k, v in leaves_with_paths(tree)}


def _port_grads(params, cfg, batch):
    live = [p.detach().requires_grad_() for p in leaves(params)]
    loss, aux = lm.loss_fn(unflatten(params, live), cfg, batch)
    grads = torch.autograd.grad(loss, live)
    return loss, aux, unflatten(params, list(grads))


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("arch", COVERED)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg = JAX_ARCHS[arch].smoke(), ARCHS[arch].smoke()
    params = perturbed_jax_params(jcfg)
    nb = _batch(cfg, 2)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(params, _jax(nb))
    loss, aux, g = _port_grads(lm.from_jax_params(cfg, params), cfg,
                               _torch(nb))
    for a, b in ((loss, jloss), (aux["xent"], jaux["xent"]),
                 (aux["z_loss"], jaux["z_loss"])):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-4,
                                   atol=1e-5)
    _close(_port_flat(g), _flat(jg), f"{arch} grads")
    ev = lm.make_eval_step(cfg)(lm.from_jax_params(cfg, params), _torch(nb))
    assert float(ev["loss"]) == float(loss.detach())


def _train_three_steps(arch, **over):
    """Three steps on each side from one carried state; returns both
    sides' final states and the elements where Adam amplified the two
    packages' gradient difference (``optim.parity``) at some step."""
    jcfg = replace(JAX_ARCHS[arch].smoke(), **over)
    cfg = replace(ARCHS[arch].smoke(), **over)
    t = 80 if "R" in cfg.pattern else 16  # > one 64-step chunk of the scan
    params = perturbed_jax_params(jcfg)
    jopt = JaxAdamW(learning_rate=jax_warmup_cosine(LR, WARMUP, TOTAL))
    opt = AdamW(learning_rate=warmup_cosine(LR, WARMUP, TOTAL))
    jstate = (params, jopt.init(params), jnp.int32(0))
    state = lm.from_jax_train_state(cfg, jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(jlm.make_train_step(jcfg, jopt))
    jgrad = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(p, jcfg, b)[0]))
    step = lm.make_train_step(cfg, opt)
    marks = {}
    for i in range(3):
        nb = _batch(cfg, 10 + i, t=t)
        # where Adam turns the gradients' rounding into a parameter move
        gj = _flat(jgrad(jstate[0], _jax(nb)))
        gt = _port_grads(state[0], cfg, _torch(nb))[2]
        parity.mark_amplified(opt, state[1], state[0], gt, unflatten(
            state[0], [torch.from_numpy(np.array(gj[k]))
                       for k, _ in leaves_with_paths(state[0])]), marks,
            1e-5)
        jstate, jm = jstep(jstate, _jax(nb))
        state, m = step(state, _torch(nb))
        for key in ("loss", "xent", "z_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i} {key}")
    assert int(state[2]) == int(jstate[2]) == 3
    assert int(state[1].step) == int(jstate[1].step) == 3
    return state, jstate, marks


def _hold_params(got, want, marks):
    """rtol 1e-4 / atol 1e-5 except where Adam amplified the gradients'
    rounding; there within the drift Adam's steps allow (|p| < 1 here),
    on under one element in a thousand."""
    lr_sum = 2.5 * LR  # the schedule's first three rates sum to less
    parity.hold_params(got, want, marks, parity.adam_step_bound(
        lr_sum, 0.1, 1.0), 1e-4, 1e-5)


@pytest.mark.parametrize("arch", COVERED)
def test_three_train_steps_match_jax(arch):
    state, jstate, marks = _train_three_steps(arch)
    _hold_params(_port_flat(state[0]), _flat(jstate[0]), marks)
    _close(_port_flat(state[1].mu), _flat(jstate[1].mu), "mu")
    _close(_port_flat(state[1].nu), _flat(jstate[1].nu), "nu")


@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen2-vl-72b",
                                  "deepseek-moe-16b", "zamba2-2.7b"])
def test_grad_accum_steps_match_jax(arch):
    """``grad_accum=2``: two microbatches per step (``positions3`` split
    on its batch dim for qwen2-vl; each microbatch routed on its own
    tokens for deepseek-moe): loss, grad norm, moments and
    parameters as in the single-batch steps (the amplified elements
    found from the full batch's gradients)."""
    state, jstate, marks = _train_three_steps(arch, grad_accum=2)
    _hold_params(_port_flat(state[0]), _flat(jstate[0]), marks)
    _close(_port_flat(state[1].mu), _flat(jstate[1].mu), "mu")
    _close(_port_flat(state[1].nu), _flat(jstate[1].nu), "nu")


@pytest.mark.parametrize("arch", ["gemma3-4b", "rwkv6-7b", "zamba2-2.7b",
                                  "deepseek-moe-16b"])
def test_remat_full_gives_the_same_grads(arch):
    """Checkpointed blocks recompute the same forward: the grads equal
    those without remat to 1e-6 (gemma3: local and global attention;
    rwkv6: the chunked scan; zamba2: Mamba2 and the shared block's
    weights, checkpointed at each of their uses; deepseek-moe: the
    routing replayed)."""
    cfg = ARCHS[arch].smoke()
    params = lm.from_jax_params(cfg, perturbed_jax_params(
        JAX_ARCHS[arch].smoke()))
    nb = _torch(_batch(cfg, 5, t=80))
    got = _port_flat(_port_grads(params, replace(cfg, remat="full"), nb)[2])
    want = _port_flat(_port_grads(params, cfg, nb)[2])
    _close(got, want, "remat", rtol=1e-6, atol=1e-6)


def test_chunked_scan_under_grad_is_the_step_loop():
    """Under autograd the chunked scan runs checkpointed chunks: the
    output and state equal the plain loop's bit for bit, and the grads
    equal one unchunked loop's to 1e-6."""
    cfg = ARCHS["rwkv6-7b"].smoke()
    p = init_params(cfg, torch.Generator().manual_seed(0))["groups"][0]
    p = {k: v[0] for k, v in p["rwkv"].items()}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 130, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want, s_want, _ = ssm.rwkv6_time_mix(x, p, head_dim=16,
                                             scan="chunked")
    xs = [x.clone().requires_grad_() for _ in range(2)]
    outs = [ssm.rwkv6_time_mix(xi, p, head_dim=16, scan="chunked",
                               chunk=c) for xi, c in zip(xs, (64, 130))]
    assert torch.equal(outs[0][0], want) and torch.equal(outs[0][1], s_want)
    for (o, s, _), xi in zip(outs, xs):
        (o.square().sum() + s.sum()).backward()
    np.testing.assert_allclose(xs[0].grad.numpy(), xs[1].grad.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_train_step_updates_in_place_and_counts():
    cfg = ARCHS["gemma3-4b"].smoke()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    wq = params["groups"][0]["attn"]["wq"]
    view = wq[0]
    before = view.clone()
    opt = AdamW()
    step = lm.make_train_step(cfg, opt)
    (p2, st, n), m = step((params, opt.init(params),
                           torch.zeros((), dtype=torch.int32)),
                          _torch(_batch(cfg, 1)))
    assert p2 is params and p2["groups"][0]["attn"]["wq"] is wq
    assert not torch.equal(view, before) and not wq.requires_grad
    assert int(n) == 1 and int(st.step) == 1
    assert set(m) == {"loss", "xent", "z_loss", "grad_norm"}
    assert lm.active_param_count(cfg) == lm.param_count(cfg)


def test_flash_jax_session_serves_the_kernel_policys_tokens():
    """``LMConfig(attn_variant="flash_jax")`` now builds: on the CPU its
    greedy tokens equal the default policy's."""
    lm_cfg = dict(arch="gemma3-4b", max_context=64, decode_batch=2)
    toks = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(
        np.int32)
    outs = []
    for variant in ("flash_jax", None):
        sess = LMSession(config=SessionConfig(
            backend="cuda-lm", device="cpu",
            lm=LMConfig(attn_variant=variant, block_q=16, **lm_cfg)))
        outs.append(sess.generate(toks, 6))
    assert sess.kernel_policy.attention == "flash_pallas"
    np.testing.assert_array_equal(outs[0], outs[1])
