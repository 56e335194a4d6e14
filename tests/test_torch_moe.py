"""The port's mixture-of-experts MLP (``repro_torch.models.moe``) against
the JAX package's ``repro.models.moe`` on the same inputs and weights.

Inputs and weights come from numpy seeds; both sides run in fp32 on the
CPU.  ``moe_mlp`` and ``aux_load_balance_loss`` are held at 1e-5 (fp32
sums in another order), over capacity factors that drop no token
(dropless: ``n_experts``), some (1.25) and many (0.5), top-k 1, 2 and
6, with and without shared experts; the gradients of ``moe_mlp``'s
output with respect to x, the router and the expert weights against
``jax.grad`` at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe

S, D, F, E = 48, 32, 24, 8
CAPACITY = {"dropless": float(E), "1.25": 1.25, "0.5": 0.5}


def _params(seed, shared: bool, e=E):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) * shape[-2] ** -0.5).astype(np.float32)

    p = {"router": w(D, e), "wg": w(e, D, F), "wu": w(e, D, F),
         "wd": w(e, F, D)}
    if shared:
        p.update(shared_wg=w(D, 2 * F), shared_wu=w(D, 2 * F),
                 shared_wd=w(2 * F, D))
    return p


def _x(seed, s=S):
    return np.random.default_rng(seed).normal(size=(s, D)).astype(np.float32)


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _dropped(x, p, top_k, capacity_factor):
    """The number of (token, expert) slots past their expert's capacity,
    counted from the JAX router's choices."""
    logits = x @ p["router"]
    eidx = np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), top_k)[1])
    c = moe.capacity(x.shape[0], top_k, p["router"].shape[1],
                     capacity_factor)
    counts = np.bincount(eidx.reshape(-1), minlength=p["router"].shape[1])
    return int(np.maximum(counts - c, 0).sum())


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("top_k", [1, 2, 6])
@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_moe_mlp_matches(capacity, top_k, shared):
    cf = CAPACITY[capacity]
    p, x = _params(1, shared), _x(2)
    want = jmoe.moe_mlp(jnp.asarray(x), p, top_k=top_k, act="silu",
                        capacity_factor=cf)
    got = moe.moe_mlp(torch.from_numpy(x), _torch(p), top_k=top_k,
                      act="silu", capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dropped = _dropped(x, p, top_k, cf)
    if capacity == "dropless":
        assert dropped == 0
    if capacity == "0.5":
        assert dropped > 0


def test_moe_mlp_gelu_and_bf16_router_input():
    """grok-1's activation, and the router fed the model's own type."""
    p, x = _params(3, True), _x(4)
    for router_in_f32 in (True, False):
        want = jmoe.moe_mlp(jnp.asarray(x), p, top_k=2, act="gelu",
                            capacity_factor=1.25,
                            router_in_f32=router_in_f32)
        got = moe.moe_mlp(torch.from_numpy(x), _torch(p), top_k=2,
                          act="gelu", capacity_factor=1.25,
                          router_in_f32=router_in_f32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_dropped_slots_do_not_overwrite_kept_ones():
    """Capacity 1 per expert: most slots drop onto slot 0 of their
    expert, whose one kept token must come through unchanged (an
    assigning scatter would leave zeros there)."""
    p, x = _params(5, False), _x(6, s=16)
    cf = E / (16 * 2)                                      # C = 1
    assert moe.capacity(16, 2, E, cf) == 1
    want = jmoe.moe_mlp(jnp.asarray(x), p, top_k=2, capacity_factor=cf)
    got = moe.moe_mlp(torch.from_numpy(x), _torch(p), top_k=2,
                      capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the tokens with a kept slot: each expert's first slot in token order
    eidx = moe.route(torch.from_numpy(x), torch.from_numpy(p["router"]),
                     2)[2].numpy().reshape(-1)
    kept = {int(np.flatnonzero(eidx == e)[0]) // 2 for e in set(eidx)}
    assert 0 < len(kept) < 16
    assert set(np.flatnonzero(np.abs(got.numpy()).sum(-1) > 0)) == kept


@pytest.mark.parametrize("top_k", [1, 2, 6])
def test_aux_load_balance_loss_matches(top_k):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(S, E)).astype(np.float32)
    eidx = np.argsort(-logits, axis=-1)[:, :top_k].astype(np.int32)
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(eidx),
                                      E, top_k)
    got = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                    torch.from_numpy(eidx).long(), E, top_k)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                               atol=1e-5)


def test_route_matches_the_reference_router():
    """The router's logits, normalized gates and expert ids."""
    p, x = _params(8, False), _x(9)
    logits, gates, eidx = moe.route(torch.from_numpy(x),
                                    torch.from_numpy(p["router"]), 2)
    jl = x @ p["router"]
    jg, je = jax.lax.top_k(jax.nn.softmax(jnp.asarray(jl), -1), 2)
    jg = jg / jnp.clip(jg.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(logits.numpy(), jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(je))


@pytest.mark.parametrize("capacity", ["dropless", "0.5"])
@pytest.mark.parametrize("shared", [False, True])
def test_moe_mlp_grads_match_jax(capacity, shared):
    """d sum(y * cot) / d(x, router, wg, wu, wd[, shared]) at 1e-4."""
    cf = CAPACITY[capacity]
    p, x = _params(10, shared), _x(11)
    cot = np.random.default_rng(12).normal(size=(S, D)).astype(np.float32)

    def jloss(x_, p_):
        return jnp.sum(jmoe.moe_mlp(x_, p_, top_k=2, capacity_factor=cf)
                       * cot)

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), p)
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: v.requires_grad_() for k, v in _torch(p).items()}
    (moe.moe_mlp(xt, pt, top_k=2, capacity_factor=cf)
     * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4)
    for k in p:
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
