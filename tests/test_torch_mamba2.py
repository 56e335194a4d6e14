"""The port's Mamba2 half of ``models/ssm.py`` against the JAX package's
on the same inputs and weights.

Inputs come from numpy seeds, weights from the JAX ``init_mamba2`` plus
numpy noise on every leaf (so the zero conv bias and A_log matter); both
sides run in fp32 on the CPU.  Tolerance 1e-5 (fp32 sums in another
order): ``ssd_chunked`` over several chunks, with and without a start
state; ``causal_conv1d`` with and without a state; ``mamba2_mix`` prefill
and two decode steps from its state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm
from repro_torch.models.layers import ParamInit


def _rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _ssd_inputs(seed, b, t, h, p, n):
    rng = np.random.default_rng(seed)
    a = np.exp(-rng.uniform(0.0, 0.3, size=(b, t, h))).astype(np.float32)
    return (a, _rnd(seed + 1, (b, t, h, p)), _rnd(seed + 2, (b, t, n), 0.5),
            _rnd(seed + 3, (b, t, n), 0.5))


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("t,chunk", [(64, 16), (256, 128), (8, 128)])
def test_ssd_chunked_matches(t, chunk, with_s0):
    """4 chunks of 16, 2 of 128, and a prompt shorter than the chunk."""
    b, h, p, n = 2, 3, 8, 4
    arrays = _ssd_inputs(1, b, t, h, p, n)
    s0 = _rnd(5, (b, h, n, p)) if with_s0 else None
    want = jssm.ssd_chunked(*map(jnp.asarray, arrays), s0=s0, chunk=chunk)
    got = ssm.ssd_chunked(*map(torch.from_numpy, arrays),
                          None if s0 is None else torch.from_numpy(s0),
                          chunk=chunk)
    for g, w in zip(got, want):
        _close(g, w)


def test_ssd_chunked_is_the_recurrence():
    """The chunked scan equals the step-by-step recurrence it stands for
    (float64 reference)."""
    b, t, h, p, n = 1, 32, 2, 4, 3
    a, u, bm, cm = _ssd_inputs(6, b, t, h, p, n)
    s = np.zeros((b, h, n, p))
    ys = []
    for i in range(t):
        s = (a[:, i, :, None, None] * s
             + np.einsum("bn,bhp->bhnp", bm[:, i], u[:, i]))
        ys.append(np.einsum("bn,bhnp->bhp", cm[:, i], s))
    y, s_final = ssm.ssd_chunked(*map(torch.from_numpy, (a, u, bm, cm)),
                                 chunk=8)
    _close(y, np.stack(ys, 1))
    _close(s_final, s)


def test_ssd_chunked_refuses_a_ragged_chunk():
    arrays = _ssd_inputs(7, 1, 40, 2, 4, 3)
    with pytest.raises(ValueError, match="chunk 16"):
        ssm.ssd_chunked(*map(torch.from_numpy, arrays), chunk=16)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches(with_state):
    x, w, b = _rnd(10, (2, 9, 12)), _rnd(11, (4, 12)), _rnd(12, (12,))
    st = _rnd(13, (2, 3, 12)) if with_state else None
    want = jssm.causal_conv1d(x, w, b, st)
    got = ssm.causal_conv1d(*map(torch.from_numpy, (x, w, b)),
                            None if st is None else torch.from_numpy(st))
    for g, wt in zip(got, want):
        _close(g, wt)


def _mamba_params(seed=20, d=32, n=8, head_dim=16):
    p = jssm.init_mamba2(jax.random.PRNGKey(0), d, ssm_state=n,
                         head_dim=head_dim, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) + (0.05 * rng.normal(size=v.shape)).astype(
        np.float32) for k, v in p.items()}
    return p, {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("t,chunk", [(24, 8), (16, 128)])
def test_mamba2_mix_prefill_then_decode_matches(t, chunk):
    """Prefill from no state, then two one-token steps from the state the
    prefill returned (the decode branch), each against JAX."""
    p, pt = _mamba_params()
    kw = dict(ssm_state=8, head_dim=16, chunk=chunk)
    x = _rnd(21, (2, t, 32))
    want, jst = jssm.mamba2_mix(jnp.asarray(x), p, **kw)
    got, st = ssm.mamba2_mix(torch.from_numpy(x), pt, **kw)
    _close(got, want)
    _close(st.ssm, jst.ssm)
    _close(st.conv, jst.conv)
    for i in range(2):
        xt = _rnd(30 + i, (2, 1, 32))
        want, jst = jssm.mamba2_mix(jnp.asarray(xt), p, state=jst, **kw)
        got, st = ssm.mamba2_mix(torch.from_numpy(xt), pt, state=st, **kw)
        _close(got, want)
        _close(st.ssm, jst.ssm)
        _close(st.conv, jst.conv)


def test_mamba2_mix_prefill_from_a_zero_state_is_prefill_without_one():
    """The serving path's prefill hands a fresh (zero) cache as the
    state: the same output and state as no state at all."""
    p, pt = _mamba_params()
    x = torch.from_numpy(_rnd(40, (2, 16, 32)))
    zero = ssm.MambaState(ssm=torch.zeros(2, 4, 8, 16),
                          conv=torch.zeros(2, 3, 64))
    a = ssm.mamba2_mix(x, pt, ssm_state=8, head_dim=16)
    b = ssm.mamba2_mix(x, pt, ssm_state=8, head_dim=16, state=zero)
    assert torch.equal(a[0], b[0])
    for u, v in zip(a[1], b[1]):
        assert torch.equal(u, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba2_has_the_jax_shapes_and_types(dtype):
    want = jax.eval_shape(lambda: jssm.init_mamba2(
        jax.random.PRNGKey(0), 64, ssm_state=16, head_dim=16,
        dtype=jnp.dtype(dtype)))
    got = ssm.init_mamba2(ParamInit("cpu", torch.Generator().manual_seed(0)),
                          64, ssm_state=16, head_dim=16,
                          dtype=getattr(torch, dtype))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype) == "torch." + str(w.dtype), k
    # dt = softplus(dt_bias) lies in [1e-3, 1e-1], as the reference draws it
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert 1e-3 * 0.999 <= float(dt.min()) <= float(dt.max()) <= 0.1 * 1.001
    # the conv weights are rounded to the model's type, kept in fp32
    cw = got["conv_w"]
    assert torch.equal(cw, cw.to(getattr(torch, dtype)).float())
