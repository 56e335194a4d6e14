"""The port's training slice against the JAX package on the CPU: AdamW and
its schedule, the flash backward (``flash_mha`` / ``local_mha``), the
kernel policy's training variant, the ball trainer and the grad guard of
the CUDA kernel wrappers.

Inputs come from numpy seeds; both packages run in fp32 on the CPU.
Tolerances are the JAX suite's: AdamW 1e-6 step for step, the schedule
and ``global_norm`` 1e-7; attention forward rtol 2e-5 / atol 2e-5 and
dq/dk/dv rtol 1e-4 / atol 1e-5 (``tests/test_attention_vjp.py``), bf16
3e-2; the ball trainer's parameters after 5 steps rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.cnn_paper import trained_ball_classifier as jax_ball
from repro.models.attention_vjp import flash_mha as jax_flash_mha
from repro.models.attention_vjp import local_mha as jax_local_mha
from repro.models.kernel_policy import KernelPolicy as JaxKernelPolicy
from repro.models.kernel_policy import fit_block as jax_fit_block
from repro.optim import AdamW as JaxAdamW
from repro.optim import global_norm as jax_global_norm
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch.configs.cnn_paper import trained_ball_classifier
from repro_torch.core import passes, quantize, torch_exec
from repro_torch.data.pipeline import ball_image_batch
from repro_torch.kernels import conv2d as conv_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import linear_scan as scan_mod
from repro_torch.kernels import maxpool2d as pool_mod
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import (DEFAULT_KERNELS, TRAIN_KERNELS, KernelPolicy,
                                fit_block, flash_mha, local_mha)
from repro_torch.optim import AdamW, global_norm, warmup_cosine

FLASH_CASES = [  # (B, T, H, Hkv, Dh, causal, window, bq, bk)
    (2, 128, 4, 2, 32, True, None, 64, 64),
    (1, 256, 8, 8, 16, True, None, 128, 64),
    (2, 128, 4, 1, 32, False, None, 64, 64),     # bidirectional MQA
    (1, 128, 4, 4, 16, True, 48, 64, 64),        # windowed via flash
]
LOCAL_CASES = [  # (B, T, H, Hkv, Dh, window, bq)
    (2, 256, 4, 2, 32, 64, 64),
    (1, 512, 2, 2, 16, 100, 128),
    (1, 128, 4, 1, 32, 32, 32),
]


def _rnd(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# -------------------------------------------------------------- AdamW ----

def _quadratic(seed):
    """A target and starting params (dict + list, as a params tree)."""
    r = np.random.default_rng(seed)
    return (r.normal(size=(8,)).astype(np.float32),
            {"w": r.normal(size=(8,)).astype(np.float32),
             "b": [r.normal(size=(3,)).astype(np.float32)]})


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("clip_norm", [None, 1.0])
def test_adamw_matches_jax_step_for_step(clip_norm, weight_decay, schedule):
    """30 steps on the quadratic of ``tests/test_substrates.py`` (plus a
    second leaf in a list): each side's own grads, parameters and both
    moments equal to 1e-6 after every step."""
    target, p0 = _quadratic(3)
    lr = 1e-2
    jopt = JaxAdamW(learning_rate=jax_warmup_cosine(lr, 5, 30)
                    if schedule else lr, weight_decay=weight_decay,
                    clip_norm=clip_norm)
    opt = AdamW(learning_rate=warmup_cosine(lr, 5, 30) if schedule else lr,
                weight_decay=weight_decay, clip_norm=clip_norm)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = {"w": torch.from_numpy(p0["w"].copy()),
          "b": [torch.from_numpy(p0["b"][0].copy())]}
    js, ts = jopt.init(jp), opt.init(tp)

    def jloss(p):
        return 3 * jnp.sum((p["w"] - target) ** 2) + jnp.sum(p["b"][0] ** 2)

    for _ in range(30):
        up, js = jopt.update(jax.grad(jloss)(jp), js, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, up)
        w, b = (t.clone().requires_grad_() for t in (tp["w"], tp["b"][0]))
        loss = 3 * ((w - torch.from_numpy(target)) ** 2).sum() + (b ** 2).sum()
        gw, gb = torch.autograd.grad(loss, [w, b])
        tu, ts = opt.update({"w": gw, "b": [gb]}, ts, tp)
        tp = {"w": tp["w"] + tu["w"], "b": [tp["b"][0] + tu["b"][0]]}
        assert int(ts.step) == int(js.step)
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for g, w_ in zip((got["w"], got["b"][0]),
                             (want["w"], want["b"][0])):
                np.testing.assert_allclose(g.numpy(), np.asarray(w_),
                                           rtol=1e-6, atol=1e-6)


def test_adamw_moments_are_fp32_for_bf16_params():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = AdamW().init(params)
    assert st.mu["w"].dtype == torch.float32 and st.step.dtype == torch.int32
    up, st = AdamW().update({"w": torch.ones(4, dtype=torch.bfloat16)}, st,
                            params)
    assert up["w"].dtype == torch.float32 and int(st.step) == 1


def test_warmup_cosine_and_global_norm_match_jax():
    for peak, warm, total in ((3e-4, 20, 100), (1.0, 10, 100)):
        js, ts = jax_warmup_cosine(peak, warm, total), warmup_cosine(
            peak, warm, total)
        want = np.array([float(js(jnp.int32(i))) for i in range(121)])
        got = np.array([float(ts(torch.tensor(i, dtype=torch.int32)))
                        for i in range(121)])
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)
    tree = {"a": _rnd(1, (4, 3)), "z": [_rnd(2, (5,)), _rnd(3, (2, 2))]}
    want = float(jax_global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(global_norm({"a": torch.from_numpy(tree["a"]),
                             "z": [torch.from_numpy(a) for a in tree["z"]]}))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    opt = AdamW(learning_rate=1.0, clip_norm=1.0, weight_decay=0.0)
    up, _ = opt.update({"w": torch.full((4,), 1e9)}, opt.init(params), params)
    assert float(global_norm(up)) < 10.0


def test_warmup_cosine_shape():
    s = warmup_cosine(1.0, 10, 100)
    assert float(s(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(s(torch.tensor(10, dtype=torch.int32))) - 1.0) < 1e-6
    assert float(s(torch.tensor(100, dtype=torch.int32))) <= 0.1 + 1e-6


# ------------------------------------------------------ flash backward ----

def _qkv(seeds, b, t, h, hkv, dh):
    return (_rnd(seeds[0], (b, t, h, dh)), _rnd(seeds[1], (b, t, hkv, dh)),
            _rnd(seeds[2], (b, t, hkv, dh)))


def _port_grads(fn, arrays, do, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(do).to(dtype))
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


def _jax_grads(fn, arrays, do, dtype=jnp.float32):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in arrays))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32))
             for g in vjp(jnp.asarray(do, dtype))])


def _dense(causal, window):
    """The port's dense attention_ref, (B,T,H,D) in and out, under
    autograd."""
    def fn(q, k, v):
        o = attention_ref(*(a.transpose(1, 2) for a in (q, k, v)),
                          causal=causal, window=window)
        return o.transpose(1, 2)
    return fn


def _hold(got, want, out_tol=2e-5):
    (o, gs), (ow, gws) = got, want
    np.testing.assert_allclose(o, ow, rtol=out_tol, atol=out_tol)
    for g, gw in zip(gs, gws):
        np.testing.assert_allclose(g, gw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,T,H,Hkv,Dh,causal,window,bq,bk", FLASH_CASES)
def test_flash_mha_matches_jax(B, T, H, Hkv, Dh, causal, window, bq, bk):
    arrays = _qkv((1, 2, 3), B, T, H, Hkv, Dh)
    do = _rnd(10, (B, T, H, Dh))
    got = _port_grads(lambda q, k, v: flash_mha(
        q, k, v, causal, window, None, bq, bk), arrays, do)
    _hold(got, _jax_grads(lambda q, k, v: jax_flash_mha(
        q, k, v, causal, window, None, bq, bk), arrays, do))
    _hold(got, _port_grads(_dense(causal, window), arrays, do))


@pytest.mark.parametrize("B,T,H,Hkv,Dh,window,bq", LOCAL_CASES)
def test_local_mha_matches_jax(B, T, H, Hkv, Dh, window, bq):
    arrays = _qkv((4, 5, 6), B, T, H, Hkv, Dh)
    do = _rnd(11, (B, T, H, Dh))
    got = _port_grads(lambda q, k, v: local_mha(q, k, v, window, None, bq),
                      arrays, do)
    _hold(got, _jax_grads(lambda q, k, v: jax_local_mha(
        q, k, v, window, None, bq), arrays, do))
    _hold(got, _port_grads(_dense(True, window), arrays, do))


def test_flash_and_local_mha_bf16_match_jax():
    """One bf16 case of each, held to its JAX counterpart at 3e-2."""
    arrays = _qkv((7, 8, 9), 1, 128, 4, 2, 32)
    do = _rnd(12, (1, 128, 4, 32))
    for port, ref in (
            (lambda q, k, v: flash_mha(q, k, v, True, None, None, 64, 64),
             lambda q, k, v: jax_flash_mha(q, k, v, True, None, None, 64,
                                           64)),
            (lambda q, k, v: local_mha(q, k, v, 48, None, 64),
             lambda q, k, v: jax_local_mha(q, k, v, 48, None, 64))):
        (o, gs) = _port_grads(port, arrays, do, torch.bfloat16)
        (ow, gws) = _jax_grads(ref, arrays, do, jnp.bfloat16)
        for a, b in zip([o] + gs, [ow] + gws):
            np.testing.assert_allclose(a, b, rtol=3e-2, atol=3e-2)


def test_flash_mha_saves_only_o_and_lse():
    """The forward keeps (q, k, v, o, lse) for the backward: O(T), no
    score block."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv((1, 2, 3), 1, 256, 4, 2, 16))
    o = flash_mha(q, k, v, True, None, None, 64, 64)
    saved = o.grad_fn.saved_tensors
    assert [tuple(s.shape) for s in saved] == [
        (1, 256, 4, 16), (1, 256, 2, 16), (1, 256, 2, 16), (1, 256, 4, 16),
        (1, 2, 2, 256)]


def test_unfitted_blocks_raise():
    q = torch.zeros(1, 96, 2, 16)
    with pytest.raises(ValueError, match="multiple"):
        flash_mha(q, q, q, True, None, None, 64, 64)
    with pytest.raises(ValueError, match="multiple"):
        local_mha(q, q, q, 16, None, 64)


# --------------------------------------------------------- the policy ----

def test_kernel_policy_train_variant_and_round_trip():
    assert TRAIN_KERNELS == KernelPolicy("flash_jax", "chunked", 512, 512)
    assert KernelPolicy("flash_jax").validate().attention == "flash_jax"
    assert TRAIN_KERNELS == KernelPolicy(*JaxKernelPolicy())
    assert DEFAULT_KERNELS == KernelPolicy("flash_pallas", "linear_scan")
    jp = JaxKernelPolicy("flash_pallas", "linear_scan", 128, 64)
    assert tuple(KernelPolicy(*jp).validate()) == tuple(jp)
    assert JaxKernelPolicy(*KernelPolicy(*jp)) == jp
    with pytest.raises(ValueError, match="blocks"):
        KernelPolicy(block_q=0).validate()
    for n, b in ((96, 64), (100, 512), (37, 16), (256, 256)):
        assert fit_block(n, b) == jax_fit_block(n, b)


# ------------------------------------------------------ the grad guard ----

def test_cuda_wrappers_raise_under_grad():
    """Each CUDA kernel wrapper refuses an input that requires grad under
    grad mode (its kernel has no backward), naming the kernel and the
    differentiable policy, before it looks at the device; under
    ``no_grad`` the same call reaches the device check instead."""
    x = torch.zeros(1, 8, 8, 4, requires_grad=True)
    w, b = torch.zeros(3, 3, 4, 4), torch.zeros(4)
    q = torch.zeros(1, 2, 8, 32, requires_grad=True)
    s = torch.zeros(1, 8, 2, 4, requires_grad=True)
    calls = {
        "conv2d": lambda: conv_mod.conv2d_cuda(x, w, b),
        "maxpool2d": lambda: pool_mod.maxpool2d_cuda(x),
        "flash_attention": lambda: flash_mod.flash_attention_cuda(q, q, q),
        "linear_scan": lambda: scan_mod.linear_scan_cuda(
            s, s, s, s, torch.zeros(1, 2, 4, 4)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=rf"{name}.*KernelPolicy"
                           r"\(\"flash_jax\", \"chunked\"\)"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
            call()


# -------------------------------------------------------- ball trainer ----

def test_ball_trainer_matches_jax_after_5_steps():
    """5 steps of the port's trainer on the CPU against the JAX trainer:
    every weight and bias at rtol 1e-4 / atol 1e-5."""
    want, want_acc = jax_ball(5, seed=0, eval_n=200)
    got, acc = trained_ball_classifier(5, seed=0, eval_n=200, device="cpu")
    assert acc == pytest.approx(want_acc, abs=1e-9)
    n = 0
    for lw, lg in zip(want.layers, got.layers):
        if getattr(lw, "weights", None) is not None:
            n += 1
            for a, b in ((lg.weights, lw.weights), (lg.bias, lw.bias)):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                           err_msg=lw.name)
    assert n == 3


def test_ball_trainer_reaches_the_quickstart_bars():
    """150 steps: held-out accuracy >= 0.97, and the port's int8
    (``quantize`` + ``forward_quantized``, percentile on 64 frames) no
    more than 0.02 below float (``tests/test_quantize.py``'s bars)."""
    graph, acc = trained_ball_classifier(150, seed=0, device="cpu")
    assert acc >= 0.97
    xs, ys = ball_image_batch(2000, seed=99, step=0)
    opt = passes.optimize(graph, simd_multiple=1)
    qg = quantize.quantize(opt, xs[:64], method="percentile", device="cpu")
    with torch.no_grad():
        x = torch.from_numpy(xs)
        fp = torch_exec.forward(graph, x, torch_exec.extract_params(graph))
        q8 = torch_exec.forward_quantized(qg, x)
    f_acc = float((fp.reshape(len(xs), -1).argmax(-1).numpy() == ys).mean())
    q_acc = float((q8.reshape(len(xs), -1).argmax(-1).numpy() == ys).mean())
    assert f_acc == pytest.approx(acc, abs=1e-6)  # acc is an fp32 mean
    assert q_acc >= f_acc - 0.02
