"""The decode-attention kernel (``csrc/decode_attention.cu``) on the card:
against its plain version over ``DECODE_ATTN_CASES``, on a narrow of
the kv heads, with an int position, twice for the same bits, its
refusals, and inside the graphed bf16 decode step (the replay equal to
the eager loop bit for bit, every attention layer of the eager step and
of the capture launching the kernel).

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false.  The file imports neither JAX nor the JAX package::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_attention.py

Tolerance (``kernels.cases.check_decode``): the kernel and the plain
version each round an fp32 output to bf16 once, from sums taken in other
orders, so they lie within one bf16 unit in the last place (2**-7 of the
value) of each other, plus 1e-5 for fp32 sums in another order near 0;
where a p rounds to its other bf16 neighbour in one of them (at most
1e-3 of the outputs), four times the most one p's rounding moves an
output more.  The plain version's bf16
p.v runs with cuBLAS's reduced-precision reduction off, so that it too
sums in fp32.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels.cases import DECODE_ATTN_CASES, check_decode
from repro_torch.kernels.ref import decode_attention_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


def _inputs(dev, b, s, hkv, g, dh, seed=0, kv_heads=None):
    """q (B,1,H,Dh), k / v caches (B,S,Hkv,Dh) of N(0, 1) in bf16 (with
    ``kv_heads`` caches of that many heads)."""
    gen = torch.Generator(dev).manual_seed(seed)
    n = kv_heads or hkv

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    return draw(b, 1, hkv * g, dh), draw(b, s, n, dh), draw(b, s, n, dh)


def _close(got, q, k, v, pos, window=None, ring=False):
    """``got`` against the plain version on the same inputs."""
    want = decode_attention_ref(q, k, v, pos, window=window, ring=ring)
    assert got.dtype == want.dtype == torch.bfloat16
    check_decode(got, want, q, k, v, pos, window=window, ring=ring)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hkv,g,dh,ring,window,pos", DECODE_ATTN_CASES)
def test_decode_attention_kernel_matches_plain(cuda, b, s, hkv, g, dh, ring,
                                               window, pos):
    q, k, v = _inputs(cuda, b, s, hkv, g, dh)
    p = torch.tensor(pos, dtype=torch.int64, device=cuda)
    before = dk.launches
    got = dk.decode_attention_cuda(q, k, v, p, window=window, ring=ring)
    assert dk.launches == before + 1
    _close(got, q, k, v, p, window, ring)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hkv,g,dh,ring,window,pos", [
    DECODE_ATTN_CASES[i] for i in (0, 4, 9, 15)])
def test_decode_attention_kernel_takes_an_int_position(cuda, b, s, hkv, g,
                                                       dh, ring, window, pos):
    q, k, v = _inputs(cuda, b, s, hkv, g, dh)
    p = torch.tensor(pos, dtype=torch.int64, device=cuda)
    assert torch.equal(
        dk.decode_attention_cuda(q, k, v, pos, window=window, ring=ring),
        dk.decode_attention_cuda(q, k, v, p, window=window, ring=ring))


@pytest.mark.cuda
@pytest.mark.parametrize("s,pos", [(320, 250), (4096, 3000)])
def test_decode_attention_kernel_reads_a_narrow_of_the_kv_heads(cuda, s,
                                                                pos):
    """``q_heads_kv_whole``: whole caches of 8 kv heads, this rank's 2 of
    them (heads 2 and 3) as a strided view."""
    q, k, v = _inputs(cuda, 2, s, 2, 2, 128, kv_heads=8)
    kn, vn = k.narrow(2, 2, 2), v.narrow(2, 2, 2)
    assert not kn.is_contiguous()
    got = dk.decode_attention_cuda(q, kn, vn, pos)
    _close(got, q, kn, vn, pos)
    assert torch.equal(got, dk.decode_attention_cuda(
        q, kn.contiguous(), vn.contiguous(), pos))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [0, 10, 17])
def test_decode_attention_kernel_gives_the_same_bits_twice(cuda, case):
    b, s, hkv, g, dh, ring, window, pos = DECODE_ATTN_CASES[case]
    q, k, v = _inputs(cuda, b, s, hkv, g, dh)
    one, two = (dk.decode_attention_cuda(q, k, v, pos, window=window,
                                         ring=ring) for _ in range(2))
    assert torch.equal(one, two)


@pytest.mark.cuda
def test_decode_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _inputs(cuda, 2, 64, 2, 2, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        dk.decode_attention_cuda(q.float(), k.float(), v.float(), 10)
    with pytest.raises(ValueError, match="CUDA"):
        dk.decode_attention_cuda(q.cpu(), k.cpu(), v.cpu(), 10)
    with pytest.raises(ValueError, match="int64"):
        dk.decode_attention_cuda(q, k, v, torch.tensor(10, device=cuda,
                                                       dtype=torch.int32))
    with pytest.raises(ValueError, match="q heads"):
        dk.decode_attention_cuda(torch.cat([q] * 5, 2), k, v, 10)
    q2, k2, v2 = _inputs(cuda, 2, 64, 2, 2, 20)
    with pytest.raises(ValueError, match="head_dim"):
        dk.decode_attention_cuda(q2, k2, v2, 10)
    with pytest.raises(ValueError, match="16-byte"):  # 2 elements off
        dk.decode_attention_cuda(q[..., 2:34], k[..., 2:34], v[..., 2:34], 10)
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        dk.decode_attention_cuda(q, k, v, 10)


def _lm_backend(arch, dev, batch=2):
    """The arch's ``.smoke()`` config in bf16 on the card, as a
    ``"cuda-lm"`` backend with random weights from seed 0."""
    from repro_torch.configs.lm_archs import ARCHS
    from repro_torch.engine import CudaLMBackend
    cfg = dataclasses.replace(ARCHS[arch].smoke(), dtype="bfloat16")
    return CudaLMBackend(cfg, max_context=40, decode_batch=batch, device=dev)


def _prompts(seed, batch, t=12):
    return np.random.default_rng(seed).integers(
        0, 256, size=(batch, t)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-moe-16b",
                                  "zamba2-2.7b", "qwen2-vl-72b"])
def test_graphed_bf16_decode_takes_the_kernel(cuda, arch):
    """Prompts of 12 (past the smoke window of 8: gemma3-4b's ring caches
    have wrapped), 8 new tokens in bf16: the graphed decode's tokens and
    last logits equal the eager loop's bit for bit, and each attention
    layer of the eager step and of the capture launches the kernel."""
    from repro_torch.models import lm
    backend = _lm_backend(arch, cuda)
    cfg, params = backend.model_cfg, backend.params
    layers = sum((cfg.prologue + cfg.pattern * cfg.n_groups).count(kind)
                 for kind in "ALS")
    prompts = _prompts(1, 2)
    prefill = lm.make_prefill_step(cfg, backend.max_context, backend.policy)
    decode = lm.make_decode_step(cfg, backend.policy)
    with torch.inference_mode():
        logits, caches, pos = prefill(params, {"tokens": torch.from_numpy(
            prompts.astype(np.int64)).to(cuda)})
        want = [logits.argmax(-1)]
        for _ in range(7):
            logits, caches, pos = decode(params, caches, want[-1][:, None],
                                         pos)
            want.append(logits.argmax(-1))
    want_toks = torch.stack(want, 1).cpu().numpy().astype(np.int32)
    want_logits = logits.cpu().numpy()

    before = dk.launches
    logits, handle = backend.prefill(prompts)
    toks = [np.argmax(logits, -1).astype(np.int32)]
    for _ in range(7):
        logits = backend.decode(handle, toks[-1])
        toks.append(np.argmax(logits, -1).astype(np.int32))
    launched = dk.launches - before
    assert handle.graph is not None
    np.testing.assert_array_equal(np.stack(toks, 1), want_toks)
    np.testing.assert_array_equal(logits, want_logits)
    # the eager step and the capture run Python; the six replays do not
    assert launched == 2 * layers
