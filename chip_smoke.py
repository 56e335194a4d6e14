#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, in order, each printing one JSON line (``time`` one per robot
layer, ``lm_main`` and ``lm_serve`` one per arch, ``lm_tune`` one per
tuned arch); any failure propagates and the script exits non-zero:

1. device    — the card's name and power limit (the raw ``nvidia-smi``
   line, also printed on its own), torch and CUDA versions, and PyTorch's
   TF32 switches as they stand (the script leaves them at their
   defaults);
2. build     — the hand-written CUDA kernels built from
   ``src/repro_torch/kernels/csrc`` into ``build/repro_torch_kernels/``:
   seconds, ptxas's lines naming each kernel function with its
   registers and spill bytes, and the same per conv2d instantiation,
   none of the robot's (fp32, 3x3) spilling;
3. kernels   — the CNN kernels held against their plain PyTorch versions
   (``kernels/ref.py``) on the card: conv2d on every conv shape of the
   four optimized nets at the main path's batches, the JAX suite's cases,
   a c_out of 300, the tiled kernel's edges (fp32 at 1e-5, bf16 at
   3e-2 and within one rounding, 2**-8 relative, of the fp32 function of
   the same inputs) and the wide and deep shapes that take column tiles
   and filter chunks (fp32 at ``conv_tol``: rtol 1e-5 and an atol that
   grows as the K products a sum takes); maxpool2d on the JAX suite's cases, the
   nets' pools, the vector-width edges, a tensor off 16-byte alignment
   and NaNs inside a vector, exact (NaN where the plain version has
   NaN);
4. time      — per robot layer at batch 256: the kernel (with the tap
   variant and tile ``conv_plan`` chose, or the plan ``pool_plan``
   chose), its plain version and one PyTorch library call (cuDNN with
   TF32 off for that call only), CUDA events around a replayed CUDA
   graph, median of repeats; bytes, fp32 operations and the bound; each
   pool also cold (``cold_ms``, ``plain_cold_ms``, ``library_cold_ms``):
   the graph's 20 calls cycle through copies of x that together exceed
   100 MB, so that each call reads from device memory, not from the
   50 MB L2;
5. main      — ``InferenceSession(backend="cuda")`` against
   ``backend="torch"`` on the card at rtol 1e-4 / atol 1e-5, with the
   TF32 switches at PyTorch's defaults until the ``"torch"`` backend sets
   cuDNN's itself: the robot detector on 64 frames, ball, pedestrian and
   residual on 8; the robot also against the CPU on 4 frames;
6. e2e       — the robot forward at batch 256 with the input on the card,
   on both backends in turns, the card's busy share under the profiler,
   and batch-1 ``session.benchmark()``;
7. serve     — 256 robot frames through ``InferenceServer(workers=2,
   max_batch=32)``, each equal to ``session.predict`` (rtol 1e-5 /
   atol 1e-6); latency percentiles, QPS, batch occupancy, and the card's
   busy share while serving;
8. int8      — the paper's int8 path through
   ``InferenceSession(backend="torch", precision="int8")`` on the card:
   the robot calibrated on the card with the session's default
   (percentile, 32 camera frames) and with minmax, each beside the same
   calibration on the CPU (zero points, the layers whose zero point
   differs, the largest relative scale difference); every net's int8
   forward on the card held to the same quantized graph on the CPU, bit
   for bit on the robot (64 frames, both calibrations) and at rtol 1e-5
   / atol 1e-6 on ball, pedestrian and residual, whose sinks are
   Softmax; top-1 agreement with the fp32 forward on 16 held-out camera
   frames, at least 0.99; 256 frames served through
   ``InferenceServer(workers=2, max_batch=32)``, each equal to
   ``session.predict`` bit for bit, with QPS and p50 / p99; launches of
   the four kernels over that path, all 0 (the int8 reference runs
   none); then the robot forward at batch 256 on int8, ``"cuda"`` and
   ``"torch"`` in turns, through a replayed CUDA graph between CUDA
   events and as eager calls, the card's busy share over int8 forwards,
   and int8 batch-1 latency;
9. cgen      — the paper's own deployment, the generated ANSI C compiled
   with the host's ``cc`` (``InferenceSession(backend="c")``), beside
   the card: the host's CPU model, core count and ``cc --version`` once,
   next to the card's name and power limit; per net (ball, pedestrian,
   robot, residual; seed 0 weights; camera frames, 64 for the robot and
   8 for the others) an fp32 C session at ``runtime.best_isa()``
   (unroll ``"auto"``, fusion auto, one stage, no autotune) held to the
   ``"cuda"`` session of phase 5 at rtol 1e-3 / atol 1e-5, and an int8 C
   session at ``supported_int8_simds()[0]`` held to the int8 ``"torch"``
   session on the card built from the same quantized graph (bit for bit
   on the robot, rtol 1e-5 / atol 1e-6 and the same argmax on the
   Softmax nets); batch-1 ``session.benchmark()`` of C fp32, C int8 and
   ``"cuda"``, with the requested and resolved simd, the C source bytes
   and the arena bytes; the C sessions' runs launch none of the four
   kernels (counted from 0 around them), the ``"cuda"`` sessions' conv2d
   and maxpool2d launches go into the kernels line; then 256 robot
   frames through ``InferenceServer(workers=2, max_batch=32)`` on
   ``"c"``, each equal to ``session.predict`` bit for bit, with QPS and
   p50 / p99.  Each C build is one ``cc -O3``, all started together.
   Then the code generator's two gates on the same host, through the
   port's tools (``tools/strict_c89_torch.py``,
   ``tools/cross_check_torch.py``), each a line of its own:
   ``strict_c89``, the paper's "plain ANSI C" claim: the tool's 12
   generic sources (ball unrolled and rolled, the residual DAG fused,
   unfused and in two stages, int8 under minmax, mse and percentile,
   the pooling/Concat DAG in fp32, int8 and per-channel int8; the int8
   ones calibrated on the card) each compiled by the host's ``cc``
   under ``-std=c89 -Wall -Wextra -Werror -pedantic-errors``, with each
   source's bytes and the gate's seconds; ``cross_check``, the int8 C
   run: the tool's three nets (the kernel zoo, the camera conv net, the
   pooling/Concat DAG with per-channel zero points; calibrated on the
   CPU) as ``generic`` C with its file-I/O harness, built and run on
   the host, the raw float32 outputs bit for bit equal to
   ``forward_quantized`` of the same quantized graph on the card; the
   ARM lanes (``neon``, ``neon_dot`` under ``qemu-aarch64``) too where
   an aarch64 cross compiler and QEMU are found (``arm_lanes``:
   ``"ran"`` or ``"toolchain missing"``); neither gate launches a
   kernel.  Any failed case fails the run;
10. lm_kernels — flash attention and the linear scan against their plain
   versions on the card: the JAX suite's cases (flash fp32 2e-5 and
   bf16 3e-2; scan fp32 1e-4 and bf16 5e-2), the archs' head dims (80
   included, with one hubert-xlarge layer at full width), the scan at
   odd N, N 128, ragged M and T and with decays down to 1e-6, and the
   main path's shapes (flash: gemma3-4b's global and local layers,
   deepseek-moe-16b's 16 heads of 128, zamba2-2.7b's shared block's 32
   heads of 80); every bf16 output also within one rounding (2**-8
   relative) of the fp32 function of the same inputs; the scan's
   two-halves state carry at 1e-5 (N 4, 64 and 128); flash attention at
   a query offset (``q_start``: the last quarter of the rows against the
   whole k and v, the last of four ranks' rows under the head-dim
   attention rule) at the main path's four layers, head dim 80 and head
   dim 128 without a mask, both routes at the same bars
   (``flash_query_offset``); then two layers at
   full width on 4 x 1536 random hidden states: one grok-1-314b layer
   (GQA 48/8 of 128, 8 experts of 32,768, top-2) through both policies
   in bf16 and in fp32 (the gates of ``lm_main`` on the layer's
   contribution), and one h2o-danube-3-4b layer in fp32 with its head
   dim padded 120 -> 128 by ``pad_head_dim``, equal to the unpadded
   layer through the kernel policy at rtol / atol 2e-5; and the
   decode-attention kernel against its plain version on
   ``DECODE_ATTN_CASES`` (``kernels/cases.py``: caches of 1 to 32,768
   slots, G 1 to 8, head dims 16 to 256, rings with windows) by
   ``check_decode``: within one bf16 unit in the last place (2**-7
   relative, 1e-5 absolute) but for at most 1e-3 of the outputs, where
   a p rounds the other way, four times the most one p's rounding moves
   the output (``2**-7 max_s p_s |v_s|``) more; the plain p.v summed in
   fp32 (cuBLAS's reduced-precision bf16 reduction off);
11. lm_time   — per LM kernel at the main path's shapes (batch 4, 1536
   tokens; flash at the four attention shapes above, rwkv6-7b's scan):
   the kernel, its plain version and the library call where one exists,
   through a replayed CUDA graph; bytes, operations and the bound; flash
   also in fp32 (``time_flash_fp32``: its ``csrc/flash_attention.cu``
   route, split TF32 on the tensor cores, which lm_main's fp32 control
   runs), against its plain version at 2e-5 and SDPA in fp32 at 1e-4,
   with the device kernels SDPA runs, by name; the decode-attention
   kernel at the benchmark's decode step (deepseek-moe-16b, batch 64, a
   cache of 320 slots, 16 kv heads of 128), held to its plain version by
   ``check_decode`` at positions 287 and 319 and timed at 319 (the cache
   full) beside the plain version and SDPA (bf16, no mask; timed, not
   compared), its bound the caches' bytes;
12. lm_main  — per arch (gemma3-4b, rwkv6-7b, deepseek-moe-16b,
   zamba2-2.7b) at full published width in bf16 with random weights
   from seed 0: ``LMSession(backend="cuda-lm")`` with the kernel policy
   and with the plain policy on 4 prompts of 1536 tokens,
   ``max_context`` 2048, 16 new tokens, each run's kernel launches
   counted from 0 (one per attention or RWKV layer of the prefill for
   the kernel policy: 34, 32, 28 and 9, none in decode, none for the
   plain policy); prefill and decode tokens/s, the card's busy share
   and top device kernels, the greedy-token agreement, the kernel's
   graphed time a prefill, standalone estimates of the modules that may
   set the prefill (the MoE MLP and its expert products, ``ssd_chunked``:
   one layer's eager call on random inputs times its layers), and the
   last prefill logits of both policies against the same weights run in
   fp32 (there the policies agree within ``LM_FP32_REL_TOL``; in bf16
   the kernel policy is no further from fp32 than ``LM_BF16_FACTOR``
   times the plain one), deepseek-moe-16b's on its first
   ``LM_CONTROL_LAYERS`` layers (those readings keyed ``control_``),
   each fp32 prefill's launches counted from 0 (the kernel policy's: one
   fp32 kernel a layer of the control);
   the bf16 hidden states' distance
   from the fp32 model's after every layer; then the arch's
   ``.smoke()`` config in fp32, where both policies give the same
   tokens.  Both sessions decode through the CUDA graph each handle
   captures (``decode_graph``): the kernel session's greedy tokens
   equal an eager oracle's (the same weights, prompts and prefill, then
   the direct ``make_decode_step`` loop), its last decode logits'
   difference from the oracle's reported; the seconds of the eager
   warm-up step and of the capture step (capture, instantiation, first
   replay), the steady step's wall ms and tokens/s, the replay's device
   ms between CUDA events beside its bound (the weights' and caches'
   bytes over 3.35 TB/s) and the oracle's decode tokens/s;
13. lm_serve — per arch, 5 requests through ``LMTokenServer(workers=1)``
   (the worker thread captures each handle's graph): each result equals
   ``session.generate`` on the same prompts;
14. lm_tune  — gemma3-4b and rwkv6-7b (after their ``lm_serve``, on the
   same weights): ``LMSession(autotune=True)`` at full width in bf16
   into a fresh directory, as the session tunes (batch 4, prompt 16,
   the best of 3 a candidate): the winner, its prefill µs, the tuning's
   seconds and kernel launches; a second session reads the record
   (``tuned_from_cache``) and launches nothing; a session pinned to the
   winner gives the tuned session's tokens;
15. lm_decode_graph — every decoding arch's ``.smoke()`` config in fp32
   at batch 2 (prompts of 12, past the smoke window of 8), and
   deepseek-moe-16b's at capacity factor 1.25 and batch 4 (1 slot an
   expert: tokens drop in decode): the graphed decode's tokens equal
   the eager oracle's; two handles of one batch size decoded in turns,
   each equal to its own run alone;
16. examples — ``examples/serve_lm_torch.py`` and
   ``examples/serve_cnn_torch.py``, each a process of its own on the
   card: exit 0 and their closing OK lines; the CNN example's conv2d and
   maxpool2d launches;
17. train_grad — the CUDA kernel wrappers refuse an input that requires
   grad under grad mode (their kernels have no backward), and
   ``flash_mha`` / ``local_mha``, the training path's attention with its
   hand-written backward, give on the card the CPU's outputs and
   dq/dk/dv (``tests/test_attention_vjp.py``'s cases plus head dims 80
   and 256) at rtol 1e-4 / atol 1e-5;
18. train_ball — ``trained_ball_classifier(150, seed=0)`` on the card:
   its parameters after 5 steps equal the CPU's (rtol 1e-4 / atol 1e-5),
   held-out accuracy at least 0.97, seconds per step, no kernel launched
   while training; the trained net served through ``"cuda"`` (conv2d
   and maxpool2d, launches counted) against ``"torch"`` at rtol 1e-4 /
   atol 1e-5 on 2,000 frames; its int8 session at least float - 0.02;
19. train_lm — lm-100m (the JAX launch script's model: 12 layers, d_model 768,
   fp32) at batch 8 x 256: its first 3 train steps on the card against
   the CPU's from the same weights (loss and grad norm at rtol 1e-4);
   200 steps through ``repro_torch.launch.train.main`` (checkpoints every
   100 in a temporary directory), the loss falling and no kernel
   launched; then the train step alone: seconds per step and tokens/s
   over 20 steps, peak memory, and the card's busy share and top kernels
   over 10 profiled steps; then preempted at step 4 of 6 (batch 2 x 32,
   checkpoints every 2) and resumed, every array of the final checkpoint
   against a straight 6-step run at rtol 1e-5 / atol 1e-6;
20. train_smoke — 2 train steps of the gemma3-4b, rwkv6-7b,
   qwen2-vl-72b, deepseek-moe-16b and zamba2-2.7b ``.smoke()`` configs
   with ``remat="full"`` (qwen2-vl with ``grad_accum=2``), card against
   CPU: loss and grad norm at rtol 1e-4,
   parameters as ``repro_torch.optim.parity`` holds them (rtol 1e-4 /
   atol 1e-5 wherever the two devices' gradients agree to 10%);
21. launch   — the launch over ``torch.distributed`` on one rank: the
   one-rank NCCL group a ``mesh_shape=(1, 1)`` session starts (a
   ``FileStore`` in a temporary directory, no network); deepseek-moe-16b
   at full width in bf16 (during its lm phases, on the same weights,
   wrapped as DTensors with no copy) through ``"cuda-lm"`` with its dense
   layers split over ``model`` (``dense``: every kind ``"heads"``; on one
   rank each block is the whole), its residual stream split over T and
   its loss's logits over the vocabulary (``activations``, ``logits``: on
   one rank each chunk is the whole) and its MoE tensor-parallel and then
   expert-parallel, lm_main's traffic and graphed decode (each captured
   step holds the split regions' and the MoE's NCCL collectives):
   the unmeshed session's tokens, the prefill logits bit-equal for TP
   and within ``LAUNCH_EP_REL_TOL`` relative L2 for EP, the flash
   launches of the prefill (28), prefill and steady decode tokens/s
   beside the unmeshed ones, the busy share, peak memory and the
   collectives issued; lm-100m's meshed train step, 3 steps bit for bit
   the unmeshed ones; the four collective wrappers over NCCL keeping
   their values on one rank and ``compress_allreduce`` over NCCL bit for
   bit the CPU's round trip (2 steps of error feedback);
   ``restore(shardings=)`` of lm-100m's parameters onto the card's mesh
   bit for bit; and the dry-run of gemma3-4b ``train_4k`` on the
   production 16 x 16 mesh, run after every timed phase in a process of
   its own with no card (FLOPs, rank 0's argument bytes, collectives,
   and ``dense``: the attention ``"head_dim"``, checked);
22. the kernels line — per kernel: launches in phases 5-7 and 9 (CNN;
   in 9 the ``"cuda"`` sessions' runs beside the C), 12-14
   (LM: the kernel policy's run in ``lm_main`` and its fp32 control's
   prefill, the server's in ``lm_serve``, the tunings of ``lm_tune``),
   16 (the CNN example), 18 (the trained ball net served) and 21 (the
   meshed sessions' runs), each counted from 0 and read as it ends, max
   error, and the kernel's, plain version's, bound's and library's ms
   per robot forward at batch 256 (maxpool2d's from the cold readings)
   or per LM prefill of the first arch that runs it, and per prefill of
   each arch that runs it (``per_arch``); flash's launches count both
   routes; for flash also its fp32 route (``fp32_route``:
   ``csrc/flash_attention.cu``, split TF32 on the tensor cores, at the
   same shapes, beside the plain version and SDPA in fp32, timed in
   phase 11; its launches, counted apart, and its bound at 3 TF32
   products a product, 495 TFLOP/s, with fp32 FMA's 67 TFLOP/s bound
   beside it); decode attention's per decode step of the benchmark's
   28 layers (its launches: two a layer a generation on the card in
   bf16, the eager step and the capture; a replay runs no Python);
23. the last line — ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is visible.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor
# cores, dense TF32 and bf16 tensor-core rates
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
# the fp32 flash kernel's split TF32 issues three TF32 products for each
# product of the function
SPLIT_TF32_PRODUCTS = 3
BATCH = 256
KERNELS = {  # name -> (CUDA source, the TPU kernel it replaces)
    "conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:31"),
    "maxpool2d": ("src/repro_torch/kernels/csrc/maxpool2d.cu",
                  "src/repro/kernels/maxpool2d.py:17"),
    # the main path's bf16 kernel; fp32 inputs take FLASH_FP32_SOURCE
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention.py:26"),
    "linear_scan": ("src/repro_torch/kernels/csrc/linear_scan.cu",
                    "src/repro/kernels/linear_scan.py:31"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "none: added for the decode step"),
}
FLASH_FP32_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
# the LM main path: 4 prompts of 1536 tokens (longer than gemma3-4b's
# window of 1024, so its ring caches roll; 12 of zamba2-2.7b's Mamba2
# chunks of 128), 16 new tokens
LM_ARCHS = ("gemma3-4b", "rwkv6-7b", "deepseek-moe-16b", "zamba2-2.7b")
LM_BATCH, LM_PROMPT, LM_CONTEXT, LM_NEW = 4, 1536, 2048, 16
# deepseek-moe-16b's fp32 control cannot sit beside its bf16 weights
# (67.5 + 33.8 GB > 80 GB): its gates and layer drift are taken on the
# first 8 of its 28 layers at full width (the same weights, as views);
# the timed runs keep all 28
LM_CONTROL_LAYERS = {"deepseek-moe-16b": 8}
# the archs LMSession(autotune=True) tunes at full width: attention and
# its tiles (gemma3-4b), the RWKV scan (rwkv6-7b)
LM_TUNE_ARCHS = ("gemma3-4b", "rwkv6-7b")
# the short prompt served beside the main batch: a multiple of Mamba2's
# chunk of 128, as zamba2-2.7b's prefill of more than one chunk requires
LM_SHORT = 640
# The kernel and plain policies compute the same function.  In fp32 at
# full width their sums differ in order only (relative ~1e-7 an op), and
# 1e-3 in relative L2 of the last prefill logits leaves room for that
# to grow through 32-34 layers.  In bf16 (8 significant bits) both
# policies round at the same places, but a rounding that falls the
# other way grows through the random-weight layers to 0.1 (rwkv6-7b,
# measured; the JAX package's own bf16 model drifts as far, see
# tests/test_torch_lm_model.py): there the kernel policy must lie no
# further from the fp32 model than LM_BF16_FACTOR times the plain
# policy's distance (plus the fp32 allowance, the precision to which
# that model is known).  The measured ratio is 0.98-0.99.
LM_FP32_REL_TOL = 1e-3
LM_BF16_FACTOR = 1.2
# A bf16 kernel output is its fp32 result rounded once: within half a
# unit in the last place, 2**-8 of the value, of the fp32 function of the
# same (upcast) inputs; atol covers fp32 sums in another order near 0.
BF16_ROUND_RTOL, BF16_ROUND_ATOL = 2.0 ** -8, 1e-5
# the type of the kernels line's max_abs_err per LM kernel: flash's bf16
# kernel is the source named in KERNELS (the model runs bf16); the scan
# keeps fp32 arithmetic for either type
MAIN_DTYPE = {"flash_attention": "bfloat16", "linear_scan": "float32",
              "decode_attention": "bfloat16"}
# the benchmark's decode step (deepseek-moe-16b-port.chat): batch 64, a
# cache of 256 + 64 slots, 16 kv heads of 128, 28 attention layers
DECODE_STEP = dict(arch="deepseek-moe-16b", batch=64, slots=320, kv_heads=16,
                   group=1, head_dim=128, layers=28)
FLASH_CASES = [  # (b, hq, hkv, t, d, causal, window): the JAX suite's
    (1, 4, 4, 128, 32, True, None), (2, 8, 2, 128, 64, True, None),
    (1, 4, 1, 256, 32, True, 64), (1, 2, 2, 128, 32, False, None),
    (1, 4, 2, 192, 64, True, 100),
    # the archs' head dims, ragged T, every row masked (window 0)
    (1, 4, 2, 77, 120, True, 16), (2, 4, 4, 100, 128, False, 30),
    (1, 2, 1, 33, 16, True, 0),
    # head dim 80 (hubert-xlarge, zamba2-2.7b): GQA 1 and 2, windowed
    (1, 4, 4, 100, 80, True, None), (1, 4, 2, 130, 80, True, 32),
    (2, 4, 2, 70, 80, False, None)]
# the pool's cold readings cycle through copies of x of at least this
# many bytes in all: twice the H100's 50 MB L2
COLD_BYTES = 100 * 2 ** 20
SCAN_CASES = [(1, 64, 2, 8, 16), (2, 128, 4, 16, 16), (1, 96, 1, 4, 8),
              (1, 33, 2, 32, 80),  # (b, t, h, n, m)
              # N no power of two and N 128, M 80 and 10, T 1 and 1537
              (1, 40, 2, 5, 16), (1, 40, 3, 48, 64), (1, 33, 2, 128, 64),
              (2, 33, 2, 64, 80), (1, 33, 2, 16, 10), (2, 1, 2, 64, 64),
              (1, 1537, 2, 64, 64)]

# (b, t, h, hkv, dh, causal, window, bq, bk): tests/test_attention_vjp.py's
# flash cases plus head dims 80 and 256; then its local cases (b, t, h,
# hkv, dh, window, bq) plus the same head dims
TRAIN_FLASH_CASES = [
    (2, 128, 4, 2, 32, True, None, 64, 64),
    (1, 256, 8, 8, 16, True, None, 128, 64),
    (2, 128, 4, 1, 32, False, None, 64, 64),
    (1, 128, 4, 4, 16, True, 48, 64, 64),
    (1, 128, 4, 2, 80, True, None, 64, 64),
    (1, 128, 2, 1, 256, True, None, 64, 128)]
TRAIN_LOCAL_CASES = [
    (2, 256, 4, 2, 32, 64, 64), (1, 512, 2, 2, 16, 100, 128),
    (1, 128, 4, 1, 32, 32, 32), (1, 128, 4, 2, 80, 32, 64),
    (1, 128, 2, 1, 256, 48, 64)]
# the launch phase: deepseek-moe-16b's session on a (1, 1) mesh (a one-rank
# NCCL group), its MoE tensor-parallel then expert-parallel, against the
# unmeshed session of lm_main on the same weights; at one rank the EP
# exchange moves each slot to itself, so its logits may differ from the
# unmeshed ones only by the order of sums (held at 1e-5 relative L2)
LAUNCH_ARCH, LAUNCH_MOE, LAUNCH_EP_REL_TOL = "deepseek-moe-16b", ("tp", "ep"), 1e-5
# the dry-run cell traced on the production 16 x 16 mesh, in a process
# of its own (the fake backend's group, meta tensors; no card), and the
# attention rule it must take there (4 kv and 8 q heads do not divide 16
# ranks, the head dim of 256 does)
DRYRUN_CELL, DRYRUN_ATTN = ("gemma3-4b", "train_4k"), "head_dim"
# the JAX launch script's model and defaults: lm-100m in fp32, batch 8 x 256
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 200
# the .smoke() configs trained card against CPU: local attention with
# GQA, the chunked scan's gradient, M-RoPE positions (with two
# microbatches), the MoE's routing and Mamba2 with the shared block's
# summed gradient; each with remat="full"
TRAIN_SMOKE = (("gemma3-4b", 1), ("rwkv6-7b", 1), ("qwen2-vl-72b", 2),
               ("deepseek-moe-16b", 1), ("zamba2-2.7b", 1))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def compare(got, want, rtol: float, atol: float, what: str) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol*|want|
    everywhere, all values are finite and shapes and types agree."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not bool(g.isfinite().all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} of {err.numel()} "
                             f"outside rtol {rtol} atol {atol}; max abs "
                             f"error {float(err.max())}")
    return float(err.max())


def check_lm_gates(rel: dict, what: str) -> None:
    """The LM gates on relative L2 distances: the fp32 kernel policy
    within LM_FP32_REL_TOL of the plain one, and the bf16 kernel policy
    no further from fp32 than LM_BF16_FACTOR times the plain one."""
    if not rel["fp32_kernels_vs_plain"] <= LM_FP32_REL_TOL:
        raise AssertionError(f"{what}: fp32 kernel vs plain policy: {rel}")
    if not (rel["bf16_kernels_vs_fp32"] <= LM_BF16_FACTOR
            * rel["bf16_plain_vs_fp32"] + LM_FP32_REL_TOL):
        raise AssertionError(f"{what}: bf16 kernel policy further from "
                             f"the fp32 model than the plain: {rel}")


def events_ms(torch, step, per: int = 1, trials: int = 5) -> float:
    """Median over ``trials`` of the CUDA-event time of ``step()``, in ms,
    divided by ``per`` (the calls one step makes)."""
    out = []
    step()
    torch.cuda.synchronize()
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / per)
    return statistics.median(out)


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` in ms: ``reps`` calls captured in one
    CUDA graph, replayed between CUDA events, so the host's launch
    overhead is left out and only the card's time is measured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return events_ms(torch, graph.replay, reps)


def cold_graph_ms(torch, fn, xs) -> float:
    """``graph_ms`` of ``fn(x)`` with its 20 calls cycling through the
    copies ``xs``, so that each call reads an x the L2 no longer holds."""
    calls = [0]

    def step():
        calls[0] += 1
        return fn(xs[calls[0] % len(xs)])
    return graph_ms(torch, step)


def device_busy(torch, fn, top: int = 8):
    """Run ``fn()`` under the profiler; returns (busy_ms, wall_ms, by
    kernel): the time in which the card ran at least one kernel or copy
    (the union of the device-side events, so overlapping streams count
    once), the host wall time of the window, which ends in a
    synchronize, and the ``top`` device kernels by summed time as
    ``[name, ms, launches]``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name[:90], (0.0, 0))
        by_name[e.name[:90]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return busy / 1e3, wall, [[name, ms, n] for name, (ms, n) in ranked]


def bound(nbytes: int, ops: int, ops_per_s: float = FP32_OPS_PER_S):
    """(bound_ms, bound_by, bytes_ms, ops_ms) on the published peaks."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", t_bytes, t_ops)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def flash_main_layers(archs) -> dict:
    """The LM main path's attention layers: label -> (arch, (q heads, kv
    heads, head dim), window, launches a prefill)."""
    def kinds(cfg):
        return cfg.prologue + cfg.pattern * cfg.n_groups

    def heads(cfg):
        return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    gemma = archs["gemma3-4b"]
    layers = {"gemma3-4b global": ("gemma3-4b", heads(gemma), None,
                                   kinds(gemma).count("A")),
              "gemma3-4b local": ("gemma3-4b", heads(gemma), gemma.window,
                                  kinds(gemma).count("L"))}
    for arch in ("deepseek-moe-16b", "zamba2-2.7b"):
        cfg = archs[arch]
        label = arch + (" shared" if "S" in cfg.pattern else "")
        layers[label] = (arch, heads(cfg), None, sum(
            k in "ALS" for k in kinds(cfg)))
    return layers


def time_flash_fp32(torch, q, k, v, window) -> dict:
    """Flash's fp32 route (``FLASH_FP32_SOURCE``) at one causal layer, q, k
    and v fp32 (B,H,T,D) views: held at 2e-5 against its plain version and
    at 1e-4 against SDPA in fp32, then ``graph_ms`` of the kernel, the
    plain version and SDPA; the bound of its split TF32 and, beside it,
    that of fp32 FMA outside the tensor cores; SDPA's device kernels by
    name, from the profiler."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels.ref import attention_ref
    b, hq, t, d = q.shape
    qi = torch.arange(t, device=q.device)[:, None]
    kj = torch.arange(t, device=q.device)[None, :]
    mask = (kj <= qi) & ((qi - kj) < (window or t))

    def kernel():
        return flash_mod.flash_attention_cuda(q, k, v, window=window)

    def plain():
        return attention_ref(q, k, v, window=window)

    def library():
        if window is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    what = f"fp32 flash_attention {tuple(q.shape)} window {window}"
    o = kernel()
    err = compare(o, plain(), 2e-5, 2e-5, what)
    compare(library(), o, 1e-4, 1e-4, "library " + what)
    ops = 4 * b * hq * d * int(mask.sum())
    row = dict(q=list(q.shape), k=list(k.shape), dtype="float32",
               window=window, max_abs_err=err, ms=graph_ms(torch, kernel),
               plain_ms=graph_ms(torch, plain, reps=3),
               library_ms=graph_ms(torch, library),
               nbytes=nbytes(q, k, v, o), ops=ops,
               ops_rate=f"split TF32 on the tensor cores: "
                        f"{SPLIT_TF32_PRODUCTS} TF32 products a product at "
                        f"495 TFLOP/s")
    (row["bound_ms"], row["bound_by"], row["bytes_ms"],
     row["ops_ms"]) = bound(row["nbytes"], SPLIT_TF32_PRODUCTS * ops,
                            TF32_OPS_PER_S)
    row["fp32_fma_bound_ms"] = bound(row["nbytes"], ops, FP32_OPS_PER_S)[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        library()
        torch.cuda.synchronize()
    row["library_kernels"] = sorted({
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA})
    return row


def conv_instantiations(log):
    """Per conv2d kernel instantiation in ptxas's log: its type, taps
    ("runtime" where variable), output channels a thread holds,
    registers and spill-store bytes."""
    out, cur = [], None
    for ln in log:
        m = re.search(r"Compiling entry function '\S*conv2d_(?:tiled_kernelI"
                      r"(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)E|general_kernelI(f|13__nv_bfloat16)Li(\d+)E)",
                      ln)
        if "Compiling entry function" in ln:
            cur = None
        if m:
            dtype, kh, kw, sh, sw, c, g_dtype, g_c = m.groups()
            cur = dict(dtype="float32" if (dtype or g_dtype) == "f"
                       else "bfloat16",
                       taps=f"{kh}x{kw}/{sh}x{sw}" if kh else "runtime",
                       c=int(c or g_c))
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            cur["spill_bytes"] = int(re.search(r"(\d+) bytes spill stores",
                                               ln).group(1))
        elif cur is not None and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
    return out


def conv_layers(graph):
    """(in_shape, layer) of every Conv2D of an optimized graph."""
    from repro_torch.core.graph import Conv2D
    smap = graph.shape_map()
    return [(smap[l.inputs[0]], l) for l in graph.layers
            if isinstance(l, Conv2D)]


def pool_layers(graph):
    """(in_shape, layer) of every valid-padded MaxPool of a graph."""
    from repro_torch.core.graph import MaxPool
    smap = graph.shape_map()
    return [(smap[l.inputs[0]], l) for l in graph.layers
            if isinstance(l, MaxPool) and l.padding == "valid"]


def train_phases(torch, np, counts, reset_counts, launches) -> None:
    """Phases 16-19: the training slice on the card (see the module
    docstring).  ``launches`` gains the trained ball net's serving run."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs.cnn_paper import trained_ball_classifier
    from repro_torch.configs.lm_archs import ARCHS
    from repro_torch.core.tree import (leaves, leaves_with_paths, tree_map,
                                       unflatten)
    from repro_torch.data.pipeline import (TokenStreamConfig,
                                           ball_image_batch, token_batch)
    from repro_torch.engine import (CalibrationConfig, InferenceSession,
                                    SessionConfig)
    from repro_torch.kernels import conv2d as conv_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import linear_scan as scan_mod
    from repro_torch.kernels import maxpool2d as pool_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import flash_mha, local_mha, lm
    from repro_torch.models.stack import init_params
    from repro_torch.optim import AdamW, parity, warmup_cosine

    dev = torch.device("cuda:0")
    cpu = torch.device("cpu")
    zero = {name: 0 for name in counts()}

    # -- 17. train_grad --------------------------------------------------
    x = torch.rand(1, 8, 8, 4, device=dev, requires_grad=True)
    w, b = torch.rand(3, 3, 4, 4, device=dev), torch.zeros(4, device=dev)
    q = torch.rand(1, 2, 8, 32, device=dev, requires_grad=True)
    s = torch.rand(1, 8, 2, 4, device=dev, requires_grad=True)
    s0 = torch.zeros(1, 2, 4, 4, device=dev)
    refused = {}
    for name, call in (
            ("conv2d", lambda: conv_mod.conv2d_cuda(x, w, b)),
            ("maxpool2d", lambda: pool_mod.maxpool2d_cuda(x)),
            ("flash_attention",
             lambda: flash_mod.flash_attention_cuda(q, q, q)),
            ("linear_scan",
             lambda: scan_mod.linear_scan_cuda(s, s, s, s, s0))):
        try:
            call()
        except RuntimeError as e:  # the repair: no gradient through a kernel
            refused[name] = str(e)
        if name not in refused or "flash_jax" not in refused[name]:
            raise AssertionError(f"{name}: no refusal under grad")
    rng = np.random.default_rng(7)

    def attn_run(fn, arrays, do, device):
        ts = [torch.from_numpy(a).to(device).requires_grad_()
              for a in arrays]
        out = fn(*ts)
        out.backward(torch.from_numpy(do).to(device))
        return [a.detach().cpu() for a in [out] + [t.grad for t in ts]]

    attn_err = 0.0
    for case in TRAIN_FLASH_CASES + TRAIN_LOCAL_CASES:
        if len(case) == 9:
            b_, t, h, hkv, dh, causal, window, bq, bk = case

            def fn(q_, k_, v_, c=causal, wnd=window, bq=bq, bk=bk):
                return flash_mha(q_, k_, v_, c, wnd, None, bq, bk)
        else:
            b_, t, h, hkv, dh, window, bq = case

            def fn(q_, k_, v_, wnd=window, bq=bq):
                return local_mha(q_, k_, v_, wnd, None, bq)
        arrays = [(rng.normal(size=sh) * 0.5).astype(np.float32)
                  for sh in ((b_, t, h, dh), (b_, t, hkv, dh),
                             (b_, t, hkv, dh))]
        do = (rng.normal(size=(b_, t, h, dh)) * 0.5).astype(np.float32)
        for got, want, what in zip(attn_run(fn, arrays, do, dev),
                                   attn_run(fn, arrays, do, cpu),
                                   ("o", "dq", "dk", "dv")):
            attn_err = max(attn_err, compare(got, want, 1e-4, 1e-5,
                                             f"train_grad {case} {what}"))
    emit("train_grad", refused=sorted(refused),
         message=refused["flash_attention"],
         flash_cases=len(TRAIN_FLASH_CASES),
         local_cases=len(TRAIN_LOCAL_CASES), rtol=1e-4, atol=1e-5,
         max_abs_err=attn_err)

    # -- 18. train_ball --------------------------------------------------
    five = [trained_ball_classifier(5, seed=0, eval_n=200, device=d)[0]
            for d in (dev, cpu)]
    ball_err = 0.0
    for lc, lp in zip(five[0].layers, five[1].layers):
        if getattr(lc, "weights", None) is not None:
            for a, b_ in ((lc.weights, lp.weights), (lc.bias, lp.bias)):
                ball_err = max(ball_err, compare(
                    torch.from_numpy(a), torch.from_numpy(b_), 1e-4, 1e-5,
                    f"ball trainer after 5 steps, {lc.name}"))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained, acc = trained_ball_classifier(150, seed=0)
    torch.cuda.synchronize()
    ball_s = time.perf_counter() - t0
    ball_launches = counts()
    if ball_launches != zero:
        raise AssertionError(f"the ball trainer launched {ball_launches}")
    if not acc >= 0.97:
        raise AssertionError(f"trained ball net accuracy {acc} < 0.97")
    xs, ys = ball_image_batch(2000, seed=99, step=0)
    plain = InferenceSession(trained, config=SessionConfig(backend="torch"))
    want = plain.predict(xs)
    reset_counts()
    sess = InferenceSession(trained, config=SessionConfig(backend="cuda"))
    got = sess.predict(xs)
    torch.cuda.synchronize()
    launches["train_ball serve"] = counts()
    serve_err = compare(torch.from_numpy(got), torch.from_numpy(want), 1e-4,
                        1e-5, "trained ball net, cuda vs torch")

    def top1(p):
        return np.argmax(p.reshape(len(p), -1), -1)

    qsess = InferenceSession(trained, config=SessionConfig(
        backend="torch", precision="int8",
        calibration=CalibrationConfig(data=xs[:64], method="percentile")))
    facc = float((top1(got) == ys).mean())
    qacc = float((top1(qsess.predict(xs)) == ys).mean())
    if not qacc >= facc - 0.02:
        raise AssertionError(f"int8 accuracy {qacc} < float {facc} - 0.02")
    emit("train_ball", steps=150, batch=64, seconds=ball_s,
         seconds_per_step=ball_s / 150, accuracy=acc,
         five_steps_vs_cpu_max_abs_err=ball_err, train_launches=ball_launches,
         serve_frames=len(xs), serve_max_abs_err=serve_err,
         serve_launches=launches["train_ball serve"], float_accuracy=facc,
         int8_accuracy=qacc,
         int8_top1_agreement=float((top1(qsess.predict(xs))
                                    == top1(got)).mean()))

    # -- 19. train_lm ----------------------------------------------------
    cfg = train_mod.LM_100M
    tc = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=0)
    host_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = AdamW(learning_rate=warmup_cosine(3e-4, 20, TRAIN_STEPS))
    step_fn = lm.make_train_step(cfg, opt)

    def start_state(device):
        p = tree_map(lambda a: a.to(device, copy=True), host_params)
        return (p, opt.init(p),
                torch.zeros((), dtype=torch.int32, device=device))

    def batch_on(i, device):
        return {k: torch.from_numpy(v).to(device)
                for k, v in token_batch(tc, i).items()}

    three = []
    for d in (dev, cpu):
        st, ms = start_state(d), []
        for i in range(3):
            st, m = step_fn(st, batch_on(i, d))
            ms.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        three.append(ms)
        del st
    for mc, mp in zip(*three):
        for k in mc:
            if abs(mc[k] - mp[k]) > 1e-4 * abs(mp[k]):
                raise AssertionError(f"lm-100m {k}: card {mc[k]} vs cpu "
                                     f"{mp[k]}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        out = train_mod.main(
            ["--arch", "lm-100m", "--steps", str(TRAIN_STEPS), "--batch",
             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-every", "100",
             "--log-every", "50", "--ckpt-dir", f"{tmp}/lm", "--device",
             "cuda"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        lm_launches = counts()
        if lm_launches != zero:
            raise AssertionError(f"lm-100m training launched {lm_launches}")
        if not out["last_loss"] < out["first_loss"]:
            raise AssertionError(f"lm-100m loss did not fall: {out}")
        if latest_step(f"{tmp}/lm") != TRAIN_STEPS:
            raise AssertionError("no final checkpoint")

    # the step alone: 5 warm-up steps, 20 timed, 10 profiled
    st = start_state(dev)
    batches = [batch_on(i, dev) for i in range(35)]
    for i in range(5):
        st, _ = step_fn(st, batches[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(5, 25):
        st, m = step_fn(st, batches[i])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 20
    peak = torch.cuda.max_memory_allocated()
    holder = [st]

    def ten():
        for i in range(25, 35):
            holder[0], _ = step_fn(holder[0], batches[i])
    busy_ms, wall_ms, top = device_busy(torch, ten, top=10)
    del st, holder, batches
    torch.cuda.empty_cache()
    # the attention of one layer, forward and the hand-written backward,
    # at the step's shape: its share of the step
    qkv = [torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.head_dim,
                       device=dev, requires_grad=True) for _ in range(3)]
    do = torch.randn_like(qkv[0])

    def attn_step():
        torch.autograd.backward(flash_mha(*qkv, True, None, None, 512, 512),
                                do)
    attn_ms = events_ms(torch, attn_step, trials=10)

    # preempt at 4 and resume, against a straight 6-step run
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--arch", "lm-100m", "--steps", "6", "--batch", "2",
                  "--seq", "32", "--ckpt-every", "2", "--log-every", "1",
                  "--device", "cuda"]
        try:
            train_mod.main(common + ["--ckpt-dir", f"{tmp}/a",
                                     "--preempt-at", "4"])
        except SystemExit as e:  # the simulated preemption
            if e.code != 17:
                raise
        else:
            raise AssertionError("--preempt-at 4 did not exit")
        if latest_step(f"{tmp}/a") != 4:
            raise AssertionError("no checkpoint at the preemption")
        train_mod.main(common + ["--ckpt-dir", f"{tmp}/a"])
        train_mod.main(common + ["--ckpt-dir", f"{tmp}/b"])
        za, zb = (np.load(f"{tmp}/{d}/step_6/arrays.npz") for d in "ab")
        if sorted(za.files) != sorted(zb.files):
            raise AssertionError("resumed and straight keys differ")
        resume_err = max(compare(torch.from_numpy(za[k]),
                                 torch.from_numpy(zb[k]), 1e-5, 1e-6,
                                 f"resumed vs straight {k}")
                         for k in za.files)
        resume_equal = all(np.array_equal(za[k], zb[k]) for k in za.files)
        n_arrays = len(za.files)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit("train_lm", arch=cfg.name, params=out["params"], dtype=cfg.dtype,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
         first_loss=out["first_loss"], last_loss=out["last_loss"],
         main_seconds=run_s, main_seconds_per_step=run_s / TRAIN_STEPS,
         seconds_per_step=step_s, tokens_per_s=tokens / step_s,
         peak_memory_gb=peak / 1e9,
         attention_fwd_bwd_ms_per_layer=attn_ms,
         attention_share_of_step=attn_ms * cfg.n_layers / (step_s * 1e3),
         profiled_steps=10,
         profiled_wall_ms=wall_ms, profiled_device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms, top_device_kernels=top,
         first_steps_card_vs_cpu={"card": three[0], "cpu": three[1]},
         launches=lm_launches, resume_arrays=n_arrays,
         resume_max_abs_err=resume_err, resume_bit_equal=resume_equal)

    # -- 20. train_smoke -------------------------------------------------
    smoke = {}
    for arch, accum in TRAIN_SMOKE:
        scfg = dataclasses.replace(ARCHS[arch].smoke(), remat="full",
                                   grad_accum=accum)
        sopt = AdamW(learning_rate=warmup_cosine(1e-3, 1, 10))
        sstep = lm.make_train_step(scfg, sopt)
        host = init_params(scfg, torch.Generator().manual_seed(1), "cpu")
        brng = np.random.default_rng(3)
        bs = []
        for _ in range(2):
            t = 80 if "R" in scfg.pattern else 32
            nb = {"tokens": brng.integers(0, scfg.vocab_size, (2, t)),
                  "labels": brng.integers(0, scfg.vocab_size, (2, t))}
            if scfg.mrope_sections is not None:
                nb["positions3"] = (np.arange(t)[None, None]
                                    + brng.integers(0, 3, (3, 2, 1)))
            bs.append(nb)
        # both devices in lockstep from one set of weights; before each
        # step, the elements where Adam amplifies the two devices'
        # gradient difference (optim.parity) are marked from the CPU's
        # state
        marks, states, ms = {}, [], ([], [])
        for d in (dev, cpu):
            p = tree_map(lambda a, d=d: a.to(d, copy=True), host)
            states.append((p, sopt.init(p),
                           torch.zeros((), dtype=torch.int32, device=d)))
        gcfg = dataclasses.replace(scfg, grad_accum=1)
        grad_err = 0.0
        for n_step, nb in enumerate(bs):
            gs, before = [], tree_map(lambda a: a.clone(), states[1][:2])
            for i, d in enumerate((dev, cpu)):
                tb = {k: torch.from_numpy(v).to(d) for k, v in nb.items()}
                live = [a.detach().requires_grad_()
                        for a in leaves(states[i][0])]
                loss, _ = lm.loss_fn(unflatten(states[i][0], live), gcfg, tb)
                gs.append(unflatten(states[i][0], [
                    g.cpu() for g in torch.autograd.grad(loss, live)]))
                states[i], m = sstep(states[i], tb)
                ms[i].append({k: float(m[k]) for k in ("loss", "grad_norm")})
            for (k, a), (_, b_) in zip(leaves_with_paths(gs[0]),
                                       leaves_with_paths(gs[1])):
                if n_step == 0:  # from the same weights
                    grad_err = max(grad_err, compare(
                        a, b_, 1e-4, 1e-5, f"{arch} smoke grad {k}"))
            parity.mark_amplified(sopt, before[1], before[0], gs[0], gs[1],
                                  marks, 1e-5)
        runs = [(ms[i], {k: v.cpu().numpy()
                         for k, v in leaves_with_paths(states[i][0])})
                for i in range(2)]
        for mc, mp in zip(runs[0][0], runs[1][0]):
            for k in mc:
                if abs(mc[k] - mp[k]) > 1e-5 + 1e-4 * abs(mp[k]):
                    raise AssertionError(f"{arch} smoke {k}: card {mc[k]} "
                                         f"vs cpu {mp[k]}")
        held = parity.hold_params(
            runs[0][1], runs[1][1], marks,
            parity.adam_step_bound(2e-3, 0.1, 1.0), 1e-4, 1e-5)
        smoke[arch] = dict(remat=scfg.remat, grad_accum=accum,
                           metrics=runs[0][0], grad_max_abs_err=grad_err,
                           **held)
    emit("train_smoke", steps=2, rtol=1e-4, atol=1e-5, archs=smoke)


def run_dryrun() -> dict:
    """The dry-run of ``DRYRUN_CELL`` on the production mesh, in a
    process of its own that sees no card, run after the timed phases so
    that its CPU work overlaps none of them.  Its record (it must
    succeed, with the attention ``DRYRUN_ATTN``): the dense layers'
    rules, the mesh, axes, FLOPs, rank 0's argument bytes, the
    collectives and the seconds."""
    arch, shape = DRYRUN_CELL
    with tempfile.TemporaryDirectory() as out_dir:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out_dir], cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                 "CUDA_VISIBLE_DEVICES": ""},
            capture_output=True, text=True, timeout=900)
        path = Path(out_dir) / f"{arch}__{shape}__pod.json"
        if proc.returncode != 0 or not path.exists():
            raise AssertionError(f"the dry-run failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        r = json.loads(path.read_text())
    if not r["ok"] or not r["full"]["flops"] > 0 or \
            not r["full"]["collectives"]["total_bytes"] > 0 or \
            r["full"]["dense"].get("attn") != DRYRUN_ATTN:
        raise AssertionError(f"the dry-run's record: {r}")
    return {"dense": r["full"]["dense"],
            **{k: r[k] for k in ("arch", "shape", "mesh", "axes", "full",
                                 "total_s")}}


def launch_rest(torch, np, counts, reset_counts) -> dict:
    """Phase 20 past the meshed sessions (see the module docstring): the
    meshed lm-100m train step against the unmeshed one, the collectives
    and ``compress_allreduce`` over NCCL against the CPU, and
    ``restore(shardings=)`` onto the card's mesh."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint import restore, save
    from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
    from repro_torch.data.pipeline import TokenStreamConfig, token_batch
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.collectives import Collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import MeshPar, to_named
    from repro_torch.models import lm
    from repro_torch.models.stack import init_params
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.optim.compress import compress_allreduce

    dev = torch.device("cuda:0")
    mesh = make_mesh((1, 1))
    out = {"backend": dist.get_backend(), "world_size": dist.get_world_size()}

    # the meshed lm-100m train step: 3 steps, bit for bit the unmeshed ones
    cfg = train_mod.LM_100M
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = AdamW(learning_rate=warmup_cosine(3e-4, 20, TRAIN_STEPS))
    par = MeshPar(mesh, cfg)
    tc = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=0)
    p0 = tree_map(lambda a: a.to(dev, copy=True), host)
    p1 = par.place_params(tree_map(lambda a: a.to(dev, copy=True), host))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    states = {"unmeshed": (p0, opt.init(p0), zero.clone()),
              "meshed": (p1, par.init_optimizer(opt, p1), zero.clone())}
    steps = {"unmeshed": lm.make_train_step(cfg, opt),
             "meshed": lm.make_train_step(cfg, opt, par=par)}
    metrics, secs = {k: [] for k in steps}, {k: [] for k in steps}
    reset_counts()
    for i in range(3):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in token_batch(tc, i).items()}
        for name, fn in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[name], m = fn(states[name], batch)
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
            metrics[name].append({k: float(v) for k, v in m.items()})
    train_launches = counts()
    whole = {name: [t.to_local() if hasattr(t, "to_local") else t
                    for t in leaves(states[name][:2])] for name in states}
    equal = all(torch.equal(a, b) for a, b in zip(whole["unmeshed"],
                                                  whole["meshed"]))
    if not equal or metrics["unmeshed"] != metrics["meshed"]:
        raise AssertionError("the meshed lm-100m steps differ from the "
                             "unmeshed ones")
    if any(train_launches.values()):
        raise AssertionError(f"lm-100m training launched {train_launches}")
    out["train_lm"] = dict(
        arch=cfg.name, steps=3, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        bit_equal=True, metrics=metrics["meshed"],
        activations=par.describe()["activations"],
        logits=par.describe()["logits"],
        step_s={k: v for k, v in secs.items()},
        collectives=par.coll.summary(), launches=train_launches)
    del states, p0, p1
    torch.cuda.empty_cache()

    # the wrappers over NCCL on one rank keep their values; then the int8
    # compressed all-reduce against the CPU's round trip, bit for bit
    coll = Collectives(mesh)
    x = torch.randn(6, 8, device=dev)
    for name, y in (("all_reduce", coll.all_reduce(x, "data")),
                    ("all_gather", coll.all_gather(x, "model", 1)),
                    ("reduce_scatter", coll.reduce_scatter(x, "model", 0)),
                    ("all_to_all", coll.all_to_all(x, "model", 0, 1))):
        if not torch.equal(y, x):
            raise AssertionError(f"NCCL {name} on one rank changed values")
    rng = np.random.default_rng(9)
    host_g = [{"w": torch.from_numpy(rng.normal(size=(1 << 20,)).astype(
        np.float32)), "m": torch.from_numpy((rng.normal(size=(64, 48))
                                             * 1e-3).astype(np.float32)),
        "z": torch.zeros(8)} for _ in range(2)]
    res_d = res_c = None
    group = coll.on("data")
    for g in host_g:
        got, res_d = compress_allreduce(tree_map(lambda a: a.to(dev), g),
                                        res_d, group=group)
        want, res_c = compress_allreduce(g, res_c)
        for a, b in zip(leaves((got, res_d)), leaves((want, res_c))):
            if not torch.equal(a.cpu(), b):
                raise AssertionError("compress_allreduce over NCCL differs "
                                     "from the CPU round trip")
    out["collectives"] = dict(wrappers_equal=True, compress_bit_equal=True,
                              compress_steps=len(host_g),
                              counts=coll.summary())

    # an elastic restore: lm-100m's parameters written from the CPU,
    # restored onto the card's mesh as DTensors, bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        save(tmp, 1, {"params": host})
        like = {"params": init_params(cfg, device="meta")}
        shardings = {"params": to_named(mesh, par.param_specs(
            like["params"]), like["params"])}
        t0 = time.perf_counter()
        got = restore(tmp, 1, like, shardings=shardings)
        restore_s = time.perf_counter() - t0
    ok = all(type(v).__name__ == "DTensor" and v.device.type == "cuda"
             and torch.equal(v.full_tensor().cpu(), h)
             for (_, v), h in zip(leaves_with_paths(got), leaves(
                 {"params": host})))
    if not ok:
        raise AssertionError("restore(shardings=) onto the card's mesh "
                             "differs from what was saved")
    out["restore"] = dict(arch=cfg.name, leaves=len(leaves(got)),
                          bit_equal=True, on=str(dev), seconds=restore_s)
    return out


def host_cpu() -> dict:
    """The host's CPU as the first processor of ``/proc/cpuinfo`` names
    it: ``model name``, and vendor, family, model and stepping (a
    virtual machine may report its model name as "unknown"), and its
    AVX-512 flags."""
    first = Path("/proc/cpuinfo").read_text().split("\n\n")[0]
    info = {}
    for line in first.splitlines():
        key, _, value = line.partition(":")
        info[key.strip()] = value.strip()
    return dict(cpu_model=info.get("model name", "unknown"),
                cpu_id=" ".join(f"{k}={info.get(k, '?')}" for k in (
                    "vendor_id", "cpu family", "model", "stepping")),
                avx512_flags=sorted(f for f in info.get("flags", "").split()
                                    if f.startswith("avx512")))


def cgen_phase(torch, np, nets, sessions, main_batch, smi, counts,
               reset_counts, launches) -> None:
    """Phase 9: the C sessions of every net in fp32 and int8 on the host,
    held to the card's sessions on the same camera frames, timed at
    batch 1 beside them, and served."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core import runtime
    from repro_torch.data.pipeline import camera_frame_batch
    from repro_torch.engine import (CalibrationConfig, InferenceSession,
                                    SessionConfig)
    from repro_torch.serve import InferenceServer, ServerConfig

    t_phase = time.perf_counter()
    host = dict(**host_cpu(), cpu_count=os.cpu_count(),
                cc=runtime.cc_fingerprint(), best_isa=runtime.best_isa(),
                int8_simds=runtime.supported_int8_simds())
    simd32, simd8 = runtime.best_isa(), runtime.supported_int8_simds()[0]
    before = dict(runtime.COMPILE_STATS)

    def build(key):
        name, precision = key
        return InferenceSession(nets[name](0), config=SessionConfig(
            backend="c", precision=precision,
            simd=simd32 if precision == "fp32" else simd8))

    # one cc -O3 a net and precision, all started together
    reset_counts()
    t0 = time.perf_counter()
    keys = [(name, p) for name in main_batch for p in ("fp32", "int8")]
    with ThreadPoolExecutor(max_workers=len(keys)) as ex:
        c_sess = dict(zip(keys, ex.map(build, keys)))
    build_s = time.perf_counter() - t0
    out, c_launches, cuda_launches = {}, {}, {}
    for name, batch in main_batch.items():
        c32, c8 = c_sess[name, "fp32"], c_sess[name, "int8"]
        frames = camera_frame_batch(batch, tuple(c32.input_shape), seed=21)
        reset_counts()
        got32, got8 = c32.predict(frames), c8.predict(frames)
        lat32 = c32.benchmark(frames[0])
        lat8 = c8.benchmark(frames[0])
        torch.cuda.synchronize()
        c_launches[name] = counts()
        if any(c_launches[name].values()):
            raise AssertionError(f"the C sessions of {name} launched "
                                 f"{c_launches[name]}")
        for got, sess in ((got32, c32), (got8, c8)):
            if not (got.shape == (batch,) + tuple(sess.output_shape)
                    and np.isfinite(got).all()):
                raise AssertionError(f"{name} C output {got.shape}")
        # the card's sessions: the "cuda" session of phase 5, and the
        # int8 reference on the card from the C session's quantized graph
        card8 = InferenceSession(nets[name](0), config=SessionConfig(
            backend="torch", precision="int8",
            calibration=CalibrationConfig(qparams={
                n: (qp.scale, qp.zero_point)
                for n, qp in c8.qgraph.acts.items()})))
        q_c, q_card = c8.qgraph, card8.qgraph
        if not (q_card.acts == q_c.acts and sorted(q_card.weights)
                == sorted(q_c.weights) and all(
                    np.array_equal(getattr(q_card.weights[n], f),
                                   getattr(q_c.weights[n], f))
                    for n in q_c.weights for f in ("w_scale", "w_q", "b_q"))):
            raise AssertionError(f"{name}: the card's int8 graph is not "
                                 f"the C session's")
        cuda_sess = sessions[name][0]
        reset_counts()
        want32 = cuda_sess.predict(frames)
        lat_cuda = cuda_sess.benchmark(frames[0], iters=200, warmup=20)
        torch.cuda.synchronize()
        got_cuda = counts()
        cuda_launches = {k: cuda_launches.get(k, 0) + v
                         for k, v in got_cuda.items()}
        want8 = card8.predict(frames)
        err32 = compare(torch.from_numpy(got32), torch.from_numpy(want32),
                        1e-3, 1e-5, f"{name} C fp32 vs cuda")
        if name == "robot":
            if not np.array_equal(got8, want8):
                raise AssertionError(
                    f"int8 C robot differs from the card's int8 reference "
                    f"on {int((got8 != want8).sum())} of {got8.size}")
            err8 = 0.0
        else:
            err8 = compare(torch.from_numpy(got8), torch.from_numpy(want8),
                           1e-5, 1e-6, f"{name} C int8 vs card int8")
            top = (got8.reshape(batch, -1).argmax(-1),
                   want8.reshape(batch, -1).argmax(-1))
            if not (top[0] == top[1]).all():
                raise AssertionError(f"{name} int8 C argmax differs")
        out[name] = dict(
            batch=batch,
            fp32=dict(simd_requested=simd32, simd=c32.simd,
                      c_source_bytes=c32.info["c_source_bytes"],
                      arena_bytes=c32.info["arena_bytes"],
                      schedule_digest=c32.info["schedule_digest"],
                      max_abs_err_vs_cuda=err32, latency_us_b1=lat32),
            int8=dict(simd_requested=simd8, simd=c8.simd,
                      c_source_bytes=c8.info["c_source_bytes"],
                      arena_bytes=c8.info["arena_bytes"],
                      schedule_digest=c8.info["schedule_digest"],
                      calibration_method=c8.qgraph.method,
                      max_abs_err_vs_card_int8=err8,
                      bit_equal=bool(np.array_equal(got8, want8)),
                      latency_us_b1=lat8),
            cuda=dict(latency_us_b1=lat_cuda, launches=got_cuda),
            c_fp32_over_cuda_b1=lat32 / lat_cuda,
            c_int8_over_cuda_b1=lat8 / lat_cuda)
        del card8

    robot = c_sess["robot", "fp32"]
    frames = camera_frame_batch(256, tuple(robot.input_shape), seed=22)
    reset_counts()
    t0 = time.perf_counter()
    with InferenceServer(robot, config=ServerConfig(
            workers=2, max_batch=32)) as srv:
        handles = [srv.submit(f) for f in frames]
        outs = [h.result(timeout=120) for h in handles]
        st = srv.stats()
    serve_s = time.perf_counter() - t0
    assert st["completed"] == len(frames), st
    assert st["failed"] == st["timeouts"] == 0, st
    for i, (o, f) in enumerate(zip(outs, frames)):
        if not np.array_equal(o, robot.predict(f)):
            raise AssertionError(f"C served frame {i} differs from "
                                 f"session.predict")
    serve_launches = counts()
    if any(serve_launches.values()):
        raise AssertionError(f"the C server launched {serve_launches}")
    launches["cgen"] = cuda_launches  # the "cuda" sessions' runs only
    emit("cgen", nvidia_smi=smi, host=host, build_s=build_s,
         cc_invocations=runtime.COMPILE_STATS["cc_invocations"]
         - before["cc_invocations"],
         so_cache_hits=runtime.COMPILE_STATS["so_cache_hits"]
         - before["so_cache_hits"],
         nets=out, c_launches=c_launches, cuda_launches=cuda_launches,
         tolerance={"fp32_vs_cuda": {"rtol": 1e-3, "atol": 1e-5},
                    "int8_vs_card_int8": {"robot": "bit for bit",
                                          "softmax sinks": {
                                              "rtol": 1e-5, "atol": 1e-6,
                                              "argmax": "equal"}}},
         serve=dict(net="robot", precision="fp32", frames=len(frames),
                    served_bit_equal=True, serve_s=serve_s, qps=st["qps"],
                    latency_p50_us=st["latency_p50_us"],
                    latency_p99_us=st["latency_p99_us"],
                    batch_size_mean=st["batch_size_mean"],
                    launches=serve_launches),
         seconds=time.perf_counter() - t_phase)
    for sess in c_sess.values():
        sess.close()
    c_tool_gates(torch, np, smi, counts, reset_counts)


def load_tool(name: str):
    """A script of ``tools/`` loaded as a module by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def c_tool_gates(torch, np, smi, counts, reset_counts) -> None:
    """Phase 9's gates on the card's host: the strict ANSI C89 compile
    of ``strict_c89_torch``'s cases, then ``cross_check_torch``'s nets
    built, run and held bit for bit to ``forward_quantized`` on the
    card (the ARM lanes too where their toolchain exists)."""
    import platform

    strict = load_tool("strict_c89_torch")
    cross = load_tool("cross_check_torch")
    cc = strict.find_cc()
    if cc is None:
        raise AssertionError("strict_c89: no C compiler on the card's host")
    cc_version = subprocess.run([cc, "--version"], capture_output=True,
                                text=True, timeout=60).stdout.splitlines()[0]
    reset_counts()
    t0 = time.perf_counter()
    cases = []
    with tempfile.TemporaryDirectory() as tmp:
        for tag, nbytes, proc in strict.run_cases(cc, "cuda:0", tmp):
            if proc.returncode != 0:
                raise AssertionError(f"strict_c89: {tag}: FAILED\n"
                                     f"{proc.stderr[:4000]}")
            cases.append(dict(tag=tag, source_bytes=nbytes, result="OK"))
    strict_s = time.perf_counter() - t0
    if [c["tag"] for c in cases] != [c[0] for c in strict.CASES]:
        raise AssertionError(f"strict_c89 ran {cases}")
    strict_launches = counts()
    emit("strict_c89", nvidia_smi=smi, cc=cc, cc_version=cc_version,
         flags=strict.STRICT_FLAGS, int8_calibration_device="cuda:0",
         cases=cases, ok=f"{len(cases)}/{len(strict.CASES)}",
         launches=strict_launches, seconds=strict_s)

    arm_cc, qemu = cross.find_toolchain()
    host = platform.machine()
    reset_counts()
    t0 = time.perf_counter()
    lanes = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, g0 in cross.nets().items():
            _, qg, xs = cross.prepare(name, g0)
            runs = [dict(cc=cc, run=[], variants=["generic"], link=(),
                         arch=host)]
            if arm_cc and qemu:
                runs.append(dict(cc=arm_cc, run=[qemu, "-cpu", "max"],
                                 variants=cross.ARM_VARIANTS))
            for kw in runs:
                for tag, ok, msg in cross.check_net(
                        name, qg, xs, tmp=tmp, device="cuda:0", **kw):
                    if not ok:
                        raise AssertionError(msg)
                    lanes.append(dict(tag=tag, result=msg.split(": ", 2)[2]))
    cross_s = time.perf_counter() - t0
    cross_launches = counts()
    if any(strict_launches.values()) or any(cross_launches.values()):
        raise AssertionError(f"the C gates launched {strict_launches} "
                             f"{cross_launches}")
    emit("cross_check", nvidia_smi=smi, host_lane=dict(
        cc=cc, arch=host, variants=["generic"], oracle=(
            "forward_quantized on cuda:0, bit for bit")),
         lanes=lanes, arm_lanes="ran" if arm_cc and qemu
         else "toolchain missing", arm_cc=arm_cc, qemu=qemu,
         launches=cross_launches, seconds=cross_s)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.cnn_paper import EXTRA_CNNS, PAPER_CNNS
    from repro_torch.core import passes
    from repro_torch.core.graph import pool_window_counts
    from repro_torch.engine import InferenceSession, SessionConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d as conv_mod
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import linear_scan as scan_mod
    from repro_torch.kernels import maxpool2d as pool_mod
    from repro_torch.kernels.cases import (BIG_CONV_CASES, EDGE_CONV_CASES,
                                           EDGE_POOL_CASES, conv_tol)
    from repro_torch.kernels.ref import conv2d_ref, maxpool2d_ref
    from repro_torch.serve import InferenceServer, ServerConfig

    dev = torch.device("cuda:0")
    nets = {**PAPER_CNNS, **EXTRA_CNNS}
    main_batch = {"robot": 64, "ball": 8, "pedestrian": 8, "residual": 8}
    rng = np.random.default_rng(0)

    def rand(shape, dtype=torch.float32, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    # counter -> (module, attribute); flash_attention counts both routes,
    # flash_attention_f32 its fp32 route (csrc/flash_attention.cu) apart
    counted = {"conv2d": (conv_mod, "launches"),
               "maxpool2d": (pool_mod, "launches"),
               "flash_attention": (flash_mod, "launches"),
               "flash_attention_f32": (flash_mod, "launches_f32"),
               "linear_scan": (scan_mod, "launches"),
               "decode_attention": (decode_mod, "launches")}

    def counts():
        return {name: getattr(mod, attr)
                for name, (mod, attr) in counted.items()}

    def reset_counts():
        for mod, attr in counted.values():
            setattr(mod, attr, 0)

    # -- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    so = build.build()
    build.kernel_library()
    log = so.with_suffix(".log").read_text().splitlines()
    conv_inst = conv_instantiations(log)
    robot_inst = [i for i in conv_inst
                  if i["dtype"] == "float32" and i["taps"] == "3x3/1x1"]
    if not robot_inst or any(i["spill_bytes"] for i in robot_inst):
        raise AssertionError(f"conv2d's 3x3 fp32 instantiations (the "
                             f"robot's) spill or are missing: {robot_inst}")
    emit("build", seconds=time.perf_counter() - t0,
         library=str(so.relative_to(ROOT)),
         conv2d_instantiations=conv_inst,
         ptxas=[ln.strip() for ln in log
                if "Function properties for" in ln or "registers" in ln
                or "spill" in ln])

    # -- 3. kernels against their plain versions -------------------------
    opt = {name: passes.optimize(f(0), simd_multiple=4)
           for name, f in nets.items()}
    conv_cases = [  # (n, h, w, ci, co, kh, kw, stride, padding, act)
        (1, 16, 16, 1, 8, 5, 5, 2, "same", "relu"),
        (2, 9, 7, 3, 4, 3, 3, 1, "same", "leaky_relu"),
        (1, 8, 8, 8, 12, 3, 3, 1, "valid", None),
        (2, 6, 6, 4, 16, 2, 2, 2, "valid", "relu"),
        (1, 12, 10, 2, 6, 1, 1, 1, "valid", None),
        (1, 60, 80, 3, 8, 3, 3, 1, "same", "leaky_relu"),
        (3, 7, 5, 5, 300, 3, 3, 1, "same", "relu"),  # c_out % 256 != 0
    ] + EDGE_CONV_CASES + BIG_CONV_CASES
    pool_cases = [((1, 8, 8, 8), (2, 2), None),
                  ((2, 9, 9, 4), (3, 3), (2, 2)),
                  ((1, 16, 8, 12), (2, 2), (2, 2))] + EDGE_POOL_CASES
    for name, g in opt.items():
        n = main_batch[name]
        for (h, w, ci), l in conv_layers(g):
            act = l.activation if l.activation != "softmax" else None
            conv_cases.append((n, h, w, ci, l.c_out, l.kh, l.kw,
                               l.strides[0], l.padding, act))
        for (h, w, c), l in pool_layers(g):
            pool_cases.append(((n, h, w, c), l.size, l.strides))
    err = {"conv2d": 0.0, "maxpool2d": 0.0}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        for case in conv_cases:
            n, h, w, ci, co, kh, kw, st, pad, act = case
            x = rand((n, h, w, ci), dtype)
            wt = rand((kh, kw, ci, co), dtype, 0.2)
            b = rand((co,))
            kw_args = dict(strides=(st, st), padding=pad, act=act)
            what = f"conv2d {dtype} {(n, h, w, ci, co, kh, kw, st)}"
            y = conv_mod.conv2d_cuda(x, wt, b, **kw_args)
            # the wide and deep shapes: an fp32 atol that grows as K
            k_atol = (conv_tol(kh, kw, ci)[1] if case in BIG_CONV_CASES
                      else 1e-5)
            e = compare(y, conv2d_ref(x, wt, b, **kw_args), tol,
                        max(tol, k_atol), what)
            if dtype == torch.float32:
                err["conv2d"] = max(err["conv2d"], e)
            else:
                compare(y.float(), conv2d_ref(x.float(), wt.float(), b,
                                              **kw_args),
                        BF16_ROUND_RTOL, max(BF16_ROUND_ATOL, k_atol),
                        what + " vs fp32")
        for shape, size, stride in pool_cases:
            x = rand(shape, dtype)
            e = compare(pool_mod.maxpool2d_cuda(x, size=size, strides=stride),
                        maxpool2d_ref(x, size=size, strides=stride), 0.0, 0.0,
                        f"maxpool2d {dtype} {shape} {size} {stride}")
            err["maxpool2d"] = max(err["maxpool2d"], e)
        # a view 4 bytes off 16-byte alignment (narrower vectors), and
        # NaNs inside a vector (channel 5 of 8) on a compiled and the
        # runtime window: NaN exactly where the plain version has NaN
        flat = rand((2 * 6 * 8 * 8 + 2,), dtype)
        x = flat[4 // flat.element_size():][:2 * 6 * 8 * 8].view(2, 6, 8, 8)
        assert x.data_ptr() % 16 == 4
        compare(pool_mod.maxpool2d_cuda(x), maxpool2d_ref(x), 0.0, 0.0,
                f"maxpool2d {dtype} off alignment")
        x = rand((2, 7, 9, 8), dtype)
        x[0, 0, 0, 5] = x[1, 3, 4, 5] = float("nan")
        for size, stride in (((2, 2), None), ((2, 3), (1, 2))):
            got = pool_mod.maxpool2d_cuda(x, size=size, strides=stride)
            want = maxpool2d_ref(x, size=size, strides=stride)
            if not (bool(want.isnan().any()) and torch.equal(
                    got.isnan(), want.isnan()) and torch.equal(
                        got.nan_to_num(), want.nan_to_num())):
                raise AssertionError(f"maxpool2d {dtype} {size}: NaNs "
                                     f"differ from the plain version")
    torch.cuda.synchronize()
    emit("kernels", conv2d_cases=len(conv_cases), maxpool2d_cases=len(
        pool_cases) + 3, dtypes=["float32", "bfloat16"],
         tolerance={"conv2d": {"float32": 1e-5, "bfloat16": 3e-2,
                               "float32_wide_and_deep_atol":
                               "1e-5, above K 512 4 * 2**-24 * 0.2 * K",
                               "bfloat16_vs_fp32": {
                                   "rtol": BF16_ROUND_RTOL,
                                   "atol": BF16_ROUND_ATOL}},
                    "maxpool2d": 0.0},
         conv2d_big_plans=[dict(
             case=list(c[:9]), tile=[p.th, p.tw], col_tiles=p.col_tiles,
             chunks=[p.c_chunks, p.h_chunks, p.w_chunks], cot=p.cot,
             variant=p.variant, smem_bytes=p.smem_bytes)
             for c in BIG_CONV_CASES for p in [conv_mod.conv_plan(
                 *c[:7], (c[7], c[7]), c[8])]],
         max_abs_err_fp32=err)

    # -- 4. time at the robot detector's shapes, batch 256 ---------------
    def fp32_cudnn_ms(fn):
        """The library call's time with cuDNN in fp32 for that call only
        (the same function as the kernel's); the script is single-
        threaded here, and the switch returns to PyTorch's default."""
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return graph_ms(torch, fn)

    robot = opt["robot"]
    rows = {"conv2d": [], "maxpool2d": []}
    for (h, w, ci), l in conv_layers(robot):
        x = rand((BATCH, h, w, ci))
        wt = torch.from_numpy(l.weights).to(dev)
        b = torch.from_numpy(l.bias).to(dev)
        kw_args = dict(strides=l.strides, padding=l.padding,
                       act=l.activation, alpha=l.alpha)
        pt, pb, pl, pr = l.pad_amounts((h, w, ci))
        assert (pt, pl) == (pb, pr), "the library call takes symmetric pads"
        x_lib = x.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
        w_lib = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        y = conv_mod.conv2d_cuda(x, wt, b, **kw_args)
        e = compare(y, conv2d_ref(x, wt, b, **kw_args), 1e-5, 1e-5,
                    f"conv2d {l.name} at batch {BATCH}")
        err["conv2d"] = max(err["conv2d"], e)
        taps = int(pool_window_counts((h, w, ci), (l.kh, l.kw), l.strides,
                                      (pt, pb, pl, pr)).sum())
        plan = conv_mod.conv_plan(BATCH, h, w, ci, l.c_out, l.kh, l.kw,
                                  tuple(l.strides), l.padding)
        rows["conv2d"].append(dict(
            layer=l.name, x=list(x.shape), w=list(wt.shape),
            variant="x".join(map(str, conv_mod.TAP_VARIANTS[plan.variant]))
            if plan.variant else "runtime taps",
            tile=dict(c=plan.c, p=plan.p, cot=plan.cot, lanes=plan.lanes,
                      threads=plan.threads, th=plan.th, tw=plan.tw,
                      passes=plan.passes, chunks=plan.chunks,
                      grid=list(plan.grid), smem_bytes=plan.smem_bytes),
            ms=graph_ms(torch, lambda: conv_mod.conv2d_cuda(
                x, wt, b, **kw_args)),
            plain_ms=graph_ms(torch, lambda: conv2d_ref(x, wt, b, **kw_args)),
            library_ms=fp32_cudnn_ms(lambda: F.conv2d(
                x_lib, w_lib, b, stride=l.strides, padding=(pt, pl))),
            nbytes=nbytes(x, wt, b, y),
            ops=BATCH * (2 * taps * ci * l.c_out + y[0].numel())))
    for (h, w, c), l in pool_layers(robot):
        x = rand((BATCH, h, w, c))
        y = pool_mod.maxpool2d_cuda(x, size=l.size, strides=l.strides)
        compare(y, maxpool2d_ref(x, size=l.size, strides=l.strides), 0.0,
                0.0, f"maxpool2d {l.name} at batch {BATCH}")
        plan = pool_mod.pool_plan(BATCH, h, w, c, *l.size, *l.strides)
        # copies of x, together past twice the L2, for the cold readings
        xs = [x] + [x.clone() for _ in range(-(-COLD_BYTES // nbytes(x)) - 1)]

        def kernel(x_):
            return pool_mod.maxpool2d_cuda(x_, size=l.size, strides=l.strides)

        def plain(x_):
            return maxpool2d_ref(x_, size=l.size, strides=l.strides)

        def library(x_):
            return F.max_pool2d(x_.permute(0, 3, 1, 2), l.size, l.strides)

        rows["maxpool2d"].append(dict(
            layer=l.name, x=list(x.shape),
            plan=dict(variant="x".join(map(str, pool_mod.POOL_VARIANTS[
                plan.variant])) if plan.variant else "runtime taps",
                vec_bytes=plan.vec,
                block=list(plan.block), grid=list(plan.grid)),
            ms=graph_ms(torch, lambda: kernel(x)),
            plain_ms=graph_ms(torch, lambda: plain(x)),
            library_ms=graph_ms(torch, lambda: library(x)),
            cold_copies=len(xs),
            cold_ms=cold_graph_ms(torch, kernel, xs),
            plain_cold_ms=cold_graph_ms(torch, plain, xs),
            library_cold_ms=cold_graph_ms(torch, library, xs),
            nbytes=nbytes(x, y), ops=y.numel() * (l.size[0] * l.size[1] - 1)))
        del xs
    for kernel, rs in rows.items():
        for r in rs:
            (r["bound_ms"], r["bound_by"], r["bytes_ms"],
             r["ops_ms"]) = bound(r["nbytes"], r["ops"])
            emit("time", kernel=kernel, **r)

    # -- 5. the main path: sessions on the card --------------------------
    reset_counts()
    main_out, sessions = {}, {}
    tf32_before = torch.backends.cudnn.allow_tf32
    for name, batch in main_batch.items():
        sess = InferenceSession(nets[name](0),
                                config=SessionConfig(backend="cuda"))
        plain = InferenceSession(nets[name](0),
                                 config=SessionConfig(backend="torch"))
        frames = np.random.default_rng(7).normal(
            size=(batch,) + tuple(sess.input_shape)).astype(np.float32)
        got = sess.predict(frames)
        assert got.shape == (batch,) + tuple(sess.output_shape), got.shape
        main_out[name] = dict(batch=batch, shape=list(got.shape),
                              max_abs_err=compare(
                                  torch.from_numpy(got),
                                  torch.from_numpy(plain.predict(frames)),
                                  1e-4, 1e-5, f"{name} cuda vs torch"))
        sessions[name] = (sess, plain)
    cpu = InferenceSession(nets["robot"](0), config=SessionConfig(
        backend="torch", device="cpu"))
    frames = np.random.default_rng(7).normal(
        size=(4,) + tuple(cpu.input_shape)).astype(np.float32)
    main_out["robot"]["max_abs_err_vs_cpu"] = compare(
        torch.from_numpy(sessions["robot"][0].predict(frames)),
        torch.from_numpy(cpu.predict(frames)), 1e-4, 1e-5,
        "robot cuda vs cpu")
    torch.cuda.synchronize()
    launches = {"main": counts()}
    emit("main", nets=main_out, launches=launches["main"],
         cudnn_allow_tf32_before=tf32_before,
         cudnn_allow_tf32_after=torch.backends.cudnn.allow_tf32)

    # -- 6. end to end: the robot forward at batch 256 -------------------
    robot_sess, robot_plain = sessions["robot"]
    pair = {"cuda": robot_sess, "torch": robot_plain}
    frames = np.random.default_rng(13).normal(
        size=(BATCH,) + tuple(robot_sess.input_shape)).astype(np.float32)
    x = torch.from_numpy(frames).to(dev)
    reset_counts()
    fwd = {"cuda": [], "torch": []}
    e2e = {}
    with torch.inference_mode():
        for backend in ("torch", "cuda", "cuda", "torch"):
            mod = pair[backend].backend.module
            fwd[backend].append(events_ms(
                torch, lambda: [mod(x) for _ in range(10)], 10))
        for backend, sess in pair.items():
            mod = sess.backend.module
            busy_ms, wall_ms, _ = device_busy(
                torch, lambda: [mod(x) for _ in range(10)])
            e2e[backend] = dict(
                forward_ms=statistics.median(fwd[backend]),
                forward_ms_turns=fwd[backend],
                profiled_busy_ms=busy_ms / 10,
                profiled_wall_ms=wall_ms / 10,
                device_busy_share=busy_ms / wall_ms)
    for backend, sess in pair.items():
        e2e[backend]["latency_us_b1"] = sess.benchmark(iters=200, warmup=20)
    torch.cuda.synchronize()
    launches["e2e"] = counts()
    emit("e2e", net="robot", batch=BATCH, **e2e, launches=launches["e2e"])

    # -- 7. serve the robot detector -------------------------------------
    frames = np.random.default_rng(11).normal(
        size=(256,) + tuple(robot_sess.input_shape)).astype(np.float32)

    def serve():
        with InferenceServer(robot_sess, config=ServerConfig(
                workers=2, max_batch=32)) as srv:
            handles = [srv.submit(f) for f in frames]
            outs = [h.result(timeout=60) for h in handles]
            return outs, srv.stats()

    reset_counts()
    t0 = time.perf_counter()
    outs, st = serve()
    wall_s = time.perf_counter() - t0
    assert st["completed"] == len(frames), st
    assert st["failed"] == st["timeouts"] == 0, st
    for i, (o, f) in enumerate(zip(outs, frames)):
        compare(torch.from_numpy(o), torch.from_numpy(robot_sess.predict(f)),
                1e-5, 1e-6, f"served frame {i}")
    # the same frames again, under the profiler: the card's busy time
    # over the wall time of that run
    busy_ms, traced_wall_ms, _ = device_busy(torch, serve)
    torch.cuda.synchronize()
    launches["serve"] = counts()
    emit("serve", frames=len(frames), wall_s=wall_s,
         latency_p50_us=st["latency_p50_us"],
         latency_p99_us=st["latency_p99_us"], qps=st["qps"],
         batches=st["batches"], batch_size_mean=st["batch_size_mean"],
         batch_occupancy=st["batch_occupancy"],
         traced_wall_ms=traced_wall_ms, traced_device_busy_ms=busy_ms,
         traced_device_busy_share=busy_ms / traced_wall_ms,
         launches=launches["serve"])

    # -- 8. int8: calibration, the int8 reference, its session and server -
    from repro_torch.core import quantize as quantize_mod
    from repro_torch.core.torch_exec import forward_quantized
    from repro_torch.data.pipeline import camera_frame_batch
    from repro_torch.engine import CalibrationConfig

    def int8_session(name, method=None, device=None):
        """The int8 session with the default calibration data (32 camera
        frames) and ``method`` (None: the session's default)."""
        return InferenceSession(nets[name](0), config=SessionConfig(
            backend="torch", precision="int8", device=device,
            calibration=CalibrationConfig(method=method)))

    def on_cpu(sess, frames):
        """The same quantized graph's int8 forward on the CPU."""
        with torch.inference_mode():
            return forward_quantized(sess.qgraph,
                                     torch.from_numpy(frames)).numpy()

    reset_counts()
    calib, int8_sessions = {}, {}
    for method in ("percentile", "minmax"):
        card = int8_session("robot", None if method == "percentile"
                            else method)
        cpu = int8_session("robot", card.qgraph.method, "cpu")
        assert card.qgraph.method == method, card.qgraph.method
        acts, acts_cpu = card.qgraph.acts, cpu.qgraph.acts
        calib[method] = dict(
            zero_points={n: qp.zero_point for n, qp in acts.items()},
            zero_points_differ_from_cpu=[n for n in acts if acts[n].zero_point
                                         != acts_cpu[n].zero_point],
            max_rel_scale_diff_vs_cpu=max(
                abs(acts[n].scale / acts_cpu[n].scale - 1.0) for n in acts))
        int8_sessions["robot " + method] = card
    robot8 = int8_sessions["robot percentile"]  # the session's default
    for name in ("ball", "pedestrian", "residual"):
        int8_sessions[name] = int8_session(name)
    parity = {}
    for key, sess in int8_sessions.items():
        name = key.split()[0]
        frames = np.random.default_rng(7).normal(
            size=(main_batch[name],) + tuple(sess.input_shape)).astype(
                np.float32)
        got, want = sess.predict(frames), on_cpu(sess, frames)
        if name == "robot":
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"int8 {key}: card differs from the CPU on "
                    f"{int((got != want).sum())} of {got.size} outputs")
            e = 0.0
        else:
            e = compare(torch.from_numpy(got), torch.from_numpy(want),
                        1e-5, 1e-6, f"int8 {key} card vs cpu")
        parity[key] = dict(batch=len(frames), shape=list(got.shape),
                           max_abs_err_vs_cpu=e,
                           bit_equal=bool(np.array_equal(got, want)))
    held_out = camera_frame_batch(16, tuple(robot8.input_shape), seed=99)
    top1 = quantize_mod.quantization_error(robot8.qgraph, held_out)
    if not top1["top1_agreement"] >= 0.99:
        raise AssertionError(f"int8 robot top-1 on held-out frames: {top1}")
    frames = np.random.default_rng(11).normal(
        size=(256,) + tuple(robot8.input_shape)).astype(np.float32)
    t0 = time.perf_counter()
    with InferenceServer(robot8, config=ServerConfig(
            workers=2, max_batch=32)) as srv:
        handles = [srv.submit(f) for f in frames]
        outs = [h.result(timeout=120) for h in handles]
        st8 = srv.stats()
    serve_s = time.perf_counter() - t0
    assert st8["completed"] == len(frames), st8
    assert st8["failed"] == st8["timeouts"] == 0, st8
    for i, (o, f) in enumerate(zip(outs, frames)):
        if not np.array_equal(o, robot8.predict(f)):
            raise AssertionError(f"int8 served frame {i} differs from "
                                 f"session.predict")
    torch.cuda.synchronize()
    int8_launches = counts()
    if any(int8_launches.values()):
        raise AssertionError(f"the int8 path launched {int8_launches}")

    x = torch.from_numpy(frames[:BATCH]).to(dev)
    mods = {"int8": robot8.backend.module,
            "cuda": robot_sess.backend.module,
            "torch": robot_plain.backend.module}
    fwd8 = {k: {"graph_ms": [], "eager_ms": []} for k in mods}
    with torch.inference_mode():
        y8 = mods["int8"](x)
        if not (y8.shape == (BATCH,) + tuple(robot8.output_shape)
                and bool(y8.isfinite().all())):
            raise AssertionError(f"int8 forward at batch {BATCH}: "
                                 f"{tuple(y8.shape)}")
        for key in ("int8", "cuda", "torch", "torch", "cuda", "int8"):
            fwd8[key]["graph_ms"].append(graph_ms(torch, lambda: mods[key](x)))
            fwd8[key]["eager_ms"].append(events_ms(
                torch, lambda: [mods[key](x) for _ in range(10)], 10))
        busy_ms, wall_ms, top = device_busy(
            torch, lambda: [mods["int8"](x) for _ in range(10)])
    torch.cuda.synchronize()
    emit("int8", net="robot", nvidia_smi=smi, calibration=calib,
         calibration_frames=robot8.config.calibration.samples,
         parity=parity, tolerance={"robot": "bit for bit",
                                   "softmax sinks": {"rtol": 1e-5,
                                                     "atol": 1e-6}},
         top1_agreement=top1["top1_agreement"],
         max_abs_err_vs_fp32=top1["max_abs_err"], held_out_frames=16,
         served_frames=len(frames), served_bit_equal=True, serve_s=serve_s,
         qps=st8["qps"], latency_p50_us=st8["latency_p50_us"],
         latency_p99_us=st8["latency_p99_us"],
         batch_size_mean=st8["batch_size_mean"], launches=int8_launches,
         batch=BATCH, forward={k: dict(v, graph_ms_median=statistics.median(
             v["graph_ms"]), eager_ms_median=statistics.median(
                 v["eager_ms"])) for k, v in fwd8.items()},
         profiled_busy_ms=busy_ms / 10, profiled_wall_ms=wall_ms / 10,
         device_busy_share=busy_ms / wall_ms, top_device_kernels=top,
         latency_us_b1=robot8.benchmark(iters=200, warmup=20))
    del int8_sessions, robot8, mods, x, y8
    torch.cuda.empty_cache()

    # -- 9. the generated C on the card's host, beside the card ----------
    cgen_phase(torch, np, nets, sessions, main_batch, smi, counts,
               reset_counts, launches)

    # -- 10. LM kernels against their plain versions ----------------------
    from repro_torch.configs.lm_archs import ARCHS
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.engine import (CudaLMBackend, LMConfig, LMSession,
                                    device_digest)
    from repro_torch.models.kernel_policy import (DEFAULT_KERNELS,
                                                  PLAIN_KERNELS)
    from repro_torch.kernels.cases import (DECODE_ATOL, DECODE_ATTN_CASES,
                                           DECODE_FLIP_SHARE, DECODE_RTOL,
                                           check_decode)
    from repro_torch.kernels.ref import (attention_ref,
                                         decode_attention_ref,
                                         linear_scan_ref)
    from repro_torch.models.align import pad_head_dim
    from repro_torch.models.layers import ParamInit
    from repro_torch.models.lm import (embed_tokens, make_decode_step,
                                       make_prefill_step, param_count)
    from repro_torch.models.moe import capacity, moe_mlp
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.models.stack import (apply_block, init_block,
                                          init_params, stack_blocks)
    from repro_torch.serve import LMTokenServer

    rwkv = ARCHS["rwkv6-7b"]
    hubert = ARCHS["hubert-xlarge"]  # one full-width layer at head dim 80
    rwkv_h, rwkv_n = rwkv.d_model // rwkv.ssm_head_dim, rwkv.ssm_head_dim

    def kinds(cfg):
        return cfg.prologue + cfg.pattern * cfg.n_groups

    def heads(cfg):
        return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    flash_main = flash_main_layers(ARCHS)
    f32, bf16 = torch.float32, torch.bfloat16

    def attn_inputs(b, hq, hkv, t, d, dtype, model_layout=False):
        """q, k, v as (B,H,T,D); with ``model_layout`` as the model hands
        them over: (B,T,H,D) activations viewed transposed."""
        if model_layout:
            return [rand((b, t, h, d), dtype).transpose(1, 2)
                    for h in (hq, hkv, hkv)]
        return [rand((b, h, t, d), dtype) for h in (hq, hkv, hkv)]

    def scan_inputs(b, t, h, n, m, dtype, small_decays=False):
        """decay in (0.5, 1), or with ``small_decays`` log-uniform in
        [1e-6, 1] (RWKV6's exp(-exp(w)) spreads them so)."""
        if small_decays:
            decay = torch.from_numpy(np.exp(rng.uniform(
                np.log(1e-6), 0.0, size=(b, t, h, n))).astype(
                    np.float32)).to(dev)
        else:
            decay = torch.sigmoid(rand((b, t, h, n))) * 0.5 + 0.5
        decay = decay.to(dtype)
        return ([decay] + [rand(shape, dtype, 0.3) for shape in
                           ((b, t, h, n), (b, t, h, m), (b, t, h, n))]
                + [rand((b, h, n, m), f32, 0.1)])

    def rel_l2_t(got, want):
        return float((got.float() - want).norm() / want.norm())

    def upcast(*ts):
        return [a.float() for a in ts]

    lm_err = {"flash_attention": {}, "linear_scan": {}}
    main_rel_l2 = {}  # bf16 kernel vs fp32 function, the main shapes
    for dtype, tol in ((f32, 2e-5), (bf16, 3e-2)):
        cases = [c + (None,) for c in FLASH_CASES] + [
            (LM_BATCH, hq, hkv, LM_PROMPT, d, True, w, layer)
            for layer, (_, (hq, hkv, d), w, _) in flash_main.items()] + [
            (LM_BATCH, hubert.n_heads, hubert.n_kv_heads, LM_PROMPT,
             hubert.head_dim, hubert.causal, None, "hubert-xlarge")]
        for b, hq, hkv, t, d, causal, window, layer in cases:
            q, k, v = attn_inputs(b, hq, hkv, t, d, dtype, layer is not None)
            what = f"flash_attention {dtype} {(b, hq, hkv, t, d, window)}"
            o = flash_mod.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window)
            e = compare(o, attention_ref(q, k, v, causal=causal,
                                         window=window), tol, tol, what)
            if dtype == bf16:
                o32 = attention_ref(*upcast(q, k, v), causal=causal,
                                    window=window)
                compare(o.float(), o32, BF16_ROUND_RTOL, BF16_ROUND_ATOL,
                        what + " vs fp32")
                if layer is not None:
                    main_rel_l2[f"flash_attention {layer}"] = rel_l2_t(o, o32)
            key = str(dtype).replace("torch.", "")
            lm_err["flash_attention"][key] = max(
                lm_err["flash_attention"].get(key, 0.0), e)
            del q, k, v, o
    # a query offset: the last quarter of the rows against the whole k
    # and v, from q_start = 3 T / 4 (the last of four ranks' rows under
    # the head-dim attention rule), at the main path's layers, at head
    # dim 80 and 128 off the tile grid, both routes
    offset_cases = [(LM_BATCH, hq, hkv, LM_PROMPT, d, True, w, layer)
                    for layer, (_, (hq, hkv, d), w, _) in flash_main.items()
                    ] + [(1, 4, 2, 520, 80, True, 32, None),
                         (2, 4, 2, 400, 128, False, None, None)]
    offset_err = {}
    for dtype, tol in ((f32, 2e-5), (bf16, 3e-2)):
        for b, hq, hkv, t, d, causal, window, layer in offset_cases:
            start = t - t // 4
            q, k, v = attn_inputs(b, hq, hkv, t, d, dtype, layer is not None)
            q = q[:, :, start:]
            what = (f"flash_attention {dtype} {(b, hq, hkv, t, d, window)} "
                    f"rows from {start}")
            o = flash_mod.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window, q_start=start)
            e = compare(o, attention_ref(q, k, v, causal=causal,
                                         window=window, q_start=start),
                        tol, tol, what)
            if dtype == bf16:
                compare(o.float(), attention_ref(
                    *upcast(q, k, v), causal=causal, window=window,
                    q_start=start), BF16_ROUND_RTOL, BF16_ROUND_ATOL,
                    what + " vs fp32")
            key = str(dtype).replace("torch.", "")
            offset_err[key] = max(offset_err.get(key, 0.0), e)
            del q, k, v, o
    scan_cases = [c + (False,) for c in SCAN_CASES] + [
        (1, 200, 2, 64, 64, True), (1, 70, 2, 5, 16, True),
        (LM_BATCH, LM_PROMPT, rwkv_h, rwkv_n, rwkv_n, False)]
    for dtype, tol in ((f32, 1e-4), (bf16, 5e-2)):
        for b, t, h, n, m, small in scan_cases:
            args = scan_inputs(b, t, h, n, m, dtype, small)
            (y, s_t), (y_ref, s_ref) = (scan_mod.linear_scan_cuda(*args),
                                        linear_scan_ref(*args))
            what = f"linear_scan {dtype} {(b, t, h, n, m)}" + (
                " small decays" if small else "")
            e = max(compare(y, y_ref, tol, tol, what),
                    compare(s_t, s_ref, tol, tol, what + " state"))
            if dtype == bf16:
                y32, s32 = linear_scan_ref(*upcast(*args))
                compare(y.float(), y32, BF16_ROUND_RTOL, BF16_ROUND_ATOL,
                        what + " vs fp32")
                compare(s_t, s32, 1e-4, 1e-4, what + " state vs fp32")
                if b == LM_BATCH and t == LM_PROMPT:
                    main_rel_l2["linear_scan"] = rel_l2_t(y, y32)
            key = str(dtype).replace("torch.", "")
            lm_err["linear_scan"][key] = max(
                lm_err["linear_scan"].get(key, 0.0), e)
    # two half scans, the second from the first's final state, equal one;
    # N 4 split at a chunk's edge, N 64 and 128 inside a chunk
    carry_err = 0.0
    for n, m, t, cut in ((4, 8, 64, 32), (64, 64, 70, 33), (128, 80, 70, 33)):
        decay, k, v, r, s0 = scan_inputs(1, t, 2, n, m, f32)
        y_full, s_full = scan_mod.linear_scan_cuda(decay, k, v, r, s0)
        halves = [[a[:, sl].contiguous() for a in (decay, k, v, r)]
                  for sl in (slice(0, cut), slice(cut, t))]
        y1, s1 = scan_mod.linear_scan_cuda(*halves[0], s0)
        y2, s2 = scan_mod.linear_scan_cuda(*halves[1], s1)
        what = f"scan state carry N {n}"
        carry_err = max(carry_err,
                        compare(torch.cat([y1, y2], 1), y_full, 1e-5, 1e-5,
                                what),
                        compare(s2, s_full, 1e-5, 1e-5, what))

    # the decode-attention kernel on its cases, a 0-d device position
    decode_err = 0.0
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    for b, s, hkv, g, d, ring, window, pos in DECODE_ATTN_CASES:
        q, k, v = (rand(shape, bf16) for shape in (
            (b, 1, hkv * g, d), (b, s, hkv, d), (b, s, hkv, d)))
        p_ = torch.tensor(pos, dtype=torch.int64, device=dev)
        decode_err = max(decode_err, check_decode(
            decode_mod.decode_attention_cuda(q, k, v, p_, window=window,
                                             ring=ring),
            decode_attention_ref(q, k, v, p_, window=window, ring=ring),
            q, k, v, p_, window=window, ring=ring))
        del q, k, v
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
        reduced)
    lm_err["decode_attention"] = {"bfloat16": decode_err}

    # two layers at full width, on random hidden states of the main shape
    positions = torch.arange(LM_PROMPT, device=dev)[None].expand(LM_BATCH,
                                                                 -1)
    policies = {"kernels": DEFAULT_KERNELS, "plain": PLAIN_KERNELS}

    def tree_float(tree):
        return tree_map(lambda a: a.float(), tree)

    def layer_out(cfg, kind, p, x, policy):
        """The block's contribution ``apply_block(x) - x``, in fp32."""
        with torch.inference_mode():
            return (apply_block(x, kind, p, cfg, policy, positions=positions)
                    .float() - x.float())

    def layer_gates(cfg, kind, p, x):
        """The ``lm_main`` gates (``check_lm_gates``) on one block's
        contribution."""
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32, x32 = tree_float(p), x.float()
        h32 = {n_: layer_out(cfg32, kind, p32, x32, pol)
               for n_, pol in policies.items()}
        del p32
        h16 = {n_: layer_out(cfg, kind, p, x, pol)
               for n_, pol in policies.items()}
        rel = {"fp32_kernels_vs_plain": rel_l2_t(h32["kernels"],
                                                 h32["plain"]),
               "bf16_kernels_vs_fp32": rel_l2_t(h16["kernels"], h32["plain"]),
               "bf16_plain_vs_fp32": rel_l2_t(h16["plain"], h32["plain"])}
        check_lm_gates(rel, f"{cfg.name} layer")
        return rel

    grok = ARCHS["grok-1-314b"]
    gen = torch.Generator(dev).manual_seed(0)
    gp = init_block(ParamInit(dev, gen), "A", grok)
    grok_rel = layer_gates(grok, "A", gp, rand((LM_BATCH, LM_PROMPT,
                                                grok.d_model), bf16))
    grok_capacity = capacity(LM_BATCH * LM_PROMPT, grok.top_k,
                             grok.n_experts, grok.capacity_factor)
    del gp
    torch.cuda.empty_cache()
    danube = dataclasses.replace(ARCHS["h2o-danube-3-4b"], dtype="float32")
    dp = init_block(ParamInit(dev, gen), "L", danube)
    dpp, danube_p = pad_head_dim(dp, danube, 128)
    x = rand((LM_BATCH, LM_PROMPT, danube.d_model))
    padded_err = compare(
        layer_out(danube_p, "L", dpp, x, DEFAULT_KERNELS),
        layer_out(danube, "L", dp, x, DEFAULT_KERNELS), 2e-5, 2e-5,
        "h2o-danube-3-4b layer, head dim 120 padded to 128")
    del dp, dpp, x
    torch.cuda.synchronize()
    emit("lm_kernels", flash_cases=len(cases), scan_cases=len(scan_cases),
         tolerance={"flash_attention": {"float32": 2e-5, "bfloat16": 3e-2},
                    "linear_scan": {"float32": 1e-4, "bfloat16": 5e-2},
                    "bfloat16_vs_fp32": {"rtol": BF16_ROUND_RTOL,
                                         "atol": BF16_ROUND_ATOL},
                    "state_carry": 1e-5, "padded_head_dim": 2e-5,
                    "decode_attention": {
                        "rtol": DECODE_RTOL, "atol": DECODE_ATOL,
                        "p_flips_share": DECODE_FLIP_SHARE}},
         decode_attention_cases=len(DECODE_ATTN_CASES),
         max_abs_err=lm_err, state_carry_err=carry_err,
         flash_query_offset=dict(cases=len(offset_cases), rows="last quarter",
                                 max_abs_err=offset_err),
         bf16_main_shape_rel_l2_vs_fp32=main_rel_l2,
         grok_layer=dict(arch=grok.name, batch=LM_BATCH, tokens=LM_PROMPT,
                         experts=grok.n_experts, top_k=grok.top_k,
                         moe_d_ff=grok.moe_d_ff, capacity=grok_capacity,
                         heads=list(heads(grok)),
                         contribution_rel_l2=grok_rel,
                         fp32_rel_tol=LM_FP32_REL_TOL,
                         bf16_factor=LM_BF16_FACTOR),
         padded_layer=dict(arch=danube.name, head_dim=[120, 128],
                           dtype="float32", policy="kernels",
                           max_abs_err=padded_err))

    # -- 11. LM kernel time at the main path's shapes --------------------
    lm_rows = {"flash_attention": [], "linear_scan": []}
    lm_rows_fp32 = []  # flash's fp32 route, csrc/flash_attention.cu
    t = LM_PROMPT
    for layer, (arch, (hq, hkv, d), window, n_layers) in flash_main.items():
        q, k, v = attn_inputs(LM_BATCH, hq, hkv, t, d, bf16, True)
        qi = torch.arange(t, device=dev)[:, None]
        kj = torch.arange(t, device=dev)[None, :]
        mask = (kj <= qi) & ((qi - kj) < (window or t))
        o = flash_mod.flash_attention_cuda(q, k, v, window=window)
        if window is None:
            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
        compare(library(), o, 3e-2, 3e-2, f"library attention {layer}")
        # the fp32 route (lm_main's fp32 controls) at the same shape
        lm_rows_fp32.append(dict(
            arch=arch, layer=layer, per_prefill=n_layers,
            **time_flash_fp32(torch, *(a.float() for a in (q, k, v)),
                              window)))
        lm_rows["flash_attention"].append(dict(
            arch=arch, layer=layer, window=window, per_prefill=n_layers,
            q=list(q.shape), k=list(k.shape), dtype="bfloat16",
            ms=graph_ms(torch, lambda: flash_mod.flash_attention_cuda(
                q, k, v, window=window)),
            plain_ms=graph_ms(torch, lambda: attention_ref(
                q, k, v, window=window), reps=3),
            library_ms=graph_ms(torch, library),
            nbytes=nbytes(q, k, v, o),
            ops=4 * LM_BATCH * hq * d * int(mask.sum()),
            ops_rate="bf16 tensor cores, 989 TFLOP/s"))
    args = scan_inputs(LM_BATCH, t, rwkv_h, rwkv_n, rwkv_n, f32)
    y, s_t = scan_mod.linear_scan_cuda(*args)
    lm_rows["linear_scan"].append(dict(
        arch="rwkv6-7b", layer="rwkv6 time mix",
        per_prefill=kinds(rwkv).count("R"),
        shape=list(args[2].shape), dtype="float32",
        ms=graph_ms(torch, lambda: scan_mod.linear_scan_cuda(*args)),
        plain_ms=graph_ms(torch, lambda: linear_scan_ref(*args), reps=1),
        library_ms=None, nbytes=nbytes(*args, y, s_t),
        ops=5 * LM_BATCH * t * rwkv_h * rwkv_n * rwkv_n,
        ops_rate="fp32 outside the tensor cores, 67 TFLOP/s"))
    ds = DECODE_STEP
    q, k, v = (rand(shape, bf16) for shape in (
        (ds["batch"], 1, ds["kv_heads"] * ds["group"], ds["head_dim"]),
        (ds["batch"], ds["slots"], ds["kv_heads"], ds["head_dim"]),
        (ds["batch"], ds["slots"], ds["kv_heads"], ds["head_dim"])))
    # held to the plain version at a position of the cell's step (its
    # prompts fill 256 slots) and at the last, which the times take
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    step_err = 0.0
    for at in (ds["slots"] - 33, ds["slots"] - 1):
        p_ = torch.tensor(at, dtype=torch.int64, device=dev)
        o = decode_mod.decode_attention_cuda(q, k, v, p_)
        step_err = max(step_err, check_decode(
            o, decode_attention_ref(q, k, v, p_), q, k, v, p_))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
        reduced)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    lm_rows["decode_attention"] = [dict(
        arch=ds["arch"], layer="decode step attention", per_step=ds["layers"],
        q=list(q.shape), k=list(k.shape), pos=ds["slots"] - 1,
        checked_pos=[ds["slots"] - 33, ds["slots"] - 1],
        max_abs_err=step_err, dtype="bfloat16",
        ms=graph_ms(torch, lambda: decode_mod.decode_attention_cuda(
            q, k, v, p_)),
        plain_ms=graph_ms(torch, lambda: decode_attention_ref(q, k, v, p_)),
        library_ms=graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt)),
        nbytes=nbytes(q, k, v, o), ops=4 * q.numel() * ds["slots"],
        ops_rate="fp32 outside the tensor cores, 67 TFLOP/s")]
    del q, k, v, qt, kt, vt, o
    for kernel, rs in lm_rows.items():
        rate = BF16_OPS_PER_S if kernel == "flash_attention" else None
        for r in rs:
            (r["bound_ms"], r["bound_by"], r["bytes_ms"],
             r["ops_ms"]) = bound(r["nbytes"], r["ops"],
                                  rate or FP32_OPS_PER_S)
            emit("lm_time", kernel=kernel, **r)
    for r in lm_rows_fp32:
        emit("lm_time", kernel="flash_attention", route="fp32",
             source=FLASH_FP32_SOURCE, **r)

    # -- 12-14. the LM main path, serving and tuning, one arch at a time -
    def timed_generate(sess, prompts, max_new):
        """Greedy tokens, the prefill's last logits, the last decode
        logits, and the seconds of the prefill and of each decode step
        (each ends on the host).  On the card the first step is the
        graph's eager warm-up, the second its capture, instantiation and
        first replay, the rest replays."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, handle = sess.prefill(prompts)
        t1 = time.perf_counter()
        tok = np.argmax(logits, axis=-1).astype(np.int32)
        out, steps, last = [tok], [], logits
        for _ in range(max_new - 1):
            t2 = time.perf_counter()
            last = sess.decode(handle, tok)
            steps.append(time.perf_counter() - t2)
            tok = np.argmax(last, axis=-1).astype(np.int32)
            out.append(tok)
        return dict(tokens=np.stack(out, axis=1), logits=logits,
                    prefill_s=t1 - t0, steps_s=steps, decode_s=sum(steps),
                    last_logits=last)

    def eager_generate(backend, prompts, max_new):
        """The eager oracle of a backend's graphed decode: its weights,
        policy and prompts through ``make_prefill_step``, then the direct
        ``make_decode_step`` loop with an int position on the current
        stream, each step as the eager backend ran it (tokens to the
        card, logits to the host); the ``timed_generate`` fields."""
        cfg, params = backend.model_cfg, backend.params
        prefill = make_prefill_step(cfg, backend.max_context, backend.policy)
        decode = make_decode_step(cfg, backend.policy)

        def to_dev(a):
            return torch.from_numpy(a.astype(np.int64)).to(dev)

        with torch.inference_mode():
            logits, caches, pos = prefill(params, {"tokens": to_dev(prompts)})
            logits = logits.cpu().numpy()
            tok = np.argmax(logits, axis=-1).astype(np.int32)
            out, steps, last = [tok], [], logits
            for _ in range(max_new - 1):
                t2 = time.perf_counter()
                step, caches, pos = decode(params, caches,
                                           to_dev(tok[:, None]), pos)
                last = step.cpu().numpy()
                steps.append(time.perf_counter() - t2)
                tok = np.argmax(last, axis=-1).astype(np.int32)
                out.append(tok)
        return dict(tokens=np.stack(out, axis=1), logits=logits,
                    steps_s=steps, decode_s=sum(steps), last_logits=last)

    def graph_vs_eager(graph, eager, what):
        """The graph's gate: greedy tokens equal the eager oracle's; the
        last decode logits' difference reported (0 when bit-equal)."""
        if not np.array_equal(graph["tokens"], eager["tokens"]):
            raise AssertionError(f"{what}: graphed decode tokens differ "
                                 f"from the eager oracle's")
        a, b = graph["last_logits"], eager["last_logits"]
        return dict(tokens_equal=True, last_logits_bit_equal=bool(
            np.array_equal(a, b)), last_logits_max_abs_diff=float(
                np.abs(a - b).max()))

    def lm_session(arch, params=None, smoke=False, **pins):
        return LMSession(config=SessionConfig(backend="cuda-lm", lm=LMConfig(
            arch=arch, smoke=smoke, max_context=LM_CONTEXT,
            decode_batch=LM_BATCH, **pins)), params=params)

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def layer_drift(cfg, params, params32, prompts):
        """Per layer, the relative L2 distance of the bf16 hidden states
        from the fp32 model's on the same weights and prompts: carried
        through the stack under each policy, and of one bf16 layer (the
        kernel policy) fed the fp32 model's input to that layer."""
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        tok = torch.from_numpy(prompts.astype(np.int64)).to(dev)
        positions = torch.arange(tok.shape[1], device=dev)[None].expand(
            *tok.shape)
        out = {"kernels": [], "plain": [], "one_layer": []}
        with torch.inference_mode():
            x32 = embed_tokens(params32, cfg32, tok)
            xs = {name: embed_tokens(params, cfg, tok) for name in policies}
            for (kind, p16, _), (_, p32, _) in zip(
                    stack_blocks(params, cfg), stack_blocks(params32, cfg32)):
                y32 = apply_block(x32, kind, p32, cfg32, DEFAULT_KERNELS,
                                  positions=positions)
                one = apply_block(x32.to(bf16), kind, p16, cfg,
                                  DEFAULT_KERNELS, positions=positions)
                out["one_layer"].append(rel_l2_t(one, y32))
                for name, policy in policies.items():
                    xs[name] = apply_block(xs[name], kind, p16, cfg, policy,
                                           positions=positions)
                    out[name].append(rel_l2_t(xs[name], y32))
                x32 = y32
        return out

    plain_pins = dict(attn_variant="reference", scan_variant="chunked")
    lm_kernel_of = {"gemma3-4b": "flash_attention", "rwkv6-7b": "linear_scan",
                    "deepseek-moe-16b": "flash_attention",
                    "zamba2-2.7b": "flash_attention"}

    def per_prefill(arch, cfg=None):
        """Launches of the arch's kernel per kernel-policy prefill: one
        per attention block (each use of a shared block) or RWKV block
        of ``cfg`` (by default the arch's)."""
        layers = kinds(cfg or ARCHS[arch])
        if lm_kernel_of[arch] == "linear_scan":
            return layers.count("R")
        return sum(k in "ALS" for k in layers)

    def decode_launches(arch):
        """Decode-attention launches of one kernel-policy generation on
        the card in bf16: its attention blocks, in the eager step and in
        the capture."""
        return 2 * sum(k in "ALS" for k in kinds(ARCHS[arch]))

    def kernel_ms(arch):
        """The graphed ms of the arch's kernel per prefill (lm_time)."""
        return sum(r["per_prefill"] * r["ms"] for r in
                   lm_rows[lm_kernel_of[arch]] if r["arch"] == arch)

    def standalone_estimates(cfg, params):
        """Standalone estimates, not a split of the timed prefill: the
        eager CUDA-event ms of one layer's module alone, at the prefill's
        shape on random inputs (random routing for the MoE, random decays
        for ``ssd_chunked``), times the layers that run it, launch gaps
        included.  The MoE MLP and its three expert products; Mamba2's
        ``ssd_chunked``."""
        blocks = stack_blocks(params, cfg)
        d, n = cfg.d_model, LM_BATCH * LM_PROMPT
        out = {}
        with torch.inference_mode():
            moe = [p_["mlp"] for k, p_, _ in blocks
                   if cfg.n_experts and k != "S"]
            if moe:
                p0, x2 = moe[0], rand((n, d), bf16)
                c = capacity(n, cfg.top_k, cfg.n_experts,
                             cfg.capacity_factor)
                buf = rand((cfg.n_experts, c, d), bf16)

                def experts():
                    h = F.silu(torch.bmm(buf, p0["wg"])) * torch.bmm(
                        buf, p0["wu"])
                    return torch.bmm(h, p0["wd"])

                out.update(
                    moe_mlp=len(moe) * events_ms(torch, lambda: moe_mlp(
                        x2, p0, top_k=cfg.top_k, act=cfg.act,
                        capacity_factor=cfg.capacity_factor)),
                    moe_expert_products=len(moe) * events_ms(torch, experts))
            n_mamba = sum(k == "M" for k, _, _ in blocks)
            if n_mamba:
                h_ = 2 * d // cfg.ssm_head_dim
                a = torch.sigmoid(rand((LM_BATCH, LM_PROMPT, h_))) * 0.5 + 0.5
                u = rand((LM_BATCH, LM_PROMPT, h_, cfg.ssm_head_dim))
                bm, cm = (rand((LM_BATCH, LM_PROMPT, cfg.ssm_state), f32,
                               0.1) for _ in range(2))
                out["ssd_chunked"] = n_mamba * events_ms(
                    torch, lambda: ssd_chunked(a, u, bm, cm))
        return out

    def first_layers(cfg, params, n):
        """``cfg`` cut to its first ``n`` groups (no prologue), and views
        of those groups' weights."""
        assert not cfg.prologue
        return (dataclasses.replace(cfg, n_layers=n * len(cfg.pattern)),
                {**params, "groups": tree_map(lambda a: a[:n],
                                              params["groups"])})

    def lm_phases(arch: str) -> None:
        """lm_main and lm_serve of one arch; its weights and sessions are
        freed when this returns."""
        cfg = ARCHS[arch]
        kernel = lm_kernel_of[arch]
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        kern = lm_session(arch, params)
        plain = lm_session(arch, params, **plain_pins)
        prompts = np.random.default_rng(21).integers(
            0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT)).astype(np.int32)
        for sess in (kern, plain):  # first calls: allocator, cuBLAS, a
            # first capture (each generate captures its own handle's)
            sess.generate(prompts[:, :128], 3)
        # the main path: one prefill and LM_NEW - 1 decode steps through
        # each session, counted from 0; the kernel policy launches its
        # prefill kernel once per layer of the prefill and the decode
        # attention once per attention layer of the eager step and of the
        # capture (a replay runs no Python), the plain policy neither
        runs, run_launches = {}, {}
        for name, sess in (("kernels", kern), ("plain", plain)):
            reset_counts()
            runs[name] = timed_generate(sess, prompts, LM_NEW)
            torch.cuda.synchronize()
            run_launches[name] = counts()
            logits = runs[name]["logits"]
            if logits.shape != (LM_BATCH, cfg.vocab_size) or not np.isfinite(
                    logits).all():
                raise AssertionError(f"{arch} {name}: bad logits "
                                     f"{logits.shape}")
        launches["lm_main " + arch] = run_launches["kernels"]
        # the eager oracle of the kernel session's graphed decode (its
        # prefill's launches are not the main path's)
        eager = eager_generate(kern.backend, prompts, LM_NEW)
        graph_gate = graph_vs_eager(runs["kernels"], eager, arch)
        # the steady replay on a handle of its own: device time between
        # CUDA events, and the bound, the weights' and caches' bytes
        _, spare = kern.prefill(prompts)
        for _ in range(2):  # the warm-up, then the capture
            kern.decode(spare, runs["kernels"]["tokens"][:, 0])
        replay_ms = events_ms(torch, lambda: [spare.graph.replay()
                                              for _ in range(10)], 10)
        # what the replayed step spends its device time on
        r_busy, r_wall, r_top = device_busy(
            torch, lambda: [spare.graph.replay() for _ in range(10)])
        step_bytes = nbytes(*leaves(params), *leaves(spare.caches))
        del spare
        gsteps, esteps = runs["kernels"]["steps_s"], eager["steps_s"]
        decode_graph = dict(
            warmup_s=gsteps[0], capture_s=gsteps[1],
            steady_step_ms=statistics.median(gsteps[2:]) * 1e3,
            steady_tok_s=LM_BATCH / statistics.median(gsteps[2:]),
            replay_ms=replay_ms, replay_profiled_busy_ms=r_busy / 10,
            replay_profiled_wall_ms=r_wall / 10,
            replay_top_device_kernels=r_top,
            bound_ms=step_bytes / MEM_BYTES_PER_S * 1e3,
            bound_by="bytes", step_bytes=step_bytes,
            replay_share_of_step=replay_ms / (statistics.median(
                gsteps[2:]) * 1e3),
            eager_decode_tok_s=LM_BATCH * (LM_NEW - 1) / eager["decode_s"],
            eager_steady_step_ms=statistics.median(esteps[1:]) * 1e3,
            **graph_gate)
        want_launches = {k: per_prefill(arch) if k == kernel
                         else decode_launches(arch)
                         if k == "decode_attention" else 0
                         for k in counted}
        if run_launches != {"kernels": want_launches,
                            "plain": dict.fromkeys(counted, 0)}:
            raise AssertionError(f"{arch}: main-path launches {run_launches}, "
                                 f"want {want_launches} and none")
        lk, lp = runs["kernels"]["logits"], runs["plain"]["logits"]
        tk, tp = runs["kernels"]["tokens"], runs["plain"]["tokens"]
        # the same weights and prompts through the fp32 model, both
        # policies: the reference the bf16 runs are measured against (for
        # deepseek-moe-16b on its first layers, bf16 runs of them beside)
        ccfg, cparams, l16 = cfg, params, {"kernels": lk, "plain": lp}
        cut = arch in LM_CONTROL_LAYERS
        if cut:
            ccfg, cparams = first_layers(cfg, params,
                                         LM_CONTROL_LAYERS[arch])
            l16 = {name: CudaLMBackend(
                ccfg, params=cparams, max_context=LM_CONTEXT,
                decode_batch=LM_BATCH, policy=policy).prefill(prompts)[0]
                for name, policy in policies.items()}
        cfg32 = dataclasses.replace(ccfg, dtype="float32")
        params32 = tree_float(cparams)
        # each fp32 prefill counted from 0: the kernel policy launches the
        # fp32 kernel once a layer of the control, the plain policy never
        l32, launches32 = {}, {}
        for name, policy in policies.items():
            backend32 = CudaLMBackend(
                cfg32, params=params32, max_context=LM_CONTEXT,
                decode_batch=LM_BATCH, policy=policy)
            reset_counts()
            l32[name] = backend32.prefill(prompts)[0]
            launches32[name] = counts()
            del backend32
        n32 = per_prefill(arch, ccfg)
        want32 = {k: n32 if k == kernel or (
            kernel == "flash_attention" and k == "flash_attention_f32")
            else 0 for k in counted}
        if launches32 != {"kernels": want32,
                          "plain": dict.fromkeys(counted, 0)}:
            raise AssertionError(f"{arch}: fp32 control launches "
                                 f"{launches32}, want {want32} and none")
        launches["lm_main_fp32 " + arch] = launches32["kernels"]
        drift = layer_drift(ccfg, cparams, params32, prompts)
        del params32
        gates = {"fp32_kernels_vs_plain": rel_l2(l32["kernels"],
                                                 l32["plain"]),
                 "bf16_kernels_vs_fp32": rel_l2(l16["kernels"], l32["plain"]),
                 "bf16_plain_vs_fp32": rel_l2(l16["plain"], l32["plain"])}
        # the timed (full-depth) runs' policies against each other; the
        # gates' readings, and for a cut control its own bf16 pair, keyed
        # control_ when they come from the cut control
        rel = {"bf16_kernels_vs_plain": rel_l2(lk, lp)}
        if cut:
            gates_cut = dict(gates, bf16_kernels_vs_plain=rel_l2(
                l16["kernels"], l16["plain"]))
            rel.update({"control_" + k: v for k, v in gates_cut.items()})
        else:
            rel.update(gates)
        estimates = standalone_estimates(cfg, params)
        busy_ms, wall_ms, top = device_busy(
            torch, lambda: kern.generate(prompts, LM_NEW))
        # the smoke config in fp32: both policies give the same tokens
        small = np.random.default_rng(22).integers(
            0, 256, size=(2, 20)).astype(np.int32)
        sk = lm_session(arch, smoke=True)
        sp = lm_session(arch, sk.backend.params, smoke=True, **plain_pins)
        (stk, slk), (stp, slp) = (
            (r["tokens"], r["logits"]) for r in (
                timed_generate(s_, small, 8) for s_ in (sk, sp)))
        if not np.array_equal(stk, stp):
            raise AssertionError(f"{arch} smoke: greedy tokens differ")
        smoke_err = compare(torch.from_numpy(slk), torch.from_numpy(slp),
                            1e-4, 1e-4, f"{arch} smoke logits")
        torch.cuda.synchronize()
        tokens_in, tokens_out = LM_BATCH * LM_PROMPT, LM_BATCH * (LM_NEW - 1)
        emit("lm_main", arch=arch, n_params=param_count(cfg),
             dtype=cfg.dtype, batch=LM_BATCH, prompt=LM_PROMPT,
             max_context=LM_CONTEXT, new_tokens=LM_NEW,
             **{f"{name}_{key}": value for name, r in runs.items()
                for key, value in (
                    ("prefill_s", r["prefill_s"]),
                    ("prefill_tok_s", tokens_in / r["prefill_s"]),
                    ("decode_s", r["decode_s"]),
                    ("decode_tok_s", tokens_out / r["decode_s"]))},
             logits_rel_l2=rel, fp32_rel_tol=LM_FP32_REL_TOL,
             bf16_factor=LM_BF16_FACTOR, control_layers=ccfg.n_layers,
             layer_drift_rel_l2=drift,
             prefill_kernel_ms={kernel: kernel_ms(arch)},
             standalone_estimates_ms=estimates,
             moe_capacity={"prefill": capacity(
                 tokens_in, cfg.top_k, cfg.n_experts, cfg.capacity_factor),
                 "decode": capacity(LM_BATCH, cfg.top_k, cfg.n_experts,
                                    cfg.capacity_factor)}
             if cfg.n_experts else None,
             decode=kern.backend.describe()["decode"],
             decode_graph=decode_graph,
             logits_max_abs_diff=float(np.abs(lk - lp).max()),
             logits_max_abs=float(np.abs(lp).max()),
             greedy_agreement=float((tk == tp).mean()),
             first_token_agreement=float((tk[:, 0] == tp[:, 0]).mean()),
             profiled_wall_ms=wall_ms, profiled_device_busy_ms=busy_ms,
             device_busy_share=busy_ms / wall_ms, top_device_kernels=top,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             smoke=dict(dtype="float32", tokens_equal=True,
                        max_abs_err=smoke_err),
             launches=run_launches["kernels"],
             launches_plain=run_launches["plain"],
             fp32_control=dict(layers=ccfg.n_layers,
                               launches=launches32["kernels"]))
        check_lm_gates(gates, f"{arch} prefill logits ({ccfg.n_layers} "
                              f"layers)")

        short = prompts[0, :LM_SHORT]
        want_short = kern.generate(short[None], 8)[0]
        reset_counts()
        t0 = time.perf_counter()
        with LMTokenServer(kern, config=ServerConfig(
                workers=1, max_batch=8, batch_deadline_ms=500.0,
                request_timeout_ms=None)) as srv:
            futs = [srv.submit(p_, max_new=LM_NEW) for p_ in prompts]
            futs.append(srv.submit(short, max_new=8))
            outs = [f.result(timeout=600) for f in futs]
            st = srv.stats()
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches["lm_serve " + arch] = counts()
        # the four long prompts rode one generate call: the same batch as
        # the kernel run of lm_main; the short one rode alone
        if not (np.array_equal(np.stack(outs[:LM_BATCH]), tk)
                and np.array_equal(outs[-1], want_short)):
            raise AssertionError(f"{arch}: served tokens differ from "
                                 f"session.generate")
        emit("lm_serve", arch=arch, requests=len(futs), wall_s=wall_s,
             tokens_out=LM_BATCH * LM_NEW + 8,
             tokens_out_per_s=(LM_BATCH * LM_NEW + 8) / wall_s,
             latency_p50_us=st["latency_p50_us"],
             latency_p99_us=st["latency_p99_us"], batches=st["batches"],
             batch_size_mean=st["batch_size_mean"],
             decode=kern.backend.describe()["decode"],
             launches=launches["lm_serve " + arch])
        if arch in LM_TUNE_ARCHS:
            lm_tune(arch, params, prompts)
        if arch == LAUNCH_ARCH:
            launch_out["sessions"] = launch_sessions(
                arch, params, prompts, runs["kernels"],
                dict(prefill_tok_s=tokens_in / runs["kernels"]["prefill_s"],
                     steady_decode_tok_s=decode_graph["steady_tok_s"],
                     device_busy_share=busy_ms / wall_ms))

    def launch_sessions(arch, params, prompts, unmeshed, unmeshed_rates):
        """The meshed session (``mesh_shape=(1, 1)``: a one-rank NCCL
        group) on the arch's weights, wrapped as DTensors without a
        copy, its dense layers split over ``model`` (``dense``), with its
        MoE tensor-parallel, then expert-parallel: lm_main's
        traffic (first calls, then one timed generate with the kernels'
        launches counted from 0), its tokens against the unmeshed
        session's, its prefill logits bit for bit (TP) or within
        ``LAUNCH_EP_REL_TOL`` (EP), prefill and steady decode tokens/s,
        the busy share, peak memory and the collectives it issued."""
        import torch.distributed as dist
        out = {"unmeshed": unmeshed_rates}
        tokens_in = LM_BATCH * LM_PROMPT
        for moe in LAUNCH_MOE:
            torch.cuda.reset_peak_memory_stats()
            sess = LMSession(config=SessionConfig(
                backend="cuda-lm", lm=LMConfig(
                    arch=arch, smoke=False, max_context=LM_CONTEXT,
                    decode_batch=LM_BATCH, mesh_shape=(1, 1))),
                params=params, moe=moe)
            be = sess.backend
            if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
                raise AssertionError(f"the mesh's group is "
                                     f"{dist.get_backend()} of "
                                     f"{dist.get_world_size()}")
            wrapped = all(a.to_local().data_ptr() == b.data_ptr()
                          for a, b in zip(leaves(be.params), leaves(params)))
            if not wrapped:
                raise AssertionError("the meshed session copied the weights")
            dense = be.par.describe()["dense"]
            if set(dense.values()) != {"heads"}:
                raise AssertionError(f"{arch} {moe}: the dense layers do "
                                     f"not run split: {dense}")
            sess.generate(prompts[:, :128], 3)  # first calls and captures
            reset_counts()
            be.par.coll.reset()
            run = timed_generate(sess, prompts, LM_NEW)
            torch.cuda.synchronize()
            got = counts()
            launches[f"lm_launch {arch} {moe}"] = got
            coll = be.par.coll.summary()
            want = {k: per_prefill(arch) if k == "flash_attention"
                    else decode_launches(arch)
                    if k == "decode_attention" else 0 for k in counted}
            if got != want:
                raise AssertionError(f"{arch} {moe}: launches {got}, want "
                                     f"{want}")
            if not np.array_equal(run["tokens"], unmeshed["tokens"]):
                raise AssertionError(f"{arch} {moe}: the meshed session's "
                                     f"tokens differ from the unmeshed one's")
            rel = rel_l2(run["logits"], unmeshed["logits"])
            bit_equal = bool(np.array_equal(run["logits"],
                                            unmeshed["logits"]))
            if moe == "tp" and not bit_equal:
                raise AssertionError(f"{arch} tp: prefill logits differ "
                                     f"from the unmeshed ones (rel {rel})")
            if rel > LAUNCH_EP_REL_TOL:
                raise AssertionError(f"{arch} {moe}: prefill logits rel L2 "
                                     f"{rel} > {LAUNCH_EP_REL_TOL}")
            busy, wall, top = device_busy(
                torch, lambda: sess.generate(prompts, LM_NEW))
            steps = run["steps_s"]
            out[moe] = dict(
                mesh=be.describe()["mesh"], backend=dist.get_backend(),
                decode=be.describe()["decode"], dense=dense,
                activations={"prefill": "sequence" if be.par.seq_splits(
                    LM_PROMPT) else "whole", "decode": "sequence"
                    if be.par.seq_splits(1) else "whole"},
                logits=be.par.describe()["logits"], params_wrapped=wrapped, launches=got, collectives=coll,
                tokens_equal=True, prefill_logits_bit_equal=bit_equal,
                prefill_logits_rel_l2=rel,
                last_logits_max_abs_diff=float(np.abs(
                    run["last_logits"] - unmeshed["last_logits"]).max()),
                prefill_s=run["prefill_s"],
                prefill_tok_s=tokens_in / run["prefill_s"],
                steady_decode_tok_s=LM_BATCH / statistics.median(steps[2:]),
                decode_tok_s=LM_BATCH * (LM_NEW - 1) / run["decode_s"],
                warmup_s=steps[0], capture_s=steps[1],
                device_busy_share=busy / wall, top_device_kernels=top,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
            sess.close()
            del sess, be
            torch.cuda.empty_cache()
        return out

    def lm_tune(arch, params, prompts):
        """``LMSession(autotune=True)`` at full width on the arch's
        weights, into a fresh directory: the tuning (its kernel launches
        counted), a second session reading the record and timing nothing
        (no launch), and a session pinned to the winner giving the tuned
        one's tokens."""
        with tempfile.TemporaryDirectory() as tdir:
            config = SessionConfig(
                backend="cuda-lm", autotune=True, tune_cache=tdir,
                lm=LMConfig(arch=arch, smoke=False, max_context=LM_CONTEXT,
                            decode_batch=LM_BATCH))
            reset_counts()
            t0 = time.perf_counter()
            tuned = LMSession(config=config, params=params)
            tune_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches["lm_tune " + arch] = counts()
            reset_counts()
            t0 = time.perf_counter()
            again = LMSession(config=config, params=params)
            again_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            again_launches = counts()
        pol = tuned.tuned.policy
        if tuned.tuned.from_cache or not again.tuned.from_cache or any(
                again_launches.values()) or again.kernel_policy != pol:
            raise AssertionError(f"{arch}: the tuning cache did not answer "
                                 f"the second session: {again.info}, "
                                 f"launches {again_launches}")
        pinned = lm_session(arch, params, attn_variant=pol.attention,
                            scan_variant=pol.scan, block_q=pol.block_q,
                            block_k=pol.block_k)
        toks = tuned.generate(prompts, 8)
        if not np.array_equal(toks, pinned.generate(prompts, 8)):
            raise AssertionError(f"{arch}: the tuned session's tokens differ "
                                 f"from its pinned winner's")
        emit("lm_tune", arch=arch, dtype=ARCHS[arch].dtype,
             batch=LM_BATCH, prompt=min(16, LM_CONTEXT),
             max_context=LM_CONTEXT, iters=max(1, config.tune_iters // 100),
             device=str(tuned.backend.device),
             digest=device_digest(dev), winner=dict(pol._asdict()),
             prefill_us=tuned.tuned.prefill_us, tune_s=tune_s,
             cached_session_s=again_s, cached_from_cache=True,
             cached_launches=again_launches,
             pinned_tokens_equal=True, launches=launches["lm_tune " + arch])

    launch_out = {}
    for arch in LM_ARCHS:
        lm_phases(arch)
        torch.cuda.empty_cache()

    # -- 15. the graphed decode on every decoding arch's smoke config ----
    def smoke_backend(arch, batch, **changes):
        cfg = dataclasses.replace(ARCHS[arch].smoke(), **changes)
        return CudaLMBackend(cfg, max_context=40, decode_batch=batch)

    def small_prompts(seed, batch):
        return np.random.default_rng(seed).integers(
            0, 256, size=(batch, 12)).astype(np.int32)

    graph_runs = {}
    graph_cases = [(a, 2, {}) for a in sorted(ARCHS)
                   if not ARCHS[a].is_encoder]
    # the MoE at capacity factor 1.25, batch 4: 1 slot an expert, so
    # tokens drop in decode, and the graph must drop the same ones
    graph_cases.append(("deepseek-moe-16b", 4, {"capacity_factor": 1.25}))
    for arch, batch, changes in graph_cases:
        be = smoke_backend(arch, batch, **changes)
        p_ = small_prompts(1, batch)
        got = timed_generate(be, p_, 8)
        key = arch + ("" if not changes else " capacity_factor 1.25")
        graph_runs[key] = dict(
            batch=batch, **graph_vs_eager(got, eager_generate(be, p_, 8), key))
        if be.model_cfg.n_experts:
            graph_runs[key].update(
                decode_capacity=capacity(batch, be.model_cfg.top_k,
                                         be.model_cfg.n_experts,
                                         be.model_cfg.capacity_factor),
                slots=batch * be.model_cfg.top_k,
                experts=be.model_cfg.n_experts)
    interleaved = {}
    for arch in ("gemma3-4b", "rwkv6-7b", "zamba2-2.7b", "deepseek-moe-16b"):
        be = smoke_backend(arch, 2)
        pa, pb = small_prompts(2, 2), small_prompts(3, 2)
        alone = [timed_generate(be, p_, 10)["tokens"] for p_ in (pa, pb)]
        (la, ha), (lb, hb) = be.prefill(pa), be.prefill(pb)
        ta, tb = [np.argmax(la, -1).astype(np.int32)], [
            np.argmax(lb, -1).astype(np.int32)]
        for _ in range(9):
            ta.append(np.argmax(be.decode(ha, ta[-1]), -1).astype(np.int32))
            tb.append(np.argmax(be.decode(hb, tb[-1]), -1).astype(np.int32))
        if not (ha.graph is not None and hb.graph is not None
                and ha.graph is not hb.graph
                and np.array_equal(np.stack(ta, 1), alone[0])
                and np.array_equal(np.stack(tb, 1), alone[1])):
            raise AssertionError(f"{arch}: two interleaved handles do not "
                                 f"each give their own run's tokens")
        interleaved[arch] = True
    emit("lm_decode_graph", dtype="float32", prompt=12, new_tokens=8,
         archs=graph_runs, interleaved_handles_equal=interleaved)

    # -- 16. the serving examples, each a process of its own -------------
    example_lines = {}
    for name, ok in (("serve_lm_torch", "serve_lm_torch: OK"),
                     ("serve_cnn_torch", "serve_cnn_torch: OK")):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"{name}.py")],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        lines = out.stdout.strip().splitlines()
        if out.returncode != 0 or not lines or lines[-1] != ok:
            raise AssertionError(f"examples/{name}.py: exit "
                                 f"{out.returncode}\n{out.stdout[-3000:]}"
                                 f"\n{out.stderr[-3000:]}")
        example_lines[name] = dict(seconds=time.perf_counter() - t0,
                                   stdout=lines)
    got = json.loads(next(ln for ln in example_lines["serve_cnn_torch"][
        "stdout"] if ln.startswith("kernel launches: ")).split(": ", 1)[1])
    launches["examples serve_cnn_torch"] = {**dict.fromkeys(counted, 0),
                                            **got}
    emit("examples", runs=example_lines,
         launches=launches["examples serve_cnn_torch"])

    # -- 17-20. training ------------------------------------------------
    train_phases(torch, np, counts, reset_counts, launches)

    # -- 21. the launch --------------------------------------------------
    launch_out.update(launch_rest(torch, np, counts, reset_counts))
    launch_out["dryrun"] = run_dryrun()
    emit("launch", nvidia_smi=smi, **launch_out)

    # -- 22. the kernels line --------------------------------------------
    for phase, got in launches.items():
        want = ([lm_kernel_of[phase.split()[1]]] if phase.startswith("lm_")
                else ["conv2d", "maxpool2d"])
        for kernel in want:
            assert got[kernel] > 0, f"phase {phase} launched no {kernel}"
    def summary(rs):
        """ms, plain, bound and library ms of rows ``rs`` per forward or
        prefill (each row times its layers), and what bounds them."""
        per = [r.get("per_prefill", 1) for r in rs]
        t_bytes = sum(n * r["bytes_ms"] for n, r in zip(per, rs))
        t_ops = sum(n * r["ops_ms"] for n, r in zip(per, rs))
        lib = [r["library_ms"] for r in rs]
        return {
            "ms": sum(n * r["ms"] for n, r in zip(per, rs)),
            "plain_ms": sum(n * r["plain_ms"] for n, r in zip(per, rs)),
            "bound_ms": sum(n * r["bound_ms"] for n, r in zip(per, rs)),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (None if None in lib else
                           sum(n * x for n, x in zip(per, lib)))}

    kernels = []
    for kernel, rs in {**rows, **lm_rows}.items():
        source, replaces = KERNELS[kernel]
        if kernel == "maxpool2d":  # the pools read x from device memory
            rs = [dict(r, ms=r["cold_ms"], plain_ms=r["plain_cold_ms"],
                       library_ms=r["library_cold_ms"]) for r in rs]
        entry = {
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(got[kernel] for got in launches.values()),
            "max_abs_err": (err[kernel] if kernel in err
                            else lm_err[kernel][MAIN_DTYPE[kernel]])}
        if kernel == "decode_attention":
            r = rs[0]
            entry.update(summary([dict(r, per_prefill=r["per_step"])]))
            entry.update(per=f"{r['arch']} decode step", batch=r["k"][0],
                         slots=r["k"][1], layers=r["per_step"],
                         layer_ms=r["ms"], layer_bound_ms=r["bound_ms"])
        elif kernel in rows:
            entry.update(summary(rs))
            entry.update(per="robot forward", layers=len(rs), batch=BATCH,
                         inputs="cold" if kernel == "maxpool2d" else "warm")
        else:
            archs = [a for a in LM_ARCHS if lm_kernel_of[a] == kernel]
            per_arch = {a: dict(summary([r for r in rs if r["arch"] == a]),
                                launches_per_prefill=per_prefill(a))
                        for a in archs}
            entry.update(per_arch[archs[0]])
            entry.update(per=f"{archs[0]} prefill", batch=LM_BATCH,
                         tokens=LM_PROMPT, per_arch=per_arch)
            if kernel == "flash_attention":
                per32 = {}
                for a in archs:
                    rs32 = [r for r in lm_rows_fp32 if r["arch"] == a]
                    per32[a] = dict(
                        summary(rs32), launches_per_prefill=per_prefill(a),
                        fp32_fma_bound_ms=sum(r["per_prefill"]
                                              * r["fp32_fma_bound_ms"]
                                              for r in rs32))
                entry["fp32_route"] = dict(
                    source=FLASH_FP32_SOURCE, dtype="float32",
                    launches=sum(got["flash_attention_f32"]
                                 for got in launches.values()),
                    max_abs_err=lm_err[kernel]["float32"],
                    bound="split TF32: 3 x operations at 495 TFLOP/s",
                    per_arch=per32)
                entry["query_offset_max_abs_err"] = offset_err
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
