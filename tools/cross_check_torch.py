#!/usr/bin/env python
"""CI gate for the NEON int8 kernel variants of the PyTorch port's code
generator: cross-compile, *execute*, bit-compare.

For each check net (softmax-free — ``expf`` is libm-version dependent,
the integer path is not) and each ARM variant (``generic`` as the
cross-toolchain baseline, ``neon`` vmlal, ``neon_dot`` vdot):

1. generate the int8 C + a tiny file-I/O ``main()`` harness,
2. cross-compile with ``aarch64-linux-gnu-gcc -static`` (static link:
   QEMU user mode needs no target sysroot),
3. run the binary under ``qemu-aarch64 -cpu max`` (dotprod available),
4. compare the raw float32 outputs byte-for-byte against
   ``torch_exec.forward_quantized`` on the CPU, from the same quantized
   graph — the same hard oracle the x86 variants face in
   tests/test_torch_c_runtime.py.

Also compiles the aarch64 ``generic`` build under the strict C89 gate
(``-std=c89 -Wall -Wextra -Werror -pedantic-errors``), so the "plain
ANSI C deploys on the robot" claim is checked with the robot's own
toolchain, not just the host's.

:func:`check_net` does one net's work for any compiler, any command
prefix that runs a binary and any variants: with the host's ``cc``, an
empty prefix and ``["generic"]`` it runs the same check natively.

Exit codes: 0 all bit-exact, 1 mismatch/compile failure, 2 toolchain
missing (CI installs it; locally tests skip on 2).
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import cgen, codegen, passes, quantize  # noqa: E402
from repro_torch.core.graph import (  # noqa: E402
    Add, AvgPool, CNNGraph, Concat, Conv2D, Dense, DepthwiseConv2D,
    Flatten, Input, MaxPool,
)
from repro_torch.core.schedule import fusable_concats, fusable_pools  # noqa: E402

ARM_VARIANTS = ["generic", "neon", "neon_dot"]
STRICT_FLAGS = ["-std=c89", "-Wall", "-Wextra", "-Werror",
                "-pedantic-errors"]

_HARNESS = """
#include <stdio.h>

int main(int argc, char **argv)
{{
    static float x[{in_n}];
    static float out[{out_n}];
    FILE *fi;
    FILE *fo;
    if (argc != 3) {{
        return 2;
    }}
    fi = fopen(argv[1], "rb");
    fo = fopen(argv[2], "wb");
    if (fi == NULL || fo == NULL) {{
        return 2;
    }}
    while (fread(x, sizeof(float), {in_n}, fi) == (size_t){in_n}) {{
        {func}(x, out);
        fwrite(out, sizeof(float), {out_n}, fo);
    }}
    fclose(fi);
    fclose(fo);
    return 0;
}}
"""


def _conv(rng, kh, kw, ci, co, **kw_args) -> Conv2D:
    w = rng.normal(0, 0.5, (kh, kw, ci, co)).astype(np.float32)
    b = rng.normal(0, 0.1, (co,)).astype(np.float32)
    return Conv2D(weights=w, bias=b, **kw_args)


def _kernel_zoo(seed=7) -> CNNGraph:
    """Same construct coverage as the int8 kernel tests: tiled convs
    with group tails, depthwise, Add, vectorized MaxPool, Dense."""
    rng = np.random.default_rng(seed)
    dw_w = rng.normal(0, 0.5, (3, 3, 12, 1)).astype(np.float32)
    dw_b = rng.normal(0, 0.1, (12,)).astype(np.float32)
    return CNNGraph([
        Input(shape=(11, 9, 3), name="in"),
        _conv(rng, 3, 3, 3, 12, padding="same", activation="relu",
              name="c1"),
        DepthwiseConv2D(weights=dw_w, bias=dw_b, padding="same",
                        activation="leaky_relu", name="dw"),
        Add(name="add", inputs=["dw", "c1"], activation="relu"),
        _conv(rng, 3, 3, 12, 19, strides=(2, 2), padding="same",
              activation="leaky_relu", name="c2"),
        MaxPool(size=(2, 2), padding="same", name="mp"),
        _conv(rng, 2, 2, 19, 33, padding="valid", name="c3"),
        Flatten(name="fl"),
        Dense(weights=rng.normal(0, 0.2, (2 * 2 * 33, 21)).astype(
                  np.float32),
              bias=rng.normal(0, 0.1, (21,)).astype(np.float32),
              activation="relu", name="d1"),
        Dense(weights=rng.normal(0, 0.2, (21, 10)).astype(np.float32),
              bias=rng.normal(0, 0.1, (10,)).astype(np.float32),
              name="d2"),
    ])


def _camera_conv_net(seed=9) -> CNNGraph:
    """Robot-detector-shaped stack (no softmax head) so the CI lane
    also runs a realistically-sized conv pyramid under emulation."""
    rng = np.random.default_rng(seed)
    return CNNGraph([
        Input(shape=(30, 40, 3), name="in"),
        _conv(rng, 5, 5, 3, 8, strides=(2, 2), padding="same",
              activation="leaky_relu", name="c1"),
        MaxPool(size=(2, 2), name="mp1"),
        _conv(rng, 3, 3, 8, 16, padding="same", activation="leaky_relu",
              name="c2"),
        _conv(rng, 3, 3, 16, 20, padding="valid", activation="relu",
              name="c3"),
    ])


def _pool_concat_net(seed=11) -> CNNGraph:
    """Branchy DAG covering the fused pool/Concat epilogues on NEON:
    MaxPool and AvgPool absorbed into their producer convs, a two-edge
    fused Concat, and a per-channel-requanted stem (quantized with
    ``per_channel=True`` below) whose NEON zero-point-table loads only
    this lane executes on real aarch64 code."""
    rng = np.random.default_rng(seed)
    return CNNGraph([
        Input(shape=(12, 12, 2), name="in"),
        _conv(rng, 3, 3, 2, 20, padding="valid", activation="relu",
              name="s"),
        _conv(rng, 1, 1, 20, 16, activation="relu", name="pm"),
        MaxPool(size=(2, 2), name="mp"),
        _conv(rng, 1, 1, 20, 16, activation="leaky_relu", name="pa",
              inputs=["s"]),
        AvgPool(size=(2, 2), name="ap"),
        _conv(rng, 3, 3, 16, 16, padding="same", name="cb1",
              inputs=["mp"]),
        _conv(rng, 1, 1, 16, 16, name="cb2", inputs=["ap"]),
        Concat(name="cat", inputs=["cb1", "cb2"]),
        _conv(rng, 1, 1, 32, 7, name="head"),
    ])


def nets():
    return {"zoo": _kernel_zoo(), "camera": _camera_conv_net(),
            "poolcat": _pool_concat_net()}


def check_frames(graph) -> np.ndarray:
    """The 8 normal frames each net calibrates on and runs."""
    rng = np.random.default_rng(3)
    return rng.normal(size=(8,) + tuple(graph.input_shape)).astype(
        np.float32)


def prepare(name, g0):
    """``(optimized graph, its int8 build, frames)`` for one net: minmax
    calibration on the CPU, per-channel zero points on poolcat."""
    g = passes.optimize(g0, simd_multiple=1)
    if name == "poolcat":
        assert fusable_pools(g) and fusable_concats(g), \
            "poolcat net must exercise the fused pool/Concat C"
    xs = check_frames(g)
    qg = quantize.quantize(g, xs, per_channel=name == "poolcat",
                           device="cpu")
    if name == "poolcat":
        assert qg.channel_acts, \
            "poolcat must carry per-channel zero-point tables"
    return g, qg, xs


def harnessed_source(qg, simd, in_n, out_n) -> str:
    """The int8 C of ``qg`` for ``simd`` with the file-I/O ``main()``."""
    opts = cgen.CodegenOptions(simd=simd)
    return codegen.compile(qg, opts).source + _HARNESS.format(
        in_n=in_n, out_n=out_n, func=opts.func_name)


def check_net(name, qg, xs, *, cc, run, variants, tmp, device="cpu",
              link=("-static",), arch="aarch64"):
    """One net's lanes: for each of ``variants`` generate the harnessed
    C, compile it with ``cc -O2`` and ``link``, run it as ``[*run, exe,
    x.bin, out.bin]`` and compare its raw float32 outputs byte for byte
    with ``forward_quantized`` of ``qg`` on ``device``; then compile the
    generic build with ``cc`` under :data:`STRICT_FLAGS` (labelled
    ``arch``).  Returns ``[(tag, ok, message)]`` in that order."""
    import torch

    from repro_torch.core.torch_exec import forward_quantized
    with torch.inference_mode():
        ref = forward_quantized(qg, torch.from_numpy(xs).to(device)) \
            .cpu().numpy()
    in_n = int(np.prod(qg.graph.input_shape))
    out_n = ref.size // len(xs)
    x_path = os.path.join(tmp, f"{name}_x.bin")
    xs.astype("<f4").tofile(x_path)
    results = []
    for simd in variants:
        tag = f"{name}/{simd}"
        c_path = os.path.join(tmp, f"{name}_{simd}.c")
        with open(c_path, "w") as f:
            f.write(harnessed_source(qg, simd, in_n, out_n))
        exe = os.path.join(tmp, f"{name}_{simd}")
        flags = list(cgen.QISAS[simd].cc_flags) \
            if simd in cgen.QISAS else []
        proc = subprocess.run([cc, "-O2", *link, *flags, c_path, "-o",
                               exe, "-lm"], capture_output=True, text=True)
        if proc.returncode != 0:
            results.append((tag, False, f"cross_check: {tag}: "
                            f"CROSS-COMPILE FAILED\n{proc.stderr[:4000]}"))
            continue
        o_path = os.path.join(tmp, f"{name}_{simd}_out.bin")
        proc = subprocess.run([*run, exe, x_path, o_path],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            results.append((tag, False, f"cross_check: {tag}: "
                            f"{'QEMU ' if run else ''}RUN FAILED "
                            f"(rc={proc.returncode})\n{proc.stderr[:2000]}"))
            continue
        got = np.fromfile(o_path, dtype="<f4")
        if got.size == ref.size and np.array_equal(
                got.reshape(ref.shape), ref):
            results.append((tag, True, f"cross_check: {tag}: BIT-EXACT "
                            f"({len(xs)} images, {out_n} outputs each)"))
        else:
            bad = int((got.reshape(ref.shape) != ref).sum()) \
                if got.size == ref.size else ref.size
            results.append((tag, False, f"cross_check: {tag}: MISMATCH "
                            f"({bad}/{ref.size} values differ)"))
    # strict ANSI gate with the target's toolchain: the generic int8
    # build must survive -std=c89 -Werror there too
    tag = f"{name}/strict-c89({arch})"
    strict_c = os.path.join(tmp, f"{name}_strict.c")
    with open(strict_c, "w") as f:
        f.write(codegen.compile(
            qg, cgen.CodegenOptions(simd="generic")).source)
    proc = subprocess.run([cc, *STRICT_FLAGS, "-c", strict_c, "-o",
                           strict_c + ".o"], capture_output=True, text=True)
    results.append((tag, proc.returncode == 0, f"cross_check: {tag}: OK"
                    if proc.returncode == 0 else
                    f"cross_check: {tag}: FAILED\n{proc.stderr[:4000]}"))
    return results


def find_tool(explicit, names):
    if explicit:
        return explicit if shutil.which(explicit) else None
    for n in names:
        if shutil.which(n):
            return n
    return None


def find_toolchain(cc=None, qemu=None):
    """``(aarch64 cross compiler, qemu user-mode binary)``, each None
    when it is not found."""
    return (find_tool(cc, ["aarch64-linux-gnu-gcc",
                           "aarch64-unknown-linux-gnu-gcc"]),
            find_tool(qemu, ["qemu-aarch64", "qemu-aarch64-static"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cc", default=None,
                    help="aarch64 cross compiler (default: autodetect)")
    ap.add_argument("--qemu", default=None,
                    help="qemu user-mode binary (default: autodetect)")
    args = ap.parse_args(argv)
    cc, qemu = find_toolchain(args.cc, args.qemu)
    if cc is None or qemu is None:
        print(f"cross_check: toolchain missing (cc={cc}, qemu={qemu})",
              file=sys.stderr)
        return 2

    failures = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, g0 in nets().items():
            _, qg, xs = prepare(name, g0)
            for _, ok, msg in check_net(name, qg, xs, cc=cc,
                                        run=[qemu, "-cpu", "max"],
                                        variants=ARM_VARIANTS, tmp=tmp):
                failures += not ok
                print(msg, file=sys.stdout if ok else sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
