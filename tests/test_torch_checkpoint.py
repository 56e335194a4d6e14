"""The port's checkpoints (``repro_torch.checkpoint``) and its training
training script's preemption and resume (``repro_torch.launch.train``) on the
CPU, with the JAX package's checkpoints on either side of the cross-format
tests.

The port's versions of the JAX suite's checkpoint tests
(``tests/test_substrates.py``), a missing key, a bf16 tree restored bit
for bit, and an fp32 train state written by each package and restored
by the other, bit for bit.  The preempt-and-resume test is the JAX
suite's on the port's training script with ``--device cpu``, on a ``.smoke()``
arch: the final arrays equal the straight run's at rtol 1e-5 /
atol 1e-6.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import restore as jax_restore
from repro.checkpoint.checkpoint import save as jax_save
from repro.configs.lm_archs import ARCHS as JAX_ARCHS
from repro.optim import AdamW as JaxAdamW
from repro_torch.checkpoint import all_steps, latest_step, restore, save
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.core.tree import leaves, leaves_with_paths
from repro_torch.models import from_jax_params, from_jax_train_state
from test_torch_lm_model import perturbed_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"a": torch.from_numpy(r.normal(size=(4, 3)).astype(np.float32)),
            "nested": [torch.from_numpy(r.integers(0, 5, (2,))),
                       torch.from_numpy(r.normal(size=(5,)).astype(
                           np.float32))]}


def _equal(got, want):
    for (kg, a), (kw, b) in zip(leaves_with_paths(got),
                                leaves_with_paths(want)):
        assert kg == kw and a.dtype == b.dtype, (kg, kw, a.dtype, b.dtype)
        assert torch.equal(a, b), kg


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    t = _tree()
    save(d, 10, t)
    save(d, 20, t)
    assert all_steps(d) == [10, 20]
    assert latest_step(d) == 20
    _equal(restore(d, 10, t), t)


def test_checkpoint_gc_keeps_latest(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4, 5):
        save(d, s, _tree(), keep=2)
    assert all_steps(d) == [4, 5]


def test_checkpoint_atomic_no_partial(tmp_path):
    """A tmp dir from a crashed writer is never visible as a checkpoint."""
    d = str(tmp_path / "ckpt")
    save(d, 1, _tree())
    os.makedirs(os.path.join(d, "tmp.99"))  # simulated crash mid-write
    assert all_steps(d) == [1]
    assert latest_step(str(tmp_path / "none")) is None


def test_checkpoint_missing_key_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 1, _tree())
    like = {**_tree(), "extra": torch.zeros(2)}
    with pytest.raises(ValueError, match="missing keys.*extra"):
        restore(d, 1, like)
    with pytest.raises(ValueError, match="shape"):
        restore(d, 1, {**_tree(), "a": torch.zeros(3, 4)})


def test_checkpoint_bf16_roundtrip_bit_for_bit(tmp_path):
    d = str(tmp_path / "ckpt")
    r = np.random.default_rng(4)
    t = {"w": torch.from_numpy(r.normal(size=(7, 5)).astype(
        np.float32)).to(torch.bfloat16),
         "s": [torch.tensor(3, dtype=torch.int32),
               torch.tensor([-0.0, float("inf"), 1e-40]).to(torch.bfloat16)]}
    save(d, 3, t)
    got = restore(d, 3, t)
    for a, b in zip(leaves(got), leaves(t)):
        assert a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        else:
            assert torch.equal(a, b)


def _jax_state(arch="gemma3-4b"):
    cfg = JAX_ARCHS[arch].smoke()
    params = perturbed_jax_params(cfg)
    opt = JaxAdamW()
    st = opt.init(params)
    r = np.random.default_rng(5)
    noisy = jax.tree.map(lambda a: jnp.asarray(
        r.normal(size=a.shape).astype(np.float32)), (st.mu, st.nu))
    return (params, st._replace(step=jnp.int32(7), mu=noisy[0],
                                nu=noisy[1]), jnp.int32(7))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A fp32 train state saved by the JAX package restores in the port
    bit for bit (the JAX keys: tuple indices, ``mu``/``nu``/``step`` by
    field name)."""
    d = str(tmp_path / "ckpt")
    jstate = _jax_state()
    jax_save(d, 7, jstate)
    like = from_jax_train_state(ARCHS["gemma3-4b"].smoke(),
                                jax.tree.map(np.asarray, jstate))
    got = restore(d, 7, like)
    _equal(got[0], like[0])
    _equal(tuple(got[1]), tuple(like[1]))
    assert int(got[2]) == 7 and got[2].dtype == torch.int32


def test_port_checkpoint_restores_in_jax(tmp_path):
    d = str(tmp_path / "ckpt")
    jstate = _jax_state()
    state = from_jax_train_state(ARCHS["gemma3-4b"].smoke(),
                                 jax.tree.map(np.asarray, jstate))
    save(d, 7, state)
    got = jax_restore(d, 7, jax.eval_shape(lambda: jstate))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _bf16_params(arch="zamba2-2.7b"):
    """A bf16 ``.smoke()`` param tree of the JAX package (bf16 weights,
    fp32 norms, conv weights and biases) with numpy leaves."""
    from dataclasses import replace
    from repro.models.stack import init_params as jax_init_params
    jcfg = replace(JAX_ARCHS[arch].smoke(), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(3)))
    cfg = replace(ARCHS[arch].smoke(), dtype="bfloat16")
    return tree, from_jax_params(cfg, tree)


def test_jax_bf16_checkpoint_restores_in_the_port(tmp_path):
    """The JAX ``save`` writes bf16 leaves as 2-byte void (``|V2``)
    arrays and lists no bf16 keys; the port restores them bit for bit."""
    d = str(tmp_path / "ckpt")
    tree, like = _bf16_params()
    assert any(a.dtype.name == "bfloat16" for a in jax.tree.leaves(tree))
    jax_save(d, 2, tree)
    _equal(restore(d, 2, like), like)
    assert any(a.dtype == torch.bfloat16 for a in leaves(like))


def test_port_bf16_checkpoint_has_the_jax_form(tmp_path):
    """For the same values the port's ``arrays.npz`` holds the keys,
    dtypes and bytes the JAX ``save`` writes; the port's manifest keeps
    its ``"bfloat16"`` list."""
    tree, like = _bf16_params()
    jax_save(str(tmp_path / "jax"), 1, tree)
    save(str(tmp_path / "port"), 1, like)
    with np.load(tmp_path / "jax" / "step_1" / "arrays.npz") as zj, \
            np.load(tmp_path / "port" / "step_1" / "arrays.npz") as zp:
        assert sorted(zj.files) == sorted(zp.files)
        n_bf16 = 0
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype, k
            assert zp[k].tobytes() == zj[k].tobytes(), k
            n_bf16 += zj[k].dtype == np.dtype("V2")
    assert n_bf16 > 0
    with open(tmp_path / "port" / "step_1" / "manifest.json") as f:
        listed = json.load(f)["bfloat16"]
    assert len(listed) == n_bf16


def test_port_bf16_tree_roundtrips_and_the_reference_refuses_it(tmp_path):
    """A bf16 param tree saved and restored by the port is bit-equal.
    The JAX ``restore`` cannot cast a ``|V2`` leaf, on the port's file as
    on its own: it raises rather than loading wrong numbers."""
    tree, like = _bf16_params()
    d = str(tmp_path / "ckpt")
    save(d, 5, like)
    _equal(restore(d, 5, like), like)
    with pytest.raises(ValueError, match="cast"):
        jax_restore(d, 5, tree)


def test_port_restores_its_older_uint16_bf16_files(tmp_path):
    """Checkpoints the port wrote before it took the reference's form
    (bf16 bits as uint16, listed under ``"bfloat16"``) still restore."""
    d = tmp_path / "ckpt" / "step_1"
    d.mkdir(parents=True)
    w = torch.tensor([1.5, -2.25, 3.0]).to(torch.bfloat16)
    np.savez(d / "arrays.npz", w=w.view(torch.int16).numpy().view(np.uint16))
    (d / "manifest.json").write_text(json.dumps(
        {"step": 1, "keys": ["w"], "bfloat16": ["w"]}))
    got = restore(str(tmp_path / "ckpt"), 1, {"w": w})
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))


def test_preempt_and_resume_matches_the_straight_run(tmp_path):
    """Train 6 steps with a kill at 4, resume, and compare the final
    checkpoint with an uninterrupted 6-step run: deterministic data and
    checkpointing make them equal."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    common = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
              "gemma3-4b", "--smoke", "--steps", "6", "--batch", "2",
              "--seq", "32", "--ckpt-every", "2", "--log-every", "1",
              "--device", "cpu"]

    def run(*extra):
        return subprocess.run(common + list(extra), env=env, cwd=REPO,
                              capture_output=True, text=True, timeout=300)

    d1 = str(tmp_path / "interrupted")
    r = run("--ckpt-dir", d1, "--preempt-at", "4")
    assert r.returncode == 17, r.stderr[-2000:]
    assert latest_step(d1) == 4
    r = run("--ckpt-dir", d1)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed from step 4" in r.stdout
    assert "[train] done:" in r.stdout

    d2 = str(tmp_path / "straight")
    r = run("--ckpt-dir", d2)
    assert r.returncode == 0, r.stderr[-2000:]
    z1 = np.load(os.path.join(d1, "step_6", "arrays.npz"))
    z2 = np.load(os.path.join(d2, "step_6", "arrays.npz"))
    assert sorted(z1.files) == sorted(z2.files)
    assert "1/mu/embed" in z1.files and "2" in z1.files
    for k in z1.files:
        np.testing.assert_allclose(z1[k], z2[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_train_script_refuses_a_missing_card():
    """Asked for the card where there is none, the script raises; it
    does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--arch", "gemma3-4b", "--smoke", "--steps", "1"])
