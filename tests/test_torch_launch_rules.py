"""The port's sharding rule tables, entry for entry against the JAX
package's.

``param_specs``, ``cache_specs`` and ``batch_specs`` of both packages on
the same duck-typed mesh (``axis_names`` and a ``shape`` mapping, which
both packages' rule functions read; no devices and no process group),
for every arch of ``configs/lm_archs.py`` at full width (the JAX shapes
from ``jax.eval_shape``, the port's on ``meta``), on meshes (16, 16),
(2, 16, 16), (2, 4) and (1, 1), with the MoE rule ``"tp"`` and ``"ep"``
(the JAX package reads ``NNCG_MOE``, set here with ``monkeypatch``).
Then ``spec_for`` / ``_fit`` on shapes that do not divide, and
``to_placements``.
"""
import functools
from types import SimpleNamespace

import jax
import pytest

from repro.configs.lm_archs import ARCHS as JAX_ARCHS
from repro.configs.lm_archs import SHAPES
from repro.launch import sharding as jsh
from repro.launch.specs import batch_shapes as jax_batch_shapes
from repro.models.stack import init_cache as jax_init_cache
from repro.models.stack import init_params as jax_init_params
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.core.tree import leaves_with_paths
from repro_torch.launch import sharding
from repro_torch.launch.mesh import DEFAULT_AXES
from repro_torch.launch.specs import batch_shapes
from repro_torch.models.stack import init_cache, init_params

MESHES = [(16, 16), (2, 16, 16), (2, 4), (1, 1)]
CACHE_B, CACHE_S = 128, 32768  # the decode_32k cell


def _mesh(shape):
    axes = DEFAULT_AXES[len(shape)]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in path)


def _jax_specs(tree):
    return {_path(path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree, specs):
    return {path: spec for (path, _), spec in sharding.spec_leaves(tree, specs)}


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    cfg = JAX_ARCHS[arch]
    return (jax.eval_shape(lambda: jax_init_params(cfg)),
            jax.eval_shape(lambda: jax_init_cache(cfg, CACHE_B, CACHE_S)))


@pytest.mark.parametrize("moe", ["tp", "ep"])
@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rule_tables_equal_jax(arch, mesh_shape, moe, monkeypatch):
    if moe == "ep":
        monkeypatch.setenv("NNCG_MOE", "ep")
    else:
        monkeypatch.delenv("NNCG_MOE", raising=False)
    mesh = _mesh(mesh_shape)
    jparams, jcaches = _jax_shapes(arch)
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    params = init_params(cfg, device="meta")
    assert _port_specs(params, sharding.param_specs(mesh, params, moe)) \
        == _jax_specs(jsh.param_specs(mesh, jparams))
    caches = init_cache(cfg, CACHE_B, CACHE_S, "meta")
    assert [p for p, _ in leaves_with_paths(caches)] == [
        _path(p) for p, _ in jax.tree_util.tree_flatten_with_path(jcaches)[0]]
    assert _port_specs(caches, sharding.cache_specs(mesh, cfg, caches)) \
        == _jax_specs(jsh.cache_specs(mesh, jcfg, jcaches))
    for name, sh in SHAPES.items():
        args = (sh["kind"], sh["global_batch"], sh["seq_len"])
        got = sharding.batch_specs(mesh, cfg, batch_shapes(cfg, *args))
        want = jsh.batch_specs(mesh, jcfg, jax_batch_shapes(jcfg, *args))
        assert got == {k: tuple(v) for k, v in want.items()}, name


@pytest.mark.parametrize("mesh_shape,shape,rule", [
    ((16, 16), (10, 48), ("data", "model")),        # 10 % 16: dropped
    ((16, 16), (48, 10), ("data", "model")),
    ((2, 16, 16), (40, 7), (("pod", "data"), None)),  # 40 % 32: dropped
    ((2, 16, 16), (64, 7), (("pod", "data"), None)),  # kept as a pair
    ((2, 4), (6, 12, 3), ("model", ("data", "model"), "data")),
    ((1, 1), (3, 5), ("data", "model")),              # size 1 always fits
    ((2, 4), (8, 8), ("pod", None)),                  # no such axis
])
def test_spec_for_drops_what_does_not_divide(mesh_shape, shape, rule):
    mesh = _mesh(mesh_shape)
    assert sharding.spec_for(mesh, shape, rule) == tuple(
        jsh.spec_for(mesh, shape, rule))
    for size, axes in zip(shape, rule):
        assert sharding._fit(mesh, size, axes) == jsh._fit(mesh, size, axes)


def test_to_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh((2, 16, 16))
    assert sharding.to_placements(mesh, (("pod", "data"), "model")) == [
        Shard(0), Shard(0), Shard(1)]
    assert sharding.to_placements(mesh, (None, "model")) == [
        Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="axis order"):
        sharding.to_placements(mesh, (("data", "pod"), None))
    assert sharding.local_shape(mesh, (64, 32), (("pod", "data"), "model")) \
        == (2, 2)
