"""Device meshes over ``torch.distributed`` (the port of the JAX package's
``launch/mesh.py``).

Functions, not module-level constants: importing this module starts no
process group and touches no device.  Shapes: one pod is 16 x 16 = 256
ranks (data, model); multi-pod is 2 pods = 512 ranks with a leading
``pod`` axis that extends data parallelism across the pods.

A mesh needs a process group of its size.  :func:`process_group` makes
the default group once and it lives for the process, as JAX's device
state does: under a launcher (``torchrun``'s ``RANK`` / ``WORLD_SIZE``
environment) it joins that group; otherwise, at world size 1, it starts
a single-rank group on a ``FileStore`` in a temporary directory (no
network), NCCL on the card and gloo on the CPU; any other world size
raises.  :func:`fake_process_group` starts the ``fake`` backend's group
of any size for the dry-run, where no collective moves data.

The mesh rules (:mod:`repro_torch.launch.sharding`) read a mesh through
:func:`axis_names` and :func:`axis_size`, which take a
``DeviceMesh`` or any object with the JAX mesh's ``axis_names`` and
``shape`` (a mapping of axis name to size), so the rule tables can be
evaluated for a production mesh without its 256 ranks.
"""
from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _close(tmpdir: str) -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(tmpdir, ignore_errors=True)


def process_group(world_size: int, device_type: str = "cuda") -> None:
    """Make sure the default process group spans ``world_size`` ranks
    with the backend of ``device_type`` (NCCL for ``"cuda"``, gloo for
    ``"cpu"``); see the module docstring.  Raises ``RuntimeError`` when
    the existing group, or the launcher's, has another size or backend,
    and when ``world_size`` > 1 has no launcher."""
    want = _backend_for(device_type)
    if dist.is_initialized():
        have, backend = dist.get_world_size(), str(dist.get_backend())
        if have != world_size:
            raise RuntimeError(f"the process group has {have} ranks; a mesh "
                               f"of {world_size} needs as many")
        if want not in backend and backend != "fake":
            raise RuntimeError(f"the process group's backend is {backend!r}; "
                               f"a {device_type} mesh needs {want!r}")
        return
    device_id = None
    if device_type == "cuda":
        device_id = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device_id)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # a launcher
        if int(os.environ["WORLD_SIZE"]) != world_size:
            raise RuntimeError(f"the launcher started {os.environ['WORLD_SIZE']}"
                               f" ranks; a mesh of {world_size} needs as many")
        dist.init_process_group(want, device_id=device_id)
        return
    if world_size != 1:
        raise RuntimeError(f"a mesh of {world_size} ranks needs a launcher "
                           f"(torchrun --nproc-per-node {world_size}); this "
                           f"process is alone")
    tmpdir = tempfile.mkdtemp(prefix="repro_torch_pg_")
    dist.init_process_group(
        want, store=dist.FileStore(os.path.join(tmpdir, "store"), 1),
        rank=0, world_size=1, device_id=device_id)
    atexit.register(_close, tmpdir)


def fake_process_group(world_size: int) -> None:
    """The default group as the ``fake`` backend's, rank 0 of
    ``world_size``: collectives return at once and move nothing (the
    dry-run's).  Raises if a real group exists."""
    if dist.is_initialized():
        if str(dist.get_backend()) == "fake" and \
                dist.get_world_size() == world_size:
            return
        raise RuntimeError("a process group exists already; the dry-run "
                           "needs a process of its own")
    dist.init_process_group("fake", rank=0, world_size=world_size)


def make_mesh(shape: Sequence[int], axes: Optional[Sequence[str]] = None,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` (e.g. (2, 2, 2)) with the JAX
    package's axis names by default: ``("data", "model")`` for two axes,
    ``("pod", "data", "model")`` for three.  Joins or starts the process
    group it needs (:func:`process_group`)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes) if axes is not None else DEFAULT_AXES[len(shape)]
    if not dist.is_initialized() or str(dist.get_backend()) != "fake":
        process_group(math.prod(shape), device_type)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def production_shape(multi_pod: bool) -> Tuple[int, ...]:
    """16 x 16 (data, model), or 2 x 16 x 16 (pod, data, model)."""
    return (2, 16, 16) if multi_pod else (16, 16)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return make_mesh(production_shape(multi_pod), device_type=device_type)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _size(mesh, name: str) -> int:
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(mesh.mesh_dim_names.index(name))
    return int(mesh.shape[name])


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: ('pod', 'data') on multi-pod, ('data',)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def axis_size(mesh, *names) -> int:
    """The product of the named axes' sizes (axes the mesh lacks: 1)."""
    s = 1
    for n in names:
        if n in axis_names(mesh):
            s *= _size(mesh, n)
    return s
