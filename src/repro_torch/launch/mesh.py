"""Process meshes (``repro.launch.mesh``) and the world they run in.

JAX runs SPMD in one process over a ``Mesh`` of devices.  The port runs one
process per rank in a ``torch.distributed`` world, arranged as a
:class:`~torch.distributed.device_mesh.DeviceMesh` with dims ``("data",
"model")`` or ``("pod", "data", "model")``:

  * single pod: 16x16 = 256 ranks, dims (data, model);
  * multi-pod:  2x16x16 = 512 ranks, dims (pod, data, model); ``pod``
    composes with ``data`` for batch sharding while ``model`` stays
    intra-pod.

Every ``make_*_mesh`` needs the world to exist (:func:`init_world`).
:class:`MeshSpec` is the mesh's shape and dim names without any process
group: the sharding rules of :mod:`repro_torch.distributed.sharding` take
either, so they run at production shapes in one process.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device

__all__ = ["MeshSpec", "POD_SHAPE", "MULTIPOD_SHAPE", "init_world", "world",
           "make_production_mesh", "make_debug_mesh", "make_subset_mesh",
           "production_spec"]

POD_SHAPE = (16, 16)
MULTIPOD_SHAPE = (2, 16, 16)
_POD_DIMS = ("data", "model")
_MULTIPOD_DIMS = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's dim sizes and names, with ``DeviceMesh``'s read-only
    surface (``shape``, ``mesh_dim_names``, ``size``) and no process
    group."""

    shape: tuple
    mesh_dim_names: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"shape {self.shape} and dims "
                             f"{self.mesh_dim_names} differ in length")

    def size(self, mesh_dim=None) -> int:
        return (math.prod(self.shape) if mesh_dim is None
                else self.shape[mesh_dim])


def production_spec(*, multi_pod: bool = False) -> MeshSpec:
    """The production mesh's :class:`MeshSpec` (no world needed)."""
    return (MeshSpec(MULTIPOD_SHAPE, _MULTIPOD_DIMS) if multi_pod
            else MeshSpec(POD_SHAPE, _POD_DIMS))


def init_world(device=None, backend=None) -> bool:
    """Join the ``torch.distributed`` world; True iff this call created it.

    Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in the
    environment) it joins that world and, on the card, makes
    ``cuda:LOCAL_RANK`` the current device.  Otherwise it makes a world of
    one over an in-process store.  ``backend`` defaults to ``nccl`` on the
    card and ``gloo`` on the CPU.  An existing world is left as it is
    (False): the default process group is process-global, so only its
    creator destroys it (:func:`world`).
    """
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


@contextlib.contextmanager
def world(device=None, backend=None):
    """:func:`init_world` for the ``with`` body; destroys the world after
    it iff this call created it."""
    created = init_world(device, backend)
    try:
        yield
    finally:
        if created:
            dist.destroy_process_group()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, dims, device_type=None) -> DeviceMesh:
    """A ``DeviceMesh`` over the first ``prod(shape)`` ranks of the world,
    rank-major in ``shape``; every rank of the world must call it."""
    need = math.prod(shape)
    have = dist.get_world_size()
    if need > have:
        raise ValueError(
            f"subset mesh needs {need} ranks, only {have} exist")
    return DeviceMesh(device_type or _device_type(),
                      torch.arange(need).reshape(shape),
                      mesh_dim_names=tuple(dims))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    spec = production_spec(multi_pod=multi_pod)
    return _mesh(spec.shape, spec.mesh_dim_names, device_type)


def make_debug_mesh(n_devices=None, model: int = 2, device_type=None):
    """Small mesh over the world's ranks (tests / examples):
    ``(n // model, model)`` with ``model`` cut to ``n``."""
    n = n_devices or dist.get_world_size()
    model = min(model, n)
    return _mesh((n // model, model), _POD_DIMS, device_type)


def make_subset_mesh(data: int, model: int = 1, device_type=None):
    """(data, model) mesh over the FIRST ``data * model`` ranks, for sweeps
    over meshes smaller than the world."""
    return _mesh((data, model), _POD_DIMS, device_type)
