"""Device meshes (the port of the JAX package's ``launch/mesh.py``).

``make_mesh`` lays a ``DeviceMesh`` over the current process group (one
rank per mesh position, rank order row-major over the named dims).
Real ranks are started by ``core/mesh.py:run_ranks``; the production
meshes of the dry run live in one process, on a ``fake`` process group of
256 or 512 ranks (``fake_world``): its collectives move nothing, which
under ``FakeTensorMode`` is all a trace needs.  That is the counterpart
of the reference's 512 forced host devices.  ``use_mesh`` makes a mesh
the one ``models/sharding.constrain`` and the MoE's expert parallelism
see.

The fake backend is a testing module of torch
(``torch.testing._internal.distributed.fake_pg``, checked on torch 2.11
and 2.13); it is imported only when a fake world is asked for.
"""
from __future__ import annotations

import contextlib
import math
import shutil
import tempfile

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..models.sharding import mesh_scope

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape, axes, device_type: str = "cpu"):
    """A mesh of ``shape`` named ``axes`` over the current process group,
    whose world size must be ``prod(shape)``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start ranks with core.mesh.run_ranks "
                           "or a fake world with launch.mesh.fake_world")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def use_mesh(mesh):
    """Context manager making ``mesh`` the ambient mesh."""
    return mesh_scope(mesh)


def fake_world(world_size: int, rank: int = 0) -> None:
    """Make the default process group a ``fake`` one of ``world_size``
    ranks (this process plays ``rank``), replacing an earlier fake one;
    raises if a real process group is up."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized: a fake world "
                               "would replace it")
        if dist.get_world_size() == world_size and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod",
    "data", "model")`` with ``multi_pod``, on a fake world of 256 or 512
    ranks (rank 0's view)."""
    shape, axes = PRODUCTION[multi_pod]
    fake_world(math.prod(shape))
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """A small ``("data", "model")`` mesh over the current process group
    (tests, examples and the launchers, which run on a mesh of one)."""
    return make_mesh((data, model), ("data", "model"), device_type)


@contextlib.contextmanager
def mesh_of_one(device):
    """A ``(1, 1)`` host mesh, made ambient, over a process group of one that
    is started here (gloo for the CPU, NCCL for a card, joined through a
    file in a temporary directory) unless one is up: the launchers
    run in it, as the reference's do on ``make_host_mesh()``."""
    tmp = None
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/store", world_size=1, rank=0)
    try:
        mesh = make_host_mesh(1, 1, device_type=device.type)
        with use_mesh(mesh):
            yield mesh
    finally:
        if tmp is not None:
            dist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)


def mesh_tag(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)
