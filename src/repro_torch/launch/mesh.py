"""Device meshes over the ``torch.distributed`` world — the port of
``repro.launch.mesh``.

A function, not a module-level constant: importing this module starts
no process group. ``make_host_mesh`` runs over whatever world exists (a
``torchrun`` launch: one process a card) and starts a world of one rank
when there is none. ``make_production_mesh`` builds ``repro``'s
``(16, 16)`` or ``(2, 16, 16)`` mesh, which only a world of 256 or 512
ranks can hold: the dry run's fake process group
(``launch/dryrun.py``).
"""
from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels.backend import resolve_device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(device=None) -> torch.device:
    """Join the ``torch.distributed`` world, or start one: from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``PORT``) when it is set, else a world of one rank
    on a free ``localhost`` port. NCCL on the card, gloo when the
    caller asks for the CPU. Returns this rank's device (``cuda:<local
    rank>`` on the card)."""
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, device_id=(
                device if device.type == "cuda" else None))
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                world_size=1, rank=0)
    return device


def make_host_mesh(model_parallel: int = 1, device=None) -> DeviceMesh:
    """A ``(world // model_parallel, model_parallel)`` mesh named
    ``("data", "model")`` over the world (``init_world``)."""
    device = init_world(device)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel="
                         f"{model_parallel}")
    return init_device_mesh(device.type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """``repro``'s production mesh: ``(16, 16)`` ``("data", "model")``
    or ``(2, 16, 16)`` ``("pod", "data", "model")``, over an existing
    world of exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized() or dist.get_world_size() != math.prod(shape):
        raise RuntimeError(f"the production mesh {shape} needs a world of "
                           f"{math.prod(shape)} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def dp_axes(mesh) -> tuple:
    """The data-parallel mesh axes (includes 'pod' when present)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def all_axes(mesh) -> tuple:
    return axis_names(mesh)


def axis_size(mesh, axes) -> int:
    """The number of ranks along ``axes`` (a name or a tuple of names)."""
    axes = (axes,) if isinstance(axes, str) else axes
    names = axis_names(mesh)
    return math.prod(mesh.shape[names.index(a)] for a in axes)
