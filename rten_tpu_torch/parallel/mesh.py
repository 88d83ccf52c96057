"""Device meshes over the ranks of a ``torch.distributed`` group (the port
of ``rten_tpu/parallel/mesh.py``).

A ``Mesh`` arranges ``data * model`` ranks as a ('data', 'model') grid with
``torch.distributed.device_mesh.DeviceMesh``: each axis gets its process
groups, registered under names that a rank-local graph's collective ops
carry (``ops/collective.py``). Rank ``d * model + m`` sits at (d, m).

Each rank runs on one device, named explicitly: the caller's ``device``,
else ``devices[rank]``, else ``cuda:<local rank>`` where there is a card
and the CPU where there is none. Two ranks may name the same card (the
gloo backend; NCCL refuses it).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence

import torch

from ..ops.collective import register_group

AXES = ("data", "model")
_mesh_ids = itertools.count()


@dataclasses.dataclass
class MeshConfig:
    """data = batch replication axis, model = tensor-parallel axis."""

    data: int = 1
    model: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


class Mesh:
    """A ('data', 'model') mesh: ``shape`` {axis: size}, this rank's
    ``coords`` {axis: index} and ``device``, each axis's process ``group``
    and the ``key`` it is registered under."""

    def __init__(self, config: MeshConfig, device_mesh, device: torch.device):
        self.config = config
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        self.shape = config.shape
        coord = device_mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not part of the mesh")
        self.coords = dict(zip(AXES, coord))
        self._id = next(_mesh_ids)
        for axis in AXES:
            register_group(self.key(axis), self.group(axis))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def key(self, axis: str) -> str:
        """The name of ``axis``'s group in the collective ops' registry."""
        return f"mesh{self._id}:{axis}"

    def __repr__(self):
        return f"Mesh({self.shape}, coords={self.coords}, device={self.device})"


def make_mesh(config: Optional[MeshConfig] = None, devices: Optional[Sequence] = None,
              device=None) -> Mesh:
    """Build a ('data', 'model') mesh over the first ``config.n_devices``
    ranks of the default group (``init_distributed`` first).

    Defaults to every rank on the model axis (TP-first, as the JAX package).
    A mesh larger than the world raises. ``device`` (this rank's) or
    ``devices`` (every rank's, by rank) name the devices; see the module
    doc for the default."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from .distributed import local_rank

    world = dist.get_world_size()
    if config is None:
        config = MeshConfig(data=1, model=world)
    if config.n_devices > world:
        raise ValueError(f"mesh {config} needs {config.n_devices} devices, have {world}")
    rank = dist.get_rank()
    if device is None:
        if devices is not None:
            device = devices[rank]
        elif torch.cuda.is_available():
            device = f"cuda:{local_rank()}"
        else:
            device = "cpu"
    device = torch.device(device)
    # The mesh's own device type matters only to DTensor, which the port
    # does not use; gloo groups are made on the CPU type so that no card is
    # selected behind the caller's back.
    mesh_type = device.type if dist.get_backend() == "nccl" else "cpu"
    grid = torch.arange(config.n_devices).reshape(config.data, config.model)
    dm = DeviceMesh(mesh_type, grid, mesh_dim_names=AXES)
    return Mesh(config, dm, device)
