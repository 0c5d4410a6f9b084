"""The data x model mesh of a multi-process run: one process is one device.

Counterpart of ``projectiontrainer_tpu/core/mesh.py``. The JAX package lays its
devices out on a ``data`` x ``model`` mesh; the port runs one process per GPU joined by
``torch.distributed`` (``parallel/distributed.py``), so its mesh is the world of
processes and ``build_mesh`` resolves ``MeshConfig`` against the world size:
``--mesh_data -1`` means every rank. Rank r sits at ``(r // model, r % model)``, the
JAX layout ``np.asarray(devices).reshape(data, model)``: the ``model`` ranks of one
replica are consecutive (one host's cards, joined by NVLink), and
``distributed.setup_mesh`` creates their groups. A deliberate divergence from the JAX
package: a fully specified mesh must use every rank (the JAX package takes a prefix of
its devices, ``--mesh_data 2`` on 8 chips trains on 2; an idle process has nothing to
do), so a mesh smaller than the world raises.
"""

from __future__ import annotations

import dataclasses

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh shape; ``data`` x ``model`` must equal the number of devices (or -1 to infer)."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        data, model = self.data, self.model
        if data == -1 and model == -1:
            raise ValueError("at most one mesh axis may be -1")
        if data == -1:
            data = n_devices // model
        if model == -1:
            model = n_devices // data
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} != device count {n_devices}"
            )
        return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The resolved mesh: ``data`` replicas of ``model`` ranks each (``model`` 1: every
    rank holds a whole replica)."""

    data: int
    model: int = 1

    @property
    def size(self) -> int:
        return self.data * self.model


def build_mesh(config: MeshConfig, world_size: int) -> Mesh:
    """The mesh of ``config`` over ``world_size`` processes; ``ValueError`` for a mesh
    that is not the world."""
    if config.data == -1 and config.model > 0 and world_size % config.model:
        raise ValueError(
            f"--mesh_model {config.model} does not divide the world of {world_size} "
            "process(es): start data x model processes, one per device, with "
            "projectiontrainer-torch-launch --nproc_per_node N (or torchrun)")
    if config.data > 0 and config.model > 0 and config.data * config.model != world_size:
        raise ValueError(
            f"mesh {config.data}x{config.model} needs {config.data * config.model} "
            f"processes and the world has {world_size}: start one process per device with "
            "projectiontrainer-torch-launch --nproc_per_node N (or torchrun), or pass "
            "--mesh_data -1")
    data, model = config.resolve(world_size)
    return Mesh(data=data, model=model)
