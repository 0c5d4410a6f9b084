"""The data x model mesh of a multi-process run: one process is one device.

Counterpart of ``projectiontrainer_tpu/core/mesh.py``. The JAX package lays its
devices out on a ``data`` x ``model`` mesh; the port runs one process per GPU joined by
``torch.distributed`` (``parallel/distributed.py``), so its mesh is the world of
processes and ``build_mesh`` resolves ``MeshConfig`` against the world size:
``--mesh_data -1`` means every rank. Rank r sits at ``(r // model, r % model)``, the
JAX layout ``np.asarray(devices).reshape(data, model)``: the ``model`` ranks of one
replica are consecutive (one host's cards, joined by NVLink), and
``distributed.setup_mesh`` creates their groups. A fully specified mesh smaller than the
world takes its first ``data x model`` ranks, as the JAX package takes a prefix of its
devices (``--mesh_data 2`` on 8 chips trains on 2); the ranks beyond it join the world
and its group creation, then leave it idle (``distributed.idle``; they exit 0 and enter
no collective of the step). A deliberate divergence: the JAX package's idle devices
belong to a process that trains; the port's are processes of their own. A mesh larger
than the world raises.
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
    """The mesh of ``config`` over ``world_size`` processes: a fully specified mesh takes
    the first ``data x model`` of them (``Mesh.size`` may be below the world);
    ``ValueError`` for a mesh larger than the world, or a model axis that does not
    divide it where the data axis is inferred."""
    if config.data == -1 and config.model > 0 and world_size % config.model:
        raise ValueError(
            f"--mesh_model {config.model} does not divide the world of {world_size} "
            "process(es): start data x model processes, one per device, with "
            "projectiontrainer-torch-launch --nproc_per_node N (or torchrun)")
    if config.data > 0 and config.model > 0:
        if config.data * config.model > world_size:
            raise ValueError(
                f"mesh {config.data}x{config.model} needs {config.data * config.model} "
                f"processes and the world has {world_size}: start one process per device "
                "with projectiontrainer-torch-launch --nproc_per_node N (or torchrun), or "
                "pass --mesh_data -1")
        return Mesh(data=config.data, model=config.model)
    data, model = config.resolve(world_size)
    return Mesh(data=data, model=model)
