"""Shared trainer plumbing: step accounting, batch feeding, host readback.

Counterpart of ``projectiontrainer_tpu/train/common.py``. The port runs one process
per device; ``init_world`` joins the data-parallel world (``parallel/distributed.py``),
which enters the feed through the process shard of ``data/pipeline.py``, the batch
arithmetic below (processes counted as the JAX package counts hosts) and
``gather_rows`` (an evaluation's rows from every rank). ``place_params`` is the JAX
package's: the params' shard plan, and under ``--fsdp`` the rank's data shards of them;
``compute_copy`` gathers those once for an evaluation.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Iterator

import numpy as np
import torch

from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.core import dtypes, mesh
from projectiontrainer_tpu_torch.core.config import CommonConfig
from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
from projectiontrainer_tpu_torch.data import pipeline as pipe
from projectiontrainer_tpu_torch.parallel import distributed, sharding


def init_world(cfg: CommonConfig) -> mesh.Mesh:
    """Join the world and resolve the data x model mesh over it; ``cfg.device`` becomes
    the rank's card (``cuda:<local rank>``) and ``cfg.num_loader_procs`` its share of
    the host's feeder workers (the host's count over its ranks).

    A process that a launcher started (``RANK``/``WORLD_SIZE`` set: ``cli/launch.py``
    or ``torchrun``) joins the process group (``parallel/distributed.py``); the mesh
    is then ``--mesh_data`` x ``--mesh_model`` ranks (-1: the rest of the world), and
    the mesh's groups are created. A fully specified mesh smaller than the world takes
    its first ranks; a rank beyond it logs that the mesh leaves it idle and exits 0
    (``SystemExit(0)``) once every rank has created the groups. ``--mesh_model`` above 1 is tensor parallelism (every
    stage: the caller slices its params to the model rank's shards before
    :func:`place_params`). ``--fsdp`` (every stage, with or without ``--mesh_model``)
    shards the params and the optimizer state over the data axis
    (:func:`place_params`); in a world of one it changes nothing. A process that no
    launcher started is a world of one, so ``--mesh_data`` -1 with several GPUs visible
    raises there: every GPU needs a process of its own."""
    device = torch.device(cfg.device)
    if not distributed.launched():
        if (-1 in (cfg.mesh_data, cfg.mesh_model) and device.type == "cuda"
                and torch.cuda.device_count() > 1):
            raise ValueError(
                f"--mesh_data {cfg.mesh_data} --mesh_model {cfg.mesh_model}: -1 means every "
                f"visible GPU ({torch.cuda.device_count()} here), and each needs a process of "
                "its own: start the run with projectiontrainer-torch-launch --nproc_per_node "
                "N (or torchrun), or pass --mesh_data 1 / narrow CUDA_VISIBLE_DEVICES")
        return mesh.build_mesh(mesh.MeshConfig(cfg.mesh_data, cfg.mesh_model), 1)
    distributed.initialize(device.type)
    world = mesh.build_mesh(mesh.MeshConfig(cfg.mesh_data, cfg.mesh_model),
                            distributed.world_size())
    distributed.setup_mesh(world.data, world.model)
    if distributed.idle():
        logging.getLogger(__name__).warning(
            "rank %d is idle: the mesh --mesh_data %d x --mesh_model %d takes the first %d of "
            "the world's %d ranks", distributed.rank(), world.data, world.model, world.size,
            int(os.environ["WORLD_SIZE"]))
        distributed.shutdown()
        raise SystemExit(0)
    if device.type == "cuda" and device.index is None:
        cfg.device = f"cuda:{torch.cuda.current_device()}"
    if cfg.num_loader_procs > 0:
        cfg.num_loader_procs = max(1, cfg.num_loader_procs // distributed.local_world_size())
    return world


def place_params(params: dict, model_cfg, cfg: CommonConfig) -> sharding.ShardPlan:
    """The shard plan of ``params`` (whole, or a model rank's shards: ``setup.build_vlm``
    slices each layer as it builds it, the stage-0 and cls CLIs slice their towers with
    ``sharding.model_shards``; anything else raises) and, under ``--fsdp``,
    each top-level subtree of ``params`` replaced IN PLACE by the rank's data shards
    (the JAX package's ``train/common.py:place_params``). A trainer calls it before it
    casts its trainables to fp32 masters, so no rank ever holds the whole fp32 model.
    The units that the model axis leaves whole (``sharding.units``) are logged once."""
    whole = sharding.check_config(model_cfg, distributed.model_size())
    if whole and distributed.rank() == 0:
        logging.getLogger(__name__).info(
            "tensor parallel over %d model ranks: whole on every rank (the model axis does "
            "not divide them): %s", distributed.model_size(), ", ".join(whole))
    plan = sharding.plan_for(params, model_cfg, fsdp=cfg.fsdp)
    sharding.check_local(params, model_cfg, plan)
    if plan.data_sharded:
        before = _nbytes(params)
        for k in list(params):
            params[k] = sharding.shard_params(params[k], plan, prefix=k,
                                              axes=(sharding.DATA_AXIS,))
        logging.getLogger(__name__).info(
            "--fsdp: %d of %d leaves are data shards over %d ranks; this rank holds %d of "
            "%d bytes of params",
            sum(1 for p, _ in unique_leaves_with_paths(params) if p in plan.data_sharded),
            sum(1 for _ in unique_leaves_with_paths(params)), plan.data, _nbytes(params),
            before)
    return plan


def _nbytes(params) -> int:
    return sum(x.numel() * x.element_size() for _, x in unique_leaves_with_paths(params))


def compute_copy(params, plan: sharding.ShardPlan, compute_dtype=None):
    """The params an evaluation and its generation run on: cast to ``compute_dtype``
    (None: as they are; ties kept) and, under ``--fsdp``, every data shard gathered
    whole after the cast. Gathered once per evaluation, not once per decoded token (a
    collective every data rank enters); the model axis's shards stay shards."""
    if compute_dtype is not None:
        params = dtypes.cast_compute_params(params, compute_dtype)
    if not plan.data_sharded:
        return params
    return sharding.gather_params(params, plan, axes=(sharding.DATA_AXIS,))


def log_thread_feed(cfg: CommonConfig, logger, why: str) -> None:
    """Say once that ``--num_loader_procs`` has no effect on this path."""
    if cfg.num_loader_procs > 0:
        logger.info("--num_loader_procs %d has no effect here: %s, so images are read on "
                    "%d threads (--num_workers)", cfg.num_loader_procs, why, cfg.num_workers)


def global_batch_size(cfg: CommonConfig) -> int:
    """``batch_size`` is per device (reference semantics): batch x world."""
    return cfg.batch_size * pipe.process_index_count()[1]


def steps_per_epoch(n_samples: int, global_batch: int, *, process_count: int = None) -> int:
    """Batches each epoch yields, counted as the feed produces them: every process
    iterates its padded 1/pc index shard in chunks of global_batch / pc."""
    pc = pipe.process_index_count()[1] if process_count is None else process_count
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} not divisible by process count {pc}")
    return math.ceil(math.ceil(n_samples / pc) / (global_batch // pc))


def update_steps(n_samples: int, global_batch: int, accum: int, epochs: int,
                 *, process_count: int = None) -> int:
    per_epoch = math.ceil(steps_per_epoch(n_samples, global_batch,
                                          process_count=process_count) / accum)
    return per_epoch * epochs


def feed(dataset, cfg: CommonConfig, *, epoch: int, shuffle: bool = True) -> Iterator[dict]:
    """Per-epoch batches on ``cfg.device``; images decoded on ``cfg.num_workers``
    threads, or on ``cfg.num_loader_procs`` processes for a dataset with the
    process-feed protocol."""
    yield from pipe.epoch_batches(dataset, batch_size=cfg.batch_size, epoch=epoch,
                                  device=cfg.device, seed=cfg.seed, shuffle=shuffle,
                                  num_workers=cfg.num_workers,
                                  num_procs=cfg.num_loader_procs)


def left_align_padding(ids, pad_id: int) -> np.ndarray:
    """Each row reordered so its pad tokens come first (left padding), the tokens'
    order kept: a generation prefix must end on a real token, because decoding reads
    the next token's logits at the last slot (the reference forces
    ``padding_side='left'`` for generation, Stage2/trainer.py:499-505)."""
    ids = np.asarray(ids)
    order = np.argsort(ids != pad_id, axis=1, kind="stable")
    return np.take_along_axis(ids, order, axis=1)


def to_host(x) -> np.ndarray:
    """A tensor (any device) as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def sync_replicas(params, paths, plan: sharding.ShardPlan = None) -> None:
    """Overwrite the leaves of ``params`` at ``paths`` (the leaves that train) with data
    rank 0's (the same model index's shard): the data-parallel replicas start equal,
    whatever each rank built or restored. The data shards of ``plan`` (``--fsdp``)
    differ by rank and are left alone."""
    skip = plan.data_sharded if plan is not None else frozenset()
    distributed.broadcast_([x for p, x in unique_leaves_with_paths(params)
                            if p in paths and p not in skip])


def gather_rows(x) -> np.ndarray:
    """Every data rank's rows of ``x`` (a tensor or array) on the host, in rank order: what
    the JAX package's ``to_host`` reads from a global array under a data mesh."""
    return distributed.gather_ragged(to_host(x))


def real_rows(batch) -> np.ndarray:
    """Boolean [B] mask of non-filler rows (``sample_weight > 0``; all true when the
    batch carries no weights): host-side eval metrics exclude straggler fillers."""
    w = batch.get("sample_weight")
    if w is None:
        first = next(iter(batch.values()))
        return np.ones((first.shape[0],), bool)
    return to_host(w) > 0


def resume_quant_method(cfg, ckpt_dir: str, logger) -> None:
    """Under ``--resume --enable_qlora``, set ``cfg.quant_method`` to the method the
    newest checkpoint in ``ckpt_dir`` was saved with (the JAX package's
    ``cli/train_stage{1,2}.py``): the base is quantized again from the snapshot and
    must be the one the saved adapters trained over."""
    if not (cfg.resume and cfg.enable_qlora and os.path.isdir(ckpt_dir)):
        return
    saved = CheckpointManager(ckpt_dir).detect_quant_method()
    if saved is not None and saved != cfg.quant_method:
        logger.warning("the checkpoint in %s was saved with quant_method=%s; overriding the "
                       "configured %s", ckpt_dir, saved, cfg.quant_method)
        cfg.quant_method = saved
