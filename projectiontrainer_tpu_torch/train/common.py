"""Shared trainer plumbing: step accounting, batch feeding, host readback.

Counterpart of ``projectiontrainer_tpu/train/common.py``. The port runs one process
on one device; a data-parallel world (``torch.distributed``) enters only through the
process shard of ``data/pipeline.py`` and the batch arithmetic below, which count
processes the way the JAX package counts hosts.
"""

from __future__ import annotations

import math
import os
from typing import Iterator

import numpy as np
import torch

from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.core.config import CommonConfig
from projectiontrainer_tpu_torch.data import pipeline as pipe


def check_one_device(cfg: CommonConfig) -> None:
    """Refuse what would need more than one device: multi-device training is not
    ported. ``--mesh_data``/``--mesh_model`` -1 mean every visible device (the JAX
    package's ``core/mesh.py``), so they are refused too when more than one GPU is
    visible."""
    if cfg.mesh_data > 1 or cfg.mesh_model > 1 or cfg.fsdp:
        raise NotImplementedError("--mesh_data/--mesh_model above 1 and --fsdp: "
                                  "multi-device training is not ported")
    if (-1 in (cfg.mesh_data, cfg.mesh_model) and torch.device(cfg.device).type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            f"--mesh_data {cfg.mesh_data} --mesh_model {cfg.mesh_model}: -1 means every "
            f"visible GPU ({torch.cuda.device_count()} here), and multi-device training is "
            "not ported: pass --mesh_data 1 --mesh_model 1, or narrow CUDA_VISIBLE_DEVICES "
            "to one card")


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
