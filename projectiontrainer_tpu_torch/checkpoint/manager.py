"""Train-state checkpoints with ``torch.save``: epoch, best, final and step_K.

Counterpart of ``projectiontrainer_tpu/checkpoint/manager.py`` (Orbax) for what stages
0-2 need: ``--resume`` restores the trained params, the optimizer state and the step
count of the newest epoch or step checkpoint. A checkpoint holds the leaves named by
``save_paths``, by default the ones the optimizer state carries; the leaves that never
train come from the model snapshots. Stage 2 names every leaf that trains at any point
of the run: after ``--train_ve_first_epoch``'s swap the tower has no optimizer state,
yet epoch 0 changed it. A tied tensor is saved once, under its first path. Files:
``<dir>/<name>.pt`` with name ``epoch_N``, ``best``, ``final`` or ``step_K`` (only the
newest ``step_K`` is kept); ``manager.json`` records the best metric. ``save_periodic`` saves epoch N when N + 1 is a multiple of
``save_every_n_epochs`` and N >= ``min_save_epoch``.

In a data-parallel world every rank holds the same state: rank 0 writes each file and
the others wait at a barrier (the JAX package's collective save); the best-save
decision takes rank 0's metric everywhere; ``--resume`` reads on every rank. Under
tensor parallelism (``plan``, a ``parallel/sharding.ShardPlan``) each model rank holds
shards: every rank enters the gathers of the sharded params and optimizer slots, rank 0
writes the whole leaves (the file is the one a single process writes), and a restore
slices each leaf to the rank's shard again. The same holds for the data axis under
``--fsdp`` (the plan's data shards, params and optimizer slots alike). Each leaf is
gathered and moved to the host one at a time, so the card never holds the whole state,
and a restore reads the file memory-mapped, each rank copying its blocks.

The cls probe names every leaf of its classifier (the JAX package saves the whole
state): its evaluators rebuild the model from a checkpoint alone (``restore_params``,
the architecture from ``metadata``).

A QLoRA checkpoint holds no quantized leaf (they never train), so ``--resume``
quantizes the base again from the snapshot: ``detect_quant_method`` reads the method
from the newest checkpoint's metadata (the JAX package reads it from the stored
tree's leaf names), and the CLIs let it override ``--quant_method``. Quantization is
deterministic, so the resumed base is the saved run's bit for bit.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Iterable, Optional

import torch

from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths, unique_leaves_with_paths
from projectiontrainer_tpu_torch.parallel import distributed


class CheckpointManager:
    def __init__(self, directory: str, *, save_every_n_epochs: int = 1,
                 min_save_epoch: int = 0, best_mode: str = "min",
                 save_paths: Optional[Iterable[str]] = None, plan=None):
        self.directory = directory
        self.plan = plan
        self.save_paths = None if save_paths is None else frozenset(save_paths)
        self.save_every_n_epochs = save_every_n_epochs
        self.min_save_epoch = min_save_epoch
        self.best_mode = best_mode
        os.makedirs(directory, exist_ok=True)
        self._best_metric = None
        meta = os.path.join(directory, "manager.json")
        if os.path.exists(meta):
            with open(meta) as f:
                self._best_metric = json.load(f).get("best_metric")

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def _host(self, tree: dict) -> dict:
        """{path: leaf} whole on the CPU, on rank 0 (empty elsewhere): each sharded leaf
        gathered (every rank of its axes enters) and moved to the host before the next."""
        out = {}
        for p, x in tree.items():
            whole = x if self.plan is None else self.plan.gather(p, x)
            if distributed.is_main():
                out[p] = whole.detach().cpu()
        return out

    def _save(self, name: str, state: dict, metadata: Optional[dict] = None):
        """Rank 0 writes (tmp + rename); every rank returns once the file is there."""
        keep = (self.save_paths if self.save_paths is not None
                else set(state["opt_state"]["mu"]))
        params = self._host({p: x for p, x in unique_leaves_with_paths(state["params"])
                             if p in keep})
        opt = {k: self._host(v) if isinstance(v, dict) else v
               for k, v in state["opt_state"].items()}
        if distributed.is_main():
            payload = {"params": params, "opt_state": opt,
                       "step": int(state["step"]), "metadata": dict(metadata or {})}
            tmp = self._path(name) + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, self._path(name))
        distributed.barrier()

    def save_periodic(self, epoch: int, state: dict, metadata: Optional[dict] = None) -> bool:
        if epoch < self.min_save_epoch or (epoch + 1) % self.save_every_n_epochs:
            return False
        self._save(f"epoch_{epoch}", state, metadata)
        return True

    def save_best(self, metric: float, state: dict, metadata: Optional[dict] = None) -> bool:
        # the decision gates a save every rank enters: take rank 0's metric everywhere
        metric = distributed.broadcast_value(metric)
        better = (self._best_metric is None
                  or (self.best_mode == "min" and metric < self._best_metric)
                  or (self.best_mode == "max" and metric > self._best_metric))
        if not better:
            return False
        self._best_metric = metric
        self._save("best", state, {**(metadata or {}), "best_metric": metric})
        if distributed.is_main():
            with open(os.path.join(self.directory, "manager.json"), "w") as f:
                json.dump({"best_metric": metric}, f)
        return True

    def save_final(self, state: dict, metadata: Optional[dict] = None):
        self._save("final", state, metadata)

    def save_step(self, step: int, state: dict, metadata: Optional[dict] = None):
        old = self.latest_step()
        self._save(f"step_{step}", state, metadata)
        if old is not None and old != step and distributed.is_main():
            os.remove(self._path(f"step_{old}"))

    def _numbered(self, prefix: str) -> Optional[int]:
        found = [int(m.group(1)) for f in glob.glob(os.path.join(self.directory, prefix + "_*.pt"))
                 if (m := re.fullmatch(prefix + r"_(\d+)\.pt", os.path.basename(f)))]
        return max(found) if found else None

    def latest_epoch(self) -> Optional[int]:
        return self._numbered("epoch")

    def latest_step(self) -> Optional[int]:
        return self._numbered("step")

    def _newest(self) -> Optional[str]:
        """The checkpoint ``--resume`` reads first: the newest ``step_K``, else the
        newest ``epoch_N``."""
        if self.latest_step() is not None:
            return f"step_{self.latest_step()}"
        if self.latest_epoch() is not None:
            return f"epoch_{self.latest_epoch()}"
        return None

    def metadata(self, name: str) -> dict:
        """Checkpoint ``name``'s metadata; the file is memory-mapped: no tensor is read."""
        payload = torch.load(self._path(name), map_location="cpu", weights_only=True, mmap=True)
        return payload.get("metadata", {})

    def _local(self, path: str, x: torch.Tensor) -> torch.Tensor:
        return x if self.plan is None else self.plan.shard(path, x)

    def restore_params(self, name: str, params) -> dict:
        """Copy the params of checkpoint ``name`` into ``params`` in place and return it:
        an evaluator's restore, without the optimizer state a trainer holds. Every leaf
        of ``params`` must be in the checkpoint."""
        saved = torch.load(self._path(name), map_location="cpu", weights_only=True)["params"]
        leaves = dict(unique_leaves_with_paths(params))
        missing = sorted(set(leaves) - set(saved))
        if missing:
            raise KeyError(f"checkpoint {name} lacks {len(missing)} leaves, e.g. {missing[:3]}")
        with torch.no_grad():
            for p, x in leaves.items():
                x.copy_(self._local(p, saved[p]))
        return params

    def detect_quant_method(self) -> Optional[str]:
        """The ``quant_method`` the newest checkpoint's run quantized its base with, or
        None (no checkpoint, or a dense base). The file is memory-mapped: no tensor is
        read."""
        name = self._newest()
        return None if name is None else self.metadata(name).get("quant_method")

    def has(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def restore(self, name: str, state: dict) -> dict:
        """Copy checkpoint ``name`` into ``state`` in place (params onto their devices
        and types, optimizer tensors onto the params' device); returns ``state``."""
        payload = torch.load(self._path(name), map_location="cpu", weights_only=True,
                             mmap=True)
        leaves = dict(leaves_with_paths(state["params"]))
        with torch.no_grad():
            for p, x in payload["params"].items():
                leaves[p].copy_(self._local(p, x))
        opt = state["opt_state"]
        for key, value in payload["opt_state"].items():
            if isinstance(value, dict):
                for p, x in value.items():
                    opt[key][p].copy_(self._local(p, x))
            else:
                opt[key] = value
        state["step"] = payload["step"]
        return state
