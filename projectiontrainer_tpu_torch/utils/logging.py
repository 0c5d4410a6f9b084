"""Process logging and metric logging: stdout + JSONL + optional W&B.

Counterpart of ``projectiontrainer_tpu/utils/logging.py`` (``setup_logging``,
``MetricLogger``). Metric names match the reference (train/batch_loss,
train/epoch_loss, learning_rate, val/loss, ...); every metric is also appended to
``metrics.jsonl`` in the output directory. W&B attaches only if the package is
importable and not disabled. Only rank 0 writes: the rank is the process group's once
one is joined, before that the ``RANK`` a launcher sets; a single process is rank 0.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Mapping, Optional


def rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def setup_logging(name: str = "projectiontrainer_tpu_torch") -> logging.Logger:
    """INFO on rank 0, WARNING elsewhere."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO if rank() == 0 else logging.WARNING)
    return logger


class MetricLogger:
    def __init__(self, output_dir: Optional[str] = None, *, project: Optional[str] = None,
                 run_name: Optional[str] = None, use_wandb: bool = False,
                 config: Optional[dict] = None):
        self.is_main = rank() == 0
        self.logger = setup_logging()
        self._jsonl = None
        self._wandb = None
        if self.is_main and output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        if self.is_main and use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=run_name, config=config or {},
                                         mode=os.environ.get("WANDB_MODE", "offline"))
            except Exception as e:  # no network, no package: JSONL only, said aloud
                self.logger.warning("wandb unavailable (%s); logging to JSONL only", e)

    def log(self, metrics: Mapping[str, float], step: Optional[int] = None):
        if not self.is_main:
            return
        payload = {k: float(v) for k, v in metrics.items()}
        if step is not None:
            payload["step"] = int(step)
        payload["time"] = time.time()
        if self._jsonl:
            self._jsonl.write(json.dumps(payload) + "\n")
            self._jsonl.flush()
        if self._wandb:
            self._wandb.log(payload, step=step)
        self.logger.info(" ".join(f"{k}={v:.6g}" for k, v in payload.items() if k != "time"))

    def log_gradient_stats(self, grads: Mapping, step: Optional[int] = None,
                           prefix: str = "gradients"):
        """Per-parameter gradient norm, mean and std (and W&B histograms when
        attached): the ``wandb.watch(projector)`` of the reference
        (Stage1/train_projection_stage1.py:359-370). ``grads`` maps paths to tensors."""
        if not self.is_main:
            return
        import numpy as np

        scalars, hists = {}, {}
        for path, leaf in grads.items():
            name = f"{prefix}/{path}"
            arr = leaf.detach().float().cpu().numpy()
            scalars[f"{name}.norm"] = float(np.linalg.norm(arr))
            scalars[f"{name}.mean"] = float(arr.mean())
            scalars[f"{name}.std"] = float(arr.std())
            hists[name] = arr
        self.log(scalars, step=step)
        if self._wandb:
            import wandb

            self._wandb.log({k: wandb.Histogram(v.ravel()) for k, v in hists.items()},
                            step=step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._wandb:
            self._wandb.finish()
