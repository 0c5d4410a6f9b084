"""Stage 0 trainer: SigLIP contrastive fine-tuning with zero-shot validation.

Counterpart of ``projectiontrainer_tpu/train/trainer_stage0.py`` (reference:
Stage0/train_vision_encoder_stage0.py:451-842), on each rank of the data-parallel
world (one device alone; rank 0 logs and writes, fenced by barriers):

- the sigmoid pairwise loss over the dual tower, with the text tower, ``logit_scale``
  and the first vision layers frozen (``masks.stage0_labels``); AdamW with the cosine
  schedule whose warmup rounds DOWN (``int(ratio * steps)``, Stage0:598), no clipping;
  no remat (the reference checkpoints activations in stages 1/2 only);
- ``--local_negatives`` (the default): each rank's pairwise loss over its own rows,
  averaged over the ranks that hold a real row; ``--no-local_negatives``: global
  negatives, every rank's images against every rank's texts;
- per-epoch zero-shot validation: the class names tokenised once, argmax over
  ``logits_per_image``, accuracy and macro precision / recall / F1 over every rank's
  rows;
- checkpoints: best by accuracy, periodic ones gated by ``save_every_n_epochs`` and
  ``min_save_epoch``, final; each best or periodic one also exported as an HF snapshot
  (``best_model/``, ``epoch_{N+1}/``), what the downstream stages load;
- ``--resume`` from the newest epoch checkpoint; the step timer and profiler of
  stage 1 (``--profile_dir`` splits the step over ``vision``, ``text``, ``loss`` and
  ``optimizer``).

ZeRO-3 over the data axis (``--fsdp``; ``parallel/fsdp.py``): the rank keeps its data
shard of every large leaf of both towers (``common.place_params``), the step gathers
them layer by layer and reduce-scatters their gradients, the zero-shot validation
gathers the towers once per evaluation, and the checkpoints and HF exports gather them
whole (rank 0 writes).

Any dataset with ``__len__`` and ``__getitem__`` returning ``{'pixel_values' [H, W, C]
float32, 'input_ids' [T] int, 'class_idx' int, 'valid' bool}`` serves (the CLI's is
``data/datasets.py``'s ``ContrastiveDataset``, whose image decoding needs PIL).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from projectiontrainer_tpu_torch.checkpoint import export
from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.core import dtypes
from projectiontrainer_tpu_torch.core.config import Stage0Config
from projectiontrainer_tpu_torch.models import siglip
from projectiontrainer_tpu_torch.parallel import distributed, sharding
from projectiontrainer_tpu_torch.train import common, masks, optim, steps
from projectiontrainer_tpu_torch.utils.logging import MetricLogger
from projectiontrainer_tpu_torch.utils.timing import StepProfiler, StepTimer


def zero_shot_prf(pred: np.ndarray, target: np.ndarray) -> dict[str, float]:
    """Accuracy and macro precision / recall / F1 over the labels seen in either
    array, a class with no prediction (or no target) scoring 0: the numbers of the
    JAX package's ``eval.metrics.zero_shot_prf`` (sklearn's
    ``precision_recall_fscore_support(average='macro', zero_division=0)``), in numpy."""
    pred, target = np.asarray(pred), np.asarray(target)
    labels = np.union1d(pred, target)
    tp = np.array([np.sum((pred == c) & (target == c)) for c in labels], np.float64)
    n_pred = np.array([np.sum(pred == c) for c in labels], np.float64)
    n_true = np.array([np.sum(target == c) for c in labels], np.float64)
    precision = np.divide(tp, n_pred, out=np.zeros_like(tp), where=n_pred > 0)
    recall = np.divide(tp, n_true, out=np.zeros_like(tp), where=n_true > 0)
    denom = precision + recall
    f1 = np.divide(2 * precision * recall, denom, out=np.zeros_like(tp), where=denom > 0)
    return {"accuracy": float(np.mean(pred == target)), "precision": float(precision.mean()),
            "recall": float(recall.mean()), "f1": float(f1.mean())}


class Stage0Trainer:
    def __init__(self, cfg: Stage0Config, *, model_cfg: siglip.SiglipConfig, params, tokenizer,
                 train_dataset, val_dataset=None, class_names: Sequence[str] = (),
                 logger: Optional[MetricLogger] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.class_names = list(class_names)
        self.logger = logger or MetricLogger(
            cfg.output_dir, project=cfg.wandb_project, run_name=cfg.wandb_run_name,
            use_wandb=not cfg.disable_wandb and cfg.wandb_project is not None,
        )
        self.timer = StepTimer()
        self.profiler = StepProfiler(cfg.profile_dir, start_step=cfg.profile_start_step,
                                     num_steps=cfg.profile_num_steps,
                                     rank=distributed.rank())

        self.max_train_steps = common.update_steps(
            len(train_dataset), common.global_batch_size(cfg), cfg.gradient_accumulation_steps,
            cfg.num_epochs)
        self.plan = common.place_params(params, model_cfg, cfg)
        labels = masks.stage0_labels(
            params, freeze_text=cfg.freeze_text_encoder,
            freeze_logit_scale=cfg.freeze_logit_scale,
            freeze_layers_ratio=cfg.freeze_layers_ratio,
            num_vision_layers=model_cfg.vision.num_layers)
        self.tx, self.schedule = optim.single_group_optimizer(
            labels, cfg.learning_rate, total_steps=self.max_train_steps,
            warmup_ratio=cfg.warmup_ratio, weight_decay=cfg.weight_decay,
            accum_steps=cfg.gradient_accumulation_steps, warmup_rounding="floor",
            fsdp_paths=self.plan.data_sharded)
        self.compute_dtype = dtypes.compute_dtype(cfg.mixed_precision)
        # --local_negatives: one group of negatives a rank (the JAX package's data-axis
        # shards); else one group over the whole batch
        shards = distributed.world_size() if cfg.local_negatives else 1
        self.train_step = steps.make_train_step(
            steps.stage0_loss(model_cfg, remat=False, local_negatives_shards=shards,
                              compute_dtype=self.compute_dtype),
            self.tx, trainable_mask=masks.bool_mask(labels), plan=self.plan)
        self.state = steps.init_state(params, self.tx)

        self.ckpt = CheckpointManager(os.path.join(cfg.output_dir, "checkpoints"),
                                      save_every_n_epochs=max(1, cfg.save_every_n_epochs),
                                      min_save_epoch=cfg.min_save_epoch, best_mode="max",
                                      plan=self.plan)
        self.global_step = 0
        self.start_epoch = 0
        if cfg.resume:
            self.resume_latest()
        common.sync_replicas(self.state["params"], set(self.state["opt_state"]["mu"]),
                             self.plan)

    def resume_latest(self) -> int:
        """Restore the trainable params, optimizer state and step from the newest epoch
        checkpoint (the frozen text tower comes from the snapshot)."""
        latest = self.ckpt.latest_epoch()
        if latest is None:
            return 0
        self.ckpt.restore(f"epoch_{latest}", self.state)
        self.start_epoch = latest + 1
        self.global_step = int(self.state["step"])
        self.logger.log({"resumed_from_epoch": latest}, step=self.global_step)
        return self.start_epoch

    # ------------------------------------------------------------------ train

    def train(self) -> dict:
        cfg = self.cfg
        accum = cfg.gradient_accumulation_steps
        best_acc = None
        epoch_loss = float("nan")
        for epoch in range(self.start_epoch, cfg.num_epochs):
            loss_sum, n_losses = None, 0
            batches = iter(common.feed(self.train_dataset, cfg, epoch=epoch))
            while True:
                profiled = self.profiler.step(self.global_step)
                self.timer.begin()
                batch = next(batches, None)
                if batch is None:
                    break
                model_batch = {k: batch[k] for k in
                               ("pixel_values", "input_ids", "sample_weight", "valid")
                               if k in batch}
                self.state, loss, aux = self.train_step(self.state, model_batch)
                self.timer.count(images=batch["pixel_values"].shape[0], discard=profiled)
                self.global_step += 1
                loss_sum = loss if loss_sum is None else loss_sum + loss
                n_losses += 1
                if self.global_step % cfg.logging_steps == 0:
                    loss_f = float(loss)  # host-device sync point
                    self.timer.window_end()
                    self.logger.log(
                        {"train/batch_loss": loss_f,
                         "learning_rate": self.schedule(self.global_step // accum),
                         "train/grad_norm": float(aux["grad_norm"]), **self.timer.summary()},
                        step=self.global_step)
            epoch_loss = float(loss_sum / n_losses) if n_losses else float("nan")
            self.timer.window_end()
            self.logger.log({"train/epoch_loss": epoch_loss, "epoch": epoch},
                            step=self.global_step)

            if self.val_dataset is not None and len(self.val_dataset) and self.class_names:
                zs = self.validate_zero_shot(epoch)
                if self.ckpt.save_best(zs["accuracy"], self.state, {"epoch": epoch, **zs}):
                    best_acc = zs["accuracy"]
                    self._export_hf("best_model")
            if cfg.save_every_n_epochs and self.ckpt.save_periodic(epoch, self.state,
                                                                   {"epoch": epoch}):
                self._export_hf(f"epoch_{epoch + 1}")  # 1-indexed, as the reference names them

        self.profiler.close()
        if self.profiler.breakdown:
            self.logger.log({f"profile/{k}": v for k, v in self.profiler.breakdown.items()},
                            step=self.global_step)
        self.ckpt.save_final(self.state)
        return {"train/epoch_loss": epoch_loss, "best_zero_shot_accuracy": best_acc,
                **self.timer.summary()}

    # ------------------------------------------------------------------ zero-shot

    @torch.no_grad()
    def validate_zero_shot(self, epoch: int) -> dict:
        """Class prompts are the raw class names (the reference encodes the class
        captions themselves, Stage0:290-307), tokenised and encoded once; a
        prediction is the argmax over the image's logits against them. The towers run
        on a compute copy (the kernels take bf16; under ``--fsdp`` gathered once here)."""
        params = common.compute_copy(self.state["params"], self.plan, self.compute_dtype)
        enc = self.tokenizer(self.class_names, padding="max_length", truncation=True,
                             max_length=self.cfg.max_text_len)
        class_ids = torch.tensor(np.asarray(enc["input_ids"], np.int64), device=self.cfg.device)
        _, class_emb = siglip.text_forward(params["text"], self.model_cfg.text, class_ids)
        dtype = params["vision"]["patch_embedding"]["weight"].dtype
        preds, targets = [], []
        for batch in common.feed(self.val_dataset, self.cfg, epoch=0, shuffle=False):
            keep = common.to_host(batch["valid"]).astype(bool) & common.real_rows(batch)
            _, img = siglip.vision_forward(params["vision"], self.model_cfg.vision,
                                           batch["pixel_values"].to(dtype))
            logits = siglip.normalized_logits(img, class_emb, params["logit_scale"],
                                              params["logit_bias"])
            preds.append(common.to_host(logits.argmax(-1))[keep])
            targets.append(common.to_host(batch["class_idx"])[keep])
        preds = common.gather_rows(
            np.concatenate(preds) if preds else np.zeros((0,), np.int64))
        targets = common.gather_rows(
            np.concatenate(targets) if targets else np.zeros((0,), np.int64))
        out = zero_shot_prf(preds, targets) if len(preds) else {"accuracy": 0.0}
        self.logger.log({f"zero_shot/{k}": v for k, v in out.items()} | {"epoch": epoch},
                        step=self.global_step)
        return out

    # ------------------------------------------------------------------ save

    def _export_hf(self, tag: str):
        """HF snapshot under output_dir/<tag>, what the reference's downstream stages
        load with ``from_pretrained`` (Stage0:800-835); every rank enters the gathers of
        the data shards, rank 0 writes."""
        params = sharding.gather_params(self.state["params"], self.plan, host=True)
        if distributed.is_main():
            src = self.cfg.model_name if os.path.isdir(self.cfg.model_name or "") else None
            export.save_siglip_hf(params, self.model_cfg,
                                  os.path.join(self.cfg.output_dir, tag), src_dir=src)
        distributed.barrier()
