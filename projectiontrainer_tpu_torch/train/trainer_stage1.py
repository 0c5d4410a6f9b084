"""Stage 1 trainer: frozen towers, trainable MLP projector, CLM loss on captions.

Counterpart of ``projectiontrainer_tpu/train/trainer_stage1.py`` (reference:
Stage1/projector_trainer.py:18-521):

- one train step (projector-only mask, AdamW + cosine + clip 5.0, gradient
  accumulation) on each rank of the data-parallel world (one device alone), the
  projector broadcast from rank 0 once built or restored;
- per-epoch validation: loss, plus greedy captions generated from the visual tokens
  alone and their last-word accuracy (reference :291-448), over every rank's rows;
- rank 0 logs and writes the checkpoints and exports, fenced by barriers;
- exports: reference-format ``projector_{best|epoch_N|final}.bin`` plus
  ``projector_config.json``, and ``torch.save`` train state for ``--resume`` (its
  metadata names the ``--quant_method`` of an ``--enable_qlora`` run, whose frozen
  base ``train/setup.py`` quantized).

Tensor parallelism (``--mesh_model`` above 1; ``parallel/sharding.py``): ``params``
hold this model rank's shards (``setup.build_vlm``); the train step sums the partial
gradients over the model axis, the exports and checkpoints gather the projector's
shards and rank 0 writes them whole, ``--resume`` slices again, and the validation
captions are generated on the sharded model.

ZeRO-3 over the data axis (``--fsdp``; ``parallel/fsdp.py``): the rank keeps its data
shard of every large leaf, the frozen towers and decoder included
(``common.place_params``); the step gathers them where they are used, the projector's
gradient is reduce-scattered, and the validation gathers the model once per
evaluation (``common.compute_copy``), not once per decoded token.

Any dataset object with ``__len__`` and ``__getitem__`` returning ``{'pixel_values'
[H, W, C] float32, 'caption_ids' [Tc] int}`` serves (the CLI's is
``data/datasets.py``'s ``Stage1PairDataset``).
"""

from __future__ import annotations

import itertools
import os
from typing import Optional

import numpy as np
import torch

from projectiontrainer_tpu_torch.eval import metrics as M
from projectiontrainer_tpu_torch.checkpoint import export
from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.core import dtypes
from projectiontrainer_tpu_torch.core.config import Stage1Config
from projectiontrainer_tpu_torch.generate import GenerationConfig, generate
from projectiontrainer_tpu_torch.models import vlm
from projectiontrainer_tpu_torch.parallel import distributed, sharding
from projectiontrainer_tpu_torch.train import common, masks, optim, steps
from projectiontrainer_tpu_torch.utils.logging import MetricLogger
from projectiontrainer_tpu_torch.utils.timing import StepProfiler, StepTimer


class Stage1Trainer:
    def __init__(self, cfg: Stage1Config, *, vlm_cfg: vlm.VLMConfig, params, tokenizer,
                 train_dataset, val_dataset=None, logger: Optional[MetricLogger] = None):
        self.cfg = cfg
        self.vlm_cfg = vlm_cfg
        self.tokenizer = tokenizer
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.logger = logger or MetricLogger(
            cfg.output_dir, project=cfg.wandb_project, run_name=cfg.wandb_run_name,
            use_wandb=not cfg.disable_wandb and cfg.wandb_project is not None,
        )
        self.timer = StepTimer()
        self.profiler = StepProfiler(cfg.profile_dir, start_step=cfg.profile_start_step,
                                     num_steps=cfg.profile_num_steps,
                                     rank=distributed.rank())

        # tensor parallelism: params hold this model rank's shards (setup.build_vlm);
        # --fsdp: the rank's data shards of them from here on
        self.plan = common.place_params(params, vlm_cfg, cfg)
        gbs = common.global_batch_size(cfg)
        self.max_train_steps = common.update_steps(
            len(train_dataset), gbs, cfg.gradient_accumulation_steps, cfg.num_epochs)
        labels = masks.stage1_labels(params)
        self.tx, self.schedule = optim.single_group_optimizer(
            labels, cfg.learning_rate, total_steps=self.max_train_steps,
            warmup_ratio=cfg.warmup_ratio, weight_decay=cfg.weight_decay,
            clip_norm=cfg.grad_clip, accum_steps=cfg.gradient_accumulation_steps,
            sharded_paths=self.plan.sharded, fsdp_paths=self.plan.data_sharded,
        )
        self.pad_id = tokenizer.pad_token_id if tokenizer.pad_token_id is not None else 0
        logits_chunk = 128 if vlm_cfg.llm.vocab_size >= 32_768 else None
        cdtype = dtypes.compute_dtype(cfg.mixed_precision)
        self.train_step = steps.make_train_step(
            steps.stage1_loss(vlm_cfg, self.pad_id, logits_chunk=logits_chunk,
                              compute_dtype=cdtype),
            self.tx, trainable_mask=masks.bool_mask(labels),
            watch_subtree="projector" if cfg.watch_gradients else None, plan=self.plan,
        )
        self.eval_step = steps.make_eval_step(
            steps.stage1_loss(vlm_cfg, self.pad_id, remat=False, logits_chunk=logits_chunk,
                              compute_dtype=cdtype))
        self.state = steps.init_state(params, self.tx)

        self.ckpt = CheckpointManager(os.path.join(cfg.output_dir, "checkpoints"),
                                      save_every_n_epochs=max(1, cfg.save_every_n_epochs),
                                      best_mode="min", plan=self.plan)
        self.global_step = 0
        self.start_epoch = 0
        self._skip_batches = 0
        if cfg.resume:
            self.resume_latest()
        common.sync_replicas(self.state["params"], set(self.state["opt_state"]["mu"]),
                             self.plan)

    def resume_latest(self) -> int:
        """Restore trainable params, optimizer state and step from the newest epoch
        checkpoint; a newer ``step_K`` checkpoint (``--save_steps``) wins, and the
        first resumed epoch then skips the batches its deterministic feed already
        gave."""
        latest = self.ckpt.latest_epoch()
        if latest is not None:
            self.ckpt.restore(f"epoch_{latest}", self.state)
            self.start_epoch = latest + 1
            self.global_step = int(self.state["step"])
        step_k = self.ckpt.latest_step()
        if step_k is not None and step_k > self.global_step:
            spe = common.steps_per_epoch(len(self.train_dataset),
                                         common.global_batch_size(self.cfg))
            self.ckpt.restore(f"step_{step_k}", self.state)
            self.global_step = int(self.state["step"])
            self.start_epoch = min(self.global_step // spe, self.cfg.num_epochs)
            if self.start_epoch < self.cfg.num_epochs:
                self._skip_batches = self.global_step % spe
        if latest is not None or step_k is not None:
            self.logger.log({"resumed_at_step": self.global_step}, step=self.global_step)
        return self.start_epoch

    # ------------------------------------------------------------------ train

    def train(self) -> dict:
        cfg = self.cfg
        accum = cfg.gradient_accumulation_steps
        best_val = None
        epoch_loss = float("nan")
        for epoch in range(self.start_epoch, cfg.num_epochs):
            # the loss sums on the device; the host syncs only at logging boundaries
            loss_sum, n_losses = None, 0
            feed = common.feed(self.train_dataset, cfg, epoch=epoch)
            if self._skip_batches:
                feed = itertools.islice(feed, self._skip_batches, None)
                self._skip_batches = 0
            batches = iter(feed)
            while True:
                # the window opens before the batch is asked for: a stalled feed shows
                profiled = self.profiler.step(self.global_step)
                self.timer.begin()
                batch = next(batches, None)
                if batch is None:
                    break
                self.state, loss, aux = self.train_step(self.state, batch)
                self.timer.count(images=batch["pixel_values"].shape[0], discard=profiled)
                self.global_step += 1
                loss_sum = loss if loss_sum is None else loss_sum + loss
                n_losses += 1
                if cfg.save_steps and self.global_step % cfg.save_steps == 0:
                    self.ckpt.save_step(self.global_step, self.state, self._meta(epoch))
                if self.global_step % cfg.logging_steps == 0:
                    loss_f = float(loss)  # host-device sync point
                    self.timer.window_end()
                    self.logger.log(
                        {"train/batch_loss": loss_f,
                         "learning_rate": self.schedule(self.global_step // accum),
                         "train/grad_norm": float(aux["grad_norm"]), **self.timer.summary()},
                        step=self.global_step)
                if cfg.watch_gradients and self.global_step % cfg.watch_log_freq == 0:
                    self.logger.log_gradient_stats(aux["watched_grads"], step=self.global_step,
                                                   prefix="gradients/projector")
            epoch_loss = float(loss_sum / n_losses) if n_losses else float("nan")
            self.timer.window_end()  # the epoch-end sync just happened
            self.logger.log({"train/epoch_loss": epoch_loss, "epoch": epoch},
                            step=self.global_step)

            if self.val_dataset is not None and len(self.val_dataset):
                val = self.evaluate(epoch)
                if self.ckpt.save_best(val["val/loss"], self.state, self._meta(epoch)):
                    best_val = val["val/loss"]
                    self._export_projector("best")
            if cfg.save_every_n_epochs and (epoch + 1) % cfg.save_every_n_epochs == 0:
                self.ckpt.save_periodic(epoch, self.state, self._meta(epoch))
                self._export_projector(f"epoch_{epoch}")

        self.profiler.close()
        if self.profiler.breakdown:
            self.logger.log({f"profile/{k}": v for k, v in self.profiler.breakdown.items()},
                            step=self.global_step)
        self.ckpt.save_final(self.state, self._meta(cfg.num_epochs - 1))
        self._export_projector("final")
        return {"train/epoch_loss": epoch_loss, "best_val_loss": best_val,
                **self.timer.summary()}

    # ------------------------------------------------------------------ eval

    def evaluate(self, epoch: int, *, max_generate_batches: int = 2) -> dict:
        """The validation loss of each global batch (every rank's rows), and the
        captions of the first ``max_generate_batches`` batches of every rank, on the
        params gathered once (``common.compute_copy``, in their stored types)."""
        cfg = self.cfg
        losses, pairs = [], []
        params = common.compute_copy(self.state["params"], self.plan)
        for n, batch in enumerate(common.feed(self.val_dataset, cfg, epoch=0, shuffle=False)):
            loss, _ = self.eval_step(params, batch)
            losses.append(float(loss))
            if n < max_generate_batches:
                keep = common.real_rows(batch)  # skip straggler filler rows
                targets = [self.tokenizer.decode([t for t in ids if t != self.pad_id],
                                                 skip_special_tokens=True)
                           for ids in common.to_host(batch["caption_ids"])]
                pairs += [(g, t) for g, t, k in
                          zip(self._generate_captions(batch, params), targets, keep) if k]
        del params
        pairs = distributed.gather_objects(pairs)
        out = {"val/loss": float(np.mean(losses)) if losses else float("nan")}
        if pairs:
            out["validation/last_word_accuracy"] = M.last_word_accuracy(
                [g for g, _ in pairs], [t for _, t in pairs])
        self.logger.log({**out, "epoch": epoch}, step=self.global_step)
        return out

    def _generate_captions(self, batch, params, max_new_tokens: int = 32) -> list[str]:
        visual, mask = vlm.visual_prefix(params, self.vlm_cfg, batch["pixel_values"])
        ids = generate(params["llm"], self.vlm_cfg.llm, visual, mask,
                       GenerationConfig(max_new_tokens=max_new_tokens, do_sample=False,
                                        eos_token_id=self.tokenizer.eos_token_id,
                                        pad_token_id=self.pad_id))
        return [self.tokenizer.decode([t for t in row if t != self.pad_id],
                                      skip_special_tokens=True)
                for row in common.to_host(ids)]

    # ------------------------------------------------------------------ save

    def _meta(self, epoch: int) -> dict:
        """A train state's metadata: its epoch and the base's quant method (or None)."""
        return {"epoch": epoch,
                "quant_method": self.cfg.quant_method if self.cfg.enable_qlora else None}

    def _export_projector(self, tag: str):
        projector = sharding.gather_params(self.state["params"]["projector"], self.plan,
                                           prefix="projector")
        if distributed.is_main():
            export.save_projector(projector, self.vlm_cfg.projector, self.cfg.output_dir,
                                  tag=tag)
        distributed.barrier()
