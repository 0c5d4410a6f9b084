"""cls_evaluate trainer: the attention-probe classifier over the SigLIP tower.

Counterpart of ``projectiontrainer_tpu/train/trainer_cls.py`` (reference:
cls_evaluate/train_utils.py:261-398), on each rank of the data-parallel world (one
device alone; rank 0 logs and writes, fenced by barriers; the evaluation reads every
rank's rows):

- freeze modes {Freeze, Unfreeze, 1EpochUnfreeze} -> label trees
  (``masks.classifier_labels``); 1EpochUnfreeze trains the tower in epoch 0 only and
  swaps to the frozen-tower optimizer at the boundary, keeping the head's Adam count
  and moments (``steps.swap_optimizer``; the reference keeps one AdamW across the
  ``requires_grad`` flip, :286-308);
- discriminative constant learning rates: the head at ``lr``, the tower at ``bb_lr``
  (``optim.discriminative_optimizer``); fp32 masters, bf16 compute
  (``--mixed_precision``); the head's dropout seeded by the global step;
- per-epoch evaluation: softmax CE, accuracy and macro one-vs-rest AUROC (:73-92);
  with ``--multilabel_two_way``, the two-way loss only;
- ``results.tsv`` (:269-281,370-379); the best checkpoint by max AUC (accuracy when
  the AUC is NaN), periodic checkpoints every 2 epochs, each with the config and the
  model architecture in its metadata (``model_config``: the evaluators rebuild the
  classifier from a checkpoint alone);
- every checkpoint holds EVERY leaf of the classifier, tower included, in every
  freeze mode (the JAX package saves the whole state): a checkpoint of the optimizer's
  leaves alone would hold the head without the tower that epoch 0 of 1EpochUnfreeze
  changed;
- ``--resume`` from the newest epoch checkpoint, under the step variant it was saved
  with; the step timer (images/s of each epoch) and profiler (``--profile_dir``
  splits a step over the spans ``vision``, ``head``, ``loss`` and ``optimizer``).

Tensor parallelism (``--mesh_model`` above 1; ``parallel/sharding.py``): ``params``
hold this model rank's shards of the tower (``sharding.model_shards``, the CLI's call:
the encoder layers and the MAP head's MLP); the classifier's head (queries, MHA,
linear) is replicated and runs whole on the tower's replicated output, so its gradient
is whole on every model rank, and its dropout masks are the same on the model ranks of
one data rank (``distributed.rank_seed`` folds in the data rank only). Every freeze
mode's step is built with the plan, so the 1EpochUnfreeze swap keeps the shards; the
losses, the evaluation's gathers and its AUROC go over the data ranks (each row once);
the checkpoints gather the shards whole (rank 0 writes) and ``--resume`` slices them.

ZeRO-3 over the data axis (``--fsdp``; ``parallel/fsdp.py``): the rank keeps its data
shard of every large leaf of the classifier (``common.place_params``; of its model
shards under a model axis), the step gathers them where they are used and
reduce-scatters their gradients, the evaluation gathers the classifier once per call,
and the checkpoints gather every leaf whole (rank 0 writes; ``--resume`` slices again).

Any dataset with ``__len__`` and ``__getitem__`` returning ``{'pixel_values' [H, W, C]
float32, 'target_indices' int}`` (or ``'targets'`` [C] float32 multi-hot under
``--multilabel_two_way``) serves (the CLI's is ``data/datasets.py``'s
``ClassificationDataset``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.core import dtypes
from projectiontrainer_tpu_torch.core.config import ClsConfig
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths, unique_leaves_with_paths
from projectiontrainer_tpu_torch.eval import metrics as M
from projectiontrainer_tpu_torch.models import classifier as cls_model
from projectiontrainer_tpu_torch.models import siglip
from projectiontrainer_tpu_torch.parallel import distributed
from projectiontrainer_tpu_torch.train import common, losses, masks, optim, steps
from projectiontrainer_tpu_torch.utils.logging import MetricLogger
from projectiontrainer_tpu_torch.utils.timing import StepProfiler, StepTimer

FREEZE_MODES = ("Freeze", "Unfreeze", "1EpochUnfreeze")
RESULTS_HEADER = "Epoch\tTrain Loss\tVal Loss\tVal Acc\tVal AUC\n"


@torch.no_grad()
def classifier_logits(params, model_cfg: cls_model.ClassifierConfig, pixels,
                      compute_dtype=None) -> np.ndarray:
    """fp32 logits [B, C] on the host, without dropout, the params cast to
    ``compute_dtype`` as the train step casts them: the trainer's evaluation and
    ``cli/cls_test.py`` both run this."""
    if compute_dtype is not None:
        params = dtypes.cast_compute_params(params, compute_dtype)
    return common.to_host(cls_model.forward(params, model_cfg, pixels)).astype(np.float32)


def classification_metrics(logits: np.ndarray, targets: np.ndarray, *,
                           multilabel: bool = False) -> tuple[float, float, float]:
    """(loss, accuracy, macro one-vs-rest AUROC) of host logits against targets; under
    ``multilabel`` the two-way loss, with NaN accuracy and AUROC (the reference's
    two-way evaluation reports the loss only, train_twoway_loss.py:290-320)."""
    lt, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    if multilabel:
        return float(losses.two_way_multilabel_loss(lt, tt)), float("nan"), float("nan")
    loss = float(losses.softmax_ce_loss(lt, tt))
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    return loss, M.accuracy(logits.argmax(-1), targets), M.macro_ovr_auroc(probs, targets)


def model_config_dict(model_cfg: cls_model.ClassifierConfig) -> dict:
    """The architecture a checkpoint's metadata carries (the reference stores
    ``vars(args)`` inside its ``.pth`` for this, cls_evaluate/train_utils.py:363)."""
    return {"vision": dataclasses.asdict(model_cfg.vision), "num_classes": model_cfg.num_classes,
            "num_heads": model_cfg.num_heads, "dropout_rate": model_cfg.dropout_rate}


def load_classifier(exp_dir: str, checkpoint: str = "best", *, device="cuda"):
    """(training config, ClassifierConfig, params) from ``exp_dir/checkpoints/<checkpoint>.pt``
    alone (the evaluators' params-only restore; dropout off)."""
    mgr = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
    meta = mgr.metadata(checkpoint)
    cfg = ClsConfig(**json.loads(meta["config"]))
    mc = meta["model_config"]
    model_cfg = cls_model.ClassifierConfig(
        vision=siglip.VisionConfig(**mc["vision"]), num_classes=mc["num_classes"],
        num_heads=mc["num_heads"], dropout_rate=0.0)
    params = cls_model.init(torch.Generator(device=device).manual_seed(0), model_cfg,
                            device=device)
    return cfg, model_cfg, mgr.restore_params(checkpoint, params)


def predict(params, model_cfg, dataset, *, batch_size: int, device, compute_dtype=None,
            target_key: str = "target_indices") -> tuple[np.ndarray, np.ndarray]:
    """fp32 logits [N, C] and targets of every sample of ``dataset``, in order."""
    logits, targets = [], []
    for i in range(0, len(dataset), batch_size):
        rows = [dataset[j] for j in range(i, min(i + batch_size, len(dataset)))]
        pixels = torch.tensor(np.stack([r["pixel_values"] for r in rows]), device=device)
        logits.append(classifier_logits(params, model_cfg, pixels, compute_dtype))
        targets.append(np.asarray([r[target_key] for r in rows]))
    return np.concatenate(logits), np.concatenate(targets)


class ClsTrainer:
    def __init__(self, cfg: ClsConfig, *, model_cfg: cls_model.ClassifierConfig, params,
                 train_dataset, val_dataset=None, logger: Optional[MetricLogger] = None):
        if cfg.freeze_mode not in FREEZE_MODES:
            raise ValueError(f"--freeze_mode must be one of {FREEZE_MODES}, got "
                             f"{cfg.freeze_mode!r}")
        self.cfg = cfg
        # the checkpoints' model_config says whether the tower carries a MAP head, so an
        # evaluator's template holds exactly the saved leaves
        self.model_cfg = dataclasses.replace(model_cfg, vision=dataclasses.replace(
            model_cfg.vision, use_head="head" in params["vision"]))
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.exp_dir = os.path.join(cfg.output_base_dir, cfg.exp_id)
        os.makedirs(self.exp_dir, exist_ok=True)
        self.logger = logger or MetricLogger(self.exp_dir)
        self.timer = StepTimer()
        self.profiler = StepProfiler(cfg.profile_dir, start_step=cfg.profile_start_step,
                                     num_steps=cfg.profile_num_steps,
                                     rank=distributed.rank())

        self.compute_dtype = dtypes.compute_dtype(cfg.mixed_precision)
        self.plan = common.place_params(params, self.model_cfg, cfg)
        loss_fn = steps.classifier_loss(self.model_cfg, multilabel=cfg.multilabel_two_way,
                                        compute_dtype=self.compute_dtype)
        # two step variants under 1EpochUnfreeze: the tower trainable, then frozen
        variants = ((False, True) if cfg.freeze_mode == "1EpochUnfreeze"
                    else (cfg.freeze_mode == "Freeze",))
        self._steps = {}
        trained = set()
        for frozen in variants:
            labels = masks.classifier_labels(params, freeze_vision=frozen)
            trained |= {p for p, on in leaves_with_paths(masks.bool_mask(labels)) if on}
            tx, schedule = optim.discriminative_optimizer(
                labels, head_lr=cfg.lr, backbone_lr=cfg.bb_lr, weight_decay=cfg.weight_decay,
                accum_steps=cfg.gradient_accumulation_steps,
                fsdp_paths=self.plan.data_sharded)
            self._steps[frozen] = (steps.make_train_step(
                loss_fn, tx, trainable_mask=masks.bool_mask(labels), plan=self.plan),
                tx, schedule)
        _, self.tx, self.schedule = self._steps[self._epoch_frozen(0)]
        self.state = steps.init_state(params, self.tx)

        # every leaf, in every freeze mode: see the module's docstring
        self.ckpt = CheckpointManager(
            os.path.join(self.exp_dir, "checkpoints"), save_every_n_epochs=2, best_mode="max",
            save_paths=[p for p, _ in unique_leaves_with_paths(params)], plan=self.plan)
        self.global_step = 0
        self.start_epoch = 0
        if cfg.resume:
            self.resume_latest()
        common.sync_replicas(self.state["params"], trained, self.plan)
        self.results_tsv = os.path.join(self.exp_dir, "results.tsv")
        if distributed.is_main() and not os.path.exists(self.results_tsv):
            with open(self.results_tsv, "w") as f:
                f.write(RESULTS_HEADER)

    def _epoch_frozen(self, epoch: int) -> bool:
        if self.cfg.freeze_mode == "Freeze":
            return True
        if self.cfg.freeze_mode == "Unfreeze":
            return False
        return epoch != 0  # 1EpochUnfreeze: the tower trains in epoch 0 only

    def _meta(self, epoch: int) -> dict:
        return {"epoch": epoch, "config": self.cfg.to_json(),
                "model_config": model_config_dict(self.model_cfg)}

    def resume_latest(self) -> int:
        """Restore params, optimizer state and step from the newest epoch checkpoint,
        under the step variant it was saved with (under 1EpochUnfreeze, epoch 0's holds
        the tower's moments; later ones the head's alone)."""
        latest = self.ckpt.latest_epoch()
        if latest is None:
            return 0
        _, tx, _ = self._steps[self._epoch_frozen(latest)]
        if tx is not self.tx:
            self.state = steps.init_state(self.state["params"], tx)
            self.tx = tx
        self.ckpt.restore(f"epoch_{latest}", self.state)
        self.start_epoch = latest + 1
        self.global_step = int(self.state["step"])
        self.logger.log({"resumed_from_epoch": latest}, step=self.global_step)
        return self.start_epoch

    # ------------------------------------------------------------------ train

    def train(self) -> dict:
        cfg = self.cfg
        best = None
        per_epoch = []
        train_loss = float("nan")
        for epoch in range(self.start_epoch, cfg.epochs):
            frozen = self._epoch_frozen(epoch)
            step_fn, tx, _ = self._steps[frozen]
            if tx is not self.tx:
                # 1EpochUnfreeze boundary: the tower freezes; the head keeps its Adam
                # moments and count
                self.state = steps.swap_optimizer(self.state, tx)
                self.tx = tx
            loss_sum, n_losses, grad_norm = None, 0, None
            batches = iter(common.feed(self.train_dataset, cfg, epoch=epoch))
            while True:
                # the window opens before the batch is asked for: a stalled feed shows
                profiled = self.profiler.step(self.global_step)
                self.timer.begin()
                batch = next(batches, None)
                if batch is None:
                    break
                # the global step seeds the head's dropout (JAX: key(global_step))
                self.state, loss, aux = step_fn(self.state, batch, self.global_step)
                self.timer.count(images=batch["pixel_values"].shape[0], discard=profiled)
                self.global_step += 1
                loss_sum = loss if loss_sum is None else loss_sum + loss
                n_losses += 1
                grad_norm = aux["grad_norm"]
                if self.global_step % cfg.logging_steps == 0:
                    loss_f = float(loss)  # host-device sync point
                    self.timer.window_end()
                    self.logger.log({"train/batch_loss": loss_f,
                                     "train/grad_norm": float(grad_norm)}, step=self.global_step)
            train_loss = float(loss_sum / n_losses) if n_losses else float("nan")
            self.timer.window_end()
            throughput = self.timer.summary()  # this epoch's windows but its first
            self.timer.reset()
            per_epoch.append({"epoch": epoch, "tower_frozen": frozen, **throughput})

            val_loss, val_acc, val_auc = float("nan"), float("nan"), float("nan")
            meta = self._meta(epoch)
            if self.val_dataset is not None and len(self.val_dataset):
                val_loss, val_acc, val_auc = self.evaluate()
                if self.ckpt.save_best(val_auc if np.isfinite(val_auc) else val_acc,
                                       self.state, meta):
                    best = (epoch, val_acc, val_auc)
            self.ckpt.save_periodic(epoch, self.state, meta)

            self.logger.log(
                {"train/epoch_loss": train_loss, "val/loss": val_loss, "val/accuracy": val_acc,
                 "val/auc": val_auc,
                 "train/grad_norm": float(grad_norm) if grad_norm is not None else float("nan"),
                 "epoch": epoch, "tower_frozen": float(frozen),
                 **{f"epoch/{k}": v for k, v in throughput.items()}},
                step=self.global_step)
            if distributed.is_main():
                with open(self.results_tsv, "a") as f:
                    f.write(f"{epoch}\t{train_loss:.6f}\t{val_loss:.6f}\t{val_acc:.6f}\t"
                            f"{val_auc:.6f}\n")
        self.profiler.close()
        if self.profiler.breakdown:
            self.logger.log({f"profile/{k}": v for k, v in self.profiler.breakdown.items()},
                            step=self.global_step)
        return {"best": best, "train/epoch_loss": train_loss, "epochs": per_epoch}

    # ------------------------------------------------------------------ eval

    def evaluate(self, dataset=None) -> tuple[float, float, float]:
        """(loss, accuracy, AUROC) over ``dataset`` (the validation set by default), a
        straggler batch's filler rows left out; the classifier gathered once
        (``common.compute_copy``) under ``--fsdp``."""
        dataset = dataset if dataset is not None else self.val_dataset
        target_key = "targets" if self.cfg.multilabel_two_way else "target_indices"
        all_logits, all_targets = [], []
        params = common.compute_copy(self.state["params"], self.plan)
        for batch in common.feed(dataset, self.cfg, epoch=0, shuffle=False):
            keep = common.real_rows(batch)
            all_logits.append(classifier_logits(params, self.model_cfg,
                                                batch["pixel_values"], self.compute_dtype)[keep])
            all_targets.append(common.to_host(batch[target_key])[keep])
        return classification_metrics(
            common.gather_rows(np.concatenate(all_logits)),
            common.gather_rows(np.concatenate(all_targets)),
            multilabel=self.cfg.multilabel_two_way)
