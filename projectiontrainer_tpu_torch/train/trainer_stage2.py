"""Stage 2 trainer: VQA instruction fine-tuning of the LLM (full, or LoRA adapters over
a quantized base), the projector and, under ``--train_ve_first_epoch``, the vision
tower in epoch 0.

Counterpart of ``projectiontrainer_tpu/train/trainer_stage2.py`` (reference:
Stage2/trainer.py:63-769) on each rank of the data-parallel world (one device alone;
every leaf that trains broadcast from rank 0 once built or restored; rank 0 logs and
writes, fenced by barriers):

- the full-joint trainables are stored in ``--master_dtype`` (fp32 masters by
  default, bf16 compute from ``--mixed_precision``);
- ``--enable_qlora``: the base (quantized by ``train/setup.py``) stays frozen and
  fp32 LoRA adapters (``train/lora.py``, initialised from ``--seed`` when ``params``
  has none) train, their dropout seeded by the global step; the vocab table is frozen,
  so the fused CE kernels run on the card;
- per-epoch global bucket plans (``data/bucketing.py``): batches padded to static
  (question, answer) buckets, ``sample_weight`` 0 on a plan's filler rows;
- two step variants under ``--train_ve_first_epoch`` (the tower trainable in epoch
  0, frozen after) and the optimizer swap at the boundary that keeps the surviving
  groups' Adam state (``steps.swap_optimizer``);
- per-module gradient clipping (1.0), AdamW + cosine warmup, accumulation;
- per-epoch evaluation: the loss, and answers generated from [visual; question]
  (beam-multinomial sampling by default) written to
  ``validation_examples/epoch_N_examples.txt``; under LoRA the adapters are merged
  into a dense copy of the decoder once per evaluation, and only when a batch
  generates (the merged 8B decoder is 16 GB);
- ``checkpoint-epoch_N/`` in the reference's layout (the adapters as a PEFT
  directory) and ``torch.save`` train states (every leaf that trains at any point of
  the run, and the ``quant_method`` in their metadata) for ``--resume``, also
  mid-epoch from ``--save_steps``.

Tensor parallelism (``--mesh_model`` above 1; ``parallel/sharding.py``): ``params``
hold this model rank's shards (``setup.build_vlm`` slices each layer as it builds it;
LoRA adapters initialised here are drawn whole from ``--seed`` and sliced); the train
step sums the partial gradients over the model axis, the checkpoints and exports gather
the shards and rank 0 writes the reference's layout, ``--resume`` slices again, and the
validation generates on the sharded model.

ZeRO-3 over the data axis (``--fsdp``; ``parallel/fsdp.py``, Gemma3-4B full-joint):
``common.place_params`` keeps each rank's data shard of every large leaf (frozen and
quantized ones too) before the trainables are cast to fp32 masters, so no rank holds
the whole fp32 model; the step gathers the shards layer by layer and reduce-scatters
their gradients, and the Adam moments and accumulators are shard-shaped, also across
the ``--train_ve_first_epoch`` swap. Checkpoints and exports gather the params and
optimizer slots leaf by leaf (rank 0 writes the one-process files; ``--resume`` slices
again). The validation gathers the model ONCE per evaluation into a compute copy (the
loss and every decoded token run on it), not once per decoded token.

Any dataset object with ``__len__``, ``__getitem__`` returning ``{'pixel_values'
[H, W, C] float32, 'question_ids' [Tq] int, 'answer_ids' [Ta] int}`` and
``token_lengths()`` serves (the CLI's is ``data/datasets.py``'s ``Stage2VQADataset``).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Optional

import numpy as np
import torch

from projectiontrainer_tpu_torch.checkpoint import export
from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.core import dtypes
from projectiontrainer_tpu_torch.core.config import Stage2Config
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths, unique_leaves_with_paths
from projectiontrainer_tpu_torch.data import bucketing
from projectiontrainer_tpu_torch.data import pipeline as pipe
from projectiontrainer_tpu_torch.generate import GenerationConfig, generate
from projectiontrainer_tpu_torch.models import vlm
from projectiontrainer_tpu_torch.parallel import distributed, sharding
from projectiontrainer_tpu_torch.train import common, lora as lora_mod, masks, optim, steps
from projectiontrainer_tpu_torch.utils.logging import MetricLogger
from projectiontrainer_tpu_torch.utils.timing import StepProfiler, StepTimer


def parse_remat(arg: str):
    """``--remat`` -> the ``remat`` argument of the loss: 'full' True, 'none' False,
    'dots' (save the products' outputs, ``core/remat.py``), an integer N the first N
    decoder layers."""
    if arg.isdigit():
        return int(arg)
    try:
        return {"full": True, "none": False, "dots": "dots"}[arg]
    except KeyError:
        raise ValueError(f"--remat must be one of full|dots|none|<int N layers>, "
                         f"got {arg!r}") from None


@dataclasses.dataclass
class Stage2Program:
    """What a stage-2 run trains with (:func:`build_stage2`)."""

    plan: sharding.ShardPlan
    policy: masks.Stage2Freeze
    steps: dict            # train_vision -> (step, optimizer, schedule)
    state: dict            # under the first epoch's variant
    trained: set           # every leaf path that trains at some point of the run
    logits_chunk: Optional[int]
    table_frozen: bool
    compute_dtype: torch.dtype


def build_stage2(params: dict, vlm_cfg: vlm.VLMConfig, cfg: Stage2Config, *, pad_id: int,
                 total_steps: int, lora_cfg=None) -> Stage2Program:
    """The train state and step variants of a stage-2 run from ``params`` (whole, or this
    model rank's shards; the adapters in ``params['lora']`` under LoRA): the params
    placed (``common.place_params``, in place: under ``--fsdp`` the rank's data shards)
    and the full-joint trainables cast to ``--master_dtype``; the loss; one (step,
    optimizer, schedule) for each variant of the tower's freeze, and the state under
    the first epoch's. ``Stage2Trainer`` and the memory budget (``parallel/budget.py``)
    both build through it."""
    plan = common.place_params(params, vlm_cfg, cfg)
    policy = cfg.freeze_policy()
    # full-parameter fine-tunes store their trainables in --master_dtype, and so
    # their Adam moments (reference: accelerate bf16 keeps fp32 masters and fp32
    # optimizer state); the loss computes in --mixed_precision's type
    if policy.train_llm:
        target = torch.float32 if cfg.master_dtype == "fp32" else torch.bfloat16
        params["llm"] = dtypes.cast_compute_params(params["llm"], target)
        if cfg.train_ve_first_epoch:
            params["vision"] = dtypes.cast_compute_params(params["vision"], target)
    logits_chunk = 128 if vlm_cfg.llm.vocab_size >= 32_768 else None
    # the vocab table trains under a full-LLM fine-tune: the chunked CE then
    table_frozen = not policy.train_llm
    compute_dtype = dtypes.compute_dtype(cfg.mixed_precision)
    loss_fn = steps.stage2_loss(vlm_cfg, pad_id, lora_cfg=lora_cfg, logits_chunk=logits_chunk,
                                table_frozen=table_frozen, compute_dtype=compute_dtype,
                                remat=parse_remat(cfg.remat))
    variants = {}
    unique = {p for p, _ in unique_leaves_with_paths(params)}
    trained = set()
    for ve in ((True, False) if cfg.train_ve_first_epoch else (False,)):
        labels = masks.stage2_labels(params, dataclasses.replace(policy, train_vision=ve))
        tx, schedule = optim.single_group_optimizer(
            labels, cfg.learning_rate, total_steps=total_steps,
            warmup_ratio=cfg.warmup_ratio, weight_decay=cfg.weight_decay,
            clip_norm=cfg.grad_clip, clip_per_module=True,
            accum_steps=cfg.gradient_accumulation_steps, sharded_paths=plan.sharded,
            fsdp_paths=plan.data_sharded)
        variants[ve] = (steps.make_train_step(
            loss_fn, tx, trainable_mask=masks.bool_mask(labels), plan=plan), tx, schedule)
        trained |= {p for p, label in leaves_with_paths(labels)
                    if label != masks.FROZEN and p in unique}
    state = steps.init_state(params, variants[cfg.train_ve_first_epoch][1])
    return Stage2Program(plan=plan, policy=policy, steps=variants, state=state,
                         trained=trained, logits_chunk=logits_chunk,
                         table_frozen=table_frozen, compute_dtype=compute_dtype)


class Stage2Trainer:
    def __init__(self, cfg: Stage2Config, *, vlm_cfg: vlm.VLMConfig, params, tokenizer,
                 train_dataset, val_dataset=None, logger: Optional[MetricLogger] = None):
        if cfg.master_dtype not in ("fp32", "bf16"):
            raise ValueError(f"--master_dtype must be fp32|bf16, got {cfg.master_dtype!r}")
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
        self.pad_id = tokenizer.pad_token_id if tokenizer.pad_token_id is not None else 0

        self.lora_cfg = None
        if cfg.enable_qlora:
            self.lora_cfg = lora_mod.LoraConfig(r=cfg.lora_r, alpha=cfg.lora_alpha,
                                                dropout=cfg.lora_dropout)
            if "lora" not in params:
                device = params["llm"]["embed_tokens"]["embedding"].device
                gen = torch.Generator(device=device).manual_seed(cfg.seed)
                full = lora_mod.init(gen, vlm_cfg.llm, self.lora_cfg, device=device)
                params["lora"] = sharding.shard_params(
                    full, sharding.plan_for(full, vlm_cfg, prefix="lora"), prefix="lora")

        # deterministic per-epoch bucket plans from the token lengths: the same in
        # every process, and the cosine schedule ends exactly at max_train_steps
        gbs = common.global_batch_size(cfg)
        q_lens, a_lens = train_dataset.token_lengths()
        qb = bucketing.buckets_covering(cfg.max_q_len, bucketing.DEFAULT_Q_BUCKETS)
        ab = bucketing.buckets_covering(cfg.max_a_len, bucketing.DEFAULT_A_BUCKETS)
        self._train_plans = [
            bucketing.global_bucket_plan(q_lens, a_lens, batch_size=gbs, epoch=e,
                                         seed=cfg.seed, q_buckets=qb, a_buckets=ab)
            for e in range(cfg.num_epochs)
        ]
        self._val_plan = None
        if val_dataset is not None and len(val_dataset):
            vq, va = val_dataset.token_lengths()
            self._val_plan = bucketing.global_bucket_plan(
                vq, va, batch_size=gbs, epoch=0, seed=cfg.seed, shuffle=False,
                q_buckets=qb, a_buckets=ab)
        accum = cfg.gradient_accumulation_steps
        self.max_train_steps = sum(-(-len(p) // accum) for p in self._train_plans)

        built = build_stage2(params, vlm_cfg, cfg, pad_id=self.pad_id,
                             total_steps=self.max_train_steps, lora_cfg=self.lora_cfg)
        self.plan, self.base_policy = built.plan, built.policy
        self.compute_dtype = built.compute_dtype
        # two step variants when the tower trains only in epoch 0
        self._steps = built.steps
        _, self.tx, self.schedule = self._steps[cfg.train_ve_first_epoch]
        self.state = built.state
        self.eval_step = steps.make_eval_step(
            steps.stage2_loss(vlm_cfg, self.pad_id, lora_cfg=self.lora_cfg, remat=False,
                              logits_chunk=built.logits_chunk,
                              table_frozen=built.table_frozen,
                              compute_dtype=self.compute_dtype))

        # every leaf that trains at any point of the run: the tower that epoch 0
        # changed has no optimizer state after the swap, yet a resume needs it
        self.ckpt = CheckpointManager(os.path.join(cfg.output_dir, "checkpoints"),
                                      best_mode="min", save_paths=built.trained, plan=self.plan)
        self.global_step = 0
        self.start_epoch = 0
        self._skip_batches = 0
        if cfg.resume:
            self.resume_latest()
        common.sync_replicas(self.state["params"], built.trained, self.plan)

    # ------------------------------------------------------------------ resume

    def _select_variant(self, ve: bool):
        """Hold the optimizer state of step variant ``ve`` (fresh: a restore fills it)."""
        _, tx, _ = self._steps[ve]
        if tx is not self.tx:
            self.state["opt_state"] = None
            self.state = steps.init_state(self.state["params"], tx)
            self.tx = tx

    def resume_latest(self) -> int:
        """Restore params, optimizer state and step from the newest epoch checkpoint,
        under the step variant it was saved with (epoch 0's under
        ``--train_ve_first_epoch``, the tower-frozen one after). A newer ``step_K``
        checkpoint (``--save_steps``) wins: its epoch comes from the deterministic
        plans, and the first resumed epoch skips the batches already consumed."""
        cfg = self.cfg
        latest = self.ckpt.latest_epoch()
        if latest is not None:
            self._select_variant(cfg.train_ve_first_epoch and latest == 0)
            self.ckpt.restore(f"epoch_{latest}", self.state)
            self.start_epoch = latest + 1
            self.global_step = int(self.state["step"])
        step_k = self.ckpt.latest_step()
        if step_k is not None and step_k > self.global_step:
            consumed, epoch = 0, None
            for e, plan in enumerate(self._train_plans):
                if step_k < consumed + len(plan):
                    epoch = e
                    break
                consumed += len(plan)
            done = epoch is None  # saved at or after the last batch: nothing left to run
            variant_epoch = len(self._train_plans) - 1 if done else epoch
            self._select_variant(cfg.train_ve_first_epoch and variant_epoch == 0)
            self.ckpt.restore(f"step_{step_k}", self.state)
            self.global_step = int(self.state["step"])
            self.start_epoch = len(self._train_plans) if done else epoch
            self._skip_batches = 0 if done else step_k - consumed
        if latest is not None or step_k is not None:
            self.logger.log({"resumed_at_step": self.global_step}, step=self.global_step)
        return self.start_epoch

    def _feed(self, dataset, plan):
        return pipe.planned_epoch_batches(dataset, plan, pad_id=self.pad_id,
                                          device=self.cfg.device,
                                          num_workers=self.cfg.num_workers)

    # ------------------------------------------------------------------ train

    def train(self) -> dict:
        cfg = self.cfg
        accum = cfg.gradient_accumulation_steps
        visual_tokens = vlm.num_visual_tokens(self.vlm_cfg)
        epoch_loss = float("nan")
        for epoch in range(self.start_epoch, cfg.num_epochs):
            ve = cfg.train_ve_first_epoch and epoch == 0
            step_fn, tx, _ = self._steps[ve]
            if tx is not self.tx:
                # --train_ve_first_epoch boundary: the tower freezes; the other groups
                # keep their Adam state, also inside an accumulation
                self.state = steps.swap_optimizer(self.state, tx)
                self.tx = tx
            # the loss sums on the device; the host syncs only at logging boundaries
            loss_sum, n_losses = None, 0
            feed = self._feed(self.train_dataset, self._train_plans[epoch])
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
                b, q_len = batch["question_ids"].shape
                a_len = batch["answer_ids"].shape[1]
                # the global step seeds the LoRA dropout (JAX: key(global_step))
                self.state, loss, aux = step_fn(self.state, batch, self.global_step)
                # processed (padded) tokens, from the shapes: no device sync
                self.timer.count(images=b, tokens=b * (visual_tokens + q_len + a_len),
                                 discard=profiled)
                self.global_step += 1
                loss_sum = loss if loss_sum is None else loss_sum + loss
                n_losses += 1
                if cfg.save_steps and self.global_step % cfg.save_steps == 0:
                    self.ckpt.save_step(self.global_step, self.state, self._meta(epoch))
                if self.global_step % cfg.logging_steps == 0:
                    loss_f = float(loss)  # host-device sync point
                    self.timer.window_end()
                    self.logger.log(
                        {"train/step_loss": loss_f,
                         "learning_rate": self.schedule(self.global_step // accum),
                         "train/grad_norm": float(aux["grad_norm"]), **self.timer.summary()},
                        step=self.global_step)
            epoch_loss = float(loss_sum / n_losses) if n_losses else float("nan")
            self.timer.window_end()  # the epoch-end sync just happened
            self.logger.log({"train/epoch_loss": epoch_loss, "epoch": epoch,
                             "ve_trained": float(ve)}, step=self.global_step)

            if self.val_dataset is not None and len(self.val_dataset):
                val = self.evaluate(epoch)
                self.ckpt.save_best(val["val/loss"], self.state, self._meta(epoch))
            self.save_checkpoint(epoch)
        self.profiler.close()
        if self.profiler.breakdown:
            self.logger.log({f"profile/{k}": v for k, v in self.profiler.breakdown.items()},
                            step=self.global_step)
        return {"train/epoch_loss": epoch_loss, **self.timer.summary()}

    # ------------------------------------------------------------------ eval

    def evaluate(self, epoch: int) -> dict:
        """The validation loss, and generated answers for the whole validation set
        (the reference's behaviour, Stage2/trainer.py:596-700) or for its first
        ``cfg.eval_example_batches`` batches. The loss and the generation run on one
        compute copy of the params (``common.compute_copy``: under ``--fsdp`` gathered
        once here); the generation params (LoRA merged) are built at the first batch
        that generates and dropped after the last one."""
        cfg = self.cfg
        losses, examples = [], []
        full = common.compute_copy(self.state["params"], self.plan, self.compute_dtype)
        gen_params = None
        for n, batch in enumerate(self._feed(self.val_dataset, self._val_plan or [])):
            loss, _ = self.eval_step(full, batch)
            losses.append(float(loss))
            if cfg.eval_example_batches is None or n < cfg.eval_example_batches:
                if gen_params is None:
                    gen_params = self.generation_params(full)
                examples += self._generate_examples(batch, gen_params)
            else:
                gen_params = None  # free the dense merge for the remaining batches
        del full, gen_params
        out = {"val/loss": float(np.mean(losses)) if losses else float("nan")}
        self.logger.log({**out, "epoch": epoch}, step=self.global_step)
        # every rank's examples (the reference's gather_object, Stage2/trainer.py:654)
        examples = distributed.gather_objects(examples)
        if examples and distributed.is_main():
            ex_dir = os.path.join(cfg.output_dir, "validation_examples")
            os.makedirs(ex_dir, exist_ok=True)
            with open(os.path.join(ex_dir, f"epoch_{epoch}_examples.txt"), "w") as f:
                for q, a, g in examples:
                    f.write(f"QUESTION: {q}\nTARGET: {a}\nGENERATED: {g}\n{'-' * 60}\n")
        return out

    def generation_params(self, full=None):
        """The params generation runs on: ``full``, the compute copy (by default made
        here: cast to the compute type, ties kept, as the loss computes, since fp32
        masters would put fp32 tensors before the kernels; gathered whole under
        ``--fsdp``), with the LoRA adapters (fp32 masters) merged into a dense decoder
        (``lora.merge_into_decoder``; a quantized base is dequantized to bf16)."""
        params = (common.compute_copy(self.state["params"], self.plan, self.compute_dtype)
                  if full is None else full)
        if self.lora_cfg is not None:
            adapters = sharding.gather_params(self.state["params"]["lora"], self.plan,
                                              prefix="lora", axes=(sharding.DATA_AXIS,))
            merged = lora_mod.merge_into_decoder(params["llm"], adapters, self.lora_cfg)
            params = {k: v for k, v in params.items() if k != "lora"}
            params["llm"] = merged
        return params

    def _decode(self, ids) -> str:
        return self.tokenizer.decode([int(t) for t in np.asarray(ids) if t != self.pad_id],
                                     skip_special_tokens=True)

    def generate_ids(self, batch, params=None) -> torch.Tensor:
        """Answer ids [B, eval_max_new_tokens] from the [visual; question] prefix, the
        questions LEFT-padded (the last prefix slot must be a real token; the
        reference forces padding_side='left' for generation, Stage2/trainer.py:499-505),
        with the reference's eval decode (beam-multinomial sampling by default,
        Stage2/trainer.py:604-614). Sampling draws from a generator seeded by the
        global step."""
        cfg = self.cfg
        params = self.generation_params() if params is None else params
        q = batch["question_ids"]
        q_left = torch.as_tensor(common.left_align_padding(common.to_host(q), self.pad_id),
                                 device=q.device)
        embeds, mask = vlm.question_prefix(params, self.vlm_cfg, batch["pixel_values"], q_left,
                                           pad_token_id=self.pad_id)
        gen = torch.Generator(device=embeds.device).manual_seed(self.global_step)
        return generate(params["llm"], self.vlm_cfg.llm, embeds, mask,
                        GenerationConfig(max_new_tokens=cfg.eval_max_new_tokens,
                                         num_beams=cfg.eval_num_beams,
                                         do_sample=cfg.eval_do_sample, top_p=cfg.eval_top_p,
                                         top_k=cfg.eval_top_k,
                                         eos_token_id=self.tokenizer.eos_token_id,
                                         pad_token_id=self.pad_id, length_penalty=1.0),
                        gen)

    def _generate_examples(self, batch, params=None) -> list[tuple[str, str, str]]:
        """(question, target, generated) strings of the batch's real rows."""
        ids = self.generate_ids(batch, params)
        keep = common.real_rows(batch)
        return [(self._decode(q), self._decode(a), self._decode(g))
                for q, a, g, k in zip(common.to_host(batch["question_ids"]),
                                      common.to_host(batch["answer_ids"]),
                                      common.to_host(ids), keep) if k]

    # ------------------------------------------------------------------ save

    def _meta(self, epoch: int) -> dict:
        """A train state's metadata: its epoch, and the method its base was quantized
        with (None for a dense base), which ``--resume`` quantizes the base by again."""
        return {"epoch": epoch,
                "quant_method": self.cfg.quant_method if self.cfg.enable_qlora else None}

    def save_checkpoint(self, epoch: int):
        self.ckpt.save_periodic(epoch, self.state, self._meta(epoch))
        # every model rank enters the gathers of the shards; rank 0 writes
        exported = ("projector", "lora") + (("llm",) if self.base_policy.train_llm else ())
        params = {k: sharding.gather_params(v, self.plan, prefix=k, host=True)
                  for k, v in self.state["params"].items() if k in exported}
        if distributed.is_main():
            export.save_stage2_checkpoint(
                self.cfg.output_dir, epoch, projector_params=params["projector"],
                projector_cfg=self.vlm_cfg.projector,
                llm_params=params["llm"] if self.base_policy.train_llm else None,
                lora_params=params.get("lora"), lora_cfg=self.lora_cfg,
                base_model_name=self.cfg.llm_name or None,
                metadata={**self._meta(epoch), "config": self.cfg.to_json()})
        distributed.barrier()
