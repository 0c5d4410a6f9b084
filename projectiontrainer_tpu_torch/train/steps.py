"""Train and eval steps for stages 0, 1 and 2.

Counterpart of ``projectiontrainer_tpu/train/steps.py``: ``stage1_loss`` rebuilds the
reference's [visual; caption] CLM loss, ``stage2_loss`` the [visual; question; answer]
answer-only CLM loss, ``stage0_loss`` the SigLIP pairwise loss over the dual tower,
``classifier_loss`` the cls probe's cross entropy or two-way multi-label loss,
``make_train_step`` differentiates any of them with respect to the trainable leaves
only and applies the masked AdamW update, ``swap_optimizer`` rebuilds the optimizer
state at a freeze-mask swap keeping what survives, and ``make_eval_step`` runs the
loss without gradients. Where JAX returns a new state, the port updates the params
and optimizer state in place and returns the same dict.

Data parallelism (``parallel/distributed.py``): each loss is this rank's share of the
loss over the whole data-parallel batch (the losses' ``over_ranks``), so the train
step sums the gradients over the ranks (span ``grad_allreduce``) right after the
backward, before the optimizer, and the reported loss is the sum of the shares: the
JAX package's global mean under its data mesh. In a single process nothing changes.

Tensor parallelism (a model axis; ``parallel/sharding.py``): the params are a model
rank's shards and the loss is the same on every model rank. The train step takes the
plan of the shards: it sums the partial gradients of the replicated leaves that act on
sharded activations over the model axis (one bucketed all-reduce, span
``tp_allreduce``) before the data all-reduce, and its ``grad_norm`` counts a sharded
leaf's squares over the model axis.

ZeRO-3 over the data axis (``--fsdp``; ``parallel/fsdp.py``): the plan also names the
leaves held as data shards. The step runs the loss and its backward with that plan
active, so the models gather each shard where they use it and its gradient arrives
already reduce-scattered (summed over the data ranks, the rank's block): those leaves
leave the data all-reduce, and the norms count their squares over the data axis (over
both axes for a leaf split by both). The optimizer's moments and accumulators are
``zeros_like`` of the shards, so its update stays local. The CLM losses gather the
decoder's table and other top-level leaves once a micro-step: the tied table serves the
embedding and the chunked CE head, and its two gradients meet before one
reduce-scatter.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from projectiontrainer_tpu_torch.core import dtypes
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths, unique_leaves_with_paths
from projectiontrainer_tpu_torch.models import classifier as cls_model
from projectiontrainer_tpu_torch.models import decoder as dec
from projectiontrainer_tpu_torch.models import siglip, vlm
from projectiontrainer_tpu_torch.parallel import distributed, fsdp, sharding
from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp
from projectiontrainer_tpu_torch.train import losses
from projectiontrainer_tpu_torch.train.optim import sharded_global_norms
from projectiontrainer_tpu_torch.utils.timing import span


def init_state(params, tx) -> dict:
    return {"params": params, "opt_state": tx.init(params), "step": 0}


def swap_optimizer(state: dict, new_tx) -> dict:
    """The optimizer state for ``new_tx`` (the next freeze mask), carrying the Adam
    count, the accumulation mini-step and every moment and accumulator slot whose path,
    shape and type are unchanged: the groups that still train keep their moments and
    bias correction (the reference keeps one AdamW across the ``requires_grad`` flip,
    Stage2/trainer.py:267-289), also when the swap falls inside an accumulation; the
    newly frozen leaves' state is dropped."""
    return {"params": state["params"],
            "opt_state": new_tx.init(state["params"], carry=state["opt_state"]),
            "step": state["step"]}


def make_train_step(loss_fn: Callable, tx, *, trainable_mask=None,
                    watch_subtree: Optional[str] = None, plan=None):
    """loss_fn(params, batch, rng) -> (loss, aux). Returns
    step(state, batch, rng=None) -> (state, loss, aux); ``rng`` (an int, the step's
    seed) reaches the loss, where it seeds the LoRA dropout.

    Only the floating leaves that ``trainable_mask`` marks True (every floating leaf
    when it is None) get ``requires_grad``; integer leaves (quantized codes) never do: the backward computes no weight gradient for a frozen
    leaf, while gradients still flow through frozen activations to the projector. A
    tensor held under two paths (the tied LM head) is one trainable leaf, under its
    first path: one gradient, the sum of both uses.
    The gradients are summed over the data-parallel ranks before the update (the
    accumulation and clipping of the optimizer see the global gradients, as optax does
    under a data mesh) and the loss returned is the global one.
    ``aux['grad_norm']`` is the global norm of the raw gradients of the trainable
    leaves; ``watch_subtree`` (a top-level key such as ``'projector'``) adds that
    subtree's gradients, keyed by their paths inside it, as ``aux['watched_grads']``.
    ``plan`` (a ``sharding.ShardPlan``; required with a model axis) names the sharded
    leaves and those whose gradients are partial on each model rank, and under
    ``--fsdp`` the data shards, which the models gather inside the step and whose
    gradients the gathers' backward reduce-scatters (the watched gradients of those
    leaves are the rank's blocks)."""
    mask = None if trainable_mask is None else dict(leaves_with_paths(trainable_mask))
    if tp.size() > 1 and plan is None:
        raise ValueError("a train step under tensor parallelism needs the params' shard plan")
    sharded = plan.sharded if plan is not None else frozenset()
    data_sharded = plan.data_sharded if plan is not None else frozenset()

    def step(state, batch, rng=None):
        params = state["params"]
        train = []
        for path, x in unique_leaves_with_paths(params):
            on = x.is_floating_point() and (mask is None or bool(mask[path]))
            x.requires_grad_(on)
            if on:
                train.append((path, x))
        with fsdp.active(plan):
            loss, aux = loss_fn(params, batch, rng)
            grads = torch.autograd.grad(loss, [x for _, x in train], allow_unused=True)
        grads = {p: torch.zeros_like(x) if g is None else g
                 for (p, x), g in zip(train, grads)}
        with distributed.collective_phase("grads"):
            if tp.size() > 1:
                partial = [g for p, g in grads.items() if p in plan.partial]
                if partial:
                    with span("tp_allreduce"):
                        tp.COUNTS["grads"] += 1
                        distributed.all_reduce_grads(partial, distributed.MODEL_AXIS)
            with span("grad_allreduce"):
                distributed.all_reduce_grads([g for p, g in grads.items()
                                              if p not in data_sharded])
                loss = distributed.sum_over_ranks(loss.detach())
        with span("optimizer"):
            with distributed.collective_phase("optimizer"):
                tx.update(grads, state["opt_state"], params)
            state["step"] += 1
            with distributed.collective_phase("grads"):
                aux = {**aux, "grad_norm": sharded_global_norms({"all": grads}, sharded,
                                                                data_sharded)["all"]}
        if watch_subtree is not None:
            prefix = watch_subtree + "/"
            aux["watched_grads"] = {p[len(prefix):]: g for p, g in grads.items()
                                    if p.startswith(prefix)}
        return state, loss.detach(), aux

    return step


def make_eval_step(loss_fn: Callable):
    """step(params, batch) -> (loss, aux) without gradients; the loss summed over the
    data-parallel ranks (every rank must run the same number of eval batches)."""
    def step(params, batch):
        with torch.no_grad():
            loss, aux = loss_fn(params, batch, None)
            return distributed.sum_over_ranks(loss), aux

    return step


# ---------------------------------------------------------------------------- stage 1


def _resolve_ce_impl(ce_impl: str, table_frozen: bool, hidden_size: Optional[int] = None,
                     on_card: bool = False) -> str:
    """'auto' picks the fused linear + CE kernels (``ops/fused_ce.py``) when the
    tensors are on the card and their contract holds: a frozen vocab table and a
    hidden size that is a multiple of 128. With a model axis the kernels run on the
    rank's vocab slice where it splits the vocab, and on the whole vocab on every rank
    where it does not (the JAX package takes the chunked CE there,
    ``train/steps.py:174-216``; the port holds the whole table on every rank, so the
    whole-vocab kernels serve). Anything else gets 'chunked'. An explicit 'fused' overrides
    the device choice (on the CPU it runs the kernels' plain versions) but not the
    contract: the kernels return a zero table gradient, so forcing them on a run that
    trains the embedding raises."""
    if ce_impl == "fused":
        if not table_frozen:
            raise ValueError(
                "ce_impl='fused' requires a frozen vocab table (the fused kernels' table "
                "gradient is zero); use 'chunked' when training the embedding/lm-head")
        if hidden_size is not None and hidden_size % 128 != 0:
            raise ValueError(
                f"ce_impl='fused' requires hidden_size % 128 == 0 (got {hidden_size})")
        return ce_impl
    if ce_impl != "auto":
        return ce_impl
    if not on_card or not table_frozen:
        return "chunked"
    if hidden_size is not None and hidden_size % 128 != 0:
        return "chunked"
    return "fused"


def _gather_decoder_top(params):
    """``params`` with the decoder's top-level leaves (the table, a separate head, the
    final norm) gathered once where they are ``--fsdp`` data shards: the embedding and
    the CE head then read one gathered table (``parallel/fsdp.py``)."""
    return {**params, "llm": fsdp.gather_top(params["llm"], "llm")}


def _clm_loss_from_embeds(params, cfg: vlm.VLMConfig, embeds, mask, labels, *, remat,
                          logits_chunk: Optional[int], sample_weights=None,
                          ce_impl: str = "chunked", loss_prefix: int = 0, lora=None,
                          lora_cfg=None, lora_seed: Optional[int] = None):
    """``loss_prefix``: the number of leading positions whose labels are statically
    -100 (the visual prefix in stage 1). Only pairs (hidden[i], labels[i + 1]) with
    i >= loss_prefix - 1 contribute, so the decoder output is cropped to that suffix
    before the head: the same loss and gradients at about half the head's work.
    ``lora``/``lora_cfg``/``lora_seed`` go to the decoder (``decoder.forward``)."""
    with span("decoder"):
        hidden, _ = dec.forward(params["llm"], cfg.llm, inputs_embeds=embeds,
                                attention_mask=mask, remat=remat, lora=lora,
                                lora_cfg=lora_cfg, lora_seed=lora_seed)
    if loss_prefix > 1:
        hidden = hidden[:, loss_prefix - 1:]
        labels = labels[:, loss_prefix - 1:]
    vocab_parallel = sharding.splits(cfg.llm, "vocab")
    with span("lm_head_ce"):
        if logits_chunk and ce_impl == "fused":
            return losses.fused_shifted_clm_loss(
                hidden, dec.lm_head_table(params["llm"], cfg.llm), labels,
                sample_weights=sample_weights, over_ranks=True,
                vocab_parallel=vocab_parallel)
        if logits_chunk:
            return losses.chunked_shifted_clm_loss(
                hidden, dec.lm_head_table(params["llm"], cfg.llm), labels,
                chunk_size=logits_chunk, sample_weights=sample_weights, over_ranks=True,
                vocab_parallel=vocab_parallel)
        return losses.shifted_clm_loss(dec.logits(params["llm"], cfg.llm, hidden), labels,
                                       sample_weights=sample_weights, over_ranks=True)


def stage1_loss(cfg: vlm.VLMConfig, pad_token_id: int, *, remat=True,
                logits_chunk: Optional[int] = None, ce_impl: str = "auto",
                compute_dtype=None):
    """[visual; caption] CLM loss (reference: Stage1/projector_trainer.py:160-233).
    batch: {'pixel_values' [B, H, W, C], 'caption_ids' [B, Tc], 'sample_weight'?}.

    ``logits_chunk`` switches to the chunked CE (large vocabularies); ``ce_impl``
    'auto' upgrades it to the fused kernels when the tensors are on the card (the
    stage-1 LLM, its table included, is always frozen). ``compute_dtype`` (bf16 from
    ``--mixed_precision``) casts the params inside the loss: fp32 masters, bf16
    compute. None computes in the params' own types."""
    _resolve_ce_impl(ce_impl, table_frozen=True, hidden_size=cfg.llm.hidden_size)

    def loss_fn(params, batch, rng=None):
        del rng
        if compute_dtype is not None:
            params = dtypes.cast_compute_params(params, compute_dtype)
        params = _gather_decoder_top(params)
        visual = vlm.visual_embeds(params, cfg, batch["pixel_values"])
        embeds, mask, labels = vlm.build_sequence(params, cfg, visual,
                                                  pad_token_id=pad_token_id,
                                                  caption_ids=batch["caption_ids"])
        impl = _resolve_ce_impl(ce_impl, table_frozen=True, hidden_size=cfg.llm.hidden_size,
                                on_card=embeds.is_cuda)
        loss, n_tok = _clm_loss_from_embeds(
            params, cfg, embeds, mask, labels, remat=remat, logits_chunk=logits_chunk,
            sample_weights=batch.get("sample_weight"), ce_impl=impl,
            loss_prefix=visual.shape[1],  # visual labels are statically -100
        )
        return loss, {"tokens": n_tok}

    return loss_fn


# ---------------------------------------------------------------------------- stage 2


def _vis_remat(remat):
    """An integer (partial) remat names decoder layers; the tower then recomputes all
    of its layers (``train/steps.py:_vis_remat`` of the JAX package); True, False and
    'dots' pass on to the tower."""
    return True if isinstance(remat, int) and not isinstance(remat, bool) else remat


def stage2_loss(cfg: vlm.VLMConfig, pad_token_id: int, *, lora_cfg=None, remat=True,
                logits_chunk: Optional[int] = None, ce_impl: str = "auto",
                table_frozen: Optional[bool] = None, compute_dtype=None):
    """[visual; question; answer] answer-masked CLM loss (reference:
    Stage2/trainer.py:306-418). batch: {'pixel_values' [B, H, W, C], 'question_ids'
    [B, Tq], 'answer_ids' [B, Ta], 'sample_weight'?}, questions and answers
    right-padded to their buckets.

    Only answer tokens are supervised, so the head and CE run on the answer region
    alone (``loss_prefix`` = visual + question tokens). ``table_frozen`` says whether
    the vocab table is frozen: a training table gets the chunked CE under 'auto', and
    'fused' raises; it defaults to ``lora_cfg is not None`` (LoRA never trains the
    table, JAX ``train/steps.py:306-307``), so the QLoRA recipe takes the fused CE
    kernels on the card. The tower runs with autograd when any of its leaves requires
    grad (``--train_ve_first_epoch``'s epoch 0).

    ``lora_cfg`` runs the adapters at ``params['lora']``; the step's ``rng`` (an int;
    the trainer passes the global step, as JAX's ``key(global_step)``) seeds their
    dropout, and None (evaluation) turns it off."""
    if table_frozen is None:
        table_frozen = lora_cfg is not None
    _resolve_ce_impl(ce_impl, table_frozen=table_frozen, hidden_size=cfg.llm.hidden_size)

    def loss_fn(params, batch, rng=None):
        if compute_dtype is not None:
            params = dtypes.cast_compute_params(params, compute_dtype)
        params = _gather_decoder_top(params)
        lora = params.get("lora") if lora_cfg is not None else None
        visual = vlm.visual_embeds(params, cfg, batch["pixel_values"], remat=_vis_remat(remat))
        embeds, mask, labels = vlm.build_sequence(
            params, cfg, visual, pad_token_id=pad_token_id,
            question_ids=batch["question_ids"], answer_ids=batch["answer_ids"])
        impl = _resolve_ce_impl(ce_impl, table_frozen=table_frozen,
                                hidden_size=cfg.llm.hidden_size, on_card=embeds.is_cuda)
        loss, n_tok = _clm_loss_from_embeds(
            params, cfg, embeds, mask, labels, remat=remat, logits_chunk=logits_chunk,
            sample_weights=batch.get("sample_weight"), ce_impl=impl,
            # visual and question labels are statically -100
            loss_prefix=visual.shape[1] + batch["question_ids"].shape[1],
            lora=lora, lora_cfg=lora_cfg, lora_seed=None if lora is None else rng,
        )
        return loss, {"tokens": n_tok}

    return loss_fn


# ---------------------------------------------------------------------------- stage 0


def stage0_loss(cfg: siglip.SiglipConfig, *, remat=False, local_negatives_shards: int = 1,
                compute_dtype=None):
    """SigLIP pairwise loss on the dual tower (reference:
    Stage0/train_vision_encoder_stage0.py:661-689). batch: {'pixel_values' [B, H, W, C],
    'input_ids' [B, T], 'sample_weight'?, 'valid'?}.

    ``sample_weight`` (0 on a straggler batch's filler rows) times ``valid`` (0 on a
    missing image's placeholder) masks rows and columns of the pairwise matrix.
    ``local_negatives_shards=N`` splits the data-parallel batch into N groups with
    their own negatives (the reference's per-rank loss under DDP; N a multiple of the
    data ranks: each data rank splits its rows into N / (data ranks) groups; the model
    ranks of one replica hold the same rows) and averages the
    losses of the groups that hold a real row, on every rank (a straggler batch can
    leave a rank without one). N = 1 gives global negatives: every rank's images
    against every rank's texts (``siglip_pairwise_loss_over_ranks``). Pixels are cast
    to the vision tower's compute type. The spans ``vision``, ``text``
    (``forward_contrastive``) and ``loss`` split a profiled step; a frozen text tower
    runs without autograd."""

    def loss_fn(params, batch, rng=None):
        del rng
        if compute_dtype is not None:
            params = dtypes.cast_compute_params(params, compute_dtype)
        pixels = batch["pixel_values"].to(params["vision"]["patch_embedding"]["weight"].dtype)
        img, txt, scale, bias = siglip.forward_contrastive(params, cfg, pixels,
                                                           batch["input_ids"], remat=remat)
        with span("loss"):
            w = batch.get("sample_weight")
            valid = batch.get("valid")
            if valid is not None:
                vf = valid.float()
                w = vf if w is None else w.float() * vf
            if local_negatives_shards <= 1:
                return losses.siglip_pairwise_loss_over_ranks(img, txt, scale[0], bias[0],
                                                              sample_weight=w), {}
            if local_negatives_shards % distributed.data_size():
                raise ValueError(f"local_negatives_shards={local_negatives_shards} is not a "
                                 f"multiple of the data ranks {distributed.data_size()}")
            n = local_negatives_shards // distributed.data_size()
            per = img.shape[0] // n
            w_s = (torch.ones((n, per), device=img.device) if w is None
                   else w.float().reshape(n, per))
            shard = torch.stack([
                losses.siglip_pairwise_loss(img[i * per:(i + 1) * per],
                                            txt[i * per:(i + 1) * per], scale[0], bias[0],
                                            sample_weight=w_s[i])
                for i in range(n)])
            # a straggler batch can leave whole shards without a real row (loss 0):
            # average over the shards, of every rank, that have one
            nonempty = (w_s.sum(1) > 0).float()
            count = distributed.sum_over_ranks(nonempty.sum())
            return (shard * nonempty).sum() / count.clamp_min(1.0), {}

    return loss_fn


# ---------------------------------------------------------------------------- classifier


def classifier_loss(cfg: cls_model.ClassifierConfig, *, multilabel: bool = False,
                    t_p: float = 4.0, t_n: float = 1.0, compute_dtype=None):
    """cls_evaluate probe loss: softmax CE (train_utils) or the two-way multi-label
    loss (train_twoway_loss). batch: {'pixel_values' [B, H, W, C], 'target_indices' [B]
    | 'targets' [B, C], 'sample_weight'?}. ``compute_dtype`` (bf16 from
    ``--mixed_precision``) casts the params inside the loss: fp32 masters, bf16
    compute. The step's ``rng`` (an int; the trainer passes the global step, as JAX's
    ``key(global_step)``) seeds the head's dropout, folded with the rank
    (``distributed.rank_seed``: each rank's rows draw their own masks); None
    (evaluation) turns it off.
    The tower runs with autograd only when one of its leaves requires grad."""

    def loss_fn(params, batch, rng=None):
        if compute_dtype is not None:
            params = dtypes.cast_compute_params(params, compute_dtype)
        pixels = batch["pixel_values"]
        gen = None
        if rng is not None:
            gen = torch.Generator(device=pixels.device).manual_seed(
                distributed.rank_seed(int(rng)))
        logits = cls_model.forward(params, cfg, pixels, dropout_gen=gen)
        with span("loss"):
            w = batch.get("sample_weight")
            if multilabel:
                loss = losses.two_way_multilabel_loss(logits, batch["targets"], t_p=t_p,
                                                      t_n=t_n, sample_weights=w,
                                                      over_ranks=True)
            else:
                loss = losses.softmax_ce_loss(logits, batch["target_indices"],
                                              sample_weights=w, over_ranks=True)
        return loss, {"logits": logits}

    return loss_fn
