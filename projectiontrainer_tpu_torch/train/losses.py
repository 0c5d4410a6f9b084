"""Training losses with the reference's semantics, computed in fp32.

Counterpart of ``projectiontrainer_tpu/train/losses.py``: the stage-0 contrastive loss
(``siglip_pairwise_loss``), the cls probe's losses (``softmax_ce_loss``,
``two_way_multilabel_loss``) and the causal-LM losses (``shifted_clm_loss``,
``chunked_shifted_clm_loss``, ``fused_shifted_clm_loss``): tokens < n predict token n,
labels -100 are ignored, the mean runs over the non-ignored targets, and optional
per-sample weights (0 for a straggler batch's filler rows) weight both the sum and the
count. Each returns ``(loss, count)``: the fp32 scalar loss and the (weighted) number
of targets as an integer tensor.

``over_ranks=True`` (the train and eval steps pass it) makes a loss this rank's share
of the loss over the whole data-parallel batch: the rank's own sum over the count
summed over the ranks (``parallel/distributed.py``), so the shares add up to the JAX
package's global mean under a data mesh, and the gradients summed over the ranks are
its gradients. A mean of per-rank means would weigh a rank's token by the rank's own
count. The count returned is then the global one. In a single process it changes
nothing.

Under tensor parallelism (a model axis, ``parallel/tensor_parallel.py``) the head
table is the rank's vocab slice: the chunked and fused CLM losses then run their
vocab-parallel forms (``ops/fused_ce.py``), whose per-token NLL is the same on every
model rank, and the ranks are counted once (the global counts sum over the data axis).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from projectiontrainer_tpu_torch.ops.fused_ce import (
    chunked_nll_vocab_parallel, fused_clm_token_nll, fused_clm_token_nll_vocab_parallel,
)
from projectiontrainer_tpu_torch.parallel import distributed
from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp

IGNORE_INDEX = -100


def _count(count, over_ranks: bool):
    return distributed.sum_over_ranks(count) if over_ranks else count


def _reduce(token_loss, valid, sample_weights, over_ranks=False):
    valid_f = valid.float()
    if sample_weights is not None:
        w = sample_weights.float()[:, None]
        token_loss = token_loss * w
        valid_f = valid_f * w
    count = _count(valid_f.sum(), over_ranks)
    return token_loss.sum() / count.clamp_min(1e-9), count.to(torch.int32)


def shifted_clm_loss(logits, labels, sample_weights=None, over_ranks=False):
    """logits [B, T, V]; labels [B, T] with -100 at ignored positions."""
    logits = logits[:, :-1].float()
    labels = labels[:, 1:]
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    logprobs = torch.log_softmax(logits, dim=-1)
    token_ll = logprobs.gather(-1, safe[..., None])[..., 0]
    token_loss = torch.where(valid, -token_ll, 0.0)
    if sample_weights is None:
        count = _count(valid.sum(), over_ranks)
        return token_loss.sum() / count.clamp_min(1), count.to(torch.int32)
    return _reduce(token_loss, valid, sample_weights, over_ranks)


def _chunk_nll(h, table, safe, scale):
    logits = torch.matmul(h, table.to(h.dtype).t()).float() * scale
    picked = logits.gather(-1, safe[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def chunked_shifted_clm_loss(hidden, embed_table, labels, *, chunk_size: int = 128,
                             logits_scale: float = 1.0, sample_weights=None,
                             over_ranks=False):
    """The same loss from hidden states [B, T, D] and the [V, D] head table, over
    ``chunk_size`` positions at a time; each chunk's logits are recomputed in the
    backward (``torch.utils.checkpoint``, as ``jax.checkpoint`` in the JAX package),
    so at most one chunk's [B, chunk, V] fp32 logits are alive. The product runs in
    the hidden states' type (bf16 in training), its result is read in fp32. With a
    model axis ``embed_table`` is the rank's vocab slice and the vocab-parallel form
    runs (``ops/fused_ce.chunked_nll_vocab_parallel``), its gradient reaching the
    slice."""
    hidden = hidden[:, :-1]
    labels = labels[:, 1:]
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    if tp.size() > 1:
        b, t, d = hidden.shape
        nll = chunked_nll_vocab_parallel(hidden.reshape(b * t, d), embed_table,
                                         safe.reshape(-1), logits_scale,
                                         chunk=chunk_size * b)
        token_loss = torch.where(valid, nll.reshape(b, t), 0.0)
        return _reduce(token_loss, valid, sample_weights, over_ranks)
    nll = []
    for s in range(0, hidden.shape[1], chunk_size):
        args = (hidden[:, s:s + chunk_size], embed_table, safe[:, s:s + chunk_size],
                logits_scale)
        nll.append(checkpoint(_chunk_nll, *args, use_reentrant=False)
                   if torch.is_grad_enabled() else _chunk_nll(*args))
    token_loss = torch.where(valid, torch.cat(nll, dim=1), 0.0)
    return _reduce(token_loss, valid, sample_weights, over_ranks)


def fused_shifted_clm_loss(hidden, embed_table, labels, *, logits_scale: float = 1.0,
                           sample_weights=None, over_ranks=False):
    """The same loss through the fused linear + CE kernels (``ops/fused_ce.py``): the
    [tokens, V] logits never exist. REQUIRES a frozen ``embed_table``: its gradient
    is zero by the kernels' contract. With a model axis in the process's mesh
    ``embed_table`` is the rank's vocab slice and the vocab-parallel kernels run
    (``fused_clm_token_nll_vocab_parallel``)."""
    b, t, d = hidden.shape
    labels = labels[:, 1:]
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0)
    flat = hidden[:, :-1].reshape(b * (t - 1), d)
    nll_fn = fused_clm_token_nll_vocab_parallel if tp.size() > 1 else fused_clm_token_nll
    nll = nll_fn(flat, embed_table, safe.reshape(-1), logits_scale)
    token_loss = torch.where(valid, nll.reshape(b, t - 1), 0.0)
    return _reduce(token_loss, valid, sample_weights, over_ranks)


def _pairwise_bce(image_features, text_features, logit_scale, logit_bias, offset=0):
    """[rows, columns] binary cross entropy of the pairwise logits of L2-normalised
    towers, ``img @ txt.T * exp(logit_scale)`` (+ bias), against the identity: row i's
    positive is column ``offset + i``."""
    img = image_features.float()
    txt = text_features.float()
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    logits = img @ txt.t() * torch.exp(logit_scale.float().reshape(()))
    if logit_bias is not None:
        logits = logits + logit_bias.float().reshape(())
    rows = torch.arange(logits.shape[0], device=logits.device) + offset
    labels = (torch.arange(logits.shape[1], device=logits.device)[None, :]
              == rows[:, None]).float()
    return logits.clamp_min(0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def siglip_pairwise_loss(image_features, text_features, logit_scale, logit_bias=None,
                         sample_weight=None):
    """The reference's stage-0 loss (Stage0/train_vision_encoder_stage0.py:260-269):
    L2-normalised towers, pairwise logits ``img @ txt.T * exp(logit_scale)`` (+ bias),
    binary cross entropy against the identity matrix, summed and divided by n.

    ``sample_weight`` (0/1 a row) masks a straggler batch's filler rows in both the
    rows and the columns of the pairwise matrix and divides by the number of real
    rows. (The reference's BCE against an identity matrix, not canonical SigLIP's
    +-1 log-sigmoid, replicated on purpose.)"""
    per = _pairwise_bce(image_features, text_features, logit_scale, logit_bias)
    if sample_weight is None:
        return per.sum() / per.shape[0]
    w = sample_weight.float()
    return (per * (w[:, None] * w[None, :])).sum() / w.sum().clamp_min(1.0)


def siglip_pairwise_loss_over_ranks(image_features, text_features, logit_scale,
                                    logit_bias=None, sample_weight=None):
    """``siglip_pairwise_loss`` with global negatives across the data-parallel world,
    this rank's share of it: every rank's text features (and weights) are gathered,
    the text features with their gradient (``all_gather_with_grad``); the rank scores
    its own images' rows of the global pairwise matrix against all the texts and
    divides by the global count. The shares add up to the loss over the whole batch,
    and no rank computes the whole matrix. ``siglip_pairwise_loss`` on a data axis of
    one. Every collective and offset here is over the data axis: the model ranks of one
    replica hold the same rows and compute the same share."""
    if distributed.data_size() == 1:
        return siglip_pairwise_loss(image_features, text_features, logit_scale, logit_bias,
                                    sample_weight)
    n = image_features.shape[0]
    w = (torch.ones((n,), dtype=torch.float32, device=image_features.device)
         if sample_weight is None else sample_weight.float())
    per = _pairwise_bce(image_features, distributed.all_gather_with_grad(text_features),
                        logit_scale, logit_bias, offset=distributed.data_rank() * n)
    w_cols = distributed.all_gather(w)
    return ((per * (w[:, None] * w_cols[None, :])).sum()
            / distributed.sum_over_ranks(w.sum()).clamp_min(1.0))


def _masked_logsumexp(x, mask, temperature):
    """T * logsumexp(x / T) over the masked elements of the last axis; a row with none
    gives a finite value that the caller discards."""
    x = x / temperature
    neg = torch.finfo(torch.float32).min
    xm = torch.where(mask, x, neg)
    m = xm.max(dim=-1, keepdim=True).values.clamp_min(neg)
    s = torch.where(mask, torch.exp(xm - m), 0.0).sum(-1)
    return temperature * (m[..., 0] + torch.log(s.clamp_min(1e-38)))


def two_way_multilabel_loss(logits, targets, *, t_p: float = 4.0, t_n: float = 1.0,
                            sample_weights=None, over_ranks=False):
    """Kobayashi CVPR'23 two-way multi-label loss (the reference's
    ``TwoWayMultiLabelLoss``, cls_evaluate/train_twoway_loss.py:166-286): a sample-wise
    term (over classes, per sample) and a class-wise term (over the batch, per class),
    each ``softplus(T_n * LSE(x_neg / T_n) + T_p * LSE(-x_pos / T_p))``, zero for a row
    or column without positives or without negatives; (mean_sample + mean_class) / 2.

    ``sample_weights`` (0/1 a row) excludes a straggler batch's filler rows from both
    directions and from the sample mean's count. The class-wise term runs over the
    whole batch, so ``over_ranks`` gathers every data rank's logits (with their
    gradient), targets and weights and takes 1/(data ranks) of the global loss (the
    model ranks of one replica hold the same rows)."""
    if over_ranks and distributed.data_size() > 1:
        return two_way_multilabel_loss(
            distributed.all_gather_with_grad(logits), distributed.all_gather(targets),
            t_p=t_p, t_n=t_n,
            sample_weights=(None if sample_weights is None
                            else distributed.all_gather(sample_weights))
        ) / distributed.data_size()
    logits = logits.float()
    pos, neg = targets == 1, targets == 0
    if sample_weights is not None:
        real = (sample_weights > 0)[:, None]
        pos, neg = pos & real, neg & real
        n_samples = real.sum().float().clamp_min(1.0)
    else:
        n_samples = float(targets.shape[0])

    def direction(dim, denom):
        p, n, x = (t.movedim(dim, -1) for t in (pos, neg, logits))
        has_both = p.any(-1) & n.any(-1)
        loss = torch.nn.functional.softplus(_masked_logsumexp(x, n, t_n)
                                            + _masked_logsumexp(-x, p, t_p))
        return torch.where(has_both, loss, 0.0).sum() / denom

    sample_loss = direction(1, n_samples)                 # over classes, each real sample
    class_loss = direction(0, float(targets.shape[1]))    # over real rows, each class
    return (sample_loss + class_loss) / 2.0


def softmax_ce_loss(logits, target_indices, sample_weights=None, over_ranks=False):
    """Single-label cross entropy over the class logits (the reference's
    ``nn.CrossEntropyLoss``, cls_evaluate/train_utils.py); ``sample_weights`` exclude
    a straggler batch's filler rows from the mean."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -logprobs.gather(-1, target_indices.long()[:, None])[:, 0]
    if sample_weights is None:
        if not over_ranks:
            return nll.mean()
        n = torch.tensor(float(nll.shape[0]), device=nll.device)
        return nll.sum() / _count(n, over_ranks)
    w = sample_weights.float()
    return (nll * w).sum() / _count(w.sum(), over_ranks).clamp_min(1e-9)
