"""Fused linear + cross-entropy for huge-vocab CLM losses: the CUDA kernels
``csrc/fused_ce.cu`` for CUDA tensors, their plain versions for CPU ones.

Counterpart of ``projectiontrainer_tpu/ops/fused_ce.py`` (``fused_clm_token_nll`` with
its custom VJP: ``_fwd_call``/``_fwd_kernel`` and ``_bwd_call``/``_bwd_kernel``):

    nll[t] = logsumexp_v(h[t] . W[v] * scale) - h[t] . W[label[t]] * scale
    dh[t]  = g[t] * scale * sum_v (softmax[t, v] - onehot[t, v]) * W[v]

with the [tokens, vocab] logits never stored. The gradient goes to ``hidden`` only:
the table's gradient is zero BY CONTRACT (a frozen vocab table; computing dW would
bring back the logits buffer the kernel exists to avoid). ``train/steps.py`` raises
when a run that trains the table asks for this path. Ignored positions pass a dummy
label 0 and are masked by the caller (``train/losses.py``). A label of -1 matches no
column (the kernels compare labels against columns; the plain versions test for it):
its ``picked`` is 0, so its nll is its lse, and its backward has no one-hot.

The kernels take bf16 hidden states [N, D] and table [V, D] with D a multiple of 64
(the width of the TMA boxes that stream both through shared memory; no upper limit);
the plain versions take any shape and type.

``fused_clm_token_nll_vocab_parallel`` is the counterpart of the JAX package's
vocab-parallel variant (``_make_vp_nll`` and ``fused_clm_token_nll_vocab_parallel``,
``ops/fused_ce.py:262,339`` there), for a table sharded over the model axis of the mesh
(``parallel/sharding.py``): each rank runs the same kernels on its ``[V / m, D]`` slice
with the labels rebased to the slice (a label outside it becomes -1), the partial lse
values combine max-shifted over the model axis, ``picked`` and ``dh`` are summed over
it, and the table's gradient is zero by the same contract. ``chunked_nll_vocab_parallel``
is the same function in plain torch with the table's gradient (the tied table that
stage 2's full-joint run trains); on CPU tensors the fused variant is it, its table
gradient dropped.
"""

from __future__ import annotations

import math

import torch

from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp

fwd_launches = _build.LaunchCounter("fused_ce_fwd")
bwd_launches = _build.LaunchCounter("fused_ce_bwd")
BM = 128      # tokens per CTA (csrc/fused_ce.cu)
FWD_BV = 256  # vocab rows per tile of the forward kernel
BWD_VW = 512  # vocab rows per range of the backward kernel
_CHUNK = 256  # tokens per step of the plain versions ([256, V] fp32 logits at a time)


def _logits(h, table, scale):
    """fp32 logits of a token chunk; the product runs in the inputs' type."""
    return torch.matmul(h, table.to(h.dtype).t()).float() * scale


def _picked(logits, labels):
    """logits[t, label[t]], 0 where the label is -1 (no column)."""
    lab = labels.long()
    got = logits.gather(1, lab.clamp(min=0)[:, None])[:, 0]
    return torch.where(lab >= 0, got, 0.0)


def fused_ce_reference(hidden, table, labels, scale: float = 1.0):
    """The plain forward -> (lse [N] fp32, nll [N] fp32), token chunk by chunk."""
    lse, nll = [], []
    for s in range(0, hidden.shape[0], _CHUNK):
        logits = _logits(hidden[s:s + _CHUNK], table, scale)
        chunk_lse = torch.logsumexp(logits, dim=-1)
        picked = _picked(logits, labels[s:s + _CHUNK])
        lse.append(chunk_lse)
        nll.append(chunk_lse - picked)
    return torch.cat(lse), torch.cat(nll)


def fused_ce_bwd_reference(hidden, table, labels, lse, g, scale: float = 1.0):
    """The plain backward -> dh [N, D] fp32 BEFORE the ``* scale``:
    sum_v (softmax - onehot) * g * W[v], with the (softmax - onehot) * g factor rounded
    to the hidden states' type before its product, as the kernels do."""
    out = []
    for s in range(0, hidden.shape[0], _CHUNK):
        h = hidden[s:s + _CHUNK]
        p = torch.exp(_logits(h, table, scale) - lse[s:s + _CHUNK, None])
        lab = labels[s:s + _CHUNK].long()
        hit = (lab >= 0).nonzero()[:, 0]  # a -1 label has no one-hot
        p[hit, lab[hit]] -= 1.0
        q = (p * g[s:s + _CHUNK, None].float()).to(h.dtype)
        out.append(torch.matmul(q, table.to(h.dtype)).float())
    return torch.cat(out)


def _check(hidden, table, labels):
    for name, x in (("hidden", hidden), ("table", table)):
        if not x.is_cuda:
            raise ValueError(f"fused_ce: {name} is not on the card")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"fused_ce: {name} must be bf16 on the card, got {x.dtype}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"fused_ce: {name} must be a contiguous 2-D tensor")
    n, d = hidden.shape
    if table.shape[1] != d or d == 0 or d % 64:
        raise ValueError(f"fused_ce: hidden size {d} (table {tuple(table.shape)}) not "
                         f"supported: the kernels take a multiple of 64")
    if labels.shape != (n,) or labels.dtype != torch.int32 or not labels.is_contiguous():
        raise ValueError("fused_ce: labels must be contiguous int32 [N]")


def _plan(n: int, v: int, vocab_tile: int, sms: int) -> tuple[int, int, int]:
    """(n_pad, splits, vocab tiles per split) of the grid (token tiles of BM, splits):
    as many vocab splits as fill the card's ``sms`` SMs once (one CTA per SM), each of
    whole vocab tiles of ``vocab_tile`` rows (FWD_BV forward, BWD_VW backward). Split s
    walks tiles [s * per, min((s + 1) * per, tiles)): no split is empty. The forward's
    scratch is [3, splits, n_pad], the backward's [splits, n_pad, D]."""
    n_tiles, n_vt = math.ceil(n / BM), math.ceil(v / vocab_tile)
    want = max(1, min(n_vt, sms // n_tiles))
    per = math.ceil(n_vt / want)
    return n_tiles * BM, math.ceil(n_vt / per), per


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_ce_fwd(hidden, table, labels, scale: float = 1.0):
    """-> (lse [N], nll [N]) fp32: the forward kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if not hidden.is_cuda:
        if hidden.device.type != "cpu":
            raise RuntimeError(f"fused_ce: no kernel for device {hidden.device}")
        return fused_ce_reference(hidden, table, labels, scale)
    _check(hidden, table, labels)
    n, d = hidden.shape
    n_pad, splits, per = _plan(n, table.shape[0], FWD_BV, _sms(hidden.device))
    part = torch.empty((3, splits, n_pad), dtype=torch.float32, device=hidden.device)
    lse = torch.empty((n,), dtype=torch.float32, device=hidden.device)
    nll = torch.empty_like(lse)
    err = _build.library().fused_ce_fwd_bf16(
        hidden.data_ptr(), table.data_ptr(), labels.data_ptr(), part.data_ptr(),
        lse.data_ptr(), nll.data_ptr(), n, table.shape[0], d, splits, per, float(scale),
        torch.cuda.current_stream(hidden.device).cuda_stream)
    _build.check("fused_ce_fwd_bf16", err)
    fwd_launches.add()
    return lse, nll


def fused_ce_bwd(hidden, table, labels, lse, g, scale: float = 1.0):
    """-> dh [N, D] fp32 before the ``* scale``: the backward kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if not hidden.is_cuda:
        if hidden.device.type != "cpu":
            raise RuntimeError(f"fused_ce: no kernel for device {hidden.device}")
        return fused_ce_bwd_reference(hidden, table, labels, lse, g, scale)
    _check(hidden, table, labels)
    n, d = hidden.shape
    lse, g = lse.float().contiguous(), g.float().contiguous()
    if lse.shape != (n,) or g.shape != (n,):
        raise ValueError("fused_ce: lse and g must be [N]")
    n_pad, splits, per = _plan(n, table.shape[0], BWD_VW, _sms(hidden.device))
    part = torch.empty((splits, n_pad, d), dtype=torch.float32, device=hidden.device)
    dh = torch.empty((n, d), dtype=torch.float32, device=hidden.device)
    err = _build.library().fused_ce_bwd_bf16(
        hidden.data_ptr(), table.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        part.data_ptr(), dh.data_ptr(), n, table.shape[0], d, splits, per, float(scale),
        torch.cuda.current_stream(hidden.device).cuda_stream)
    _build.check("fused_ce_bwd_bf16", err)
    bwd_launches.add()
    return dh


class _FusedNLL(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, table, labels, scale):
        lse, nll = fused_ce_fwd(hidden, table, labels, scale)
        ctx.save_for_backward(hidden, table, labels, lse)
        ctx.scale = scale
        return nll

    @staticmethod
    def backward(ctx, g):
        hidden, table, labels, lse = ctx.saved_tensors
        dh = fused_ce_bwd(hidden, table, labels, lse, g, ctx.scale)
        # scale and downcast outside the kernel, as in JAX; the table's gradient is
        # zero by contract (module docstring)
        dh = (dh * ctx.scale).to(hidden.dtype)
        dtable = torch.zeros_like(table) if ctx.needs_input_grad[1] else None
        return dh, dtable, None, None


def fused_clm_token_nll(hidden, table, labels, scale: float = 1.0):
    """Per-token NLL ``lse - logit[label]`` for flattened tokens.

    hidden [N, D]; table [V, D]; labels [N] int in [0, V) (ignored positions pass a
    dummy 0, masked outside). Returns fp32 [N]. Differentiable with respect to
    ``hidden`` only; the table's gradient is zero by contract."""
    return _FusedNLL.apply(hidden, table, labels.to(torch.int32).contiguous(), float(scale))


# ------------------------------------------------------------------ vocab-parallel (TP)


def rebase_labels(labels, v_local: int):
    """Labels [N] -> the rank's slice's columns (rank r holds ids r * v_local ...
    (r + 1) * v_local - 1), -1 outside the slice."""
    local = labels.long() - tp.rank() * v_local
    return torch.where((local >= 0) & (local < v_local), local, -1).to(torch.int32)


def combine_lse(lse_s, picked_s):
    """Each rank's partial (lse [N], picked [N]) -> the whole vocab's (lse, picked): the
    lse values max-shifted over the model axis, picked summed (a label lives in one
    slice). Two all-reduces, of [N] and [2, N]."""
    m = tp.all_reduce(lse_s, "forward", op=torch.distributed.ReduceOp.MAX)
    both = tp.all_reduce(torch.stack([torch.exp(lse_s - m), picked_s]), "forward")
    return m + torch.log(both[0]), both[1]


class _VocabParallelNLL(torch.autograd.Function):
    """The fused kernels (or their plain versions) on the rank's vocab slice; the table's
    gradient is zero by contract."""

    @staticmethod
    def forward(ctx, hidden, table, labels, scale):
        loc = rebase_labels(labels, table.shape[0])
        lse_s, nll_s = fused_ce_fwd(hidden, table, loc, scale)
        lse, picked = combine_lse(lse_s, lse_s - nll_s)
        ctx.save_for_backward(hidden, table, loc, lse)
        ctx.scale = scale
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        hidden, table, loc, lse = ctx.saved_tensors
        dh = fused_ce_bwd(hidden, table, loc, lse, g, ctx.scale)
        dh = tp.all_reduce(dh, "backward")  # the vocab sum splits across the slices
        dh = (dh * ctx.scale).to(hidden.dtype)
        dtable = torch.zeros_like(table) if ctx.needs_input_grad[1] else None
        return dh, dtable, None, None


def fused_clm_token_nll_vocab_parallel(hidden, table, labels, scale: float = 1.0):
    """Per-token NLL with the table sharded over the model axis: hidden [N, D] (every
    model rank's the same), table [V / m, D] (the rank's slice), labels [N] in [0, V)
    (ignored positions pass a dummy 0, masked outside). Returns fp32 [N], the same on
    every model rank; differentiable with respect to ``hidden`` only."""
    return _VocabParallelNLL.apply(hidden, table, labels.to(torch.int32).contiguous(),
                                   float(scale))


class _ChunkedVocabParallelNLL(torch.autograd.Function):
    """The plain vocab-parallel NLL with the table's gradient: logits [chunk, V / m] in
    the hidden states' type read in fp32, recomputed in the backward chunk by chunk."""

    @staticmethod
    def forward(ctx, hidden, table, labels, scale, chunk):
        loc = rebase_labels(labels, table.shape[0])
        lse_s, picked_s = [], []
        for s in range(0, hidden.shape[0], chunk):
            logits = _logits(hidden[s:s + chunk], table, scale)
            lse_s.append(torch.logsumexp(logits, dim=-1))
            picked_s.append(_picked(logits, loc[s:s + chunk]))
        lse, picked = combine_lse(torch.cat(lse_s), torch.cat(picked_s))
        ctx.save_for_backward(hidden, table, loc, lse)
        ctx.scale, ctx.chunk = scale, chunk
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        hidden, table, loc, lse = ctx.saved_tensors
        w = table.to(hidden.dtype)
        dh, dw = [], torch.zeros_like(w, dtype=torch.float32)
        for s in range(0, hidden.shape[0], ctx.chunk):
            h = hidden[s:s + ctx.chunk]
            p = torch.exp(_logits(h, table, ctx.scale) - lse[s:s + ctx.chunk, None])
            lab = loc[s:s + ctx.chunk].long()
            # minus one at each label inside the slice; no data-dependent shape, so a
            # trace without data (parallel/budget.py) runs it too
            hit = (lab >= 0)[:, None]
            p.scatter_add_(1, lab.clamp_min(0)[:, None], -hit.to(p.dtype))
            q = (p * (g[s:s + ctx.chunk, None].float() * ctx.scale)).to(h.dtype)
            dh.append(q @ w)
            dw += (q.t() @ h).float()
        dh = tp.all_reduce(torch.cat(dh), "backward")
        dtable = dw.to(table.dtype) if ctx.needs_input_grad[1] else None
        return dh.to(hidden.dtype), dtable, None, None, None


def chunked_nll_vocab_parallel(hidden, table, labels, scale: float = 1.0,
                               chunk: int = 128):
    """``fused_clm_token_nll_vocab_parallel`` in plain torch, ``chunk`` tokens at a
    time, differentiable with respect to ``hidden`` and the table's slice."""
    return _ChunkedVocabParallelNLL.apply(hidden, table, labels.to(torch.int32).contiguous(),
                                          float(scale), int(chunk))
