"""Autoregressive generation from embedding prefixes with a split KV cache.

Counterpart of ``projectiontrainer_tpu/generate/decode.py``, with the same semantics:

- the prefix is prefilled ONCE per sample through a monolithic cache, then split
  (``decoder.split_cache``) into a per-sample prefix cache that is never reordered and
  a per-row generated cache [B * beams, G] that beam selection gathers;
- greedy / temperature / top-k / top-p sampling with HF's repetition penalty;
- beam search, deterministic or beam-multinomial, with HF's finished-hypothesis set,
  length penalty (the length counts the EOS) and early-stop heuristic.

``lax.while_loop`` becomes a Python loop whose exit test reads one bool from the
device per step. Top-k selections are stable (ties go to the lower index, as
``jax.lax.top_k`` breaks them), so deterministic decoding gives the JAX package's
tokens. Random draws come from a ``torch.Generator`` and differ from JAX's.

On a model rank's shards (tensor parallelism) the caches hold the KV heads the rank
attends with and the decode kernel runs on them (``decoder.local_heads``: the rank's
heads, the KV heads its query heads read, or all heads where the attention is whole);
``decoder.logits`` gathers a split vocab's logits over the model axis, so every model
rank takes the same steps, and a caller that samples seeds the same generator on every
model rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from projectiontrainer_tpu_torch.models import decoder as dec

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 64
    do_sample: bool = False
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    repetition_penalty: float = 1.0
    num_beams: int = 1
    length_penalty: float = 1.0
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    # The JAX package's ``approx_max_k`` candidate scan in sampled beam search. Off the
    # TPU, XLA computes that as an exact top-k, and so does the port: the scan takes the
    # exact ``_top_k`` with the flag set or not (recall 1.0; the TPU aims at 0.95), and
    # every other path ignores the flag, as the JAX package does.
    approx_top_k: bool = False


# ---------------------------------------------------------------------------- logit ops


def _top_k(x: torch.Tensor, k: int):
    """Descending top-k along the last axis; equal values keep index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _apply_repetition_penalty(logits, generated, penalty: float):
    """HF semantics: logits of tokens generated so far are divided by the penalty when
    positive, multiplied when negative. ``generated`` is [B, L] with -1 = unwritten.
    A scatter over [B, L]: no [B, L, V] one-hot."""
    if penalty == 1.0:
        return logits
    seen = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    seen.scatter_reduce_(1, generated.clamp(min=0), (generated >= 0).to(torch.int32),
                         reduce="amax")
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen.bool(), penalized, logits)


def _top_p_on_sorted(sorted_vals, p: float):
    """Nucleus filter on a descending-sorted score set: keep the smallest prefix whose
    probability reaches p (entries equal to the cutoff survive)."""
    probs = torch.softmax(sorted_vals, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < p
    cutoff_idx = keep.sum(-1, keepdim=True) - 1
    cutoff = sorted_vals.gather(-1, cutoff_idx)
    return torch.where(sorted_vals < cutoff, NEG_INF, sorted_vals)


def _top_p_filter(logits, p: float):
    """Nucleus filter on unsorted logits (same cutoff as ``_top_p_on_sorted``)."""
    sorted_logits, _ = _top_k(logits, logits.shape[-1])
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < p
    cutoff = sorted_logits.gather(-1, keep.sum(-1, keepdim=True) - 1)
    return torch.where(logits < cutoff, NEG_INF, logits)


def _gumbel(shape, gen: torch.Generator, device):
    u = torch.rand(shape, generator=gen, device=device).clamp_(min=1e-20, max=1.0 - 1e-7)
    return -torch.log(-torch.log(u))


def _categorical(logits, gen: torch.Generator):
    return torch.argmax(logits + _gumbel(logits.shape, gen, logits.device), dim=-1)


def _sample_token(logits, cfg: GenerationConfig, generated, gen: torch.Generator):
    logits = _apply_repetition_penalty(logits.float(), generated, cfg.repetition_penalty)
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    if cfg.top_k:
        vals, vidx = _top_k(logits, min(cfg.top_k, logits.shape[-1]))
        if cfg.top_p is not None and cfg.top_p < 1.0:
            vals = _top_p_on_sorted(vals, cfg.top_p)
        return vidx.gather(-1, _categorical(vals, gen)[:, None])[:, 0]
    if cfg.top_p is not None and cfg.top_p < 1.0:
        logits = _top_p_filter(logits, cfg.top_p)
    return _categorical(logits, gen)


# ---------------------------------------------------------------------------- prefill


def _prefill(params, llm_cfg, inputs_embeds, attention_mask, total_len: int):
    """Run the prefix through the decoder into cache[0:P] ->
    (cache, last_logits, last_positions, full_mask)."""
    b, p, _ = inputs_embeds.shape
    device = inputs_embeds.device
    cache = dec.init_cache(llm_cfg, b, total_len, dtype=inputs_embeds.dtype, device=device)
    positions = (torch.cumsum(attention_mask, dim=-1) - 1).clamp(min=0)
    full_mask = torch.zeros((b, total_len), dtype=torch.int32, device=device)
    full_mask[:, :p] = attention_mask.to(torch.int32)
    hidden, cache = dec.forward(params, llm_cfg, inputs_embeds=inputs_embeds,
                                attention_mask=full_mask, positions=positions, cache=cache,
                                q_offset=0)
    logits = dec.logits(params, llm_cfg, hidden[:, -1:, :])[:, 0]
    return cache, logits, positions[:, -1], full_mask


def _cache_pad() -> int:
    """Prefix / generated cache padding: 1, since the CUDA decode kernel masks its own
    edges (the TPU kernel needed multiples of 128)."""
    return 1


def _step(params, llm_cfg, token, last_pos, t, pmask, cache, prefix_len, dtype):
    """One decode step: embed ``token`` [R], attend over the split cache at step t."""
    emb = dec.embed(params, llm_cfg, token[:, None]).to(dtype)
    positions = (last_pos + 1 + t)[:, None]
    hidden, cache = dec.forward(params, llm_cfg, inputs_embeds=emb, attention_mask=pmask,
                                positions=positions, cache=cache, q_offset=t,
                                prefix_len=prefix_len)
    return dec.logits(params, llm_cfg, hidden[:, -1:, :])[:, 0], cache


# ---------------------------------------------------------------------------- greedy/sample


def _generate_sample(params, llm_cfg, inputs_embeds, attention_mask, cfg, gen,
                     *, with_stats: bool = False):
    b, p, _ = inputs_embeds.shape
    max_new = cfg.max_new_tokens
    cache, logits, last_pos, _ = _prefill(params, llm_cfg, inputs_embeds, attention_mask, p)
    cache, pmask = dec.split_cache(cache, llm_cfg, b, max_new, prefix_mask=attention_mask,
                                   pad_to=_cache_pad())
    generated = torch.full((b, max_new), -1, dtype=torch.long, device=inputs_embeds.device)
    done = torch.zeros((b,), dtype=torch.bool, device=inputs_embeds.device)
    t = 0
    while t < max_new:
        token = _sample_token(logits, cfg, generated, gen)
        if cfg.eos_token_id is not None:
            token = torch.where(done, cfg.pad_token_id, token)
            done = done | (token == cfg.eos_token_id)
        generated[:, t] = token
        t += 1
        # stop once every row hit EOS (done rows only write pad, so the output is the
        # same) or the budget is spent; the last step's logits would go unused
        if t == max_new or (cfg.eos_token_id is not None and bool(done.all())):
            break
        logits, cache = _step(params, llm_cfg, token, last_pos, t - 1, pmask, cache, p,
                              inputs_embeds.dtype)
    out = torch.where(generated < 0, cfg.pad_token_id, generated)
    return (out, t) if with_stats else out


# ---------------------------------------------------------------------------- beam search


def _reorder_cache(cache, flat_src):
    """Gather the GENERATED caches to follow beam selection; the shared prefix cache
    is per-sample and never reordered."""
    return [{**layer, "kg": layer["kg"].index_select(0, flat_src),
             "vg": layer["vg"].index_select(0, flat_src)} for layer in cache]


def _rows(x, idx):
    """x [B, N, L] gathered along N by idx [B, K] -> [B, K, L]."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _generate_beam(params, llm_cfg, inputs_embeds, attention_mask, cfg, gen,
                   *, with_stats: bool = False):
    """Beam search with HF ``_beam_search`` semantics (see the JAX package's
    ``_generate_beam`` for the full account): log-softmax scores, repetition penalty
    against each beam's own tokens, warpers when sampling, 2*nb candidates, EOS
    candidates ranked within the top nb enter a finished set of nb scored
    ``sum_logprob / len ** length_penalty`` (len counts the EOS), the early-stop
    heuristic of ``early_stopping=False``, and HF ``finalize``."""
    b, p, _ = inputs_embeds.shape
    device = inputs_embeds.device
    nb, max_new, vocab = cfg.num_beams, cfg.max_new_tokens, llm_cfg.vocab_size
    k2 = 2 * nb
    lp = cfg.length_penalty

    cache, logits, last_pos, _ = _prefill(params, llm_cfg, inputs_embeds, attention_mask, p)
    cache, pmask = dec.split_cache(cache, llm_cfg, b * nb, max_new,
                                   prefix_mask=attention_mask, pad_to=_cache_pad())
    logits = logits.repeat_interleave(nb, dim=0)
    last_pos = last_pos.repeat_interleave(nb, dim=0)

    f32 = dict(dtype=torch.float32, device=device)
    # after prefill every beam of a batch is identical: only beam 0 may win step 0
    live_scores = torch.tensor([0.0] + [NEG_INF] * (nb - 1), **f32).repeat(b, 1)
    live_gen = torch.full((b, nb, max_new), -1, dtype=torch.long, device=device)
    fin_scores = torch.full((b, nb), NEG_INF, **f32)
    fin_gen = torch.full((b, nb, max_new), -1, dtype=torch.long, device=device)
    heur_unsat = torch.ones((b,), dtype=torch.bool, device=device)
    batch_rows = torch.arange(b, device=device)[:, None]
    first_nb = (torch.arange(k2, device=device) < nb)[None, :]

    t = 0
    while True:
        scores = torch.log_softmax(logits.float(), dim=-1)
        scores = _apply_repetition_penalty(scores, live_gen.reshape(b * nb, max_new),
                                           cfg.repetition_penalty)
        if cfg.do_sample and cfg.top_k:
            # compact candidates: one top-k per beam, then warp / draw on [B, nb * k];
            # exact under approx_top_k too (GenerationConfig.approx_top_k)
            if cfg.temperature != 1.0:
                scores = scores / cfg.temperature
            k = min(cfg.top_k, vocab)
            vals, vidx = _top_k(scores, k)
            if cfg.top_p is not None and cfg.top_p < 1.0:
                vals = _top_p_on_sorted(vals, cfg.top_p)
            cand = (vals + live_scores.reshape(-1)[:, None]).reshape(b, nb * k)
            _, top_cidx = _top_k(cand + _gumbel(cand.shape, gen, device), k2)
            top_scores = cand.gather(-1, top_cidx)
            order = torch.argsort(-top_scores, dim=-1, stable=True)  # HF sorts by score
            top_scores, top_cidx = top_scores.gather(-1, order), top_cidx.gather(-1, order)
            src = top_cidx // k
            tok = vidx[batch_rows * nb + src, top_cidx % k]
        else:
            if cfg.do_sample:
                if cfg.temperature != 1.0:
                    scores = scores / cfg.temperature
                if cfg.top_p is not None and cfg.top_p < 1.0:
                    scores = _top_p_filter(scores, cfg.top_p)
            cand = (scores + live_scores.reshape(-1)[:, None]).reshape(b, nb * vocab)
            if cfg.do_sample:
                _, top_idx = _top_k(cand + _gumbel(cand.shape, gen, device), k2)
                top_scores = cand.gather(-1, top_idx)
                order = torch.argsort(-top_scores, dim=-1, stable=True)
                top_scores, top_idx = top_scores.gather(-1, order), top_idx.gather(-1, order)
            else:
                top_scores, top_idx = _top_k(cand, k2)
            src = top_idx // vocab
            tok = top_idx % vocab
        if cfg.eos_token_id is not None:
            is_eos = tok == cfg.eos_token_id
        else:
            is_eos = torch.zeros_like(tok, dtype=torch.bool)

        # finished set: EOS candidates within the top nb, scored at t + 1 tokens; a
        # batch whose heuristic is satisfied has its finished set frozen
        gen_len_pen = torch.tensor(float(t + 1), **f32) ** lp
        ins_mask = is_eos & first_nb & heur_unsat[:, None]
        ins_scores = torch.where(ins_mask, top_scores / gen_len_pen, NEG_INF)
        cand_gen = _rows(live_gen, src)
        cand_gen[:, :, t] = tok
        fin_scores, fidx = _top_k(torch.cat([fin_scores, ins_scores], dim=1), nb)
        fin_gen = _rows(torch.cat([fin_gen, cand_gen], dim=1), fidx)

        # live continuation: best nb non-EOS candidates
        live_scores, lidx = _top_k(torch.where(is_eos, NEG_INF, top_scores), nb)
        live_src, live_tok = src.gather(-1, lidx), tok.gather(-1, lidx)
        live_gen = _rows(live_gen, live_src)
        live_gen[:, :, t] = live_tok

        # early-stop heuristic (HF `_check_early_stop_heuristic`): the best live beam at
        # the current length must still beat the worst finished hypothesis
        best_possible = live_scores[:, 0] / gen_len_pen
        heur_unsat = heur_unsat & (best_possible > fin_scores.min(dim=-1).values)
        t += 1
        if t == max_new or not bool(heur_unsat.any()):
            break

        cache = _reorder_cache(cache, (batch_rows * nb + live_src).reshape(-1))
        logits, cache = _step(params, llm_cfg, live_tok.reshape(-1), last_pos, t - 1, pmask,
                              cache, p, inputs_embeds.dtype)

    # finalize: live beams of batches that ran to max_new compete, penalized at max_new
    max_pen = torch.tensor(float(max_new), **f32) ** lp
    live_final = torch.where(heur_unsat[:, None], live_scores / max_pen, NEG_INF)
    all_scores = torch.cat([fin_scores, live_final], dim=1)
    all_gen = torch.cat([fin_gen, live_gen], dim=1)
    out = all_gen[torch.arange(b, device=device), torch.argmax(all_scores, dim=-1)]
    out = torch.where(out < 0, cfg.pad_token_id, out)
    return (out, t) if with_stats else out


# ---------------------------------------------------------------------------- public API


@torch.no_grad()
def generate(params, llm_cfg, inputs_embeds, attention_mask, cfg: GenerationConfig,
             generator: Optional[torch.Generator] = None, *, with_stats: bool = False):
    """Generated token ids [B, max_new_tokens] (pad after EOS).

    ``params``: decoder params (the ``llm`` part of a VLM tree); ``inputs_embeds``
    [B, P, D] embedding prefix; ``attention_mask`` [B, P], left-padded (the last slot
    is a real token). ``with_stats`` also returns the number of steps taken."""
    if generator is None:
        generator = torch.Generator(device=inputs_embeds.device).manual_seed(0)
    fn = _generate_beam if cfg.num_beams > 1 else _generate_sample
    return fn(params, llm_cfg, inputs_embeds, attention_mask, cfg, generator,
              with_stats=with_stats)
