"""GQA + RoPE causal decoder (Gemma3, Qwen3, Llama and Mistral families): the training
forward and the inference paths.

Counterpart of ``projectiontrainer_tpu/models/decoder.py``: ``embed``, the full-sequence
forward (differentiable; per-layer remat through ``torch.utils.checkpoint``), the
prefill through a monolithic cache, the split prefix / generated cache of the decode
steps (``ops/decode_attention.py``), ``logits`` and ``lm_head_table``. Parameters are a
nested dict shaped like the JAX tree; linear weights are ``[out, in]``, and ``lm_head``
is always present (the embedding table itself when the head is tied). Serving calls
the forward under ``torch.no_grad`` (``generate/decode.py``).

A projection goes through ``_proj``, the hook of the JAX package's ``decoder.py:264``:
a quantized leaf (``ops/quant.py``) is dequantized into its product, and a layer with
LoRA adapters (``train/lora.py``) adds their delta, with a dropout mask seeded by
(``lora_seed``, layer, target) so that a remat recompute draws the forward's bits.
Not ported yet: ``remat='dots'``.

Caches are updated IN PLACE (the JAX package returns new arrays): the prefill writes
its K/V into the monolithic cache and each decode step writes slot ``t`` of the
generated cache. ``forward`` still returns the cache list, so callers read the same
way as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from projectiontrainer_tpu_torch.ops import layers as L
from projectiontrainer_tpu_torch.ops.attention import dot_product_attention
from projectiontrainer_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference,
)
from projectiontrainer_tpu_torch.ops.flash_attention import flash_attention
from projectiontrainer_tpu_torch.ops import quant
from projectiontrainer_tpu_torch.train import lora as lora_mod


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rms_norm_eps: float = 1e-6
    act: str = "gelu_tanh"
    rope_theta: float = 1_000_000.0
    rope_local_theta: Optional[float] = None     # used by sliding layers (Gemma3)
    rope_scaling_factor: float = 1.0             # linear rope scaling on full layers
    rope_llama3: Optional[tuple] = None          # (factor, low, high, original max)
    layer_types: tuple = ()                      # per layer: 'full' | 'sliding'
    sliding_window: Optional[int] = None
    query_pre_attn_scalar: Optional[float] = None
    qk_norm: bool = True
    rmsnorm_zero_centered: bool = True
    sandwich_norms: bool = True
    embed_scale: bool = True
    tie_embeddings: bool = True
    attention_bias: bool = False
    attn_impl: str = "kernel"                    # 'kernel' | 'plain'

    def __post_init__(self):
        if not self.layer_types:
            object.__setattr__(self, "layer_types", ("full",) * self.num_layers)
        if len(self.layer_types) != self.num_layers:
            raise ValueError("layer_types must name every layer")

    @property
    def attn_scale(self) -> float:
        base = (self.query_pre_attn_scalar if self.query_pre_attn_scalar is not None
                else self.head_dim)
        return float(base) ** -0.5


def gemma3_config(
    *, vocab_size=262_144, hidden_size=1152, intermediate_size=6912, num_layers=26,
    num_heads=4, num_kv_heads=1, head_dim=256, sliding_window=512,
    sliding_pattern=6, rope_theta=1_000_000.0, rope_local_theta=10_000.0,
    rope_scaling_factor=1.0, query_pre_attn_scalar=256, **kw,
) -> DecoderConfig:
    """Gemma3 defaults (1B-shaped); one full layer per ``sliding_pattern`` layers."""
    layer_types = tuple(
        "full" if (i + 1) % sliding_pattern == 0 else "sliding" for i in range(num_layers)
    )
    return DecoderConfig(
        vocab_size=vocab_size, hidden_size=hidden_size, intermediate_size=intermediate_size,
        num_layers=num_layers, num_heads=num_heads, num_kv_heads=num_kv_heads,
        head_dim=head_dim, act="gelu_tanh", rope_theta=rope_theta,
        rope_local_theta=rope_local_theta, rope_scaling_factor=rope_scaling_factor,
        layer_types=layer_types, sliding_window=sliding_window,
        query_pre_attn_scalar=query_pre_attn_scalar, qk_norm=True,
        rmsnorm_zero_centered=True, sandwich_norms=True, embed_scale=True, **kw,
    )


def qwen3_config(
    *, vocab_size=151_936, hidden_size=4096, intermediate_size=12_288, num_layers=36,
    num_heads=32, num_kv_heads=8, head_dim=128, rope_theta=1_000_000.0,
    tie_embeddings=False, **kw,
) -> DecoderConfig:
    """Qwen3 defaults (8B-shaped): pre-LN plain RMSNorm, SiLU, q/k norms, one rope
    theta, no embedding scale, an untied head."""
    return DecoderConfig(
        vocab_size=vocab_size, hidden_size=hidden_size, intermediate_size=intermediate_size,
        num_layers=num_layers, num_heads=num_heads, num_kv_heads=num_kv_heads,
        head_dim=head_dim, act="silu", rope_theta=rope_theta,
        layer_types=("full",) * num_layers, sliding_window=None,
        query_pre_attn_scalar=None, qk_norm=True, rmsnorm_zero_centered=False,
        sandwich_norms=False, embed_scale=False, tie_embeddings=tie_embeddings, **kw,
    )


def _llama_rope_scaling(cfg: dict):
    """A Llama/Mistral ``rope_scaling`` -> (linear factor, llama3 tuple or None); a type
    other than default, linear or llama3 raises."""
    rs = cfg.get("rope_scaling")
    if not rs:
        return 1.0, None
    rtype = rs.get("rope_type", rs.get("type", "default"))
    if rtype == "linear":
        return float(rs.get("factor", 1.0)), None
    if rtype == "llama3":
        return 1.0, (float(rs["factor"]), float(rs["low_freq_factor"]),
                     float(rs["high_freq_factor"]),
                     float(rs["original_max_position_embeddings"]))
    if rtype != "default":
        raise ValueError(f"unsupported rope_scaling type: {rtype!r}")
    return 1.0, None


def from_hf_config(cfg: dict) -> DecoderConfig:
    """DecoderConfig from a Gemma3 ``config.json`` dict (text-only, or the multimodal
    wrapper's ``text_config``), a Qwen3, a Llama or a Mistral one.

    Llama and Mistral: pre-LN, SiLU, plain RMSNorm, no q/k norms, no embedding scale.
    Mistral (v0.1) slides every layer with the one global theta (``rope_local_theta``
    stays None, so no sliding layer takes another theta); Llama-3 checkpoints carry
    frequency-dependent rope scaling (``rope_llama3``)."""
    if cfg.get("model_type") == "gemma3":
        cfg = cfg["text_config"]
    if cfg.get("model_type") in ("llama", "mistral"):
        n = cfg["num_hidden_layers"]
        factor, llama3 = _llama_rope_scaling(cfg)
        sliding = cfg.get("sliding_window")
        return DecoderConfig(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"], num_layers=n,
            num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
            head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6), act="silu",
            rope_theta=cfg.get("rope_theta", 10_000.0), rope_scaling_factor=factor,
            rope_llama3=llama3, layer_types=("sliding" if sliding else "full",) * n,
            sliding_window=sliding, query_pre_attn_scalar=None, qk_norm=False,
            rmsnorm_zero_centered=False, sandwich_norms=False, embed_scale=False,
            tie_embeddings=cfg.get("tie_word_embeddings", False),
            attention_bias=cfg.get("attention_bias", False),
        )
    if cfg.get("model_type") == "qwen3":
        n = cfg["num_hidden_layers"]
        return DecoderConfig(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"], num_layers=n,
            num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
            head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6), act="silu",
            rope_theta=cfg.get("rope_theta", 1_000_000.0), layer_types=("full",) * n,
            sliding_window=None, query_pre_attn_scalar=None, qk_norm=True,
            rmsnorm_zero_centered=False, sandwich_norms=False, embed_scale=False,
            tie_embeddings=cfg.get("tie_word_embeddings", False),
            attention_bias=cfg.get("attention_bias", False),
        )
    if cfg.get("model_type") != "gemma3_text":
        raise ValueError(f"unsupported model_type {cfg.get('model_type')!r} "
                         "(the port reads Gemma3, Qwen3, Llama and Mistral decoders)")
    n = cfg["num_hidden_layers"]
    if cfg.get("layer_types"):
        layer_types = tuple("sliding" if t == "sliding_attention" else "full"
                            for t in cfg["layer_types"])
    else:
        pattern = cfg.get("sliding_window_pattern", 6)
        layer_types = tuple("full" if (i + 1) % pattern == 0 else "sliding"
                            for i in range(n))
    factor = float((cfg.get("rope_scaling") or {}).get("factor", 1.0))
    return DecoderConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"], num_layers=n,
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim", 256), rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        act="gelu_tanh", rope_theta=cfg.get("rope_theta", 1_000_000.0),
        rope_local_theta=cfg.get("rope_local_base_freq", 10_000.0),
        rope_scaling_factor=factor, layer_types=layer_types,
        sliding_window=cfg.get("sliding_window", 4096),
        query_pre_attn_scalar=cfg.get("query_pre_attn_scalar", 256),
        tie_embeddings=cfg.get("tie_word_embeddings", True),
        attention_bias=cfg.get("attention_bias", False),
    )


# ---------------------------------------------------------------------------- init


def init(gen: torch.Generator, cfg: DecoderConfig, dtype=torch.float32, device=None):
    """Random decoder parameters, distributed like the JAX package's ``init``."""
    h = cfg.hidden_size
    params = {
        "embed_tokens": L.init_embedding(gen, cfg.vocab_size, h, dtype=dtype, device=device),
        "final_norm": L.init_rmsnorm(h, dtype=dtype, device=device,
                                     zero_centered=cfg.rmsnorm_zero_centered),
        "layers": [],
    }
    params["lm_head"] = ({"weight": params["embed_tokens"]["embedding"]} if cfg.tie_embeddings
                         else L.init_linear(gen, h, cfg.vocab_size, bias=False, dtype=dtype,
                                            device=device))
    for _ in range(cfg.num_layers):
        params["layers"].append(init_layer(gen, cfg, dtype, device))
    return params


def init_layer(gen: torch.Generator, cfg: DecoderConfig, dtype=torch.float32, device=None):
    """One layer's random parameters (``init`` draws them layer after layer from
    ``gen``, so a caller may build a decoder one layer at a time, quantizing each as it
    comes, and draw the same weights)."""
    h, q_dim = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    lin = lambda i, o, bias=cfg.attention_bias: L.init_linear(gen, i, o, bias=bias,
                                                             dtype=dtype, device=device)
    norm = lambda d: L.init_rmsnorm(d, dtype=dtype, device=device,
                                    zero_centered=cfg.rmsnorm_zero_centered)
    layer = {
        "input_norm": norm(h),
        "attn": {"q_proj": lin(h, q_dim), "k_proj": lin(h, kv_dim),
                 "v_proj": lin(h, kv_dim), "o_proj": lin(q_dim, h)},
        "mlp": {"gate_proj": lin(h, cfg.intermediate_size, False),
                "up_proj": lin(h, cfg.intermediate_size, False),
                "down_proj": lin(cfg.intermediate_size, h, False)},
        "post_attn_norm": norm(h),
    }
    if cfg.qk_norm:
        layer["attn"]["q_norm"] = norm(cfg.head_dim)
        layer["attn"]["k_norm"] = norm(cfg.head_dim)
    if cfg.sandwich_norms:
        layer["pre_ffw_norm"] = norm(h)
        layer["post_ffw_norm"] = norm(h)
    return layer


# ---------------------------------------------------------------------------- forward


def embed(params, cfg: DecoderConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding, with Gemma3's ``sqrt(hidden)`` scale rounded to the table's type."""
    x = L.embedding_lookup(params["embed_tokens"], input_ids)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    return x


def _rope_for_layer(cfg: DecoderConfig, layer_type: str, positions):
    if layer_type == "sliding" and cfg.rope_local_theta is not None:
        return L.rope_frequencies(cfg.head_dim, positions, theta=cfg.rope_local_theta)
    return L.rope_frequencies(cfg.head_dim, positions, theta=cfg.rope_theta,
                              scaling_factor=cfg.rope_scaling_factor,
                              llama3_scaling=cfg.rope_llama3)


def _norm(p, x, cfg: DecoderConfig):
    return L.rmsnorm(p, x, eps=cfg.rms_norm_eps, zero_centered=cfg.rmsnorm_zero_centered)


def _proj(lp, name, x, lora):
    """One projection: a quantized leaf through ``quant.quantized_matmul``, a dense one
    through ``L.linear``; plus the layer's LoRA delta when ``lora`` = (its adapters,
    LoraConfig, {target: dropout seed} or None) holds one for ``name``."""
    p = lp[name]
    y = quant.quantized_matmul(p, x) if quant.is_quantized(p) else L.linear(p, x)
    if lora is None:
        return y
    layer, cfg, seeds = lora
    return lora_mod.apply_delta(layer, name, cfg, x, y,
                                seed=None if seeds is None else seeds[name])


def _attention_block(lp, cfg: DecoderConfig, x, sin, cos, *, layer_type, kv_mask,
                     q_offset, cache=None, prefix_len=None, lora=None):
    b, t, _ = x.shape
    q = _proj(lp, "q_proj", x, lora).reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = _proj(lp, "k_proj", x, lora).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = _proj(lp, "v_proj", x, lora).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = _norm(lp["q_norm"], q, cfg)
        k = _norm(lp["k_norm"], k, cfg)
    q = L.apply_rope(q, sin, cos)
    k = L.apply_rope(k, sin, cos)
    window = cfg.sliding_window if layer_type == "sliding" else None

    if cache is not None and "kp" in cache:
        # split cache: this step's K/V goes to generated slot q_offset (the 0-based
        # decode step); kv_mask is the [B, P] prefix mask, prefix_len the real length
        kg, vg = cache["kg"], cache["vg"]
        kg[:, :, q_offset] = k[:, 0].to(kg.dtype)
        vg[:, :, q_offset] = v[:, 0].to(vg.dtype)
        attend = decode_attention if cfg.attn_impl == "kernel" else decode_attention_reference
        out = attend(q[:, 0].to(cache["kp"].dtype), cache["kp"], cache["vp"], kg, vg,
                     prefix_mask=kv_mask, t=q_offset, prefix_len=prefix_len,
                     scale=cfg.attn_scale, window=window).to(q.dtype)
        return _proj(lp, "o_proj", out.reshape(b, t, -1), lora), cache

    if cache is not None:  # monolithic cache: write this call's K/V at q_offset
        cache["k"][:, q_offset:q_offset + t] = k.to(cache["k"].dtype)
        cache["v"][:, q_offset:q_offset + t] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]

    k, v = k.to(q.dtype), v.to(q.dtype)
    if cfg.attn_impl == "kernel" and k.shape[1] == t and q_offset == 0:
        out = flash_attention(q, k, v, scale=cfg.attn_scale, causal=True, window=window,
                              kv_mask=kv_mask)[0]
    else:
        out = dot_product_attention(q, k, v, scale=cfg.attn_scale, causal=True,
                                    window=window, kv_mask=kv_mask, q_offset=q_offset)
    return _proj(lp, "o_proj", out.reshape(b, t, -1), lora), cache


def _mlp_block(lp, cfg: DecoderConfig, x, lora=None):
    gate = L.ACTIVATIONS[cfg.act](_proj(lp, "gate_proj", x, lora))
    return _proj(lp, "down_proj", gate * _proj(lp, "up_proj", x, lora), lora)


def _layer(lp, cfg: DecoderConfig, x, sin, cos, *, layer_type, kv_mask, q_offset,
           cache, prefix_len, lora=None):
    h, _ = _attention_block(
        lp["attn"], cfg, _norm(lp["input_norm"], x, cfg), sin, cos,
        layer_type=layer_type, kv_mask=kv_mask, q_offset=q_offset, cache=cache,
        prefix_len=prefix_len, lora=lora,
    )
    if cfg.sandwich_norms:
        x = x + _norm(lp["post_attn_norm"], h, cfg)
        h = _mlp_block(lp["mlp"], cfg, _norm(lp["pre_ffw_norm"], x, cfg), lora)
        return x + _norm(lp["post_ffw_norm"], h, cfg)
    x = x + h
    return x + _mlp_block(lp["mlp"], cfg, _norm(lp["post_attn_norm"], x, cfg), lora)


def forward(params, cfg: DecoderConfig, *, input_ids=None, inputs_embeds=None,
            attention_mask=None, positions=None, cache=None, q_offset: int = 0,
            prefix_len: Optional[int] = None, remat: Union[bool, int, str] = False,
            lora: Optional[dict] = None, lora_cfg=None, lora_seed: Optional[int] = None):
    """Run the decoder -> (hidden_states, cache).

    Without a cache: a full-sequence forward, differentiable with respect to
    ``inputs_embeds`` and any parameter that requires grad. ``remat=True``
    recomputes every layer's activations in the backward (``torch.utils.checkpoint``,
    non-reentrant), an int N only the first N layers', as ``decoder.py:431-447`` of
    the JAX package does; ``'dots'`` (save only matmul outputs) is not ported and
    raises. With a monolithic cache (``init_cache``): ``q_offset`` tokens are already
    cached and ``attention_mask`` covers the whole cache. With a split cache
    (``split_cache``): ``q_offset`` is the 0-based decode step, ``attention_mask`` the
    [B, P] prefix mask, ``prefix_len`` the real prefix length, and ``positions`` must
    be given. Cache paths do not remat.

    ``lora`` (``{'layers': [...]}``, ``train/lora.py``) with ``lora_cfg`` adds the
    adapters' deltas to every adapted projection; ``lora_seed`` (an int, the train
    step's) turns on their dropout when ``lora_cfg.dropout > 0``: layer i, target t
    draws its mask from ``lora.dropout_seed(lora_seed, i, t)``. None is no dropout."""
    if remat == "dots":
        raise NotImplementedError("remat='dots' is not ported; use True, False or an int")
    x = embed(params, cfg, input_ids) if inputs_embeds is None else inputs_embeds
    b, t, _ = x.shape
    if positions is None:
        positions = (torch.arange(t, device=x.device)[None, :] + q_offset).expand(b, t)
    kv_mask = None if attention_mask is None else attention_mask.bool()
    rope = {lt: _rope_for_layer(cfg, lt, positions) for lt in set(cfg.layer_types)}

    dropout = lora is not None and lora_seed is not None and lora_cfg.dropout > 0.0
    for i, lp in enumerate(params["layers"]):
        layer_type = cfg.layer_types[i]
        sin, cos = rope[layer_type]
        layer_lora = None
        if lora is not None:
            seeds = ({t: lora_mod.dropout_seed(lora_seed, i, t) for t in lora_mod.TARGETS}
                     if dropout else None)
            layer_lora = (lora["layers"][i], lora_cfg, seeds)
        fn = functools.partial(_layer, lp, cfg, layer_type=layer_type, kv_mask=kv_mask,
                               q_offset=q_offset, cache=None if cache is None else cache[i],
                               prefix_len=prefix_len, lora=layer_lora)
        # True == 1 in Python: test for bool before the int (partial remat) branch
        layer_remat = remat if isinstance(remat, bool) else i < int(remat)
        if layer_remat and cache is None and torch.is_grad_enabled():
            x = checkpoint(fn, x, sin, cos, use_reentrant=False)
        else:
            x = fn(x, sin, cos)
    return _norm(params["final_norm"], x, cfg), cache


def lm_head_table(params, cfg: DecoderConfig) -> torch.Tensor:
    """The [V, D] output-projection table (the tied embedding or the separate head):
    what the chunked and fused CLM losses read instead of full logits."""
    del cfg  # the port always carries ``lm_head`` (the embedding itself when tied)
    return params["lm_head"]["weight"]


def logits(params, cfg: DecoderConfig, hidden: torch.Tensor) -> torch.Tensor:
    """LM head -> fp32 logits. The product runs in the hidden states' type; with bf16
    weights the logits are rounded to bf16 before the fp32 cast (JAX accumulates
    straight into fp32)."""
    w = params["lm_head"]["weight"]
    return F.linear(hidden, w.to(hidden.dtype)).float()


def init_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def split_cache(prefix_cache, cfg: DecoderConfig, rows: int, gen_len: int,
                prefix_mask=None, pad_to: int = 1):
    """Prefilled monolithic cache [B, P] -> the split decode structure: head-major
    prefix caches [B, Hkv, P, D] and zeroed generated caches [rows, Hkv, G, D]
    (``rows`` = B * beams, ``gen_len`` = max_new_tokens). ``pad_to`` pads P and G up,
    with the padded prefix slots masked in the returned prefix mask.
    Returns (cache_list, prefix_mask)."""
    def rup(n):
        return (n + pad_to - 1) // pad_to * pad_to

    b, p = prefix_cache[0]["k"].shape[:2]
    p_pad, g_pad = rup(p), rup(gen_len)
    out = []
    for layer in prefix_cache:
        kp = layer["k"].transpose(1, 2)
        vp = layer["v"].transpose(1, 2)
        kp = F.pad(kp, (0, 0, 0, p_pad - p)).contiguous()
        vp = F.pad(vp, (0, 0, 0, p_pad - p)).contiguous()
        shape = (rows, cfg.num_kv_heads, g_pad, cfg.head_dim)
        out.append({"kp": kp, "vp": vp,
                    "kg": torch.zeros(shape, dtype=kp.dtype, device=kp.device),
                    "vg": torch.zeros(shape, dtype=kp.dtype, device=kp.device)})
    if prefix_mask is not None and p_pad != p:
        prefix_mask = F.pad(prefix_mask.to(torch.int32), (0, p_pad - p))
    return out, prefix_mask


def params_from_hf_state_dict(cfg: DecoderConfig, sd: dict, *, device=None,
                              dtype=None) -> dict:
    """An HF Gemma3, Qwen3, Llama or Mistral (``*ForCausalLM`` / text model) state dict
    of tensors or numpy arrays -> decoder params (torch layout, so linear weights pass
    unchanged). q/k norm keys are read only for a config with ``qk_norm``; a tied head
    reads no ``lm_head.weight``. An untied head missing from the state dict (a bare text
    model) starts as a copy of the embedding table, as in the JAX package."""
    def get(name):
        for key in ("model." + name, name):
            if key in sd:
                return torch.as_tensor(sd[key]).to(device=device, dtype=dtype)
        raise KeyError(name)

    def lin(name):
        p = {"weight": get(name + ".weight")}
        if cfg.attention_bias:
            p["bias"] = get(name + ".bias")
        return p

    table = get("embed_tokens.weight")
    params = {"embed_tokens": {"embedding": table}, "final_norm": {"scale": get("norm.weight")},
              "layers": []}
    if cfg.tie_embeddings:
        params["lm_head"] = {"weight": table}
    elif "lm_head.weight" in sd:
        params["lm_head"] = {"weight": torch.as_tensor(sd["lm_head.weight"]).to(
            device=device, dtype=dtype)}
    else:
        params["lm_head"] = {"weight": table.clone()}
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        layer = {
            "input_norm": {"scale": get(pre + "input_layernorm.weight")},
            "attn": {n: lin(pre + "self_attn." + n)
                     for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {n: {"weight": get(pre + f"mlp.{n}.weight")}
                    for n in ("gate_proj", "up_proj", "down_proj")},
            "post_attn_norm": {"scale": get(pre + "post_attention_layernorm.weight")},
        }
        if cfg.qk_norm:
            layer["attn"]["q_norm"] = {"scale": get(pre + "self_attn.q_norm.weight")}
            layer["attn"]["k_norm"] = {"scale": get(pre + "self_attn.k_norm.weight")}
        if cfg.sandwich_norms:
            layer["pre_ffw_norm"] = {"scale": get(pre + "pre_feedforward_layernorm.weight")}
            layer["post_ffw_norm"] = {"scale": get(pre + "post_feedforward_layernorm.weight")}
        params["layers"].append(layer)
    return params
