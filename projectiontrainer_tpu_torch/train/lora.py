"""LoRA adapters over the decoder's projections, held apart from the base weights.

Counterpart of ``projectiontrainer_tpu/train/lora.py`` (the reference's PEFT QLoRA:
``LoraConfig(r=16, alpha=32, dropout=0.05)`` on q/k/v/o/gate/up/down,
Stage2/train_vqa_stage2.py:169-244). The adapters live in ``params['lora']`` =
``{'layers': [{target: {'a', 'b'}}]}``, so the trainable mask is that subtree and the
base may be quantized (``ops/quant.py``). ``a`` is ``[r, in]`` and ``b`` is
``[out, r]``, the torch layout of PEFT's ``lora_A.weight`` / ``lora_B.weight`` (the
JAX package stores the transposes, ``[in, r]`` / ``[r, out]``;
``checkpoint/from_jax.py`` carries them across).

``apply_delta`` adds ``scaling * (dropout(x) A^T) B^T`` to a projection's output as two
thin products, with JAX's rounding: each product accumulates in fp32 (``F.linear``)
and is cast to x's type, then scaled. LoRA dropout is PEFT's inverted dropout on the
branch's input, drawn as JAX does it, a 16-bit threshold test: ``thresh =
min(round((1 - p) * 65536), 65535)``, keep ``bits < thresh``, the scale times
``65536 / thresh``. The bits come from a ``torch.Generator`` seeded by
(``seed``, layer, target) (``dropout_seed``), not from JAX's ``rbg`` stream: the masks
differ from JAX's draw for draw, their distribution does not. A fresh generator per
mask makes a remat recompute draw the same bits as the forward it repeats.

Tensor parallelism (``parallel/sharding.py``): the adapters follow the base's sharding.
A column target's ``b`` holds the rank's output rows and its ``a`` is replicated; a row
target's ``a`` holds the rank's input columns and its ``b`` is replicated, so a row
target's delta is partial, like the base product it joins before the all-reduce. A row
target's dropout mask is the rank's slice of the full mask along the input, drawn whole
and sliced; a column target's mask is the full one on every model rank (their dropout
seeds come from the data rank). ``merge_into_decoder`` merges shard by shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from projectiontrainer_tpu_torch.ops import quant
from projectiontrainer_tpu_torch.parallel import distributed
from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp

TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
ATTN_TARGETS = frozenset({"q_proj", "k_proj", "v_proj", "o_proj"})
# stable per-target indices for the dropout streams (PEFT has one dropout module per
# adapted projection; each draws its own mask)
TARGET_INDEX = {t: i for i, t in enumerate(TARGETS)}
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 16
    alpha: int = 32
    dropout: float = 0.05
    targets: tuple = TARGETS

    def __post_init__(self):
        if not 0.0 <= self.dropout < 1.0:
            # 1.0 would zero the branch and divide the rescale by a zero threshold
            raise ValueError(f"lora dropout must be in [0, 1), got {self.dropout}")

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def target_dims(dec_cfg) -> dict:
    """target -> (in, out) of the decoder's projection."""
    h = dec_cfg.hidden_size
    q_dim = dec_cfg.num_heads * dec_cfg.head_dim
    kv_dim = dec_cfg.num_kv_heads * dec_cfg.head_dim
    return {"q_proj": (h, q_dim), "k_proj": (h, kv_dim), "v_proj": (h, kv_dim),
            "o_proj": (q_dim, h), "gate_proj": (h, dec_cfg.intermediate_size),
            "up_proj": (h, dec_cfg.intermediate_size),
            "down_proj": (dec_cfg.intermediate_size, h)}


def init(gen: torch.Generator, dec_cfg, cfg: LoraConfig, dtype=torch.float32, device=None):
    """Per layer and target: A ~ N(0, 1) / r, B = 0 (PEFT's init semantics; the
    numbers differ from the JAX package's draw)."""
    dims = target_dims(dec_cfg)
    layers = []
    for _ in range(dec_cfg.num_layers):
        layer = {}
        for t in cfg.targets:
            din, dout = dims[t]
            a = torch.randn((cfg.r, din), generator=gen, device=device) * (1.0 / cfg.r)
            layer[t] = {"a": a.to(dtype), "b": torch.zeros((dout, cfg.r), dtype=dtype,
                                                           device=device)}
        layers.append(layer)
    return {"layers": layers}


def _mix(z: int) -> int:
    """splitmix64's finaliser: well-spread 64-bit seeds from nearby integers."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def dropout_seed(seed: int, layer: int, target: str) -> int:
    """The seed of one mask: fixed by (the step's seed folded with the data-parallel
    rank, layer, target), so the mask of a layer recomputed under remat is the
    forward's and each rank's rows draw masks of their own (the JAX package draws one
    mask over the global batch)."""
    return _mix(_mix(_mix(distributed.rank_seed(int(seed))) ^ layer) ^ TARGET_INDEX[target])


def dropout_threshold(p: float) -> int:
    """The 16-bit keep threshold of JAX's mask: keep where bits < thresh."""
    return min(int(round((1.0 - p) * 65536.0)), 65535)


def dropout_mask(shape, seed: int, p: float, device) -> torch.Tensor:
    """bool keep-mask of ``shape``: uniform 16-bit draws below ``dropout_threshold(p)``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 65536, shape, generator=gen, device=device, dtype=torch.int32)
    return bits < dropout_threshold(p)


def apply_delta(lora_layer: Optional[dict], target: str, cfg: LoraConfig, x: torch.Tensor,
                y: torch.Tensor, seed: Optional[int] = None,
                row_parallel: bool = False) -> torch.Tensor:
    """y + scaling * (dropout(x) A^T) B^T for one projection; y itself when the target
    is not adapted. ``seed`` (a mask seed, ``dropout_seed``) turns on the dropout when
    ``cfg.dropout > 0``; None (evaluation) is the identity. ``row_parallel``: the
    projection is row-parallel in a unit the model axis splits, so x holds the rank's
    input columns, and the mask is the rank's slice of the whole input's mask."""
    if lora_layer is None or target not in lora_layer:
        return y
    p = lora_layer[target]
    a, b = p["a"].to(x.dtype), p["b"].to(x.dtype)
    scale = cfg.scaling
    if seed is not None and cfg.dropout > 0.0:
        if row_parallel and tp.size() > 1:
            n = x.shape[-1]
            keep = dropout_mask(x.shape[:-1] + (n * tp.size(),), seed, cfg.dropout,
                                x.device).narrow(-1, tp.rank() * n, n)
        else:
            keep = dropout_mask(x.shape, seed, cfg.dropout, x.device)
        x = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
        scale = scale * (65536.0 / dropout_threshold(cfg.dropout))
    delta = F.linear(F.linear(x, a), b)
    return y + scale * delta.to(y.dtype)


def merge_into_decoder(dec_params: dict, lora_params: dict, cfg: LoraConfig) -> dict:
    """A plain decoder tree with W + scaling * B A in place of each adapted projection
    (export, generation). A quantized base is dequantized to bf16 first; the sum is
    taken in fp32 and stored in the weight's type. Tensors not adapted are shared with
    ``dec_params``. On a model rank's shards it merges the rank's shard: B's rows (a
    column target) or A's columns (a row target) are the rank's, the other factor whole."""
    merged = {k: v for k, v in dec_params.items() if k != "layers"}
    merged["layers"] = [dict(layer, attn=dict(layer["attn"]), mlp=dict(layer["mlp"]))
                        for layer in dec_params["layers"]]
    with torch.no_grad():
        for i, layer in enumerate(lora_params["layers"]):
            for t, p in layer.items():
                dst = merged["layers"][i]["attn" if t in ATTN_TARGETS else "mlp"]
                tp = dst[t]
                if quant.is_quantized(tp):
                    tp = {"weight": quant.dequantize_any(tp, dtype=torch.bfloat16),
                          **({"bias": tp["bias"]} if "bias" in tp else {})}
                w = tp["weight"]
                delta = (p["b"].float() @ p["a"].float()).to(w.device) * cfg.scaling
                dst[t] = dict(tp, weight=(w.float() + delta).to(w.dtype))
    return merged
