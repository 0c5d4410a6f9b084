"""Weight-only quantization of the QLoRA base: int8, exact NF4 and the NF4 int8 mirror.

Counterpart of ``projectiontrainer_tpu/ops/quant.py``, with the same codes and scales
bit for bit (``tests/test_torch_quant.py``):

- **int8**: symmetric per output channel; ``scales = max(absmax / 127, 1e-12)``.
- **nf4**: blocks of 64 values along the input dimension (``min(64, in)`` for tiny
  models), absmax-scaled, each value snapped to the nearest of bitsandbytes' 16
  normal-quantile codes through ``searchsorted`` over the same fp32 midpoints; two
  codes to a byte, the HIGH nibble holding the even input index.
- **nf4-mirror**: the NF4 codes re-encoded once as ``round(127 * CODE)`` int8 with
  ``block_scales / 127``: every value within 1/254 of its block scale of exact NF4,
  and dequantization a cast and a multiply instead of a 16-entry lookup.

Layout. The port's linear weights are ``[out, in]``, so its quantized leaves keep that
orientation; the JAX package's are the transposes (``checkpoint/from_jax.py`` carries
them across, the bytes unchanged):

============  ======================================  ==================================
method        the port                                the JAX package
============  ======================================  ==================================
int8          ``qvalues`` int8 [out, in],             ``qvalues`` [in, out],
              ``scales`` f32 [out]                    ``scales`` [out]
nf4           ``packed_nf4`` uint8 [out, in/2],       ``packed_nf4`` [in/2, out],
              ``block_scales`` f32 [out, in/64]       ``block_scales`` [in/64, out]
nf4-mirror    ``qvalues_block`` int8 [out, in],       ``qvalues_block`` [in, out],
              ``block_scales`` f32 [out, in/64]       ``block_scales`` [in/64, out]
============  ======================================  ==================================

``quantized_matmul`` dequantizes to the activations' type (inside the profiler span
``dequant``) and hands the product to ``F.linear``: the JAX package leaves this
product to XLA outside any Pallas kernel, so the library's product is the port's too
(a fused dequant-GEMM is ROADMAP item B7). ``quantize_decoder`` quantizes the seven
projections of every layer and leaves embeddings, norms and ``lm_head`` as they are.

Under tensor parallelism a layer is quantized whole and its leaves then sliced to a
model rank's shard (``train/setup.py``, ``parallel/sharding.py``): int8's scale of an
output channel spans the whole input, so quantizing a row-parallel shard alone would
change the codes of o_proj and down_proj; NF4 blocks of 64 along the input stay whole
on a rank because its input share is a multiple of 64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from projectiontrainer_tpu_torch.utils.timing import span

# bitsandbytes' NF4 codebook: the 16 quantiles of a standard normal, scaled to [-1, 1]
# (a copy of the JAX package's NF4_CODE; tests/test_torch_no_jax_package.py holds it
# equal)
NF4_CODE = np.asarray([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], np.float32)
NF4_BLOCK = 64
# nearest codebook entry via the midpoints of neighbouring codes, in fp32 as in JAX
_NF4_MID = (NF4_CODE[1:] + NF4_CODE[:-1]) / 2.0
_NF4_CODE8 = np.round(NF4_CODE * 127.0).astype(np.int8)

QUANT_KEYS = ("qvalues", "packed_nf4", "qvalues_block")
QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
METHODS = ("int8", "nf4", "nf4-mirror")


def quantize(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8: w [out, in] -> {qvalues int8 [out, in],
    scales f32 [out]}."""
    w = w.float()
    scales = torch.clamp(w.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scales), -127, 127).to(torch.int8)
    return {"qvalues": q, "scales": scales.squeeze(1)}


def dequantize(qp: dict, *, dtype=torch.bfloat16) -> torch.Tensor:
    return (qp["qvalues"].float() * qp["scales"][:, None]).to(dtype)


def _nf4_codes(w: torch.Tensor, block: int):
    """(codes uint8 [out, in], block_scales f32 [out, in/block]) of w [out, in]."""
    dout, din = w.shape
    blocks = w.float().reshape(dout, din // block, block)
    scales = torch.clamp(blocks.abs().amax(dim=2), min=1e-12)
    norm = blocks / scales[:, :, None]
    mid = torch.as_tensor(_NF4_MID, device=w.device)
    idx = torch.searchsorted(mid, norm.reshape(-1).contiguous())
    return idx.reshape(dout, din).to(torch.uint8), scales


def _check_nf4(din: int, block: int) -> None:
    if din % block or din % 2:
        raise ValueError(f"nf4: input dim {din} must be even and a multiple of the block "
                         f"{block}")


def quantize_nf4(w: torch.Tensor, *, block: int = NF4_BLOCK) -> dict:
    """Block-wise NF4: w [out, in] -> {packed_nf4 uint8 [out, in/2], block_scales f32
    [out, in/block]}; input index 2i in the high nibble of byte i, 2i + 1 in the low."""
    block = min(block, w.shape[1])  # tiny test models; real widths are multiples of 64
    _check_nf4(w.shape[1], block)
    idx, scales = _nf4_codes(w, block)
    pairs = idx.reshape(idx.shape[0], -1, 2)
    return {"packed_nf4": (pairs[:, :, 0] << 4) | pairs[:, :, 1], "block_scales": scales}


def _unpack(packed: torch.Tensor) -> torch.Tensor:
    """packed uint8 [out, in/2] -> codes int64 [out, in]."""
    hi, lo = (packed >> 4).long(), (packed & 0xF).long()
    return torch.stack([hi, lo], dim=2).reshape(packed.shape[0], -1)


def _block_scale(vals: torch.Tensor, scales: torch.Tensor, dtype) -> torch.Tensor:
    dout, din = vals.shape
    block = din // scales.shape[1]
    return (vals.reshape(dout, din // block, block) * scales[:, :, None]).reshape(
        dout, din).to(dtype)


def dequantize_nf4(qp: dict, *, dtype=torch.bfloat16) -> torch.Tensor:
    code = torch.as_tensor(NF4_CODE, device=qp["packed_nf4"].device)
    return _block_scale(code[_unpack(qp["packed_nf4"])], qp["block_scales"], dtype)


def nf4_int8_mirror(qp: dict) -> dict:
    """An NF4 linear -> its block-wise int8 compute mirror: codes re-encoded as
    ``round(127 * CODE[c])`` int8, block scales divided by 127."""
    code8 = torch.as_tensor(_NF4_CODE8, device=qp["packed_nf4"].device)
    out = {"qvalues_block": code8[_unpack(qp["packed_nf4"])],
           "block_scales": qp["block_scales"] / 127.0}
    if "bias" in qp:
        out["bias"] = qp["bias"]
    return out


def dequantize_block_int8(qp: dict, *, dtype=torch.bfloat16) -> torch.Tensor:
    return _block_scale(qp["qvalues_block"].float(), qp["block_scales"], dtype)


def quantize_linear(p: dict, *, method: str = "int8") -> dict:
    """A linear ``{'weight': [out, in], 'bias'?}`` -> its quantized leaves (bias kept)."""
    if method == "nf4":
        out = quantize_nf4(p["weight"])
    elif method == "nf4-mirror":
        out = nf4_int8_mirror(quantize_nf4(p["weight"]))
    elif method == "int8":
        out = quantize(p["weight"])
    else:
        raise ValueError(f"quant_method must be one of {METHODS}, got {method!r}")
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def is_quantized(p: dict) -> bool:
    return any(k in p for k in QUANT_KEYS)


def dequantize_any(qp: dict, *, dtype=torch.bfloat16) -> torch.Tensor:
    """The dense [out, in] weight of a quantized linear of any method."""
    if "packed_nf4" in qp:
        return dequantize_nf4(qp, dtype=dtype)
    if "qvalues_block" in qp:
        return dequantize_block_int8(qp, dtype=dtype)
    return dequantize(qp, dtype=dtype)


def quantized_matmul(qp: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ dequant(W)^T (+ bias) in x's type; the dequantization runs in span
    ``dequant``."""
    with span("dequant"):
        w = dequantize_any(qp, dtype=x.dtype)
    b = qp.get("bias")
    return F.linear(x, w, None if b is None else b.to(x.dtype))


def quantize_decoder(dec_params: dict, targets=QUANT_TARGETS, *, method: str = "int8") -> dict:
    """Quantize every projection of a decoder's layers (embeddings, norms and
    ``lm_head`` keep their type, as bitsandbytes quantizes only ``nn.Linear``
    modules). The quantized leaves live on the weights' device; the returned tree
    shares every other tensor with ``dec_params``."""
    out = {k: v for k, v in dec_params.items() if k != "layers"}
    out["layers"] = [quantize_layer(layer, targets, method=method)
                     for layer in dec_params["layers"]]
    return out


def quantize_layer(layer: dict, targets=QUANT_TARGETS, *, method: str = "int8") -> dict:
    """One decoder layer's projections quantized (see ``quantize_decoder``)."""
    new = {}
    for blk_name, blk in layer.items():
        if blk_name in ("attn", "mlp"):
            new[blk_name] = {t: (quantize_linear(p, method=method)
                                 if t in targets and "weight" in p else p)
                             for t, p in blk.items()}
        else:
            new[blk_name] = blk
    return new


def quantization_error(qp: dict, weight) -> float:
    """Max dequantization error of a quantized linear against its original ``weight``
    [out, in], relative to the weight's max magnitude."""
    w = torch.as_tensor(weight).float()
    err = (dequantize_any(qp, dtype=torch.float32) - w).abs().max()
    return float(err / torch.clamp(w.abs().max(), min=1e-12))
