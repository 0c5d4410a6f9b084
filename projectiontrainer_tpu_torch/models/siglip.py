"""SigLIP vision tower: the part the VLM serving path runs.

Counterpart of the vision path of ``projectiontrainer_tpu/models/siglip.py``: pre-LN
encoder blocks, gelu-tanh MLP, no CLS token, learned absolute position embeddings.
Parameters are a nested dict shaped like the JAX tree (``checkpoint/from_jax.py``
carries one across).

The MAP pooling head is not ported: the VLM path discards the pooled output (the
JAX package computes it and XLA removes the dead code, but eager PyTorch would run
it), so ``vision_forward`` returns the last hidden state alone.

``attn_impl`` / ``norm_impl`` choose, per config, between the kernel wrappers
("kernel": the Hopper kernel on CUDA tensors, the plain version on CPU ones) and the
plain functions on any device ("plain"), which the end-to-end check on the card
compares the kernel path against.
"""

from __future__ import annotations

import dataclasses

import torch

from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN
from projectiontrainer_tpu_torch.ops import layers as L
from projectiontrainer_tpu_torch.ops.attention import dot_product_attention
from projectiontrainer_tpu_torch.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    layer_norm_eps: float = 1e-6
    image_size: int = 384
    patch_size: int = 16
    num_channels: int = 3
    use_head: bool = True
    attn_impl: str = "kernel"   # 'kernel' | 'plain'
    norm_impl: str = "kernel"   # 'kernel' | 'plain'

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def vit_l_16_384(**kw) -> VisionConfig:
    """StanfordAIMI/XraySigLIP__vit-l-16-siglip-384__webli vision shape."""
    return VisionConfig(hidden_size=1024, intermediate_size=4096, num_layers=24,
                        num_heads=16, image_size=384, patch_size=16, **kw)


def from_hf_config(cfg: dict) -> VisionConfig:
    """VisionConfig from a SigLIP ``config.json`` dict (its ``vision_config``)."""
    v = cfg.get("vision_config", cfg)
    return VisionConfig(
        hidden_size=v.get("hidden_size", 768), intermediate_size=v.get("intermediate_size", 3072),
        num_layers=v.get("num_hidden_layers", 12), num_heads=v.get("num_attention_heads", 12),
        layer_norm_eps=v.get("layer_norm_eps", 1e-6), image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 16), num_channels=v.get("num_channels", 3),
    )


# ---------------------------------------------------------------------------- init


def _init_encoder_layer(gen, cfg: VisionConfig, dtype, device):
    d = cfg.hidden_size
    lin = lambda i, o: L.init_linear(gen, i, o, dtype=dtype, device=device)
    return {
        "ln1": L.init_layernorm(d, dtype=dtype, device=device),
        "attn": {"q_proj": lin(d, d), "k_proj": lin(d, d), "v_proj": lin(d, d),
                 "out_proj": lin(d, d)},
        "ln2": L.init_layernorm(d, dtype=dtype, device=device),
        "mlp": {"fc1": lin(d, cfg.intermediate_size), "fc2": lin(cfg.intermediate_size, d)},
    }


def init_vision(gen: torch.Generator, cfg: VisionConfig, dtype=torch.float32, device=None):
    """Random tower parameters (no MAP head: the VLM path does not run it)."""
    d = cfg.hidden_size
    return {
        "patch_embedding": L.init_conv_patch(gen, cfg.patch_size, cfg.num_channels, d,
                                             dtype=dtype, device=device),
        "position_embedding": L.init_embedding(gen, cfg.num_patches, d, dtype=dtype,
                                               device=device),
        "layers": [_init_encoder_layer(gen, cfg, dtype, device) for _ in range(cfg.num_layers)],
        "post_layernorm": L.init_layernorm(d, dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------- forward


def _ln(p, cfg: VisionConfig, x):
    if cfg.norm_impl == "kernel":
        return FLN.layernorm(p, x, eps=cfg.layer_norm_eps)
    return L.layernorm(p, x, eps=cfg.layer_norm_eps)


def _attention(cfg: VisionConfig, q, k, v):
    if cfg.attn_impl == "kernel":
        return flash_attention(q, k, v, causal=False)[0]
    return dot_product_attention(q, k, v, causal=False)


def _encoder_layer(p, cfg: VisionConfig, x):
    b, t, d = x.shape
    h = _ln(p["ln1"], cfg, x)
    shape = (b, t, cfg.num_heads, cfg.head_dim)
    q = L.linear(p["attn"]["q_proj"], h).reshape(shape)
    k = L.linear(p["attn"]["k_proj"], h).reshape(shape)
    v = L.linear(p["attn"]["v_proj"], h).reshape(shape)
    h = L.linear(p["attn"]["out_proj"], _attention(cfg, q, k, v).reshape(b, t, d))
    x = x + h
    h = _ln(p["ln2"], cfg, x)
    h = L.linear(p["mlp"]["fc2"], L.gelu(L.linear(p["mlp"]["fc1"], h), approximate=True))
    return x + h


def vision_forward(params, cfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """pixel_values [B, H, W, C] (NHWC) -> last_hidden_state [B, num_patches, D].

    The MAP head (``pooled`` in the JAX package) is not computed: no caller of the
    port uses it yet."""
    x = L.conv_patchify(params["patch_embedding"], pixel_values, patch=cfg.patch_size)
    x = x + params["position_embedding"]["embedding"][None].to(x.dtype)
    for lp in params["layers"]:
        x = _encoder_layer(lp, cfg, x)
    return _ln(params["post_layernorm"], cfg, x)


def vision_params(sd: dict, cfg: VisionConfig, *, device=None, dtype=None,
                  prefix: str = "vision_model") -> dict:
    """Tower parameters from an HF ``SiglipVisionModel`` state dict of tensors or
    numpy arrays (torch layout: linear weights are already [out, in]). The conv
    weight [D, C, p, p] becomes the space-to-depth matrix [D, p*p*C]."""
    def get(name):
        x = sd[f"{prefix}.{name}"] if f"{prefix}.{name}" in sd else sd[name]
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    def lin(name):
        return {"weight": get(name + ".weight"), "bias": get(name + ".bias")}

    def ln(name):
        return {"scale": get(name + ".weight"), "bias": get(name + ".bias")}

    conv = get("embeddings.patch_embedding.weight")
    layers = []
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}."
        layers.append({
            "ln1": ln(pre + "layer_norm1"),
            "attn": {n: lin(pre + "self_attn." + n)
                     for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "ln2": ln(pre + "layer_norm2"),
            "mlp": {"fc1": lin(pre + "mlp.fc1"), "fc2": lin(pre + "mlp.fc2")},
        })
    return {
        "patch_embedding": {
            "weight": conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1).contiguous(),
            "bias": get("embeddings.patch_embedding.bias"),
        },
        "position_embedding": {"embedding": get("embeddings.position_embedding.weight")},
        "layers": layers,
        "post_layernorm": ln("post_layernorm"),
    }
