"""SigLIP: vision tower, text tower, MAP pooling head, the contrastive dual tower.

Counterpart of ``projectiontrainer_tpu/models/siglip.py``: pre-LN encoder blocks,
gelu-tanh MLP, no CLS token, learned absolute position embeddings, the MAP pooling
head (vision) and last-token pooling + linear head (text). Parameters are a nested
dict shaped like the JAX tree (``checkpoint/from_jax.py`` carries one across).

Two callers: the VLM path (``models/vlm.py``) uses the vision tower's last hidden
state and builds its tower without the MAP head (eager PyTorch would run a head whose
output it discards; the JAX package computes it and XLA removes the dead code); stage
0 trains the whole dual tower through ``forward_contrastive``.

``attn_impl`` / ``norm_impl`` choose, per config, between the kernel wrappers
("kernel": the Hopper kernels on CUDA tensors, the plain versions on CPU ones) and the
plain functions on any device ("plain"), which the end-to-end checks on the card
compare the kernel path against. The MAP head's attention (one query against every
patch) is always the plain one: the flash kernels take self-attention shapes only, as
the JAX package's gate does (``flash_attention_supported``).

Tensor parallelism (every stage's towers; ``parallel/tensor_parallel.py``): with a
model axis the encoder layers hold one rank's shard (``parallel/sharding.py``): q/k/v
and fc1 column-parallel, out_proj and fc2 row-parallel (all-reduced on exit, the bias
added once after), the heads read from the weights' shapes; the LayerNorms (K2, K8)
run row-local on the replicated residual stream. The MAP head's MLP is split the same
way (its attention, LayerNorm and probe stay replicated, as the JAX rules leave them),
and the text tower's token table is a vocab shard; its linear head, the position
embeddings and ``logit_scale``/``logit_bias`` are replicated. A tower's attention (its
heads), its MLPs (the intermediate size) and the text vocab each run whole on every
rank where the model axis does not divide them (``sharding.units``).

ZeRO-3 over the data axis (``--fsdp``, ``parallel/fsdp.py``): inside a train step a
tower's leaves may be data shards; the embeddings, the final LayerNorm and the heads
are gathered at the top of the tower's forward, and each encoder layer gathers its own
leaves inside the function that the remat policy checkpoints; the towers' places in
the params tree are ``vision`` and ``text``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Union

import torch

from projectiontrainer_tpu_torch.core import remat as remat_mod
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN
from projectiontrainer_tpu_torch.ops import layers as L
from projectiontrainer_tpu_torch.ops.attention import dot_product_attention
from projectiontrainer_tpu_torch.ops.flash_attention import flash_attention
from projectiontrainer_tpu_torch.parallel import fsdp, sharding
from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp
from projectiontrainer_tpu_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    layer_norm_eps: float = 1e-6
    attn_impl: str = "kernel"   # 'kernel' | 'plain'
    norm_impl: str = "kernel"   # 'kernel' | 'plain'

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class VisionConfig(TowerConfig):
    image_size: int = 384
    patch_size: int = 16
    num_channels: int = 3
    use_head: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class TextConfig(TowerConfig):
    vocab_size: int = 32_000
    max_position_embeddings: int = 64
    projection_size: Optional[int] = None  # defaults to hidden_size


@dataclasses.dataclass(frozen=True)
class SiglipConfig:
    vision: VisionConfig
    text: TextConfig


def vit_l_16_384(**kw) -> VisionConfig:
    """StanfordAIMI/XraySigLIP__vit-l-16-siglip-384__webli vision shape."""
    return VisionConfig(hidden_size=1024, intermediate_size=4096, num_layers=24,
                        num_heads=16, image_size=384, patch_size=16, **kw)


def so400m_16_512(**kw) -> VisionConfig:
    """google/siglip2-so400m-patch16-512 vision shape (the stage-0 default)."""
    return VisionConfig(hidden_size=1152, intermediate_size=4304, num_layers=27,
                        num_heads=16, image_size=512, patch_size=16, **kw)


def so400m_text(**kw) -> TextConfig:
    """The so400m text tower (``bench.py``'s stage-0 model): 27 layers of 1152, 16
    heads of 72, vocab 256,000, 64 positions."""
    return TextConfig(hidden_size=1152, intermediate_size=4304, num_layers=27,
                      num_heads=16, vocab_size=256_000, max_position_embeddings=64, **kw)


def vision_from_hf_config(cfg: dict) -> VisionConfig:
    """VisionConfig from a SigLIP ``config.json`` dict (its ``vision_config``), with
    the defaults of transformers' ``SiglipVisionConfig`` for missing fields."""
    v = cfg.get("vision_config", cfg)
    return VisionConfig(
        hidden_size=v.get("hidden_size", 768), intermediate_size=v.get("intermediate_size", 3072),
        num_layers=v.get("num_hidden_layers", 12), num_heads=v.get("num_attention_heads", 12),
        layer_norm_eps=v.get("layer_norm_eps", 1e-6), image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 16), num_channels=v.get("num_channels", 3),
    )


def from_hf_config(cfg: dict) -> SiglipConfig:
    """SiglipConfig from a SigLIP ``config.json`` dict, with the defaults of
    transformers' ``SiglipVisionConfig`` / ``SiglipTextConfig`` for missing fields."""
    t = cfg.get("text_config", {})
    hidden = t.get("hidden_size", 768)
    return SiglipConfig(
        vision=vision_from_hf_config(cfg.get("vision_config", {})),
        text=TextConfig(
            hidden_size=hidden, intermediate_size=t.get("intermediate_size", 3072),
            num_layers=t.get("num_hidden_layers", 12), num_heads=t.get("num_attention_heads", 12),
            layer_norm_eps=t.get("layer_norm_eps", 1e-6), vocab_size=t.get("vocab_size", 32000),
            max_position_embeddings=t.get("max_position_embeddings", 64),
            projection_size=t.get("projection_size", hidden),
        ),
    )


# ---------------------------------------------------------------------------- init


def _init_encoder_layer(gen, cfg: TowerConfig, dtype, device):
    d = cfg.hidden_size
    lin = lambda i, o: L.init_linear(gen, i, o, dtype=dtype, device=device)  # noqa: E731
    return {
        "ln1": L.init_layernorm(d, dtype=dtype, device=device),
        "attn": {"q_proj": lin(d, d), "k_proj": lin(d, d), "v_proj": lin(d, d),
                 "out_proj": lin(d, d)},
        "ln2": L.init_layernorm(d, dtype=dtype, device=device),
        "mlp": {"fc1": lin(d, cfg.intermediate_size), "fc2": lin(cfg.intermediate_size, d)},
    }


def _init_map_head(gen, cfg: VisionConfig, dtype, device):
    d = cfg.hidden_size
    lin = lambda i, o: L.init_linear(gen, i, o, dtype=dtype, device=device)  # noqa: E731
    return {
        "probe": torch.randn((1, 1, d), generator=gen, device=device).to(dtype),
        "attention": {"q_proj": lin(d, d), "k_proj": lin(d, d), "v_proj": lin(d, d),
                      "out_proj": lin(d, d)},
        "layernorm": L.init_layernorm(d, dtype=dtype, device=device),
        "mlp": {"fc1": lin(d, cfg.intermediate_size), "fc2": lin(cfg.intermediate_size, d)},
    }


def init_vision(gen: torch.Generator, cfg: VisionConfig, dtype=torch.float32, device=None,
                *, head: bool = False):
    """Random tower parameters; the MAP head only with ``head=True`` (the VLM path does
    not run it)."""
    d = cfg.hidden_size
    params = {
        "patch_embedding": L.init_conv_patch(gen, cfg.patch_size, cfg.num_channels, d,
                                             dtype=dtype, device=device),
        "position_embedding": L.init_embedding(gen, cfg.num_patches, d, dtype=dtype,
                                               device=device),
        "layers": [_init_encoder_layer(gen, cfg, dtype, device) for _ in range(cfg.num_layers)],
        "post_layernorm": L.init_layernorm(d, dtype=dtype, device=device),
    }
    if head:
        params["head"] = _init_map_head(gen, cfg, dtype, device)
    return params


def init_text(gen: torch.Generator, cfg: TextConfig, dtype=torch.float32, device=None):
    d = cfg.hidden_size
    return {
        "token_embedding": L.init_embedding(gen, cfg.vocab_size, d, dtype=dtype, device=device),
        "position_embedding": L.init_embedding(gen, cfg.max_position_embeddings, d,
                                               dtype=dtype, device=device),
        "layers": [_init_encoder_layer(gen, cfg, dtype, device) for _ in range(cfg.num_layers)],
        "final_layer_norm": L.init_layernorm(d, dtype=dtype, device=device),
        "head": L.init_linear(gen, d, cfg.projection_size or d, dtype=dtype, device=device),
    }


def init(gen: torch.Generator, cfg: SiglipConfig, *, device=None, vision_dtype=torch.float32,
         text_dtype=torch.float32):
    """Random dual-tower parameters (distributed like the JAX ``init``; the numbers
    differ): the vision tower with its MAP head, the text tower, and fp32
    ``logit_scale`` = log 10 and ``logit_bias`` = -10."""
    return {
        "vision": init_vision(gen, cfg.vision, vision_dtype, device, head=cfg.vision.use_head),
        "text": init_text(gen, cfg.text, text_dtype, device),
        "logit_scale": torch.tensor([math.log(10.0)], dtype=torch.float32, device=device),
        "logit_bias": torch.tensor([-10.0], dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------- forward


def _ln(p, cfg: TowerConfig, x):
    if cfg.norm_impl == "kernel":
        return FLN.layernorm(p, x, eps=cfg.layer_norm_eps)
    return L.layernorm(p, x, eps=cfg.layer_norm_eps)


def _attention(cfg: TowerConfig, q, k, v):
    if cfg.attn_impl == "kernel":
        return flash_attention(q, k, v, causal=False)[0]
    return dot_product_attention(q, k, v, causal=False)


def _linears(split: bool):
    """(column, row) linears: on the rank's shards of a unit the model axis splits, else
    plain."""
    return (tp.column_linear, tp.row_linear) if split else (L.linear, L.linear)


def _mlp(p, ln, cfg: TowerConfig, x):
    """The LayerNorm ``ln`` then the MLP ``p`` (fc1, gelu, fc2) on ``x``; where the model
    axis splits the MLP, fc1 column-parallel and fc2 row-parallel (all-reduced on exit)."""
    split = sharding.splits(cfg, "mlp")
    col, row = _linears(split)
    h = _ln(ln, cfg, x)
    if split:
        h = tp.copy_to_model(h)
    return row(p["fc2"], L.gelu(col(p["fc1"], h), approximate=True))


def _encoder_layer(p, cfg: TowerConfig, x, path=""):
    p = fsdp.gather(p, path)
    b, t, _ = x.shape
    split = sharding.splits(cfg, "attn")
    col, row = _linears(split)
    h = _ln(p["ln1"], cfg, x)
    if split:
        h = tp.copy_to_model(h)
    shape = (b, t, -1, cfg.head_dim)  # the rank's heads
    q = col(p["attn"]["q_proj"], h).reshape(shape)
    k = col(p["attn"]["k_proj"], h).reshape(shape)
    v = col(p["attn"]["v_proj"], h).reshape(shape)
    h = row(p["attn"]["out_proj"], _attention(cfg, q, k, v).reshape(b, t, -1))
    x = x + h
    return x + _mlp(p["mlp"], p["ln2"], cfg, x)


def _map_head(p, cfg: VisionConfig, x):
    """MAP pooling head with torch.nn.MultiheadAttention semantics (scale head_dim^-0.5)
    -> [B, D]. Where the model axis splits the tower's MLP, the head's runs
    column-then-row on the rank's shards of fc1/fc2 (all-reduced on exit, as the
    encoder's); its attention, LayerNorm and probe are replicated and run whole on every
    rank."""
    b, t, d = x.shape
    probe = p["probe"].to(x.dtype).expand(b, 1, d)
    q = L.linear(p["attention"]["q_proj"], probe).reshape(b, 1, cfg.num_heads, cfg.head_dim)
    k = L.linear(p["attention"]["k_proj"], x).reshape(b, t, cfg.num_heads, cfg.head_dim)
    v = L.linear(p["attention"]["v_proj"], x).reshape(b, t, cfg.num_heads, cfg.head_dim)
    h = L.linear(p["attention"]["out_proj"], dot_product_attention(q, k, v).reshape(b, 1, d))
    return (h + _mlp(p["mlp"], p["layernorm"], cfg, h))[:, 0]


def _encoder(layers, cfg: TowerConfig, x, remat: Union[bool, int, str], prefix: str):
    """The encoder blocks; ``remat`` True recomputes every layer in the backward
    (``torch.utils.checkpoint``), an int N the first N only, 'dots' every layer but its
    products' outputs (``core/remat.py``)."""
    remat_mod.check(remat)
    for i, lp in enumerate(layers):
        x = remat_mod.run(functools.partial(_encoder_layer, lp, cfg,
                                            path=f"{prefix}/layers/{i}"),
                          remat_mod.layer_remat(remat, i), x)
    return x


def vision_forward(params, cfg: VisionConfig, pixel_values: torch.Tensor, *,
                   remat: Union[bool, int] = False):
    """pixel_values [B, H, W, C] (NHWC) -> (last_hidden_state [B, num_patches, D],
    pooled [B, D] from the MAP head, or None for a tower without one)."""
    params = fsdp.gather_top(params, "vision")
    x = L.conv_patchify(params["patch_embedding"], pixel_values, patch=cfg.patch_size)
    x = x + params["position_embedding"]["embedding"][None].to(x.dtype)
    x = _ln(params["post_layernorm"], cfg, _encoder(params["layers"], cfg, x, remat, "vision"))
    pooled = _map_head(params["head"], cfg, x) if "head" in params else None
    return x, pooled


def vision_patch_embeddings(params, cfg: VisionConfig, pixel_values: torch.Tensor, *,
                            remat: Union[bool, int] = False) -> torch.Tensor:
    """The VLM's visual tokens: the last hidden state with patch 0 dropped (the
    reference's "discard CLS" slice, although SigLIP has no CLS token): 576 patches ->
    575 tokens at ViT-L/16-384. ``models/vlm.py`` slices it itself."""
    hidden, _ = vision_forward(params, cfg, pixel_values, remat=remat)
    return hidden[:, 1:, :]


def text_forward(params, cfg: TextConfig, input_ids: torch.Tensor):
    """input_ids [B, T] -> (last_hidden_state [B, T, D], pooled [B, projection]).
    No attention mask (the processor pads to ``max_length`` and the model attends to
    the padding); pooled is the LAST token's hidden state through the linear head.
    Where the model axis splits the vocab the token table is the rank's slice
    (``tp.vocab_embedding``: the rows summed over the model axis); the head is
    replicated."""
    t = input_ids.shape[-1]
    params = fsdp.gather_top(params, "text")
    table = params["token_embedding"]["embedding"]
    x = (tp.vocab_embedding(table, input_ids) if sharding.splits(cfg, "vocab")
         else table[input_ids])
    x = x + params["position_embedding"]["embedding"][None, :t].to(x.dtype)
    x = _ln(params["final_layer_norm"], cfg, _encoder(params["layers"], cfg, x, False, "text"))
    return x, L.linear(params["head"], x[:, -1, :])


def forward_contrastive(params, cfg: SiglipConfig, pixel_values, input_ids, *,
                        remat: Union[bool, int] = False):
    """Dual-tower forward -> (image_embeds, text_embeds, logit_scale, logit_bias), the
    embeds unnormalised (the loss normalises). ``remat`` checkpoints the vision
    layers. The text tower runs without autograd unless one of its parameters
    requires grad (a frozen tower needs no graph: nothing upstream of its output
    trains). Each tower runs inside its ``span`` (``vision``, ``text``)."""
    with span("vision"):
        _, img = vision_forward(params["vision"], cfg.vision, pixel_values, remat=remat)
    text_trains = any(x.requires_grad for _, x in leaves_with_paths(params["text"]))
    with span("text"), torch.set_grad_enabled(torch.is_grad_enabled() and text_trains):
        _, txt = text_forward(params["text"], cfg.text, input_ids)
    return img, txt, params["logit_scale"], params["logit_bias"]


def normalized_logits(img, txt, logit_scale, logit_bias):
    """L2-normalised image/text embeds -> img @ txt^T * exp(scale) + bias, in fp32."""
    img, txt = img.float(), txt.float()
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    return img @ txt.t() * torch.exp(logit_scale[0].float()) + logit_bias[0].float()


def logits_per_image(params, cfg: SiglipConfig, pixel_values, input_ids):
    """Zero-shot scoring (HF ``SiglipModel`` semantics): [B_img, B_txt]."""
    return normalized_logits(*forward_contrastive(params, cfg, pixel_values, input_ids))


# ---------------------------------------------------------------------------- HF import


def _getter(sd: dict, prefix: str, device, dtype):
    def get(name):
        x = sd[f"{prefix}.{name}"] if f"{prefix}.{name}" in sd else sd[name]
        return torch.as_tensor(x).to(device=device, dtype=dtype)
    return get


def _encoder_layers(get, num_layers: int) -> list:
    def lin(name):
        return {"weight": get(name + ".weight"), "bias": get(name + ".bias")}

    def ln(name):
        return {"scale": get(name + ".weight"), "bias": get(name + ".bias")}

    layers = []
    for i in range(num_layers):
        pre = f"encoder.layers.{i}."
        layers.append({
            "ln1": ln(pre + "layer_norm1"),
            "attn": {n: lin(pre + "self_attn." + n)
                     for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "ln2": ln(pre + "layer_norm2"),
            "mlp": {"fc1": lin(pre + "mlp.fc1"), "fc2": lin(pre + "mlp.fc2")},
        })
    return layers


def vision_params(sd: dict, cfg: VisionConfig, *, device=None, dtype=None,
                  prefix: str = "vision_model", head: bool = False) -> dict:
    """Tower parameters from an HF ``SiglipVisionModel`` state dict of tensors or
    numpy arrays (torch layout: linear weights are already [out, in]). The conv
    weight [D, C, p, p] becomes the space-to-depth matrix [D, p*p*C]. ``head`` adds
    the MAP head (its packed ``in_proj`` split into q/k/v) when the snapshot has one."""
    get = _getter(sd, prefix, device, dtype)
    conv = get("embeddings.patch_embedding.weight")
    params = {
        "patch_embedding": {
            "weight": conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1).contiguous(),
            "bias": get("embeddings.patch_embedding.bias"),
        },
        "position_embedding": {"embedding": get("embeddings.position_embedding.weight")},
        "layers": _encoder_layers(get, cfg.num_layers),
        "post_layernorm": {"scale": get("post_layernorm.weight"),
                           "bias": get("post_layernorm.bias")},
    }
    if head and cfg.use_head and (f"{prefix}.head.probe" in sd or "head.probe" in sd):
        d = cfg.hidden_size
        in_w, in_b = get("head.attention.in_proj_weight"), get("head.attention.in_proj_bias")
        params["head"] = {
            "probe": get("head.probe"),
            "attention": {
                name: {"weight": in_w[i * d:(i + 1) * d].clone(),
                       "bias": in_b[i * d:(i + 1) * d].clone()}
                for i, name in enumerate(("q_proj", "k_proj", "v_proj"))
            } | {"out_proj": {"weight": get("head.attention.out_proj.weight"),
                              "bias": get("head.attention.out_proj.bias")}},
            "layernorm": {"scale": get("head.layernorm.weight"),
                          "bias": get("head.layernorm.bias")},
            "mlp": {n: {"weight": get(f"head.mlp.{n}.weight"), "bias": get(f"head.mlp.{n}.bias")}
                    for n in ("fc1", "fc2")},
        }
    return params


def text_params(sd: dict, cfg: TextConfig, *, device=None, dtype=None,
                prefix: str = "text_model") -> dict:
    """Text tower parameters from an HF ``SiglipTextModel`` state dict."""
    get = _getter(sd, prefix, device, dtype)
    return {
        "token_embedding": {"embedding": get("embeddings.token_embedding.weight")},
        "position_embedding": {"embedding": get("embeddings.position_embedding.weight")},
        "layers": _encoder_layers(get, cfg.num_layers),
        "final_layer_norm": {"scale": get("final_layer_norm.weight"),
                             "bias": get("final_layer_norm.bias")},
        "head": {"weight": get("head.weight"), "bias": get("head.bias")},
    }


def params_from_hf_state_dict(cfg: SiglipConfig, sd: dict, *, device=None,
                              vision_dtype=None, text_dtype=None) -> dict:
    """The dual tower from an HF ``SiglipModel`` state dict; logit scale and bias as
    fp32 [1] tensors."""
    scalar = lambda name: torch.as_tensor(sd[name]).reshape(1).to(  # noqa: E731
        device=device, dtype=torch.float32)
    return {
        "vision": vision_params(sd, cfg.vision, device=device, dtype=vision_dtype, head=True),
        "text": text_params(sd, cfg.text, device=device, dtype=text_dtype),
        "logit_scale": scalar("logit_scale"),
        "logit_bias": scalar("logit_bias"),
    }
