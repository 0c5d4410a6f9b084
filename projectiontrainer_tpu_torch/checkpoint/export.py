"""Exports in the reference's formats.

Counterpart of ``projectiontrainer_tpu/checkpoint/export.py``:

- ``save_projector``: ``projector_{tag}.bin`` (a torch state dict
  ``model.{0,2}.{weight,bias}``) plus ``projector_config.json``, readable by the
  reference, by the JAX package's ``load_projector`` and by
  ``checkpoint/hf_import.load_projector``;
- ``save_siglip_hf``: the SigLIP dual tower as an HF snapshot (``config.json`` plus
  fp32 ``model.safetensors`` under HF ``SiglipModel`` keys), what the reference's stage
  0 writes with ``save_pretrained`` and its downstream stages load; readable by
  ``hf_import.load_siglip``, the JAX package's ``hf_import.load_siglip`` and
  transformers;
- ``save_stage2_checkpoint``: the reference's ``checkpoint-epoch_N/`` directory
  (``projection_layer/``, ``language_model/``, ``metadata.json``;
  Stage2/trainer.py:710-769): a full LLM as ``model.safetensors`` under the JAX
  package's flat ``path_str`` keys and layout, so its ``load_flat_safetensors`` reads
  it; LoRA adapters as an HF-PEFT adapter directory;
- ``save_peft_adapter`` / ``load_peft_adapter`` / ``load_adapter``: the PEFT adapter
  format (``adapter_model.safetensors`` keyed
  ``base_model.model.model.layers.N.{self_attn|mlp}.{target}.lora_{A,B}.weight``,
  A ``[r, in]`` and B ``[out, r]`` in fp32, plus ``adapter_config.json``), what the
  reference's PEFT ``save_pretrained`` writes, ``PeftModel.from_pretrained`` and the
  JAX package's ``load_adapter`` read; ``load_adapter`` also reads the JAX package's
  legacy flat format (``layers/N/target/{a,b}``, A ``[in, r]``, B ``[r, out]``).

``safetensors`` is imported only inside the functions that write it.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import torch

from projectiontrainer_tpu_torch.checkpoint.from_jax import decoder_params_to_jax, lora_params
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
from projectiontrainer_tpu_torch.models import projector as proj
from projectiontrainer_tpu_torch.models import siglip
from projectiontrainer_tpu_torch.train.lora import ATTN_TARGETS, LoraConfig

# processor and tokenizer files copied from the source snapshot beside an export
_SNAPSHOT_FILES = ("preprocessor_config.json", "tokenizer_config.json", "tokenizer.json",
                   "special_tokens_map.json", "spiece.model", "vocab.txt")


def save_projector(params, cfg: proj.ProjectorConfig, out_dir: str, *, tag: str = "final") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"projector_{tag}.bin")
    torch.save(proj.to_torch_state_dict(params), path)
    with open(os.path.join(out_dir, "projector_config.json"), "w") as f:
        json.dump(proj.config_dict(cfg), f, indent=2)
    return path


def _siglip_state_dict(params, cfg: siglip.SiglipConfig) -> dict[str, torch.Tensor]:
    """The port's dual-tower params -> an HF ``SiglipModel`` state dict of contiguous
    fp32 CPU tensors (the patch matrix back to an OIHW conv weight, the MAP head's
    q/k/v packed into ``in_proj``)."""
    sd: dict[str, torch.Tensor] = {}

    def put(name, x):
        sd[name] = x.detach().to(device="cpu", dtype=torch.float32).contiguous()

    def put_lin(name, p):
        put(name + ".weight", p["weight"])
        put(name + ".bias", p["bias"])

    def put_ln(name, p):
        put(name + ".weight", p["scale"])
        put(name + ".bias", p["bias"])

    def put_encoder(prefix, layers):
        for i, lp in enumerate(layers):
            pre = f"{prefix}.layers.{i}."
            put_ln(pre + "layer_norm1", lp["ln1"])
            for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
                put_lin(pre + f"self_attn.{k}", lp["attn"][k])
            put_ln(pre + "layer_norm2", lp["ln2"])
            put_lin(pre + "mlp.fc1", lp["mlp"]["fc1"])
            put_lin(pre + "mlp.fc2", lp["mlp"]["fc2"])

    v, vc = params["vision"], cfg.vision
    w = v["patch_embedding"]["weight"]  # [D, p*p*C], rows (patch row, patch column, channel)
    put("vision_model.embeddings.patch_embedding.weight",
        w.reshape(w.shape[0], vc.patch_size, vc.patch_size, vc.num_channels).permute(0, 3, 1, 2))
    put("vision_model.embeddings.patch_embedding.bias", v["patch_embedding"]["bias"])
    put("vision_model.embeddings.position_embedding.weight", v["position_embedding"]["embedding"])
    put_encoder("vision_model.encoder", v["layers"])
    put_ln("vision_model.post_layernorm", v["post_layernorm"])
    if "head" in v:
        h = v["head"]
        qkv = [h["attention"][k] for k in ("q_proj", "k_proj", "v_proj")]
        put("vision_model.head.probe", h["probe"])
        put("vision_model.head.attention.in_proj_weight", torch.cat([p["weight"] for p in qkv]))
        put("vision_model.head.attention.in_proj_bias", torch.cat([p["bias"] for p in qkv]))
        put_lin("vision_model.head.attention.out_proj", h["attention"]["out_proj"])
        put_ln("vision_model.head.layernorm", h["layernorm"])
        put_lin("vision_model.head.mlp.fc1", h["mlp"]["fc1"])
        put_lin("vision_model.head.mlp.fc2", h["mlp"]["fc2"])

    t = params["text"]
    put("text_model.embeddings.token_embedding.weight", t["token_embedding"]["embedding"])
    put("text_model.embeddings.position_embedding.weight", t["position_embedding"]["embedding"])
    put_encoder("text_model.encoder", t["layers"])
    put_ln("text_model.final_layer_norm", t["final_layer_norm"])
    put_lin("text_model.head", t["head"])
    put("logit_scale", params["logit_scale"].reshape(1))
    put("logit_bias", params["logit_bias"].reshape(1))
    return sd


def save_siglip_hf(params, cfg: siglip.SiglipConfig, out_dir: str, *,
                   src_dir: Optional[str] = None) -> str:
    """Write the dual tower as an HF snapshot under ``out_dir``. ``config.json`` starts
    from ``src_dir``'s (the snapshot the run began from) when there is one, so fields
    the port does not model survive, and its processor and tokenizer files are
    copied beside the weights."""
    from safetensors.torch import save_file

    os.makedirs(out_dir, exist_ok=True)
    save_file(_siglip_state_dict(params, cfg), os.path.join(out_dir, "model.safetensors"))
    src_config = os.path.join(src_dir, "config.json") if src_dir else None
    if src_config and os.path.exists(src_config):
        with open(src_config) as f:
            hf = json.load(f)
    else:
        hf = {"model_type": "siglip", "vision_config": {}, "text_config": {}}
    vc, tc = cfg.vision, cfg.text
    hf.setdefault("vision_config", {}).update({
        "model_type": "siglip_vision_model", "hidden_size": vc.hidden_size,
        "intermediate_size": vc.intermediate_size, "num_hidden_layers": vc.num_layers,
        "num_attention_heads": vc.num_heads, "layer_norm_eps": vc.layer_norm_eps,
        "image_size": vc.image_size, "patch_size": vc.patch_size,
        "num_channels": vc.num_channels,
    })
    hf.setdefault("text_config", {}).update({
        "model_type": "siglip_text_model", "hidden_size": tc.hidden_size,
        "intermediate_size": tc.intermediate_size, "num_hidden_layers": tc.num_layers,
        "num_attention_heads": tc.num_heads, "layer_norm_eps": tc.layer_norm_eps,
        "vocab_size": tc.vocab_size, "max_position_embeddings": tc.max_position_embeddings,
        "projection_size": tc.projection_size or tc.hidden_size,
    })
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=2)
    for name in _SNAPSHOT_FILES if src_dir else ():
        src = os.path.join(src_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_dir, name))
    return out_dir


def save_stage2_checkpoint(out_dir: str, epoch: int, *, projector_params, projector_cfg,
                           llm_params=None, lora_params=None, lora_cfg=None,
                           base_model_name: Optional[str] = None,
                           metadata: Optional[dict] = None) -> str:
    """Write ``out_dir/checkpoint-epoch_N/``: the projector under
    ``projection_layer/`` (``projector_best.bin``); under ``language_model/`` the full
    LLM (when given) as ``model.safetensors`` with the JAX package's keys
    (``layers/0/attn/q_proj/kernel``, kernels ``[in, out]``, a tied table only as
    ``embed_tokens/embedding``) in the leaves' own types, or the LoRA adapters (when
    given, with their ``lora_cfg``) as a PEFT adapter directory naming
    ``base_model_name``; and ``metadata.json``."""
    ckpt_dir = os.path.join(out_dir, f"checkpoint-epoch_{epoch}")
    save_projector(projector_params, projector_cfg, os.path.join(ckpt_dir, "projection_layer"),
                   tag="best")
    lm_dir = os.path.join(ckpt_dir, "language_model")
    os.makedirs(lm_dir, exist_ok=True)
    if lora_params is not None:
        save_peft_adapter(lora_params, lora_cfg, lm_dir, base_model_name_or_path=base_model_name)
    if llm_params is not None:
        from safetensors.torch import save_file

        flat = dict(leaves_with_paths(decoder_params_to_jax(llm_params)))
        save_file(flat, os.path.join(lm_dir, "model.safetensors"))
    if metadata is not None:
        with open(os.path.join(ckpt_dir, "metadata.json"), "w") as f:
            json.dump(metadata, f, indent=2, default=str)
    return ckpt_dir


# ------------------------------------------------------------------ PEFT adapters

ADAPTER_FILE = "adapter_model.safetensors"
ADAPTER_CONFIG = "adapter_config.json"
_PEFT_KEY = re.compile(r"layers\.(\d+)\.(?:self_attn|mlp)\.([A-Za-z0-9_]+)\.lora_(A|B)\.weight$")
_FLAT_KEY = re.compile(r"layers/(\d+)/([A-Za-z0-9_]+)/(a|b)$")


def peft_key(layer: int, target: str, ab: str) -> str:
    """PEFT's state-dict key of one adapter matrix over an HF ``*ForCausalLM`` base."""
    parent = "self_attn" if target in ATTN_TARGETS else "mlp"
    return f"base_model.model.model.layers.{layer}.{parent}.{target}.lora_{ab}.weight"


def save_peft_adapter(lora: dict, cfg: LoraConfig, out_dir: str, *,
                      base_model_name_or_path: Optional[str] = None) -> str:
    """The port's adapters (``a`` [r, in], ``b`` [out, r]) -> an HF-PEFT adapter
    directory: fp32 tensors under ``peft_key`` and the JAX package's
    ``adapter_config.json`` fields."""
    from safetensors.torch import save_file

    os.makedirs(out_dir, exist_ok=True)
    sd = {}
    for i, layer in enumerate(lora["layers"]):
        for target, p in layer.items():
            for ab, key in (("A", "a"), ("B", "b")):
                sd[peft_key(i, target, ab)] = p[key].detach().to("cpu", torch.float32).contiguous()
    save_file(sd, os.path.join(out_dir, ADAPTER_FILE))
    config = {
        "peft_type": "LORA", "task_type": "CAUSAL_LM", "r": int(cfg.r),
        "lora_alpha": int(cfg.alpha), "lora_dropout": float(cfg.dropout),
        "target_modules": sorted(cfg.targets), "bias": "none", "fan_in_fan_out": False,
        "inference_mode": True, "base_model_name_or_path": base_model_name_or_path,
    }
    with open(os.path.join(out_dir, ADAPTER_CONFIG), "w") as f:
        json.dump(config, f, indent=2)
    return out_dir


def _layers_from(entries: dict, where: str) -> list:
    """{(layer, target): {'a', 'b'}} -> the adapters' layer list; raises on a missing
    half of a pair or no tensors at all."""
    if not entries:
        raise ValueError(f"no LoRA tensors found in {where}")
    layers = [{} for _ in range(max(i for i, _ in entries) + 1)]
    for (i, target), entry in sorted(entries.items()):
        if set(entry) != {"a", "b"}:
            raise ValueError(f"layer {i} target {target}: missing lora_"
                             f"{({'a', 'b'} - set(entry)).pop()}")
        layers[i][target] = entry
    return layers


def load_peft_adapter(adapter_dir: str, *, device=None):
    """An HF-PEFT LoRA adapter directory (PEFT's own or ``save_peft_adapter``'s) ->
    (adapters in fp32, LoraConfig). Any wrapper depth before ``layers.N.`` matches."""
    from safetensors.torch import load_file

    with open(os.path.join(adapter_dir, ADAPTER_CONFIG)) as f:
        cfg_json = json.load(f)
    entries: dict = {}
    for key, val in load_file(os.path.join(adapter_dir, ADAPTER_FILE)).items():
        m = _PEFT_KEY.search(key)
        if m is None:
            raise ValueError(f"unrecognized PEFT adapter key: {key}")
        entry = entries.setdefault((int(m.group(1)), m.group(2)), {})
        entry["a" if m.group(3) == "A" else "b"] = val.to(device=device, dtype=torch.float32)
    layers = _layers_from(entries, adapter_dir)
    cfg = LoraConfig(r=int(cfg_json.get("r", 16)), alpha=int(cfg_json.get("lora_alpha", 32)),
                     dropout=float(cfg_json.get("lora_dropout", 0.0)),
                     targets=tuple(sorted({t for layer in layers for t in layer})))
    return {"layers": layers}, cfg


def load_adapter(adapter_dir: str, *, device=None):
    """A LoRA adapter directory in either format -> (adapters, LoraConfig or None): PEFT
    when ``adapter_config.json`` is there, else the JAX package's legacy flat
    safetensors (``layers/N/target/{a,b}``), which carries no config."""
    if os.path.exists(os.path.join(adapter_dir, ADAPTER_CONFIG)):
        return load_peft_adapter(adapter_dir, device=device)
    from safetensors.numpy import load_file

    entries: dict = {}
    for key, val in load_file(os.path.join(adapter_dir, ADAPTER_FILE)).items():
        m = _FLAT_KEY.fullmatch(key)
        if m is None:
            raise ValueError(f"unrecognized flat adapter key: {key}")
        entries.setdefault((int(m.group(1)), m.group(2)), {})[m.group(3)] = val
    jax_layout = {"layers": _layers_from(entries, adapter_dir)}
    return lora_params(jax_layout, device=device, dtype=torch.float32), None
