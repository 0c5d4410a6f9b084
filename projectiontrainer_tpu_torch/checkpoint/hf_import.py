"""Local HF snapshot import: ``config.json`` plus ``*.safetensors`` (or
``pytorch_model.bin``) -> the port's configs and parameters.

Counterpart of ``projectiontrainer_tpu/checkpoint/hf_import.py``, without the
transformers config classes: the configs are read from ``config.json`` as dicts.
``safetensors`` is imported only inside the loader.
"""

from __future__ import annotations

import json
import os

import torch

from projectiontrainer_tpu_torch.models import decoder, projector, siglip


def load_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    """Every tensor of a local HF model directory (sharded or single safetensors, or a
    torch ``pytorch_model.bin``), on the CPU."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        sd = {}
        for shard in shards:
            sd.update(_load_safetensors(os.path.join(model_dir, shard)))
        return sd
    single = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(single):
        return _load_safetensors(single)
    torch_bin = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(torch_bin):
        return torch.load(torch_bin, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model weights found under {model_dir}")


def _load_safetensors(path: str) -> dict[str, torch.Tensor]:
    from safetensors.torch import load_file

    return load_file(path, device="cpu")


def load_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def load_siglip_vision(model_dir: str, *, device=None, dtype=None, head: bool = False):
    """Local SigLIP snapshot -> (VisionConfig, vision tower params); ``head`` keeps the
    snapshot's MAP head (the cls probe saves and trains it as the JAX package does)."""
    cfg = siglip.vision_from_hf_config(load_config(model_dir))
    return cfg, siglip.vision_params(load_state_dict(model_dir), cfg, device=device,
                                     dtype=dtype, head=head)


def load_siglip(model_dir: str, *, device=None, vision_dtype=None, text_dtype=None):
    """Local SigLIP snapshot -> (SiglipConfig, dual-tower params: vision tower with
    its MAP head, text tower, fp32 logit scale and bias)."""
    cfg = siglip.from_hf_config(load_config(model_dir))
    return cfg, siglip.params_from_hf_state_dict(cfg, load_state_dict(model_dir),
                                                 device=device, vision_dtype=vision_dtype,
                                                 text_dtype=text_dtype)


def load_decoder(model_dir: str, *, device=None, dtype=None):
    """Local Gemma3 snapshot -> (DecoderConfig, params). Multimodal Gemma3 snapshots
    keep their language model under ``language_model.``."""
    cfg = decoder.from_hf_config(load_config(model_dir))
    sd = {k.removeprefix("language_model."): v for k, v in load_state_dict(model_dir).items()
          if not k.startswith(("vision_tower.", "multi_modal_projector."))}
    return cfg, decoder.params_from_hf_state_dict(cfg, sd, device=device, dtype=dtype)


def load_projector(stage1_dir: str, *, prefer=("best", "final"), device=None, dtype=None):
    """A reference-format projector directory (``projector_config.json`` plus
    ``projector_{best,final,...}.{bin,safetensors}``) -> (ProjectorConfig, params)."""
    with open(os.path.join(stage1_dir, "projector_config.json")) as f:
        cd = json.load(f)
    cfg = projector.ProjectorConfig(
        vision_dim=cd["vision_dim"], llm_dim=cd["llm_dim"],
        expansion_factor=cd.get("expansion_factor", cd["intermediate_dim"] // cd["vision_dim"]),
    )
    names = [f"projector_{tag}{ext}" for tag in prefer for ext in (".bin", ".safetensors")]
    names += sorted(f for f in os.listdir(stage1_dir)
                    if f.startswith("projector_") and f.endswith((".bin", ".safetensors")))
    for name in names:
        path = os.path.join(stage1_dir, name)
        if os.path.exists(path):
            sd = (_load_safetensors(path) if path.endswith(".safetensors")
                  else torch.load(path, map_location="cpu", weights_only=True))
            return cfg, projector.params_from_torch_state_dict(sd, device=device, dtype=dtype)
    raise FileNotFoundError(f"no projector weights in {stage1_dir}")
