"""Model assembly from local HF snapshots (no hub downloads).

Counterpart of ``projectiontrainer_tpu/train/setup.py``: the pretrained towers are
stored in bf16 (``frozen_dtype``) and the projector in fp32 (``param_dtype``); the
projector comes from a stage-1 directory or is initialised from ``seed``; under
``--enable_qlora`` the decoder's projections are quantized on the device
(``ops/quant.py``), layer by layer.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from projectiontrainer_tpu_torch.checkpoint import hf_import
from projectiontrainer_tpu_torch.models import projector as proj
from projectiontrainer_tpu_torch.models import vlm
from projectiontrainer_tpu_torch.ops import quant


def load_tokenizer(name_or_path: str):
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(name_or_path)
    if tok.pad_token is None:  # reference: Stage2/dataset.py:34-36
        tok.pad_token = tok.eos_token
    return tok


def build_vlm(vision_model_name: str, llm_name: str, *, device,
              stage1_projector_path: Optional[str] = None, expansion_factor: int = 10,
              seed: int = 0, param_dtype=torch.float32, frozen_dtype=torch.bfloat16,
              quantize_llm: bool = False, quant_method: str = "nf4-mirror"):
    """(VLMConfig, params) from local snapshot directories, on ``device``.
    ``quantize_llm`` stores the decoder's projections quantized by ``quant_method``
    ('nf4-mirror', the reference's NF4 value grid with int8 compute; 'nf4', exact; or
    'int8'), each quantized from its ``frozen_dtype`` weight, as the JAX package does;
    each layer's dense weights are released once it is quantized."""
    for path in (vision_model_name, llm_name):
        if not os.path.isdir(path):
            raise FileNotFoundError(f"{path!r} is not a local model directory: download "
                                    "snapshots ahead of time and pass their paths")
    vis_cfg, vis_params = hf_import.load_siglip_vision(vision_model_name, device=device,
                                                       dtype=frozen_dtype)
    llm_cfg, llm_params = hf_import.load_decoder(llm_name, device=device, dtype=frozen_dtype)
    if quantize_llm:
        layers = llm_params["layers"]
        for i, layer in enumerate(layers):
            layers[i] = quant.quantize_layer(layer, method=quant_method)
    if stage1_projector_path:
        proj_cfg, proj_params = hf_import.load_projector(stage1_projector_path, device=device,
                                                         dtype=param_dtype)
    else:
        proj_cfg = proj.ProjectorConfig(vision_dim=vis_cfg.hidden_size,
                                        llm_dim=llm_cfg.hidden_size,
                                        expansion_factor=expansion_factor)
        gen = torch.Generator(device=device).manual_seed(seed)
        proj_params = proj.init(gen, proj_cfg, param_dtype, device)
    cfg = vlm.VLMConfig(vision=vis_cfg, projector=proj_cfg, llm=llm_cfg)
    return cfg, {"vision": vis_params, "projector": proj_params, "llm": llm_params}
