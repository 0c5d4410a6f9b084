"""Model assembly from local HF snapshots (no hub downloads).

Counterpart of ``projectiontrainer_tpu/train/setup.py``: the pretrained towers are
stored in bf16 (``frozen_dtype``) and the projector in fp32 (``param_dtype``); the
projector comes from a stage-1 directory or is initialised from ``seed``; under
``--enable_qlora`` the decoder's projections are quantized on the device
(``ops/quant.py``), layer by layer. Under tensor parallelism (a model axis,
``parallel/sharding.py``) each layer is quantized whole and then sliced to the rank's
shard as it comes, so a rank never holds more than one whole layer beside its shards.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from projectiontrainer_tpu_torch.checkpoint import hf_import
from projectiontrainer_tpu_torch.models import decoder as dec
from projectiontrainer_tpu_torch.models import projector as proj
from projectiontrainer_tpu_torch.models import vlm
from projectiontrainer_tpu_torch.ops import quant
from projectiontrainer_tpu_torch.parallel import distributed, sharding


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
    each layer's dense weights are released once it is quantized, and the decoder's
    config says so (``decoder.QuantizedDecoderConfig``: the NF4 blocks a model axis must
    keep whole). With a model axis the params returned are this model rank's shards
    (:func:`shard_model`)."""
    for path in (vision_model_name, llm_name):
        if not os.path.isdir(path):
            raise FileNotFoundError(f"{path!r} is not a local model directory: download "
                                    "snapshots ahead of time and pass their paths")
    vis_cfg, vis_params = hf_import.load_siglip_vision(vision_model_name, device=device,
                                                       dtype=frozen_dtype)
    llm_cfg, llm_params = hf_import.load_decoder(llm_name, device=device, dtype=frozen_dtype)
    if quantize_llm:
        llm_cfg = dec.quantized_config(llm_cfg, quant_method)
    layers = llm_params["layers"]
    for i, layer in enumerate(layers):
        if quantize_llm:
            layer = quant.quantize_layer(layer, method=quant_method)
        layers[i] = shard_layer(layer, i, llm_cfg)
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
    return cfg, shard_model({"vision": vis_params, "projector": proj_params,
                             "llm": llm_params}, cfg)


def shard_layer(layer: dict, i: int, llm_cfg) -> dict:
    """Decoder layer ``i`` (whole, quantized or not) sliced to this model rank's shard;
    the layer itself without a model axis."""
    if distributed.model_size() == 1:
        return layer
    prefix = f"llm/layers/{i}"
    return sharding.shard_params(layer, sharding.plan_for(layer, llm_cfg, prefix=prefix),
                                 prefix=prefix)


def shard_model(params: dict, cfg) -> dict:
    """A VLM tree whose decoder layers may already be shards (:func:`shard_layer`) with
    every other leaf sliced to this model rank's shard (a unit the model axis leaves
    whole stays whole, ``sharding.units``); the tree itself without a model axis."""
    if distributed.model_size() == 1:
        return params
    sharding.check_config(cfg, distributed.model_size())
    out = {}
    for k, v in params.items():
        rest = {n: x for n, x in v.items() if n != "layers"} if k == "llm" else v
        rest = sharding.shard_params(rest, sharding.plan_for(rest, cfg, prefix=k), prefix=k)
        out[k] = ({n: (v["layers"] if n == "layers" else rest[n]) for n in v} if k == "llm"
                  else rest)
    return out
