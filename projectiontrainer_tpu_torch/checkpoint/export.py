"""Projector export in the reference format.

Counterpart of ``projectiontrainer_tpu/checkpoint/export.py:save_projector``:
``projector_{tag}.bin`` (a torch state dict ``model.{0,2}.{weight,bias}``) plus
``projector_config.json``, readable by the reference, by the JAX package's
``load_projector`` and by ``checkpoint/hf_import.load_projector``.
"""

from __future__ import annotations

import json
import os

import torch

from projectiontrainer_tpu_torch.models import projector as proj


def save_projector(params, cfg: proj.ProjectorConfig, out_dir: str, *, tag: str = "final") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"projector_{tag}.bin")
    torch.save(proj.to_torch_state_dict(params), path)
    with open(os.path.join(out_dir, "projector_config.json"), "w") as f:
        json.dump(proj.config_dict(cfg), f, indent=2)
    return path
