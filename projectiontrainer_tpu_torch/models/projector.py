"""MLP projector: vision patch embeddings -> LLM embedding space.

Counterpart of ``projectiontrainer_tpu/models/projector.py``: ``Linear(v, ef*v) ->
exact GELU -> Linear(ef*v, llm)`` per patch. Its parameters stay fp32 over a bf16
tower output: each linear computes in fp32 and casts back to the input's type, as
JAX's dtype promotion does (``ops/layers.py:linear``). Under tensor parallelism
(``parallel/tensor_parallel.py``) fc1 is column-parallel (the rank's hidden columns)
and fc2 row-parallel (all-reduced on exit, its bias added once after), as the JAX
rules shard them (``parallel/sharding.py:46-53`` there), where the model axis divides
the intermediate size; else it runs whole on every rank. Under ``--fsdp`` its leaves
are gathered where it runs (``parallel/fsdp.py``; the projector sits at ``projector/``
of the VLM tree).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from projectiontrainer_tpu_torch.ops import layers as L
from projectiontrainer_tpu_torch.parallel import distributed, fsdp, sharding
from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    vision_dim: int
    llm_dim: int
    expansion_factor: int = 10

    @property
    def intermediate_dim(self) -> int:
        return self.vision_dim * self.expansion_factor


def init(gen: torch.Generator, cfg: ProjectorConfig, dtype=torch.float32, device=None):
    return {
        "fc1": L.init_linear(gen, cfg.vision_dim, cfg.intermediate_dim, dtype=dtype,
                             device=device),
        "fc2": L.init_linear(gen, cfg.intermediate_dim, cfg.llm_dim, dtype=dtype,
                             device=device),
    }


def forward(params, x: torch.Tensor, cfg: Optional[ProjectorConfig] = None) -> torch.Tensor:
    """x [B, P, vision_dim] -> [B, P, llm_dim]; GELU is exact (torch nn.GELU default).
    ``cfg`` says whether a model axis splits the projector; without one it may be None."""
    params = fsdp.gather(params, "projector")
    if cfg is None and distributed.model_size() > 1:
        raise ValueError("projector.forward: the config is needed under a model axis")
    if cfg is not None and sharding.splits(cfg, "mlp"):
        h = L.gelu(tp.column_linear(params["fc1"], tp.copy_to_model(x)), approximate=False)
        return tp.row_linear(params["fc2"], h)
    h = L.gelu(L.linear(params["fc1"], x), approximate=False)
    return L.linear(params["fc2"], h)


def params_from_torch_state_dict(sd: dict, *, device=None, dtype=None) -> dict:
    """A reference ``projector_*.bin`` state dict (``model.{0,2}.{weight,bias}``,
    with or without the ``module.`` / ``model.`` prefixes) -> projector params."""
    clean = {}
    for k, v in sd.items():
        clean[k.removeprefix("module.").removeprefix("model.")] = torch.as_tensor(v).to(
            device=device, dtype=dtype)
    return {
        "fc1": {"weight": clean["0.weight"], "bias": clean["0.bias"]},
        "fc2": {"weight": clean["2.weight"], "bias": clean["2.bias"]},
    }


def to_torch_state_dict(params) -> dict:
    """The reference's ``model.{0,2}.{weight,bias}`` layout (CPU fp32 tensors)."""
    return {
        f"model.{i}.{k}": params[name][k].detach().float().cpu().contiguous()
        for i, name in ((0, "fc1"), (2, "fc2")) for k in ("weight", "bias")
    }


def config_dict(cfg: ProjectorConfig) -> dict:
    """The ``projector_config.json`` payload (reference: Stage1/projector_trainer.py:488-505)."""
    return {
        "vision_dim": cfg.vision_dim,
        "llm_dim": cfg.llm_dim,
        "intermediate_dim": cfg.intermediate_dim,
        "expansion_factor": cfg.expansion_factor,
        "projector_type": "mlp_2layer_gelu",
    }
