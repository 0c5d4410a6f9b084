"""VLM assembly for generation: vision tower -> projector -> decoder prefix.

Counterpart of ``projectiontrainer_tpu/models/vlm.py``. The visual tokens are the
tower's last hidden state with patch 0 dropped (the reference's "discard CLS" quirk,
kept on purpose), projected into the decoder's embedding space.
"""

from __future__ import annotations

import dataclasses

import torch

from projectiontrainer_tpu_torch.models import decoder as dec
from projectiontrainer_tpu_torch.models import projector as proj
from projectiontrainer_tpu_torch.models import siglip


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    vision: siglip.VisionConfig
    projector: proj.ProjectorConfig
    llm: dec.DecoderConfig
    drop_first_patch: bool = True  # the reference's "discard CLS" quirk


def num_visual_tokens(cfg: VLMConfig) -> int:
    n = cfg.vision.num_patches
    return n - 1 if cfg.drop_first_patch else n


def init(gen: torch.Generator, cfg: VLMConfig, *, device=None,
         tower_dtype=torch.float32, projector_dtype=torch.float32):
    """Random VLM parameters from one generator (distributed like the JAX ``init``;
    the numbers differ). Serving stores the towers in bf16 and the projector in fp32
    (``train/setup.py:build_vlm``)."""
    return {
        "vision": siglip.init_vision(gen, cfg.vision, tower_dtype, device),
        "projector": proj.init(gen, cfg.projector, projector_dtype, device),
        "llm": dec.init(gen, cfg.llm, tower_dtype, device),
    }


@torch.no_grad()
def visual_embeds(params, cfg: VLMConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] pixels -> projected visual embeddings [B, V, llm_dim]. The tower
    runs in its stored type: pixels are cast to it."""
    w = params["vision"]["patch_embedding"]["weight"]
    hidden = siglip.vision_forward(params["vision"], cfg.vision, pixel_values.to(w.dtype))
    if cfg.drop_first_patch:
        hidden = hidden[:, 1:, :]
    return proj.forward(params["projector"], hidden)


@torch.no_grad()
def question_prefix(params, cfg: VLMConfig, pixel_values: torch.Tensor,
                    question_ids: torch.Tensor, pad_token_id: int):
    """[visual; question] generation prefix -> (embeds [B, P, D], mask [B, P] int32).
    ``question_ids`` must be LEFT-padded, so the last slot is the last real token."""
    visual = visual_embeds(params, cfg, pixel_values)
    q_emb = dec.embed(params["llm"], cfg.llm, question_ids).to(visual.dtype)
    embeds = torch.cat([visual, q_emb], dim=1)
    mask = torch.cat([
        torch.ones(visual.shape[:2], dtype=torch.int32, device=visual.device),
        (question_ids != pad_token_id).to(torch.int32),
    ], dim=1)
    return embeds, mask
