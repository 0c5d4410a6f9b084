"""VLM assembly: vision tower -> projector -> decoder inputs, for training and for
generation.

Counterpart of ``projectiontrainer_tpu/models/vlm.py``. The visual tokens are the
tower's last hidden state with patch 0 dropped (the reference's "discard CLS" quirk,
kept on purpose), projected into the decoder's embedding space; the tower trains when
any of its leaves requires grad (stage 2's epoch 0). Stage 1's sequence is
[visual; caption], labels -100 on the visual tokens and on caption padding, the
attention mask ones on the visual tokens and ``caption != pad`` after them.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
from projectiontrainer_tpu_torch.models import decoder as dec
from projectiontrainer_tpu_torch.models import projector as proj
from projectiontrainer_tpu_torch.models import siglip
from projectiontrainer_tpu_torch.utils.timing import span

IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    vision: siglip.VisionConfig
    projector: proj.ProjectorConfig
    llm: dec.DecoderConfig
    drop_first_patch: bool = True  # the reference's "discard CLS" quirk


def full_joint_4b_config(**llm_kw) -> VLMConfig:
    """BASELINE config #4's model: the XraySigLIP ViT-L/16-384 tower, the projector
    1024 -> 10240 -> 2560 and Gemma3-4B (``decoder.gemma3_4b_config``; ``llm_kw``
    overrides its fields, ``num_layers`` to cut the depth): the port's copy of the JAX
    package's ``parallel/budget.py:full_joint_4b_vlm_cfg``."""
    vis = siglip.vit_l_16_384()
    llm = dec.gemma3_4b_config(**llm_kw)
    return VLMConfig(vision=vis, llm=llm, projector=proj.ProjectorConfig(
        vision_dim=vis.hidden_size, llm_dim=llm.hidden_size, expansion_factor=10))


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


def visual_embeds(params, cfg: VLMConfig, pixel_values: torch.Tensor, *,
                  remat: Union[bool, int] = False) -> torch.Tensor:
    """[B, H, W, C] pixels -> projected visual embeddings [B, V, llm_dim].

    The tower runs in its stored type (pixels are cast to it). A frozen tower runs
    under ``torch.no_grad``; when any tower leaf requires grad (stage 2's
    ``--train_ve_first_epoch``, epoch 0) it runs with autograd, ``remat`` recomputing
    its layers in the backward (``siglip.vision_forward``)."""
    trains = any(x.requires_grad for _, x in leaves_with_paths(params["vision"]))
    w = params["vision"]["patch_embedding"]["weight"]
    with torch.set_grad_enabled(trains and torch.is_grad_enabled()), span("tower"):
        hidden, _ = siglip.vision_forward(params["vision"], cfg.vision,
                                          pixel_values.to(w.dtype), remat=remat)
    if cfg.drop_first_patch:
        hidden = hidden[:, 1:, :]
    with span("projector"):
        return proj.forward(params["projector"], hidden, cfg.projector)


@torch.no_grad()
def visual_prefix(params, cfg: VLMConfig, pixel_values: torch.Tensor):
    """Visual-only generation prefix -> (embeds [B, V, D], all-ones mask [B, V] int32):
    stage 1 generates captions from the visual tokens alone."""
    visual = visual_embeds(params, cfg, pixel_values)
    return visual, torch.ones(visual.shape[:2], dtype=torch.int32, device=visual.device)


def build_sequence(params, cfg: VLMConfig, visual: torch.Tensor, *, pad_token_id: int,
                   caption_ids=None, question_ids=None, answer_ids=None):
    """Concatenated embeds, attention mask and labels for the CLM loss ->
    (inputs_embeds [B, T, D], attention_mask [B, T] int32, labels [B, T] int64).

    Text segments go through the decoder's (scaled) embedding table in the visual
    embeddings' type. Captions and answers are supervised (pad -> -100); questions
    are not (all -100)."""
    b, v, _ = visual.shape
    dev = visual.device
    embeds = [visual]
    masks = [torch.ones((b, v), dtype=torch.int32, device=dev)]
    labels = [torch.full((b, v), IGNORE_INDEX, dtype=torch.int64, device=dev)]
    for ids, supervised in ((caption_ids, True), (question_ids, False), (answer_ids, True)):
        if ids is None:
            continue
        ids = ids.to(device=dev, dtype=torch.int64)
        embeds.append(dec.embed(params["llm"], cfg.llm, ids).to(visual.dtype))
        masks.append((ids != pad_token_id).to(torch.int32))
        labels.append(torch.where(ids == pad_token_id, IGNORE_INDEX, ids) if supervised
                      else torch.full_like(ids, IGNORE_INDEX))
    return torch.cat(embeds, dim=1), torch.cat(masks, dim=1), torch.cat(labels, dim=1)


def forward_logits(params, cfg: VLMConfig, inputs_embeds, attention_mask, *,
                   remat: Union[bool, int] = False, lora_cfg=None) -> torch.Tensor:
    """The decoder over a built sequence -> fp32 logits [B, T, V]; with ``lora_cfg``,
    through the adapters at ``params['lora']`` (unmerged, no dropout)."""
    lora = params.get("lora") if lora_cfg is not None else None
    hidden, _ = dec.forward(params["llm"], cfg.llm, inputs_embeds=inputs_embeds,
                            attention_mask=attention_mask, remat=remat, lora=lora,
                            lora_cfg=lora_cfg)
    return dec.logits(params["llm"], cfg.llm, hidden)


@torch.no_grad()
def question_prefix(params, cfg: VLMConfig, pixel_values: torch.Tensor,
                    question_ids: torch.Tensor, pad_token_id: int):
    """[visual; question] generation prefix -> (embeds [B, P, D], mask [B, P] int32).
    ``question_ids`` must be LEFT-padded, so the last slot is the last real token. The
    decoder does not run here (the embedding table only), so LoRA adapters, merged or
    not, play no part in the prefix."""
    visual = visual_embeds(params, cfg, pixel_values)
    q_emb = dec.embed(params["llm"], cfg.llm, question_ids).to(visual.dtype)
    embeds = torch.cat([visual, q_emb], dim=1)
    mask = torch.cat([
        torch.ones(visual.shape[:2], dtype=torch.int32, device=visual.device),
        (question_ids != pad_token_id).to(torch.int32),
    ], dim=1)
    return embeds, mask
