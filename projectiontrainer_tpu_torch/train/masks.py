"""Freezing policies as label trees over the params.

Counterpart of ``projectiontrainer_tpu/train/masks.py`` for stages 0, 1 and 2:
``stage1_labels`` (train the projector, freeze the vision tower and the LLM),
``Stage2Freeze`` and ``stage2_labels`` (any subset of LLM or LoRA, projector and
tower; ``--train_ve_first_epoch`` swaps two label trees at the epoch-0 boundary),
``stage0_labels`` (train the dual tower but for the frozen text tower, logit scale and
first vision layers), ``classifier_labels`` (the cls probe: ``head`` and ``backbone``
at their own learning rates, or the tower ``frozen``) and ``bool_mask``. The train step
turns the mask into ``requires_grad`` flags: only trainable leaves get gradients and
optimizer state.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from projectiontrainer_tpu_torch.core.pytree import map_with_path

FROZEN = "frozen"
TRAINABLE = "trainable"


def stage1_labels(params) -> Mapping:
    """Train the projector; freeze the vision tower and the LLM."""
    return map_with_path(lambda p, _: TRAINABLE if p.startswith("projector/") else FROZEN,
                         params)


@dataclasses.dataclass(frozen=True)
class Stage2Freeze:
    """Derived freeze policy (reference: Stage2/train_vqa_stage2.py:121-134)."""

    train_llm: bool = True          # full LLM fine-tune (ignored when use_lora)
    use_lora: bool = False          # LoRA adapters are the only trainable LLM params
    train_projector: bool = False   # --unfreeze_projection_layer
    train_vision: bool = False      # epoch-0 state of --train_ve_first_epoch


def stage2_labels(params, policy: Stage2Freeze) -> Mapping:
    def label(p: str, _) -> str:
        if p.startswith("projector/"):
            return TRAINABLE if policy.train_projector else FROZEN
        if p.startswith("vision/"):
            return TRAINABLE if policy.train_vision else FROZEN
        if "/lora/" in p or p.startswith("lora/"):
            return TRAINABLE if policy.use_lora else FROZEN
        if p.startswith("llm/"):
            return TRAINABLE if (policy.train_llm and not policy.use_lora) else FROZEN
        return FROZEN

    return map_with_path(label, params)


def stage0_labels(params, *, freeze_text: bool = True, freeze_logit_scale: bool = True,
                  freeze_layers_ratio: float = 0.0,
                  num_vision_layers: Optional[int] = None) -> Mapping:
    """The full contrastive model; the text tower, ``logit_scale`` and the first
    ``int(num_vision_layers * freeze_layers_ratio)`` vision layers frozen (reference:
    Stage0/train_vision_encoder_stage0.py:555-576)."""
    n_freeze = 0
    if freeze_layers_ratio > 0.0 and num_vision_layers:
        n_freeze = int(num_vision_layers * freeze_layers_ratio)

    def label(p: str, _) -> str:
        if p.startswith("text/"):
            return FROZEN if freeze_text else TRAINABLE
        if p.startswith("logit_scale"):
            return FROZEN if freeze_logit_scale else TRAINABLE
        if p.startswith("vision/layers/") and int(p.split("/")[2]) < n_freeze:
            return FROZEN
        return TRAINABLE

    return map_with_path(label, params)


HEAD = "head"
BACKBONE = "backbone"


def classifier_labels(params, *, freeze_vision: bool) -> Mapping:
    """Labels {head, backbone, frozen}: the head trains at ``lr``, the tower at
    ``bb_lr`` (discriminative learning rates) or not at all."""
    return map_with_path(
        lambda p, _: (FROZEN if freeze_vision else BACKBONE) if p.startswith("vision/") else HEAD,
        params)


def bool_mask(labels) -> Mapping:
    """Labels -> bool trainable mask (anything not FROZEN trains)."""
    return map_with_path(lambda _, label: label != FROZEN, labels)
