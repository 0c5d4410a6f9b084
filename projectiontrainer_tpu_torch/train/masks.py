"""Freezing policies as label trees over the params.

Counterpart of ``projectiontrainer_tpu/train/masks.py`` for stages 0 and 1:
``stage1_labels`` (train the projector, freeze the vision tower and the LLM),
``stage0_labels`` (train the dual tower but for the frozen text tower, logit scale and
first vision layers) and ``bool_mask``. The train step turns the mask into
``requires_grad`` flags: only trainable leaves get gradients and optimizer state.
"""

from __future__ import annotations

from typing import Mapping, Optional

from projectiontrainer_tpu_torch.core.pytree import map_with_path

FROZEN = "frozen"
TRAINABLE = "trainable"


def stage1_labels(params) -> Mapping:
    """Train the projector; freeze the vision tower and the LLM."""
    return map_with_path(lambda p, _: TRAINABLE if p.startswith("projector/") else FROZEN,
                         params)


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


def bool_mask(labels) -> Mapping:
    """Labels -> bool trainable mask (anything not FROZEN trains)."""
    return map_with_path(lambda _, label: label != FROZEN, labels)
