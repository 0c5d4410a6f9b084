"""Freezing policies as label trees over the params.

Counterpart of ``projectiontrainer_tpu/train/masks.py`` for stage 1: ``stage1_labels``
(train the projector, freeze the vision tower and the LLM) and ``bool_mask``. The
train step turns the mask into ``requires_grad`` flags: only trainable leaves get
gradients and optimizer state.
"""

from __future__ import annotations

from typing import Mapping

from projectiontrainer_tpu_torch.core.pytree import map_with_path

FROZEN = "frozen"
TRAINABLE = "trainable"


def stage1_labels(params) -> Mapping:
    """Train the projector; freeze the vision tower and the LLM."""
    return map_with_path(lambda p, _: TRAINABLE if p.startswith("projector/") else FROZEN,
                         params)


def bool_mask(labels) -> Mapping:
    """Labels -> bool trainable mask (anything not FROZEN trains)."""
    return map_with_path(lambda _, label: label != FROZEN, labels)
