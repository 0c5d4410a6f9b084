"""Abnormality classifier: SigLIP vision tower + per-class query cross-attention head.

Counterpart of ``projectiontrainer_tpu/models/classifier.py`` (the reference's
``AbnormalityClassifier``, cls_evaluate/models.py:107-139): learnable per-class query
vectors cross-attend (16-head MHA, torch semantics) over the tower's patch features;
a shared ``Linear(d, 1)`` scores each attended query -> per-class logits. Dropout on
the attended queries in training.

The tower runs the port's kernels (K1, K2; K4, K5, K8 in its backward when it
trains), inside the span ``vision``; the head (C queries against every patch, no
self-attention shape) runs the plain ``dot_product_attention``, as the JAX package
runs it on its XLA path, inside the span ``head``. A snapshot's MAP head, which the
classifier never reads, stays in the params (so it is saved, and under ``Unfreeze``
AdamW's decay moves it as in JAX) but is not run. Under ``--fsdp`` the tower gathers
its data shards as it runs and the head's leaves are gathered where the head runs
(``parallel/fsdp.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from projectiontrainer_tpu_torch.models import siglip
from projectiontrainer_tpu_torch.ops import layers as L
from projectiontrainer_tpu_torch.ops.attention import dot_product_attention
from projectiontrainer_tpu_torch.parallel import fsdp
from projectiontrainer_tpu_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    vision: siglip.VisionConfig
    num_classes: int
    num_heads: int = 16
    dropout_rate: float = 0.1


def init(gen: torch.Generator, cfg: ClassifierConfig, dtype=torch.float32, device=None, *,
         vision: Optional[dict] = None):
    """Random parameters (distributed like the JAX ``init``; the numbers differ); a
    pretrained tower when ``vision`` is given (its leaves are used as they are)."""
    d = cfg.vision.hidden_size
    lin = lambda i, o: L.init_linear(gen, i, o, dtype=dtype, device=device)  # noqa: E731
    if vision is None:
        vision = siglip.init_vision(gen, cfg.vision, dtype, device, head=cfg.vision.use_head)
    return {
        "vision": vision,
        "queries": torch.randn((1, cfg.num_classes, d), generator=gen, device=device).to(dtype),
        "mha": {"q_proj": lin(d, d), "k_proj": lin(d, d), "v_proj": lin(d, d),
                "out_proj": lin(d, d)},
        "head": lin(d, 1),
    }


def dropout(h: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate`` and scaled by
    ``1 / (1 - rate)``, the mask drawn from ``gen`` (one seed, one mask)."""
    keep = torch.rand(h.shape, generator=gen, device=h.device) < 1.0 - rate
    return torch.where(keep, h / (1.0 - rate), torch.zeros((), dtype=h.dtype, device=h.device))


def forward(params, cfg: ClassifierConfig, pixel_values: torch.Tensor, *,
            dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """pixel_values [B, H, W, C] -> logits [B, num_classes]. Uses the FULL
    last_hidden_state (no token dropped, unlike the VLM path; the reference:
    cls_evaluate/models.py:131-139). ``dropout_gen`` turns dropout on."""
    tower = {k: v for k, v in params["vision"].items() if k != "head"}
    with span("vision"):
        features, _ = siglip.vision_forward(
            tower, cfg.vision, pixel_values.to(tower["patch_embedding"]["weight"].dtype))
    with span("head"):
        params = fsdp.gather({k: v for k, v in params.items() if k != "vision"}, "")
        b, t, d = features.shape
        c, nh = cfg.num_classes, cfg.num_heads
        mha = params["mha"]
        queries = params["queries"].to(features.dtype).expand(b, c, d)
        q = L.linear(mha["q_proj"], queries).reshape(b, c, nh, d // nh)
        k = L.linear(mha["k_proj"], features).reshape(b, t, nh, d // nh)
        v = L.linear(mha["v_proj"], features).reshape(b, t, nh, d // nh)
        h = L.linear(mha["out_proj"], dot_product_attention(q, k, v).reshape(b, c, d))
        if dropout_gen is not None and cfg.dropout_rate > 0.0:
            h = dropout(h, cfg.dropout_rate, dropout_gen)
        return L.linear(params["head"], h)[..., 0]


def params_from_torch_state_dict(cfg: ClassifierConfig, sd, *, device=None,
                                 dtype=None) -> dict:
    """A reference ``.pth`` checkpoint's ``model_state_dict`` (tensors or numpy
    arrays): ``vision_model.*`` (an HF ``SiglipVisionModel``), ``abnormality_queries``,
    the MHA's packed ``in_proj_*`` split into q/k/v, ``mha.out_proj.*`` and
    ``classification_head.*``; torch's weights are already [out, in]."""
    d = cfg.vision.hidden_size
    get = lambda name: torch.as_tensor(np.asarray(sd[name])).to(  # noqa: E731
        device=device, dtype=dtype)
    vision_sd = {k[len("vision_model."):]: v for k, v in sd.items()
                 if k.startswith("vision_model.")}
    in_w, in_b = get("mha.in_proj_weight"), get("mha.in_proj_bias")
    return {
        "vision": siglip.vision_params(vision_sd, cfg.vision, device=device, dtype=dtype,
                                       prefix="vision_model", head=True),
        "queries": get("abnormality_queries"),
        "mha": {
            name: {"weight": in_w[i * d:(i + 1) * d].clone(), "bias": in_b[i * d:(i + 1) * d].clone()}
            for i, name in enumerate(("q_proj", "k_proj", "v_proj"))
        } | {"out_proj": {"weight": get("mha.out_proj.weight"), "bias": get("mha.out_proj.bias")}},
        "head": {"weight": get("classification_head.weight"),
                 "bias": get("classification_head.bias")},
    }
