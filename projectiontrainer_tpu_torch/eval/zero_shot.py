"""Zero-shot SigLIP classification (no trained head).

Counterpart of ``projectiontrainer_tpu/eval/zero_shot.py``: each image is scored
against one prompt a class through the dual tower's ``normalized_logits`` (HF
``logits_per_image`` semantics), softmax over the classes; accuracy against
(possibly comma-separated multi-label) ground truth. The prompt templates are the
reference's three styles.

The class prompts' text embeddings are encoded ONCE, when the classifier is built:
they do not depend on the image, so each ``predict`` runs the vision tower only. The
JAX package re-runs the text tower inside every jitted call; the probabilities are
the same. As in ``siglip.text_forward``, the prompts pad to ``max_text_len`` and the
text tower runs without an attention mask, pooling the last position.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from projectiontrainer_tpu_torch.models import siglip

PROMPT_TEMPLATES = {
    "xray": "This X-ray shows {label}.",
    "photo": "This is a photo of {label}.",
    "plain": "{label}",
}


def build_prompts(class_names: Sequence[str], template: str = "xray") -> list[str]:
    """One prompt a class; ``template`` names a PROMPT_TEMPLATES entry or is a format
    string with ``{label}``."""
    tmpl = PROMPT_TEMPLATES.get(template, template)
    return [tmpl.format(label=c) for c in class_names]


class ZeroShotClassifier:
    def __init__(self, cfg: siglip.SiglipConfig, params, tokenizer, class_names,
                 *, template: str = "xray", max_text_len: int = 64):
        self.cfg = cfg
        self.params = params
        self.class_names = list(class_names)
        enc = tokenizer(build_prompts(class_names, template), padding="max_length",
                        truncation=True, max_length=max_text_len)
        device = params["text"]["token_embedding"]["embedding"].device
        self.class_ids = torch.as_tensor(np.asarray(enc["input_ids"], np.int64), device=device)
        with torch.no_grad():
            _, self.text_embeds = siglip.text_forward(params["text"], cfg.text, self.class_ids)

    @torch.no_grad()
    def logits(self, pixel_values) -> torch.Tensor:
        """[B, H, W, C] pixels -> fp32 logits [B, C] on the params' device."""
        w = self.params["vision"]["patch_embedding"]["weight"]
        pixels = torch.as_tensor(np.asarray(pixel_values)).to(device=w.device, dtype=w.dtype)
        _, img = siglip.vision_forward(self.params["vision"], self.cfg.vision, pixels)
        return siglip.normalized_logits(img, self.text_embeds, self.params["logit_scale"],
                                        self.params["logit_bias"])

    def predict(self, pixel_values) -> tuple[np.ndarray, np.ndarray]:
        """Returns (probs [B, C], predicted class indices [B])."""
        probs = torch.softmax(self.logits(pixel_values), dim=-1).cpu().numpy()
        return probs, probs.argmax(-1)

    def evaluate(self, batches, *, label_key: str = "class_idx") -> dict:
        preds, targets = [], []
        for batch in batches:
            _, p = self.predict(batch["pixel_values"])
            preds.append(p)
            targets.append(np.asarray(batch[label_key]))
        preds = np.concatenate(preds)
        targets = np.concatenate(targets)
        return {"accuracy": float((preds == targets).mean()), "n": int(len(preds))}


def multi_label_accuracy(predicted_labels: Sequence[str],
                         ground_truth: Sequence[str]) -> float:
    """The reference's comma-separated ground truth: a prediction is right when it is
    ANY of the comma-separated labels (case and surrounding spaces ignored)."""
    hits = 0
    for pred, gt in zip(predicted_labels, ground_truth):
        gt_set = {g.strip().lower() for g in str(gt).split(",")}
        hits += int(pred.strip().lower() in gt_set)
    return hits / max(1, len(predicted_labels))
