"""t-SNE embedding analysis of SigLIP vision features by class.

Counterpart of ``projectiontrainer_tpu/eval/tsne.py``: filter a manifest to a class
subset and balance it to the smallest class (the same ``default_rng(seed)`` draws, so
the same samples), embed through the vision tower's pooled output (the MAP head) or
through the stage-1 projector (the mean over patches 1:), 2-D t-SNE (sklearn) and a
scatter plot per class (matplotlib). sklearn and matplotlib are imported inside the
functions that need them; the card's machine has no sklearn, and ``tsne_2d`` raises
its ImportError there.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from projectiontrainer_tpu_torch.models import projector as proj_mod
from projectiontrainer_tpu_torch.models import siglip


def balance_classes(samples: Sequence[dict], classes: Sequence[str], *, seed: int = 42,
                    label_key: str = "normal_caption") -> list[dict]:
    """Filter to ``classes`` and subsample each to the minimum class count."""
    rng = np.random.default_rng(seed)
    by_class = {c: [s for s in samples if str(s.get(label_key, "")).strip() == c]
                for c in classes}
    n_min = min((len(v) for v in by_class.values() if v), default=0)
    out = []
    for group in by_class.values():
        idx = rng.choice(len(group), size=min(n_min, len(group)), replace=False)
        out.extend(group[i] for i in idx)
    return out


@torch.no_grad()
def compute_image_embeddings(params, cfg: siglip.VisionConfig, batches,
                             *, projector_params=None) -> np.ndarray:
    """[N, D] fp32 embeddings of every image of ``batches`` (arrays [B, H, W, C]): the
    pooled MAP-head output (the mean of the last hidden state for a tower without a
    head), or with ``projector_params`` the projector over patches 1: averaged over
    them."""
    w = params["patch_embedding"]["weight"]
    out = []
    for pixel_values in batches:
        pixels = torch.as_tensor(np.asarray(pixel_values)).to(device=w.device, dtype=w.dtype)
        hidden, pooled = siglip.vision_forward(params, cfg, pixels)
        if projector_params is not None:
            emb = proj_mod.forward(projector_params, hidden[:, 1:, :]).mean(dim=1)
        else:
            emb = pooled if pooled is not None else hidden.mean(dim=1)
        out.append(emb.float().cpu().numpy())
    return np.concatenate(out)


def tsne_2d(embeddings: np.ndarray, *, seed: int = 42, perplexity: float = 30.0) -> np.ndarray:
    from sklearn.manifold import TSNE

    perplexity = min(perplexity, max(2.0, (len(embeddings) - 1) / 3))
    return TSNE(n_components=2, random_state=seed, perplexity=perplexity,
                init="pca").fit_transform(embeddings)


def plot_tsne(points: np.ndarray, labels: Sequence[str], out_path: str,
              *, title: str = "t-SNE of SigLIP embeddings"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    for c in sorted(set(labels)):
        mask = np.asarray([label == c for label in labels])
        ax.scatter(points[mask, 0], points[mask, 1], s=12, alpha=0.7, label=c)
    ax.legend()
    ax.set_title(title)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
