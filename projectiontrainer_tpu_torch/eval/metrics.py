"""Evaluation metrics replicating the reference's definitions (the port's own copy of
the JAX package's ``eval/metrics.py``: numpy only; sklearn inside ``zero_shot_prf``
alone, since the card's machine has no sklearn: the AUROC repeats sklearn's
``roc_auc_score`` arithmetic in numpy, ``binary_auroc``).

- last-word accuracy: Stage-1 validation metric — the final whitespace token of the
  generated caption vs the target's (reference: Stage1/projector_trainer.py:386-407).
- substring-match accuracy: generation eval correctness = ground truth appears as a
  substring of the generation, case-insensitive (reference: inference_generation.py:95).
- accuracy + macro one-vs-rest AUROC for the classifier probe (reference:
  cls_evaluate/train_utils.py:73-92), confusion-based per-class stats and micro/macro AUC
  for the test reporter (cls_evaluate/test.py:225-312).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def last_word(text: str) -> str:
    words = text.strip().split()
    return words[-1] if words else ""


def last_word_accuracy(generated: Sequence[str], targets: Sequence[str]) -> float:
    if not generated:
        return 0.0
    hits = sum(
        last_word(g).strip(".,!?\"'").lower() == last_word(t).strip(".,!?\"'").lower()
        for g, t in zip(generated, targets)
    )
    return hits / len(generated)


def substring_accuracy(generated: Sequence[str], targets: Sequence[str]) -> float:
    """Correct iff the ground-truth string occurs in the generation (case-insensitive)."""
    if not generated:
        return 0.0
    hits = sum(t.strip().lower() in g.lower() for g, t in zip(generated, targets))
    return hits / len(generated)


def per_label_substring_accuracy(generated, targets) -> dict[str, tuple[int, int]]:
    """label -> (hits, total), the reference's per-class generation summary
    (inference_generation.py:150-181)."""
    out: dict[str, list[int]] = {}
    for g, t in zip(generated, targets):
        key = t.strip()
        hit = int(key.lower() in g.lower())
        agg = out.setdefault(key, [0, 0])
        agg[0] += hit
        agg[1] += 1
    return {k: (v[0], v[1]) for k, v in out.items()}


def accuracy(pred: np.ndarray, target: np.ndarray) -> float:
    return float((np.asarray(pred) == np.asarray(target)).mean())


def binary_auroc(y_true: np.ndarray, score: np.ndarray) -> float:
    """ROC-AUC of 0/1 labels against scores: sklearn's ``roc_auc_score`` step for
    step (the ROC points at each distinct score, collinear points dropped, the
    trapezoid rule), so it returns the same bits."""
    order = np.argsort(-np.asarray(score), kind="stable")
    s, y = np.asarray(score)[order], np.asarray(y_true)[order].astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(s))[0], len(s) - 1]
    tps = np.cumsum(y, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    if fps.shape[0] > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[keep], tps[keep]
    fpr, tpr = np.r_[0.0, fps] / fps[-1], np.r_[0.0, tps] / tps[-1]
    return float(np.add.reduce(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def macro_ovr_auroc(probs: np.ndarray, targets: np.ndarray,
                    num_classes: Optional[int] = None) -> float:
    """Macro-averaged one-vs-rest ROC-AUC over classes present in targets (sklearn
    semantics as used by the reference; classes absent from targets are skipped)."""
    probs = np.asarray(probs)
    targets = np.asarray(targets)
    num_classes = num_classes or probs.shape[1]
    aucs = []
    for c in range(num_classes):
        mask = targets == c
        if mask.all() or not mask.any():
            continue
        aucs.append(binary_auroc(mask.astype(int), probs[:, c]))
    return float(np.mean(aucs)) if aucs else float("nan")


def confusion_matrix(pred: np.ndarray, target: np.ndarray, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), np.int64)
    for t, p in zip(np.asarray(target), np.asarray(pred)):
        cm[t, p] += 1
    return cm


def per_class_stats(cm: np.ndarray) -> dict[str, np.ndarray]:
    """recall / precision / specificity / F1 per class from a confusion matrix
    (reference: cls_evaluate/test.py:225-263)."""
    tp = np.diag(cm).astype(float)
    fn = cm.sum(1) - tp
    fp = cm.sum(0) - tp
    tn = cm.sum() - tp - fn - fp
    with np.errstate(divide="ignore", invalid="ignore"):
        recall = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        precision = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        specificity = np.where(tn + fp > 0, tn / (tn + fp), 0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall), 0.0)
    return {"recall": recall, "precision": precision, "specificity": specificity, "f1": f1}


def zero_shot_prf(pred: np.ndarray, target: np.ndarray) -> dict[str, float]:
    """Accuracy + macro precision/recall/F1 (Stage-0 zero-shot validation metrics,
    reference: Stage0:432-446)."""
    from sklearn.metrics import precision_recall_fscore_support

    p, r, f, _ = precision_recall_fscore_support(
        target, pred, average="macro", zero_division=0
    )
    return {
        "accuracy": accuracy(pred, target),
        "precision": float(p),
        "recall": float(r),
        "f1": float(f),
    }
