"""Single-checkpoint test report: confusion matrix, per-class stats, ROC-AUC, ROC plot.

Counterpart of ``projectiontrainer_tpu/cli/cls_test.py`` (reference:
cls_evaluate/test.py:39-345), plus ``--device``:

    python -m projectiontrainer_tpu_torch.cli.cls_test --exp_dir cls_experiments/EXP1 \\
        --checkpoint best --test_json ... --image_root ...

The classifier is rebuilt from the checkpoint alone: its architecture from the
``model_config`` the trainer embeds in every checkpoint's metadata, its weights by a
params-only restore (every leaf, tower included), its compute type from the training
config (``--mixed_precision``), so a checkpoint evaluated here gives the trainer's own
validation numbers on the same samples. The metrics are ``eval/metrics.py``'s (numpy);
sklearn and matplotlib are imported only for the micro-averaged AUC and ``--roc_plot``.
"""

from __future__ import annotations

import argparse

import numpy as np

from projectiontrainer_tpu_torch.core import dtypes
from projectiontrainer_tpu_torch.data import datasets
from projectiontrainer_tpu_torch.eval import metrics as M
from projectiontrainer_tpu_torch.train.trainer_cls import (classification_metrics,
                                                          load_classifier, predict)
from projectiontrainer_tpu_torch.utils.logging import setup_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir", type=str, required=True,
                   help="Experiment directory holding checkpoints/")
    p.add_argument("--checkpoint", type=str, default="best")
    p.add_argument("--test_json", type=str, required=True)
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--image_root_2", type=str, default=None)
    p.add_argument("--img_size", type=int, default=384)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--roc_plot", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    logger = setup_logging()

    cfg, model_cfg, params = load_classifier(args.exp_dir, args.checkpoint, device=args.device)
    names = cfg.effective_class_names()
    ds = datasets.ClassificationDataset(
        datasets.load_manifest(args.test_json), image_root=args.image_root, class_names=names,
        image_size=args.img_size, image_root_2=args.image_root_2,
        handle_abnormal=cfg.handle_abnormal, abnormal_source_classes=cfg.abnormal_source_classes)
    logits, targets = predict(params, model_cfg, ds, batch_size=args.batch_size,
                              device=args.device,
                              compute_dtype=dtypes.compute_dtype(cfg.mixed_precision))
    loss, acc, auc = classification_metrics(logits, targets)
    preds = logits.argmax(-1)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)

    cm = M.confusion_matrix(preds, targets, len(names))
    stats = M.per_class_stats(cm)
    logger.info("accuracy: %.4f", acc)
    logger.info("confusion matrix:\n%s", cm)
    for i, name in enumerate(names):
        logger.info("%-20s recall=%.3f precision=%.3f specificity=%.3f f1=%.3f",
                    name, stats["recall"][i], stats["precision"][i],
                    stats["specificity"][i], stats["f1"][i])
    logger.info("macro OVR AUC: %.4f", auc)
    try:
        from sklearn.metrics import roc_auc_score
        from sklearn.preprocessing import label_binarize

        y_bin = label_binarize(targets, classes=list(range(len(names))))
        if y_bin.shape[1] == 1:
            y_bin = np.hstack([1 - y_bin, y_bin])
        logger.info("micro OVR AUC: %.4f",
                    roc_auc_score(y_bin, probs, average="micro", multi_class="ovr"))
    except Exception as e:  # no sklearn (the card's machine), or one class only
        logger.warning("micro AUC unavailable: %s", e)

    if args.roc_plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.metrics import roc_curve

        fig, ax = plt.subplots(figsize=(7, 7))
        for i, name in enumerate(names):
            mask = (targets == i).astype(int)
            if mask.sum() in (0, len(mask)):
                continue
            fpr, tpr, _ = roc_curve(mask, probs[:, i])
            ax.plot(fpr, tpr, label=name)
        ax.plot([0, 1], [0, 1], "k--", alpha=0.4)
        ax.set_xlabel("FPR")
        ax.set_ylabel("TPR")
        ax.legend()
        fig.savefig(args.roc_plot, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return {"loss": loss, "accuracy": acc, "auc": auc, "confusion_matrix": cm.tolist()}


if __name__ == "__main__":
    main()
