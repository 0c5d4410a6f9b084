"""Checkpoint sweep: evaluate every saved checkpoint of a cls experiment on a test set.

Counterpart of ``projectiontrainer_tpu/cli/cls_evaluate_experiment.py`` (reference:
cls_evaluate/evaluate_experiment.py:258-411), plus ``--device``: per-checkpoint
metrics, the best epoch from results.tsv (AUC, accuracy where the AUC is NaN), the
machine-readable BEST_RESULT line and a metric-vs-epoch plot.
"""

from __future__ import annotations

import argparse
import json
import os

from projectiontrainer_tpu_torch.eval import sweep
from projectiontrainer_tpu_torch.utils.logging import setup_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_id", type=str, required=True)
    p.add_argument("--output_base_dir", type=str, required=True)
    p.add_argument("--test_json", type=str, default=None,
                   help="Test manifest; omit to just summarize results.tsv")
    p.add_argument("--image_root", type=str, default=None)
    p.add_argument("--image_root_2", type=str, default=None)
    p.add_argument("--img_size", type=int, default=384)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--plot", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    logger = setup_logging()

    exp_dir = os.path.join(args.output_base_dir, args.exp_id)
    results = []
    if args.test_json:
        from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
        from projectiontrainer_tpu_torch.core.config import ClsConfig
        from projectiontrainer_tpu_torch.data import datasets

        # the class names come from the training config in the newest checkpoint
        mgr = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
        latest = mgr.latest_epoch()
        meta = mgr.metadata("best" if latest is None else f"epoch_{latest}")
        cfg = ClsConfig(**json.loads(meta["config"]))
        names = cfg.effective_class_names()
        common = dict(image_root=args.image_root or cfg.image_root, class_names=names,
                      image_size=args.img_size, image_root_2=args.image_root_2)
        samples = datasets.load_manifest(args.test_json)
        if cfg.multilabel_two_way:
            test_ds = datasets.MultiLabelClassificationDataset(samples, **common)
        else:
            test_ds = datasets.ClassificationDataset(
                samples, handle_abnormal=cfg.handle_abnormal,
                abnormal_source_classes=cfg.abnormal_source_classes, **common)
        results = sweep.evaluate_all_checkpoints(exp_dir, test_ds, batch_size=args.batch_size,
                                                 device=args.device)
        for r in results:
            logger.info("%s: acc=%.4f auc=%.4f loss=%.4f",
                        r["checkpoint"], r["accuracy"], r["auc"], r["loss"])
        if args.plot and results:
            sweep.plot_metrics_vs_epoch(results, args.plot)

    return {"results": results, "best": sweep.emit_best_result(args.exp_id, exp_dir)}


if __name__ == "__main__":
    main()
