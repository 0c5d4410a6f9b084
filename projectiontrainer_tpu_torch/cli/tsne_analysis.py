"""t-SNE visualization of SigLIP embeddings by class, with the per-epoch sweep.

Counterpart of ``projectiontrainer_tpu/cli/tsne_analysis.py``, with the same flags plus
``--device``: ``--model_name`` plots one SigLIP snapshot; ``--epochs_root`` points at a
stage-0 output directory and plots every exported ``epoch_N``/``best_model`` HF snapshot
in it, so the class separation can be followed over training.

    python -m projectiontrainer_tpu_torch.cli.tsne_analysis --epochs_root s0out \\
        --data_json data.json --image_root images --output plots/

The tower is stored in bf16 (the kernels' type on the card), the projector of
``--projector_path`` in fp32. The t-SNE needs sklearn, which raises its ImportError
where it is missing.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch

from projectiontrainer_tpu_torch.checkpoint import hf_import
from projectiontrainer_tpu_torch.data import datasets, image as I
from projectiontrainer_tpu_torch.eval import tsne
from projectiontrainer_tpu_torch.utils.logging import setup_logging


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_name", type=str, default=None,
                   help="Single local SigLIP snapshot dir")
    p.add_argument("--epochs_root", type=str, default=None,
                   help="Sweep mode: a Stage-0 output dir; every epoch_N/ and "
                        "best_model/ HF snapshot inside gets its own plot")
    p.add_argument("--data_json", type=str, required=True)
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--image_root_2", type=str, default=None)
    p.add_argument("--classes", type=str,
                   default="No Finding,Atelectasis,Cardiomegaly,Effusion")
    p.add_argument("--img_size", type=int, default=384)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_samples_per_class", type=int, default=200)
    p.add_argument("--projector_path", type=str, default=None,
                   help="Optional: also embed through the Stage-1 projector")
    p.add_argument("--output", type=str, default="tsne.png",
                   help="Output image (single mode) or directory (sweep mode)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda")
    return p


def _epoch_snapshot_dirs(root: str) -> list[tuple[str, str]]:
    """(tag, dir) for every HF snapshot under a Stage-0 output dir, epochs sorted."""
    out = []
    for d in sorted(os.listdir(root)):
        full = os.path.join(root, d)
        if not os.path.isdir(full) or not os.path.exists(os.path.join(full, "config.json")):
            continue
        if re.fullmatch(r"epoch_\d+", d) or d == "best_model":
            out.append((d, full))
    out.sort(key=lambda td: (0, int(td[0][6:])) if td[0].startswith("epoch_") else (1, 0))
    return out


def run_one(model_dir: str, args, samples, classes, logger, output: str) -> str:
    device = torch.device(args.device)
    cfg, params = hf_import.load_siglip_vision(model_dir, device=device, dtype=torch.bfloat16,
                                               head=True)

    def batches():
        for i in range(0, len(samples), args.batch_size):
            yield np.stack([
                I.preprocess(I.load_image(I.resolve_image_path(s["image"], args.image_root,
                                                               args.image_root_2)),
                             args.img_size)
                for s in samples[i:i + args.batch_size]
            ])

    projector_params = None
    if args.projector_path:
        _, projector_params = hf_import.load_projector(args.projector_path, device=device,
                                                       dtype=torch.float32)
    emb = tsne.compute_image_embeddings(params, cfg, batches(),
                                        projector_params=projector_params)
    pts = tsne.tsne_2d(emb, seed=args.seed)
    tsne.plot_tsne(pts, [str(s["normal_caption"]) for s in samples], output)
    logger.info("wrote %s", output)
    return output


def main(argv=None):
    args = build_parser().parse_args(argv)
    logger = setup_logging()
    if bool(args.model_name) == bool(args.epochs_root):
        raise SystemExit("exactly one of --model_name / --epochs_root is required")

    classes = [c.strip() for c in args.classes.split(",")]
    samples = tsne.balance_classes(datasets.load_manifest(args.data_json), classes,
                                   seed=args.seed)
    samples = samples[: args.max_samples_per_class * len(classes)]
    logger.info("embedding %d balanced samples over %d classes", len(samples), len(classes))

    if args.model_name:
        return run_one(args.model_name, args, samples, classes, logger, args.output)

    snapshots = _epoch_snapshot_dirs(args.epochs_root)
    if not snapshots:
        raise SystemExit(f"no epoch_N/best_model HF snapshots under {args.epochs_root}")
    os.makedirs(args.output, exist_ok=True)
    return [run_one(model_dir, args, samples, classes, logger,
                    os.path.join(args.output, f"tsne_{tag}.png"))
            for tag, model_dir in snapshots]


if __name__ == "__main__":
    main()
