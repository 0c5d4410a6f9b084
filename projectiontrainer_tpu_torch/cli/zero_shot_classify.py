"""Zero-shot SigLIP classification over a manifest (no trained head).

Counterpart of ``projectiontrainer_tpu/cli/zero_shot_classify.py``, with the same flags
plus ``--device``: prompt-template scoring through the dual tower's logits (the class
prompts encoded once), accuracy against (comma-separated) ground-truth labels.

    python -m projectiontrainer_tpu_torch.cli.zero_shot_classify --model_name SIGLIP_DIR \\
        --data_json data.json --image_root images --class_names "Edema,No Finding"

Both towers are stored in bf16, the type the attention and LayerNorm kernels take on
the card; the logit scale and bias stay fp32.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from projectiontrainer_tpu_torch.checkpoint import hf_import
from projectiontrainer_tpu_torch.data import datasets, image as I
from projectiontrainer_tpu_torch.eval import zero_shot
from projectiontrainer_tpu_torch.train import setup
from projectiontrainer_tpu_torch.utils.logging import setup_logging


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_name", type=str, required=True, help="Local SigLIP snapshot dir")
    p.add_argument("--data_json", type=str, required=True)
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--image_root_2", type=str, default=None)
    p.add_argument("--class_names", type=str, required=True, help="Comma-separated")
    p.add_argument("--template", type=str, default="xray",
                   choices=list(zero_shot.PROMPT_TEMPLATES) + ["custom"])
    p.add_argument("--custom_template", type=str, default=None)
    p.add_argument("--img_size", type=int, default=384)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_text_len", type=int, default=64)
    p.add_argument("--output_json", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logger = setup_logging()

    cfg, params = hf_import.load_siglip(args.model_name, device=torch.device(args.device),
                                        vision_dtype=torch.bfloat16,
                                        text_dtype=torch.bfloat16)
    tokenizer = setup.load_tokenizer(args.model_name)
    class_names = [c.strip() for c in args.class_names.split(",") if c.strip()]
    template = args.custom_template if args.template == "custom" else args.template
    clf = zero_shot.ZeroShotClassifier(cfg, params, tokenizer, class_names, template=template,
                                       max_text_len=args.max_text_len)

    samples = datasets.load_manifest(args.data_json)
    predictions, gts = [], []
    for i in range(0, len(samples), args.batch_size):
        chunk = samples[i:i + args.batch_size]
        pixels = np.stack([
            I.preprocess(I.load_image(I.resolve_image_path(s["image"], args.image_root,
                                                           args.image_root_2)), args.img_size)
            for s in chunk
        ])
        _, pred_idx = clf.predict(pixels)
        predictions.extend(class_names[j] for j in pred_idx)
        gts.extend(str(s.get("normal_caption", "")) for s in chunk)

    acc = zero_shot.multi_label_accuracy(predictions, gts)
    logger.info("zero-shot accuracy: %.4f over %d samples", acc, len(predictions))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump({"accuracy": acc,
                       "predictions": [{**s, "predicted": p}
                                       for s, p in zip(samples, predictions)]}, f, indent=2)
    return acc


if __name__ == "__main__":
    main()
