"""Balanced random sampling of a QA manifest into a new JSON file.

Counterpart of ``projectiontrainer_tpu/cli/balanced_sample.py`` (reference:
Stage2/balanced_random_sample.py:16-73): keep the samples whose ``normal_caption``
EXACTLY matches one of the candidate labels, split ``--sample_size`` evenly across the
labels (earlier labels take the remainder), sample each group from a seeded
``random.Random``, shuffle, and write the result: the JAX CLI's output, sample for
sample. (``data/datasets.py``'s ``balanced_sample`` is the library form with a per-label
count and numpy's generator; it draws other samples.)

    python -m projectiontrainer_tpu_torch.cli.balanced_sample \\
        --input_json formatted_Class_QA.json \\
        --candidate_labels "Atelectasis, No Finding" \\
        --output_path filtered_formatted_Class_QA.json --sample_size 100
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
import os
import random

from projectiontrainer_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("projectiontrainer_tpu_torch")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_json", type=str, required=True,
                   help="Source QA manifest (list of {image, problem, normal_caption})")
    p.add_argument("--candidate_labels", type=str, required=True,
                   help="Comma-separated exact labels, e.g. 'Atelectasis, No Finding'")
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--sample_size", type=int, default=100,
                   help="TOTAL number of samples across all labels")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--label_key", type=str, default="normal_caption")
    return p


def balanced_random_sample(data, candidate_labels, sample_size, seed,
                           label_key="normal_caption"):
    """The reference's selection: the budget split evenly, earlier labels take the
    remainder, each group's draw capped at what it has, a final shuffle; all from
    ``random.Random(seed)``."""
    rng = random.Random(seed)
    filtered = [item for item in data if item.get(label_key) in candidate_labels]
    log.info("found %d entries with exact matches to %s", len(filtered), candidate_labels)

    groups = collections.defaultdict(list)
    for item in filtered:
        groups[item[label_key]].append(item)

    per_label = sample_size // len(candidate_labels)
    remainder = sample_size % len(candidate_labels)
    out = []
    for i, label in enumerate(candidate_labels):
        if label not in groups:
            log.warning("no samples found for label %r", label)
            continue
        n = min(per_label + (1 if i < remainder else 0), len(groups[label]))
        out.extend(rng.sample(groups[label], n))
        log.info("sampled %d images for label %r", n, label)
    rng.shuffle(out)
    return out


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)
    labels = [s.strip() for s in args.candidate_labels.split(",")]
    with open(args.input_json) as f:
        data = json.load(f)
    out = balanced_random_sample(data, labels, args.sample_size, args.seed,
                                 label_key=args.label_key)
    os.makedirs(os.path.dirname(os.path.abspath(args.output_path)), exist_ok=True)
    with open(args.output_path, "w") as f:
        json.dump(out, f, indent=4)
    log.info("wrote %d balanced samples to %s", len(out), args.output_path)
    return out


if __name__ == "__main__":
    main()
