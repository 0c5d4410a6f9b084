"""Experiment sweep runner: the reference's bash job scheduler as a Python CLI.

Counterpart of ``projectiontrainer_tpu/cli/run_experiments.py`` (reference:
cls_evaluate/run_experiments.sh + run_distributed_experiments.sh): launches the
default 6-experiment grid (or a JSON grid file) of ``cli/cls_train`` processes with
max-concurrency throttling, each on its own cards, then gathers the BEST_RESULT lines
into all_experiments_summary.tsv. Flags it does not know go to every ``cls_train``.
"""

from __future__ import annotations

import argparse
import json

from projectiontrainer_tpu_torch.eval import sweep


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_json", type=str, required=True)
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--image_root_2", type=str, default=None)
    p.add_argument("--output_base_dir", type=str, required=True)
    p.add_argument("--vision_model_name", type=str, required=True)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--bb_lr", type=float, default=1e-5)
    p.add_argument("--max_concurrent", type=int, default=None,
                   help="Concurrent experiment cap. Default: len(--device_slots) when "
                        "slots are given, else 1. An explicit value always wins.")
    p.add_argument("--device_slots", type=str, default=None,
                   help="';'-separated pool of slots, one job each: a slot is a card list "
                        "('0;1;2;3' = 4 jobs x 1 card, '0,1;2,3' = 2 jobs x 2 cards) or "
                        "'cpu' (--device cpu). A finished job's slot is reused at once.")
    p.add_argument("--grid_json", type=str, default=None,
                   help="Optional JSON list of [exp_id, classes, freeze_mode, "
                        "handle_abnormal, filter_no_finding]")
    args, extra = p.parse_known_args(argv)

    grid = sweep.DEFAULT_EXPERIMENT_GRID
    if args.grid_json:
        with open(args.grid_json) as f:
            grid = [tuple(row) for row in json.load(f)]

    slots = args.device_slots.split(";") if args.device_slots else None
    if args.max_concurrent is not None:
        max_concurrent = args.max_concurrent
    else:
        max_concurrent = len(slots) if slots else 1
    lines = sweep.run_experiment_grid(
        data_json=args.data_json, image_root=args.image_root, image_root_2=args.image_root_2,
        output_base_dir=args.output_base_dir, vision_model_name=args.vision_model_name,
        grid=grid, epochs=args.epochs, lr=args.lr, bb_lr=args.bb_lr,
        max_concurrent=max_concurrent, extra_args=extra, device_slots=slots)
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
