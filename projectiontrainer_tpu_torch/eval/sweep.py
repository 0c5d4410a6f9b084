"""Checkpoint sweeper + experiment scheduler for cls_evaluate.

Counterpart of ``projectiontrainer_tpu/eval/sweep.py``, replacing two reference
components:

- ``evaluate_experiment.py`` (cls_evaluate/evaluate_experiment.py:58-411): evaluate
  every saved checkpoint of an experiment on a test set (the model rebuilt from the
  checkpoint alone, ``trainer_cls.load_classifier``), pick the best epoch from the
  training ``results.tsv`` (Val AUC, Val Acc when the AUC is NaN), print the
  machine-readable ``BEST_RESULT\\t...`` line and plot accuracy / AUC against epoch;
- the bash experiment grid and multi-GPU scheduler (run_experiments.sh:20-189,
  run_distributed_experiments.sh:26-272): ``run_experiment_grid`` launches each
  experiment as a ``projectiontrainer_tpu_torch.cli.cls_train`` process, throttled to
  ``max_concurrent``, each pinned to its own cards (``CUDA_VISIBLE_DEVICES``, the
  reference's round-robin) or to the CPU (slot ``'cpu'``: ``--device cpu``).
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np

# The reference's default 6-experiment grid (run_experiments.sh:168-189):
# (exp_id, class_names, freeze_mode, handle_abnormal, filter_no_finding)
DEFAULT_EXPERIMENT_GRID = (
    ("EXP1", "No Finding,Atelectasis,Cardiomegaly,Effusion", "Freeze", False, False),
    ("EXP2", "No Finding,Atelectasis", "Freeze", False, False),
    ("EXP3", "No Finding,Cardiomegaly", "Freeze", False, False),
    ("EXP4", "No Finding,Effusion", "Freeze", False, False),
    ("EXP5", "Atelectasis,Cardiomegaly,Effusion", "Freeze", False, True),
    ("EXP6", "No Finding,Atelectasis,Cardiomegaly,Effusion", "Freeze", True, False),
)


def read_results_tsv(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        header = f.readline().strip().split("\t")
        for line in f:
            vals = line.strip().split("\t")
            if len(vals) == len(header):
                rows.append(dict(zip(header, vals)))
    return rows


def best_epoch_from_results(results_tsv: str) -> tuple[int, float, float]:
    """The best epoch by Val AUC, by Val Acc where the AUC is NaN (reference:
    evaluate_experiment.py:289-336). Returns (epoch, acc, auc)."""
    rows = read_results_tsv(results_tsv)
    if not rows:
        raise ValueError(f"empty results file {results_tsv}")

    def key(row):
        auc = float(row.get("Val AUC", "nan"))
        acc = float(row.get("Val Acc", "nan"))
        return (not np.isnan(auc), auc if not np.isnan(auc) else acc, acc)

    best = max(rows, key=key)
    return int(best["Epoch"]), float(best.get("Val Acc", "nan")), float(best.get("Val AUC", "nan"))


def emit_best_result(exp_id: str, exp_dir: str, *, stream=None) -> str:
    """The line the reference's TSV aggregation greps for (evaluate_experiment.py:345,
    run_experiments.sh:137-148); its last field names the epoch's checkpoint, or the
    best one when that epoch was not kept."""
    epoch, acc, auc = best_epoch_from_results(os.path.join(exp_dir, "results.tsv"))
    ckpt = os.path.join(exp_dir, "checkpoints", f"epoch_{epoch}.pt")
    if not os.path.exists(ckpt):
        ckpt = os.path.join(exp_dir, "checkpoints", "best.pt")
    line = f"BEST_RESULT\t{exp_id}\t{epoch}\t{acc:.6f}\t{auc:.6f}\t{ckpt}"
    print(line, file=stream or sys.stdout)
    return line


def evaluate_all_checkpoints(exp_dir: str, test_dataset, *, batch_size: int = 32,
                             device="cuda") -> list[dict]:
    """Every ``epoch_N`` checkpoint of an experiment on a test dataset, each model
    rebuilt from its own checkpoint (architecture from the embedded metadata, the
    reference's pattern: evaluate_experiment.py:88-114)."""
    from projectiontrainer_tpu_torch.core import dtypes
    from projectiontrainer_tpu_torch.train import trainer_cls

    names = [m.group(1) for f in glob.glob(os.path.join(exp_dir, "checkpoints", "epoch_*.pt"))
             if (m := re.fullmatch(r"(epoch_\d+)\.pt", os.path.basename(f)))]
    results = []
    for name in sorted(names, key=lambda n: int(n[6:])):
        cfg, model_cfg, params = trainer_cls.load_classifier(exp_dir, name, device=device)
        logits, targets = trainer_cls.predict(
            params, model_cfg, test_dataset, batch_size=batch_size, device=device,
            compute_dtype=dtypes.compute_dtype(cfg.mixed_precision),
            target_key="targets" if cfg.multilabel_two_way else "target_indices")
        loss, acc, auc = trainer_cls.classification_metrics(
            logits, targets, multilabel=cfg.multilabel_two_way)
        results.append({"checkpoint": name, "epoch": int(name[6:]), "loss": loss,
                        "accuracy": acc, "auc": auc})
    return results


def plot_metrics_vs_epoch(results: Sequence[dict], out_path: str):
    """Accuracy/AUC-vs-epoch plot (reference: evaluate_experiment.py:364-402)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = [r["epoch"] for r in results]
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(epochs, [r["accuracy"] for r in results], "o-", label="Accuracy")
    ax.plot(epochs, [r["auc"] for r in results], "s-", label="AUC")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Metric")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def slot_env(slot: Optional[str]) -> dict:
    """The environment of a job on ``slot`` (the reference's ``CUDA_VISIBLE_DEVICES``
    round-robin, run_distributed_experiments.sh:239-241):

    - ``None``: inherited (one job owns every card);
    - ``'cpu'``: no card visible (the job also gets ``--device cpu``, ``slot_args``);
    - ``'0'`` / ``'1,2'``: those cards only, so concurrent experiments own disjoint
      cards."""
    env = dict(os.environ)
    if slot is not None:
        env["CUDA_VISIBLE_DEVICES"] = "" if slot == "cpu" else slot
    return env


def slot_args(slot: Optional[str]) -> list[str]:
    """The job's own flags for ``slot``: ``--device cpu`` on a CPU slot."""
    return ["--device", "cpu"] if slot == "cpu" else []


def run_experiment_grid(
    *,
    data_json: str,
    image_root: str,
    output_base_dir: str,
    vision_model_name: str,
    image_root_2: Optional[str] = None,
    grid: Sequence = DEFAULT_EXPERIMENT_GRID,
    epochs: int = 10,
    lr: float = 1e-5,
    bb_lr: float = 1e-5,
    max_concurrent: int = 1,
    extra_args: Sequence[str] = (),
    summary_path: Optional[str] = None,
    device_slots: Optional[Sequence[Optional[str]]] = None,
) -> list[str]:
    """Launch each experiment as a subprocess throttled over ``max_concurrent`` slots
    (the reference's ``jobs -p`` / ``wait -n`` protocol,
    run_distributed_experiments.sh:243-253), then gather the BEST_RESULT lines into
    ``all_experiments_summary.tsv``.

    ``device_slots`` gives each concurrent job its own cards (``slot_env``), e.g.
    ``['0', '1', '2', '3']`` runs 4 experiments with one card each. Slots are a free
    pool: a finished job's slot is reused at once. When given, ``max_concurrent`` is
    capped at ``len(device_slots)``."""
    os.makedirs(output_base_dir, exist_ok=True)
    summary_path = summary_path or os.path.join(output_base_dir, "all_experiments_summary.tsv")
    with open(summary_path, "w") as f:
        f.write("ExpID\tBestEpoch\tBestAcc\tBestAUC\tBestCheckpoint\n")

    free_slots = list(device_slots) if device_slots else []
    if device_slots:
        max_concurrent = min(max_concurrent, len(free_slots)) or len(free_slots)

    running: list[tuple[str, subprocess.Popen, Optional[str]]] = []
    best_lines = []

    def drain(block: bool):
        """Reap FINISHED jobs only; ``block=True`` waits until at least one finishes
        (the reference's ``wait -n``). Never waits on a running job, so a long job does
        not hold the others back."""
        nonlocal running
        while True:
            still, done = [], []
            for item in running:
                (done if item[1].poll() is not None else still).append(item)
            for exp_id, p, slot in done:
                p.wait()
                if device_slots:
                    free_slots.append(slot)
                try:
                    line = emit_best_result(exp_id, os.path.join(output_base_dir, exp_id))
                    best_lines.append(line)
                    with open(summary_path, "a") as f:
                        f.write("\t".join(line.split("\t")[1:]) + "\n")
                except Exception as e:  # a failed job has no results: reported, not fatal
                    print(f"[sweep] {exp_id} failed to summarize: {e}", file=sys.stderr)
            running = still
            if not block or done or not running:
                return
            time.sleep(0.2)

    for job in grid:
        exp_id, classes, freeze_mode, handle_abn, filter_nf = job
        while len(running) >= max_concurrent or (device_slots and not free_slots):
            drain(block=True)
        slot = free_slots.pop(0) if device_slots else None
        cmd = [
            sys.executable, "-m", "projectiontrainer_tpu_torch.cli.cls_train",
            "--exp_id", exp_id, "--class_names", classes, "--freeze_mode", freeze_mode,
            "--data_json", data_json, "--image_root", image_root,
            "--output_base_dir", output_base_dir,
            "--vision_model_name", vision_model_name,
            "--epochs", str(epochs), "--lr", str(lr), "--bb_lr", str(bb_lr),
            *(["--image_root_2", image_root_2] if image_root_2 else []),
            *(["--handle_abnormal"] if handle_abn else []),
            *(["--filter_no_finding"] if filter_nf else []),
            *slot_args(slot),
            *extra_args,
        ]
        print(f"[sweep] launching {exp_id} (slot={slot}): {' '.join(cmd)}", file=sys.stderr)
        running.append((exp_id, subprocess.Popen(cmd, env=slot_env(slot)), slot))
    while running:  # block=True returns after EACH completion; reap until all done
        drain(block=True)
    return best_lines
