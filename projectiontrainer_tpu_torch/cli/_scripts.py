"""Console-script shims for the port's entries in ``pyproject.toml [project.scripts]``
(``projectiontrainer-torch-*``).

The CLI ``main()`` functions return their results (metrics dicts, generated strings,
accuracies) for tests and callers; pip's generated wrapper runs ``sys.exit(main())``,
which would turn a truthy return into exit status 1 on a run that succeeded. Each shim
runs its CLI's ``main`` and returns None (exit status 0); a failure still propagates as
an exception.
"""

from __future__ import annotations

import importlib


def _run(module: str) -> None:
    importlib.import_module(f"projectiontrainer_tpu_torch.cli.{module}").main()


def train_stage0():
    _run("train_stage0")


def train_stage1():
    _run("train_stage1")


def train_stage2():
    _run("train_stage2")


def infer_stage1():
    _run("infer_stage1")


def infer_vqa():
    _run("infer_vqa_stage2")


def infer_generation():
    _run("infer_generation")


def balanced_sample():
    _run("balanced_sample")


def tsne():
    _run("tsne_analysis")


def zero_shot():
    _run("zero_shot_classify")


def cls_train():
    _run("cls_train")


def cls_test():
    _run("cls_test")


def cls_evaluate():
    _run("cls_evaluate_experiment")


def run_experiments():
    _run("run_experiments")


def serve():
    _run("serve")


def launch():
    # a failed rank raises SystemExit with its exit code inside the launcher's main
    _run("launch")


def budget():
    _run("budget")
