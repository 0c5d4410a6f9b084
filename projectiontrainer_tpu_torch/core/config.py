"""Config dataclasses with the reference's argparse flag names.

Counterpart of ``projectiontrainer_tpu/core/config.py`` for the stage-0 and stage-1
paths (``CommonConfig``, ``Stage0Config``, ``Stage1Config``, ``parser_for``,
``from_args``): the same fields, flag names and defaults, plus the port's ``--device``.
Flags whose machinery is not ported yet (``--enable_qlora``, ``--mesh_data``/
``--mesh_model`` above 1, ``--fsdp``) parse as in JAX; the CLIs raise on them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class CommonConfig:
    image_root: str = ""
    image_root_2: Optional[str] = None
    train_json: str = ""
    val_json: Optional[str] = None
    output_dir: str = "./output"
    img_size: int = 384
    batch_size: int = 4
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    num_epochs: int = 5
    warmup_ratio: float = 0.0
    gradient_accumulation_steps: int = 1
    seed: int = 42
    num_workers: int = 8
    # > 0: decode on worker processes (data/feeder.py of the JAX package); not
    # ported: the port's pipeline decodes on threads
    num_loader_procs: int = 0
    mesh_data: int = -1
    mesh_model: int = 1
    # ZeRO-3 sharded parameters and optimizer state (multi-device; not ported)
    fsdp: bool = False
    mixed_precision: str = "bf16"
    # the port's own flag: the card the run uses ('cuda', 'cuda:1') or 'cpu' for the
    # kernels' plain versions (tests, tiny snapshots); never chosen by a fallback
    device: str = "cuda"
    wandb_project: Optional[str] = None
    wandb_run_name: Optional[str] = None
    disable_wandb: bool = False
    logging_steps: int = 100
    # resume trainable params + optimizer + step from the latest checkpoint in
    # output_dir (checkpoint/manager.py)
    resume: bool = False
    # > 0: additionally checkpoint every N batches under step_K (only the newest is
    # kept); --resume restores mid-epoch and skips the already-consumed batches of the
    # deterministic feed — preemption safety for long epochs (stage 1/2 trainers)
    save_steps: int = 0
    # torch.profiler capture of steps [profile_start_step, +profile_num_steps) into
    # profile_dir (a Chrome trace); off when unset
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_num_steps: int = 5

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


@dataclasses.dataclass
class Stage1Config(CommonConfig):
    """Projector alignment (reference flags: Stage1/train_projection_stage1.py:138-160)."""

    vision_model_name: str = ""
    llm_name: str = ""
    train_val_split: float = 0.0
    max_caption_len: int = 512
    save_every_n_epochs: int = 2
    enable_qlora: bool = False       # quantized base LLM (not ported)
    quant_method: str = "nf4-mirror"
    expansion_factor: int = 10
    # wandb.watch equivalent: per-parameter projector gradient norms + histograms
    # every watch_log_freq steps (reference: train_projection_stage1.py:359-370,
    # log_freq=100). Off by default: pulling raw grads costs device-to-host copies.
    watch_gradients: bool = False
    watch_log_freq: int = 100
    grad_clip: float = 5.0
    learning_rate: float = 1e-4
    num_epochs: int = 10


@dataclasses.dataclass
class Stage0Config(CommonConfig):
    """SigLIP contrastive fine-tuning (reference flags: Stage0:867-894)."""

    model_name: str = ""
    max_text_len: int = 77
    freeze_layers_ratio: float = 0.0
    freeze_text_encoder: bool = True
    freeze_logit_scale: bool = True
    save_every_n_epochs: int = 1
    min_save_epoch: int = 1
    use_online_augmentation: bool = False
    val_split: float = 0.05
    learning_rate: float = 1e-5
    warmup_ratio: float = 0.1
    # True = per-data-shard pairwise negatives (the reference's DDP semantics);
    # False = global negatives across the whole batch. One process: the same.
    local_negatives: bool = True


def _add_dataclass_args(parser: argparse.ArgumentParser, cls, *, skip=()):
    for f in dataclasses.fields(cls):
        if f.name in skip:
            continue
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in ("bool", bool):
            parser.add_argument(
                f"--{f.name}", action=argparse.BooleanOptionalAction, default=default
            )
        else:
            typ = {"int": int, "float": float}.get(str(f.type).replace("Optional[", "").rstrip("]"), str)
            if isinstance(default, bool):
                parser.add_argument(f"--{f.name}", action=argparse.BooleanOptionalAction, default=default)
            elif isinstance(default, int):
                parser.add_argument(f"--{f.name}", type=int, default=default)
            elif isinstance(default, float):
                parser.add_argument(f"--{f.name}", type=float, default=default)
            else:
                parser.add_argument(f"--{f.name}", type=typ, default=default)
    return parser


def parser_for(cls, description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    _add_dataclass_args(parser, cls)
    return parser


def from_args(cls, args: argparse.Namespace):
    field_names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items() if k in field_names})
