"""Config dataclasses with the reference's argparse flag names.

Counterpart of ``projectiontrainer_tpu/core/config.py`` for the stage-0, stage-1 and
stage-2 paths and the cls probe (``CommonConfig``, ``Stage0Config``, ``Stage1Config``,
``Stage2Config``, ``ClsConfig``, ``parser_for``, ``from_args``): the same fields, flag
names and defaults, plus the port's ``--device``. A flag whose machinery is not ported
yet (``--mesh_model`` above 1 in stage 0 and the cls probe) parses as in JAX; the CLIs
raise on it.
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
    # ZeRO-3: params and optimizer state sharded over the data axis (parallel/fsdp.py)
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
    enable_qlora: bool = False       # quantized frozen base LLM (ops/quant.py)
    quant_method: str = "nf4-mirror"  # nf4-mirror | nf4 | int8
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
class Stage2Config(CommonConfig):
    """VQA instruction fine-tuning (reference flags: Stage2/train_vqa_stage2.py:83-118)."""

    vision_model_name: str = ""
    llm_name: str = ""
    stage1_projector_path: str = ""
    max_q_len: int = 128
    max_a_len: int = 512
    enable_qlora: bool = False       # quantized base LLM + LoRA adapters
    quant_method: str = "nf4-mirror"  # nf4-mirror | nf4 | int8
    unfreeze_projection_layer: bool = False
    unfreeze_llm: bool = False
    # the vision tower trains in epoch 0 and is frozen from epoch 1 on
    train_ve_first_epoch: bool = False
    # start from a saved adapter (PEFT directory or the legacy flat format)
    resume_qlora_adapter_path: Optional[str] = None
    lora_r: int = 16
    lora_alpha: int = 32
    lora_dropout: float = 0.05
    grad_clip: float = 1.0
    # storage type of the full-joint trainables (the LLM, and the tower under
    # --train_ve_first_epoch) and so of their Adam moments: 'fp32' masters (the
    # reference's fidelity) or 'bf16' (half the memory)
    master_dtype: str = "fp32"
    # activation recompute in the backward: 'full' (the reference's gradient
    # checkpointing), 'none', an integer N (the first N decoder layers; the tower
    # recomputes all of its layers) or 'dots' (save the products' outputs, recompute
    # the rest)
    remat: str = "full"
    num_epochs: int = 5
    batch_size: int = 1
    warmup_ratio: float = 0.05
    gradient_accumulation_steps: int = 8
    # generation eval: the reference's beam-multinomial sampling (do_sample, 3 beams,
    # top_p 0.9, top_k 50; Stage2/trainer.py:604-614), max_new lowered for eval time
    eval_max_new_tokens: int = 128
    eval_num_beams: int = 3
    eval_do_sample: bool = True
    eval_top_p: float = 0.9
    eval_top_k: int = 50
    # None: examples for the whole eval set (the reference's behaviour); an int caps the
    # number of generation batches
    eval_example_batches: Optional[int] = None

    def freeze_policy(self):
        """Derived policy (reference: Stage2/train_vqa_stage2.py:121-134)."""
        from projectiontrainer_tpu_torch.train.masks import Stage2Freeze

        return Stage2Freeze(
            train_llm=self.unfreeze_llm and not self.enable_qlora,
            use_lora=self.enable_qlora,
            train_projector=self.unfreeze_projection_layer,
            train_vision=self.train_ve_first_epoch,
        )


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


@dataclasses.dataclass
class ClsConfig(CommonConfig):
    """cls_evaluate probe (reference flags: cls_evaluate/train.py:53-110)."""

    exp_id: str = "EXP"
    class_names: str = ""            # comma-separated, like the reference
    freeze_mode: str = "Freeze"      # Freeze | Unfreeze | 1EpochUnfreeze
    handle_abnormal: bool = False
    filter_no_finding: bool = False
    vision_model_name: str = ""
    data_json: str = ""
    output_base_dir: str = "./cls_experiments"
    lr: float = 1e-4
    bb_lr: float = 1e-5
    epochs: int = 10
    dropout_rate: float = 0.1
    batch_size: int = 32
    multilabel_two_way: bool = False

    def effective_class_names(self) -> list[str]:
        """Abnormal mapping / No-Finding filtering (reference: cls_evaluate/train.py:86-109)."""
        names = [c.strip() for c in self.class_names.split(",") if c.strip()]
        if self.handle_abnormal:
            abnormal_sources = [c for c in names if c != "No Finding"]
            names = ["Abnormal"] + (["No Finding"] if "No Finding" in names else [])
            self._abnormal_sources = abnormal_sources
        else:
            self._abnormal_sources = []
        if self.filter_no_finding:
            names = [c for c in names if c != "No Finding"]
        return names

    @property
    def abnormal_source_classes(self) -> list[str]:
        if not hasattr(self, "_abnormal_sources"):
            self.effective_class_names()
        return self._abnormal_sources


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
