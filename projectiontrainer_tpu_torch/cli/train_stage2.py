"""Stage 2 entry: VQA instruction fine-tuning, on one device or data parallel.

Counterpart of ``projectiontrainer_tpu/cli/train_stage2.py`` with the same flags
(reference: Stage2/train_vqa_stage2.py:82-352), plus ``--device``. The full-joint
recipe:

    python -m projectiontrainer_tpu_torch.cli.train_stage2 --image_root ... \\
        --train_json ... --vision_model_name <local dir> --llm_name <local dir> \\
        --unfreeze_llm --unfreeze_projection_layer --train_ve_first_epoch

and the QLoRA recipe of the reference's launcher (LoRA r16/alpha32/dropout 0.05 on
q/k/v/o/gate/up/down over a base quantized by ``--quant_method``):

    python -m projectiontrainer_tpu_torch.cli.train_stage2 ... --enable_qlora \
        --quant_method nf4-mirror --lora_r 16 --lora_alpha 32 --lora_dropout 0.05

``--resume_qlora_adapter_path`` starts from a saved adapter (PEFT or the legacy flat
format); ``--resume`` with ``--enable_qlora`` quantizes the base by the method the
checkpoint was saved with.

Images are read on ``--num_workers`` threads, as the JAX package's stage 2 reads them:
``--num_loader_procs`` has no effect here (said once in the log).

Data parallel over N GPUs: ``projectiontrainer-torch-launch --nproc_per_node N stage2 --
<these flags>`` (or ``torchrun``) starts one process per GPU; ``--mesh_data`` N or -1 (every
rank). Tensor parallelism: ``--mesh_model`` M splits each replica over M ranks (rank r
at (r // M, r % M); heads, hidden columns and the vocab sharded, ``parallel/sharding.py``;
``launchers/run_stage2_h100.sh`` runs the stage-2 QLoRA recipe at 4 x 2); a unit the M
ranks do not divide runs whole on each of them. ``--remat dots`` saves the products' outputs and recomputes
the rest (``core/remat.py``). ``--fsdp`` shards the params and the optimizer state over
the data axis (ZeRO-3, ``parallel/fsdp.py``; with ``--mesh_model`` too), the recipe of
``launchers/run_stage2_full_joint_h100.sh`` (Gemma3-4B full-joint). ``--mesh_data -1``
with more than one GPU visible in a process no launcher started raises.
"""

from __future__ import annotations

import os

import torch

from projectiontrainer_tpu_torch.checkpoint import export
from projectiontrainer_tpu_torch.core.config import Stage2Config, from_args, parser_for
from projectiontrainer_tpu_torch.data import datasets
from projectiontrainer_tpu_torch.parallel import sharding
from projectiontrainer_tpu_torch.train import common, setup
from projectiontrainer_tpu_torch.train.trainer_stage2 import Stage2Trainer
from projectiontrainer_tpu_torch.utils.logging import setup_logging


def main(argv=None):
    cfg = from_args(Stage2Config, parser_for(Stage2Config, __doc__).parse_args(argv))
    common.init_world(cfg)
    logger = setup_logging()
    common.log_thread_feed(cfg, logger, "stage 2 executes a bucket plan")
    device = torch.device(cfg.device)
    common.resume_quant_method(cfg, os.path.join(cfg.output_dir, "checkpoints"), logger)
    vlm_cfg, params = setup.build_vlm(cfg.vision_model_name, cfg.llm_name, device=device,
                                      stage1_projector_path=cfg.stage1_projector_path or None,
                                      seed=cfg.seed, quantize_llm=cfg.enable_qlora,
                                      quant_method=cfg.quant_method)
    tokenizer = setup.load_tokenizer(cfg.llm_name)
    if cfg.resume_qlora_adapter_path:
        # a reference run's language_model/ (PEFT) or an adapter of either package
        full, loaded = export.load_adapter(cfg.resume_qlora_adapter_path, device=device)
        params["lora"] = sharding.shard_params(
            full, sharding.plan_for(full, vlm_cfg, prefix="lora"), prefix="lora")
        if loaded is not None and (loaded.r != cfg.lora_r or loaded.alpha != cfg.lora_alpha):
            logger.warning("adapter_config.json says r=%d alpha=%d but the flags ask r=%d "
                           "alpha=%d: the flags win (alpha/r scales the adapter)",
                           loaded.r, loaded.alpha, cfg.lora_r, cfg.lora_alpha)
        logger.info("resumed LoRA adapters from %s", cfg.resume_qlora_adapter_path)

    def make(path):
        return datasets.Stage2VQADataset.from_json(
            path, image_root=cfg.image_root, tokenizer=tokenizer, image_size=cfg.img_size,
            max_q_len=cfg.max_q_len, max_a_len=cfg.max_a_len, image_root_2=cfg.image_root_2)

    train_data = make(cfg.train_json)
    val_data = make(cfg.val_json) if cfg.val_json else None
    trainer = Stage2Trainer(cfg, vlm_cfg=vlm_cfg, params=params, tokenizer=tokenizer,
                            train_dataset=train_data, val_dataset=val_data)
    logger.info("starting stage-2 training: %d train / %d val samples on %s", len(train_data),
                len(val_data) if val_data is not None else 0, device)
    result = trainer.train()
    logger.info("done: %s", result)
    return result


if __name__ == "__main__":
    main()
