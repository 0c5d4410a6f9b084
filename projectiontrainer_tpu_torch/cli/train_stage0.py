"""Stage 0 entry: SigLIP contrastive vision-encoder fine-tuning, data and tensor parallel.

Counterpart of ``projectiontrainer_tpu/cli/train_stage0.py`` with the same flags
(reference: Stage0/train_vision_encoder_stage0.py:845-897), plus ``--device``:

    python -m projectiontrainer_tpu_torch.cli.train_stage0 --image_root ... \\
        --train_json ... --model_name <local SigLIP snapshot with its tokenizer>

The vision tower, its MAP head and ``logit_bias`` train in fp32 masters with bf16
compute (``--mixed_precision``); the text tower is stored in the compute type when
it is frozen (``--freeze_text_encoder``, the default).

``--use_online_augmentation`` augments every training image (``data/augmentation.py``,
the C++ pipeline of ``runtime/``); ``--num_loader_procs N`` decodes and augments on N
worker processes (``data/feeder.py``) instead of ``--num_workers`` threads.

Data parallel over N GPUs: ``projectiontrainer-torch-launch --nproc_per_node N stage0 --
<these flags>`` (or ``torchrun``) starts one process per GPU; ``--mesh_data`` N or -1 (every
rank); ``--mesh_model`` M splits both towers over M ranks of each replica (tensor
parallelism: the snapshot is loaded whole and sliced to the rank's shards,
``parallel/sharding.model_shards``; heads, intermediate sizes and the text vocab must
divide over M); ``--fsdp`` shards the towers and the optimizer state over the data axis
(ZeRO-3, ``parallel/fsdp.py``), with or without ``--mesh_model``. ``--mesh_data -1``
with more than one GPU visible in a process no launcher started raises, as does a
``--mesh_data`` x ``--mesh_model`` mesh other than the world of ranks.
"""

from __future__ import annotations

import torch

from projectiontrainer_tpu_torch.data import datasets
from projectiontrainer_tpu_torch.checkpoint import hf_import
from projectiontrainer_tpu_torch.core import dtypes
from projectiontrainer_tpu_torch.core.config import Stage0Config, from_args, parser_for
from projectiontrainer_tpu_torch.parallel import sharding
from projectiontrainer_tpu_torch.train import common, setup
from projectiontrainer_tpu_torch.train.trainer_stage0 import Stage0Trainer
from projectiontrainer_tpu_torch.utils.logging import setup_logging


def main(argv=None):
    cfg = from_args(Stage0Config, parser_for(Stage0Config, __doc__).parse_args(argv))
    common.init_world(cfg)
    logger = setup_logging()
    device = torch.device(cfg.device)
    text_dtype = dtypes.compute_dtype(cfg.mixed_precision) if cfg.freeze_text_encoder else None
    model_cfg, params = hf_import.load_siglip(cfg.model_name, device=device,
                                              vision_dtype=torch.float32,
                                              text_dtype=text_dtype or torch.float32)
    params = sharding.model_shards(params, model_cfg)
    tokenizer = setup.load_tokenizer(cfg.model_name)

    samples = datasets.load_manifest(cfg.train_json)
    train_samples, val_samples = datasets.train_val_split(samples, cfg.val_split, seed=cfg.seed)

    def make(s, augment):
        return datasets.ContrastiveDataset(
            s, image_root=cfg.image_root, tokenizer=tokenizer, image_size=cfg.img_size,
            max_text_len=cfg.max_text_len, image_root_2=cfg.image_root_2, augment=augment,
            seed=cfg.seed)

    train_ds = make(train_samples, cfg.use_online_augmentation)
    trainer = Stage0Trainer(cfg, model_cfg=model_cfg, params=params, tokenizer=tokenizer,
                            train_dataset=train_ds,
                            val_dataset=make(val_samples, False) if val_samples else None,
                            class_names=train_ds.class_names)
    logger.info("starting stage-0 training: %d train / %d val samples on %s",
                len(train_samples), len(val_samples), device)
    result = trainer.train()
    logger.info("done: %s", result)
    return result


if __name__ == "__main__":
    main()
