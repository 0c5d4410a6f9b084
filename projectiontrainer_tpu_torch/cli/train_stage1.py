"""Stage 1 entry: projector alignment training, on one device or data parallel.

Counterpart of ``projectiontrainer_tpu/cli/train_stage1.py`` with the same flags
(reference: Stage1/train_projection_stage1.py:136-408), plus ``--device``:

    python -m projectiontrainer_tpu_torch.cli.train_stage1 --image_root ... \\
        --train_json ... --vision_model_name <local dir> --llm_name <local dir>

``--enable_qlora`` stores the frozen base LLM quantized by ``--quant_method``
(nf4-mirror, nf4 or int8; no adapters in stage 1); with ``--resume`` the method the
checkpoint was saved with wins.

``--num_loader_procs N`` decodes the images on N worker processes (``data/feeder.py``)
instead of ``--num_workers`` threads.

Data parallel over N GPUs: ``projectiontrainer-torch-launch --nproc_per_node N stage1 --
<these flags>`` (or ``torchrun``) starts one process per GPU; ``--mesh_data`` N or -1 (every
rank). Tensor parallelism: ``--mesh_model`` M splits each replica over M ranks (rank r
at (r // M, r % M); heads, hidden columns and the vocab sharded, ``parallel/sharding.py``);
a unit the M ranks do not divide runs whole on each of them. ``--fsdp`` shards the
params and the optimizer state over the data axis (ZeRO-3, ``parallel/fsdp.py``; with
``--mesh_model`` too). ``--mesh_data -1`` with more than one GPU visible in a process no launcher
started raises.
"""

from __future__ import annotations

import os

import torch

from projectiontrainer_tpu_torch.data import datasets
from projectiontrainer_tpu_torch.core.config import Stage1Config, from_args, parser_for
from projectiontrainer_tpu_torch.train import common, setup
from projectiontrainer_tpu_torch.train.trainer_stage1 import Stage1Trainer
from projectiontrainer_tpu_torch.utils.logging import setup_logging


def main(argv=None):
    cfg = from_args(Stage1Config, parser_for(Stage1Config, __doc__).parse_args(argv))
    common.init_world(cfg)
    logger = setup_logging()
    device = torch.device(cfg.device)
    common.resume_quant_method(cfg, os.path.join(cfg.output_dir, "checkpoints"), logger)
    vlm_cfg, params = setup.build_vlm(cfg.vision_model_name, cfg.llm_name, device=device,
                                      expansion_factor=cfg.expansion_factor, seed=cfg.seed,
                                      quantize_llm=cfg.enable_qlora,
                                      quant_method=cfg.quant_method)
    tokenizer = setup.load_tokenizer(cfg.llm_name)

    samples = datasets.load_manifest(cfg.train_json)
    if cfg.val_json:
        train_samples, val_samples = samples, datasets.load_manifest(cfg.val_json)
    elif cfg.train_val_split > 0:
        train_samples, val_samples = datasets.train_val_split(samples, cfg.train_val_split,
                                                              seed=cfg.seed)
    else:
        train_samples, val_samples = samples, []

    def make(s):
        return datasets.Stage1PairDataset(
            s, image_root=cfg.image_root, tokenizer=tokenizer, image_size=cfg.img_size,
            max_length=cfg.max_caption_len, image_root_2=cfg.image_root_2)

    trainer = Stage1Trainer(cfg, vlm_cfg=vlm_cfg, params=params, tokenizer=tokenizer,
                            train_dataset=make(train_samples),
                            val_dataset=make(val_samples) if val_samples else None)
    logger.info("starting stage-1 training: %d train / %d val samples on %s",
                len(train_samples), len(val_samples), device)
    result = trainer.train()
    logger.info("done: %s", result)
    return result


if __name__ == "__main__":
    main()
