"""cls_evaluate training entry: attention-probe classifier experiments, data and tensor
parallel.

Counterpart of ``projectiontrainer_tpu/cli/cls_train.py`` with the same flags
(reference: cls_evaluate/train.py:53-143: ``--exp_id``, ``--class_names``,
``--freeze_mode {Freeze,Unfreeze,1EpochUnfreeze}``, ``--handle_abnormal``,
``--filter_no_finding``, ``--lr``/``--bb_lr`` discriminative rates), plus ``--device``:

    python -m projectiontrainer_tpu_torch.cli.cls_train --exp_id EXP1 \\
        --class_names "No Finding,Atelectasis,Cardiomegaly,Effusion" \\
        --freeze_mode 1EpochUnfreeze --vision_model_name <local SigLIP snapshot> \\
        --data_json ... --image_root ... --output_base_dir ./cls_experiments

The tower (with its MAP head when the snapshot has one) and the head train in fp32
masters with bf16 compute (``--mixed_precision``). ``--multilabel_two_way`` reads
multi-hot targets (``MultiLabelClassificationDataset``). Images are read on
``--num_workers`` threads: the classification datasets lack the process feeder's
protocol, so ``--num_loader_procs`` has no effect (said once in the log), as in the JAX
package. Data parallel over N GPUs: ``projectiontrainer-torch-launch --nproc_per_node N cls --
<these flags>`` (or ``torchrun``) starts one process per GPU; ``--mesh_data`` N or -1 (every
rank); ``--mesh_model`` M splits the tower over M ranks of each replica (tensor
parallelism: the classifier is built whole and sliced to the rank's shards,
``parallel/sharding.model_shards``; the tower's attention or MLP that M does not divide
runs whole on each rank; the classifier's head is replicated); ``--fsdp`` shards the classifier and the
optimizer state over the data axis (ZeRO-3, ``parallel/fsdp.py``), with or without
``--mesh_model``. ``--mesh_data -1`` with more than one GPU visible in a process no
launcher started raises, as does a ``--mesh_data`` x ``--mesh_model`` mesh other than
the world of ranks.
"""

from __future__ import annotations

import torch

from projectiontrainer_tpu_torch.checkpoint import hf_import
from projectiontrainer_tpu_torch.core.config import ClsConfig, from_args, parser_for
from projectiontrainer_tpu_torch.data import datasets
from projectiontrainer_tpu_torch.models import classifier as cls_model
from projectiontrainer_tpu_torch.parallel import sharding
from projectiontrainer_tpu_torch.train import common
from projectiontrainer_tpu_torch.train.trainer_cls import ClsTrainer
from projectiontrainer_tpu_torch.utils.logging import setup_logging


def build_trainer(cfg: ClsConfig, *, vision_cfg=None, vision_params=None) -> ClsTrainer:
    """The trainer over ``cfg.data_json``'s stratified 90/10 split; the tower from the
    snapshot ``cfg.vision_model_name`` unless ``vision_cfg``/``vision_params`` are given
    (``vision_params`` None then: a random tower from ``cfg.seed``)."""
    common.init_world(cfg)
    logger = setup_logging()
    common.log_thread_feed(cfg, logger, "the classification datasets lack the process "
                           "feeder's protocol")
    names = cfg.effective_class_names()
    device = torch.device(cfg.device)
    if vision_cfg is None:
        vision_cfg, vision_params = hf_import.load_siglip_vision(
            cfg.vision_model_name, device=device, dtype=torch.float32, head=True)
    model_cfg = cls_model.ClassifierConfig(vision=vision_cfg, num_classes=len(names),
                                           dropout_rate=cfg.dropout_rate)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    params = sharding.model_shards(
        cls_model.init(gen, model_cfg, device=device, vision=vision_params), model_cfg)

    samples = datasets.load_manifest(cfg.data_json)
    if cfg.filter_no_finding:
        samples = [s for s in samples
                   if str(s.get("normal_caption", "")).strip() != "No Finding"]
    train_s, val_s = datasets.stratified_split(samples, val_ratio=0.1, seed=cfg.seed)

    def make(s):
        if cfg.multilabel_two_way:
            return datasets.MultiLabelClassificationDataset(
                s, image_root=cfg.image_root, class_names=names, image_size=cfg.img_size,
                image_root_2=cfg.image_root_2)
        return datasets.ClassificationDataset(
            s, image_root=cfg.image_root, class_names=names, image_size=cfg.img_size,
            image_root_2=cfg.image_root_2, handle_abnormal=cfg.handle_abnormal,
            abnormal_source_classes=cfg.abnormal_source_classes)

    logger.info("experiment %s: classes=%s train=%d val=%d freeze=%s on %s",
                cfg.exp_id, names, len(train_s), len(val_s), cfg.freeze_mode, device)
    return ClsTrainer(cfg, model_cfg=model_cfg, params=params, train_dataset=make(train_s),
                      val_dataset=make(val_s))


def main(argv=None):
    cfg = from_args(ClsConfig, parser_for(ClsConfig, __doc__).parse_args(argv))
    return build_trainer(cfg).train()


if __name__ == "__main__":
    main()
