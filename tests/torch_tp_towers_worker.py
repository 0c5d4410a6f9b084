"""One rank of the tensor-parallel CPU tests of stage 0 and the cls probe
(``tests/test_torch_tp_towers.py``), run as its own process over gloo:

    python tests/torch_tp_towers_worker.py <data>x<model> <dir>

with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``PTT_DIST_TIMEOUT_S`` in the environment (``torch_dp_worker.spawn_ranks`` sets them).
It imports torch and the port, never JAX. The rank lays the world out as a data x model
mesh (``distributed.setup_mesh``), slices every case's whole params of
``<dir>/payload.pt`` to its model rank's shards (``sharding.model_shards``, the CLIs'
call) and writes ``<dir>/result<r>.pt``:

- ``stage0`` / ``cls``: the trainers' step (``run_case``) over the batches, on the
  rank's data rows (under ``fsdp`` on its data shards too): losses, grad norms, every
  trained leaf gathered whole, and the trained leaves the model axis leaves whole, as
  bytes after every step;
- ``stage0_trainer`` / ``cls_trainer``: ``Stage0Trainer.train()`` / ``ClsTrainer.train()``
  over in-memory rows (``Rows``), with the rows the zero-shot validation and the
  evaluation gathered (``capture``), every logged row and the checkpoints the ranks
  wrote under ``<dir>/<case>``.

``run_case``, ``Rows``, ``StubTokenizer`` and the trainer runs serve the one-process
references of the test too. ``_counts`` holds the model-axis collectives of the whole
run by phase (``tensor_parallel.COUNTS``), ``_counts_by_case`` each case's.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dp_worker  # noqa: E402

MAX_TEXT_LEN = 8


class Rows:
    """An in-memory dataset of numpy rows (the trainers' dataset protocol)."""

    def __init__(self, rows):
        self.rows = list(rows)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return dict(self.rows[i])


class StubTokenizer:
    """The zero-shot validation's tokenizer: each class name as a fixed row of ids."""

    def __init__(self, ids_by_name: dict):
        self.ids_by_name = ids_by_name

    def __call__(self, names, **_):
        return {"input_ids": np.stack([self.ids_by_name[n] for n in names])}


class Logger:
    """Every logged row, in order (the trainers' ``MetricLogger`` protocol)."""

    def __init__(self):
        self.rows = []

    def log(self, row, step=None):
        self.rows.append({**row, "step": step})


def place(params, cfg, fsdp: bool):
    """The plan a trainer builds (``common.place_params``); under ``fsdp`` ``params``
    become the rank's data shards, in place."""
    from projectiontrainer_tpu_torch.core.config import CommonConfig
    from projectiontrainer_tpu_torch.train import common

    return common.place_params(params, cfg, CommonConfig(fsdp=fsdp, device="cpu"))


def run_case(case: dict, params, batches, plan=None) -> dict:
    """The stage-0 or cls trainer's step over ``batches`` (numpy dicts), on whole params
    (``plan`` None) or a rank's shards: losses, grad norms, the trained leaves after the
    last step (gathered whole under a plan) and, under a plan, the bytes of the trained
    leaves the model axis leaves whole after every step. A cls case under
    ``1EpochUnfreeze`` swaps to the frozen-tower optimizer before batch ``swap_at``
    (``steps.swap_optimizer``, as ``ClsTrainer`` does)."""
    from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths, unique_leaves_with_paths
    from projectiontrainer_tpu_torch.train import masks, optim, steps

    cfg = case["cfg"]
    sharded = frozenset() if plan is None else plan.sharded
    data_sharded = frozenset() if plan is None else plan.data_sharded
    variants = {}
    if case["kind"] == "stage0":
        labels = masks.stage0_labels(params, freeze_text=case["freeze_text"])
        tx, _ = optim.single_group_optimizer(labels, 3e-3, total_steps=len(batches),
                                             warmup_ratio=0.3, weight_decay=0.01,
                                             warmup_rounding="floor", sharded_paths=sharded,
                                             fsdp_paths=data_sharded)
        loss = steps.stage0_loss(cfg, remat=False, local_negatives_shards=case["shards"])
        variants[None] = (labels, tx, loss)
        frozen_at = [None] * len(batches)
    else:
        loss = steps.classifier_loss(cfg, multilabel=case["multilabel"])
        mode = case["freeze_mode"]
        frozen_at = [mode == "Freeze" or (mode == "1EpochUnfreeze" and i >= case["swap_at"])
                     for i in range(len(batches))]
        for frozen in sorted(set(frozen_at)):
            labels = masks.classifier_labels(params, freeze_vision=frozen)
            tx, _ = optim.discriminative_optimizer(labels, head_lr=1e-2, backbone_lr=1e-3,
                                                   weight_decay=0.01, fsdp_paths=data_sharded)
            variants[frozen] = (labels, tx, loss)
    built = {k: (steps.make_train_step(fn, tx, trainable_mask=masks.bool_mask(labels),
                                       plan=plan), tx)
             for k, (labels, tx, fn) in variants.items()}
    trained = {p for labels, _, _ in variants.values()
               for p, on in leaves_with_paths(masks.bool_mask(labels)) if on}
    state = steps.init_state(params, built[frozen_at[0]][1])
    losses, norms, whole_bytes = [], [], []
    for i, b in enumerate(batches):
        step, tx = built[frozen_at[i]]
        if i and frozen_at[i] != frozen_at[i - 1]:
            state = steps.swap_optimizer(state, tx)
        state, value, aux = step(state, {k: torch.tensor(v) for k, v in b.items()}, i)
        losses.append(float(value))
        norms.append(float(aux["grad_norm"]))
        if plan is not None:
            whole_bytes.append(b"".join(
                x.detach().contiguous().view(torch.uint8).numpy().tobytes()
                for p, x in unique_leaves_with_paths(params)
                if p in trained and p not in sharded))
    leaves = [(p, x.detach().clone()) for p, x in unique_leaves_with_paths(params)
              if p in trained]
    out = {"losses": losses, "grad_norms": norms,
           "params": {p: (x if plan is None else plan.gather(p, x)) for p, x in leaves}}
    if plan is not None:
        out["model_whole_bytes_by_step"] = whole_bytes
    return out


def capture(module, name: str, into: list):
    """Wrap ``module.<name>`` so each call's positional arguments land in ``into``."""
    original = getattr(module, name)

    def wrapped(*args, **kw):
        into.append([np.asarray(a) for a in args])
        return original(*args, **kw)

    setattr(module, name, wrapped)
    return original


def stage0_trainer_case(case: dict, params, out_dir: str, *, batch: int) -> dict:
    """``Stage0Trainer.train()`` over the case's rows at ``batch`` rows a data rank (the
    case's ``local_negatives``, global by default), the text tower trained, 2 epochs, zero-shot validation each epoch, checkpoints and HF
    exports every epoch under ``out_dir``: the logged rows and the (predictions,
    targets) each validation gathered."""
    from projectiontrainer_tpu_torch.core.config import Stage0Config
    from projectiontrainer_tpu_torch.train import trainer_stage0

    seen = []
    original = capture(trainer_stage0, "zero_shot_prf", seen)
    try:
        cfg = Stage0Config(output_dir=out_dir, batch_size=batch, num_epochs=2,
                           learning_rate=1e-2, warmup_ratio=0.0, max_text_len=MAX_TEXT_LEN,
                           min_save_epoch=0, save_every_n_epochs=1, logging_steps=1,
                           num_workers=1, mixed_precision="no", disable_wandb=True,
                           device="cpu", seed=0,
                           local_negatives=case.get("local_negatives", False),
                           freeze_text_encoder=False, fsdp=case.get("fsdp", False))
        logger = Logger()
        trainer = trainer_stage0.Stage0Trainer(
            cfg, model_cfg=case["cfg"], params=params,
            tokenizer=StubTokenizer(case["class_ids"]), train_dataset=Rows(case["train"]),
            val_dataset=Rows(case["val"]), class_names=list(case["class_ids"]), logger=logger)
        trainer.train()
    finally:
        trainer_stage0.zero_shot_prf = original
    return {"logs": logger.rows, "zero_shot": seen}


def cls_trainer_case(case: dict, params, out_dir: str, *, batch: int) -> dict:
    """``ClsTrainer.train()`` (``1EpochUnfreeze``, 2 epochs, dropout on) over the case's
    rows at ``batch`` rows a data rank, then ``evaluate()`` again: the logged rows, the
    (logits, targets) each evaluation gathered, and the final evaluation."""
    from projectiontrainer_tpu_torch.core.config import ClsConfig
    from projectiontrainer_tpu_torch.train import trainer_cls

    seen = []
    original = capture(trainer_cls, "classification_metrics", seen)
    try:
        cfg = ClsConfig(exp_id="EXPT", output_base_dir=out_dir, batch_size=batch, epochs=2,
                        lr=1e-2, bb_lr=1e-3, freeze_mode="1EpochUnfreeze",
                        mixed_precision="no", device="cpu", num_workers=1, logging_steps=1,
                        seed=0, fsdp=case.get("fsdp", False))
        logger = Logger()
        trainer = trainer_cls.ClsTrainer(cfg, model_cfg=case["cfg"], params=params,
                                         train_dataset=Rows(case["train"]),
                                         val_dataset=Rows(case["val"]), logger=logger)
        trainer.train()
        final = trainer.evaluate()
    finally:
        trainer_cls.classification_metrics = original
    return {"logs": logger.rows, "evaluations": seen, "final": final}


def faults(case: dict) -> dict:
    """The losses that reduce over the data axis, on ranks of one replica that hold the
    same rows: the pairwise loss with global negatives, the two-way loss over the ranks
    and the stage-0 loss with ``local_negatives_shards`` groups (given embeddings: the
    towers replaced by the case's features)."""
    from projectiontrainer_tpu_torch.models import siglip
    from projectiontrainer_tpu_torch.train import losses, steps

    img, txt = torch.tensor(case["img"]), torch.tensor(case["txt"])
    scale, bias = torch.tensor([case["scale"]]), torch.tensor([case["bias"]])
    out = {"pairwise": float(losses.siglip_pairwise_loss_over_ranks(img, txt, scale[0],
                                                                      bias[0])),
           "two_way": float(losses.two_way_multilabel_loss(
               torch.tensor(case["logits"]), torch.tensor(case["targets"]), over_ranks=True))}
    original = siglip.forward_contrastive
    siglip.forward_contrastive = lambda *a, **k: (img, txt, scale, bias)
    try:
        loss_fn = steps.stage0_loss(None, local_negatives_shards=case["shards"])
        out["stage0_local"] = float(loss_fn({"vision": {"patch_embedding": {
            "weight": torch.zeros(1)}}}, {"pixel_values": torch.zeros(img.shape[0]),
                                          "input_ids": None})[0])
    finally:
        siglip.forward_contrastive = original
    return out


def main(mesh: str, directory: str) -> None:
    torch.set_num_threads(1)
    from projectiontrainer_tpu_torch.parallel import distributed, sharding
    from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp

    data, model = (int(v) for v in mesh.split("x"))
    rank, _ = distributed.initialize("cpu")
    try:
        distributed.setup_mesh(data, model)
        d = distributed.data_rank()
        payload = torch.load(os.path.join(directory, "payload.pt"), weights_only=False)
        results, by_case = {}, {}
        for name, case in payload.items():
            before = dict(tp.COUNTS)
            kind = case["kind"]
            if kind == "faults":
                results[name] = faults(case)
                continue
            params = sharding.model_shards(case["params"], case["cfg"])
            if kind in ("stage0", "cls"):
                plan = place(params, case["cfg"], case.get("fsdp", False))
                rows = [torch_dp_worker.shard(b, d, data) for b in case["batches"]]
                results[name] = run_case(case, params, rows, plan)
            elif kind == "stage0_trainer":
                results[name] = stage0_trainer_case(case, params, os.path.join(directory, name),
                                                    batch=case["batch"])
            elif kind == "cls_trainer":
                results[name] = cls_trainer_case(case, params, os.path.join(directory, name),
                                                 batch=case["batch"])
            else:
                raise ValueError(kind)
            by_case[name] = {k: v - before[k] for k, v in tp.COUNTS.items()}
        results["_counts"] = dict(tp.COUNTS)
        results["_counts_by_case"] = by_case
        torch.save(results, os.path.join(directory, f"result{rank}.pt"))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
