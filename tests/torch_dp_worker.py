"""One rank of the port's data-parallel CPU tests (``tests/test_torch_distributed.py``,
``tests/test_torch_dp.py``), run as its own process over gloo:

    python tests/torch_dp_worker.py {collectives|dp} <dir>

with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``PTT_DIST_TIMEOUT_S`` in the environment (``spawn_ranks`` sets them). It imports torch
and the port, never JAX: the tests build the inputs (from the JAX package's models) and
the references in their own process and pass them through ``<dir>``.

- ``collectives``: ``gather_ragged`` and ``gather_objects`` at per-rank counts 3, 5, 7,
  9 (rank r holds 3 + 2r rows), ``all_gather_with_grad``'s gradient, the coalesced
  gradient all-reduce over mixed types, ``broadcast_``, ``broadcast_value``, the
  ranks' dropout seeds and ``barrier``; writes ``<dir>/rank<r>.pt``.
- ``dp``: every case of ``<dir>/payload.pt`` through ``run_case`` on this rank's rows
  of each global batch (rank r the contiguous rows r*b .. (r+1)*b, as the JAX package's
  data mesh gives shard r); writes ``<dir>/result<r>.pt``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD = 0


def spawn_ranks(mode: str, directory: str, world: int, *, timeout: float = 120,
                script: str = __file__) -> None:
    """Run ``world`` ranks of this worker (or of ``script``) over gloo, each bounded by
    ``timeout`` seconds and its collectives by 60; raises with a failing rank's output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), PTT_DIST_TIMEOUT_S="60",
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, script, mode, directory],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")


def shard(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous rows of a global batch."""
    b = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


# ------------------------------------------------------------------------ the cases


def run_case(case: dict, params, batches) -> dict:
    """The trainers' step (``steps.make_train_step`` with their optimizer) over
    ``batches`` (numpy dicts): the losses and grad norms it reports, and the trainable
    leaves after the last step."""
    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.train import lora, masks, optim, steps

    kind, cfg, steps_n = case["kind"], case["cfg"], len(batches)
    accum = case.get("accum", 1)
    total = -(-steps_n // accum)
    if kind == "stage1":
        labels = masks.stage1_labels(params)
        tx, _ = optim.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.1,
                                             weight_decay=0.01, clip_norm=5.0)
        loss = steps.stage1_loss(cfg, PAD, remat=False, logits_chunk=5, ce_impl="chunked")
    elif kind == "stage0":
        labels = masks.stage0_labels(params)
        tx, _ = optim.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.3,
                                             weight_decay=0.01, warmup_rounding="floor")
        loss = steps.stage0_loss(cfg, remat=False, local_negatives_shards=case["shards"])
    elif kind == "stage2":
        labels = masks.stage2_labels(params, masks.Stage2Freeze(**case["policy"]))
        tx, _ = optim.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.1,
                                             weight_decay=0.01, clip_norm=1.0,
                                             clip_per_module=True, accum_steps=accum)
        lora_cfg = (lora.LoraConfig(r=case["lora_r"], alpha=2 * case["lora_r"], dropout=0.0)
                    if "lora_r" in case else None)
        loss = steps.stage2_loss(cfg, PAD, lora_cfg=lora_cfg, remat=False, logits_chunk=5,
                                 table_frozen=lora_cfg is not None)
    elif kind == "cls":
        labels = masks.classifier_labels(params, freeze_vision=False)
        tx, _ = optim.discriminative_optimizer(labels, head_lr=1e-2, backbone_lr=1e-3,
                                               weight_decay=0.01)
        loss = steps.classifier_loss(cfg, multilabel=case["multilabel"])
    else:
        raise ValueError(kind)
    step = steps.make_train_step(loss, tx, trainable_mask=masks.bool_mask(labels))
    state = steps.init_state(params, tx)
    losses, norms = [], []
    for i, b in enumerate(batches):
        state, value, aux = step(state, {k: torch.tensor(v) for k, v in b.items()}, i)
        losses.append(float(value))
        norms.append(float(aux["grad_norm"]))
    trained = set(state["opt_state"]["mu"])
    return {"losses": losses, "grad_norms": norms,
            "params": {p: x.detach().clone() for p, x in unique_leaves_with_paths(params)
                       if p in trained}}


# ------------------------------------------------------------------------ the modes


def _collectives(directory: str, rank: int, world: int) -> dict:
    from projectiontrainer_tpu_torch.parallel import distributed

    n = 3 + 2 * rank
    rows = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 100 * rank
    out = {"ragged": distributed.gather_ragged(rows),
           "ragged_bool": distributed.gather_ragged(np.arange(n) % 2 == 0),
           "objects": distributed.gather_objects([f"r{rank}-{i}" for i in range(n)]),
           "empty": distributed.gather_ragged(np.zeros((0 if rank == 1 else 2, 4), np.int64))}

    # all_gather_with_grad: each rank's loss reads every rank's rows with its own weights
    x = torch.tensor(np.random.default_rng(rank).standard_normal((2, 4)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(np.random.default_rng(10 + rank).standard_normal((2 * world, 4)),
                     dtype=torch.float32)
    gathered = distributed.all_gather_with_grad(x)
    (gathered * w).sum().backward()
    out.update(x=x.detach(), x_grad=x.grad, gathered=gathered.detach())

    # the coalesced all-reduce over mixed types and a bucket boundary
    grads = [torch.full((5,), float(rank + 1)), torch.full((3, 2), 2.0 * (rank + 1)),
             torch.full((4,), rank + 1.0, dtype=torch.bfloat16), torch.full((2,), 3.0 * rank)]
    old, distributed.BUCKET_BYTES = distributed.BUCKET_BYTES, 24
    try:
        distributed.all_reduce_grads(grads)
    finally:
        distributed.BUCKET_BYTES = old
    params = [torch.full((3,), float(rank), requires_grad=True), torch.full((2, 2), -rank)]
    distributed.broadcast_(params)
    out.update(reduced=grads, broadcast=[p.detach() for p in params],
               value=distributed.broadcast_value(0.5 + rank),
               summed=distributed.sum_over_ranks(torch.tensor(float(rank + 1))))

    # dropout seeds: each rank's rows draw masks of their own
    from projectiontrainer_tpu_torch.train import lora

    out.update(rank_seed=distributed.rank_seed(5), lora_seed=lora.dropout_seed(5, 1, "q_proj"))

    # barrier: the ranks arrive 0.3 s apart; none leaves before the last arrives
    time.sleep(0.3 * rank)
    out["arrived"] = time.time()
    distributed.barrier()
    out["left"] = time.time()
    return out


def main(mode: str, directory: str) -> None:
    torch.set_num_threads(1)
    from projectiontrainer_tpu_torch.parallel import distributed

    rank, world = distributed.initialize("cpu")
    try:
        if mode == "collectives":
            torch.save(_collectives(directory, rank, world),
                       os.path.join(directory, f"rank{rank}.pt"))
        elif mode == "dp":
            payload = torch.load(os.path.join(directory, "payload.pt"), weights_only=False)
            results = {name: run_case(case, case["params"],
                                      [shard(b, rank, world) for b in case["batches"]])
                       for name, case in payload.items()}
            torch.save(results, os.path.join(directory, f"result{rank}.pt"))
        else:
            raise ValueError(mode)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
