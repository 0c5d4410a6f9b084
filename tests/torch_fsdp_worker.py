"""One rank of the port's ``--fsdp`` CPU tests (``tests/test_torch_fsdp.py``), run as its
own process over gloo:

    python tests/torch_fsdp_worker.py <data>x<model> <dir>

with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``PTT_DIST_TIMEOUT_S`` in the environment (``torch_dp_worker.spawn_ranks`` sets them).
It imports torch and the port, never JAX. The rank lays the world out as a data x model
mesh, slices every case's full params of ``<dir>/payload.pt`` to its model rank's
shards and then to its data shards under the ``--fsdp`` plan (``parallel/sharding.py``),
runs the case on its data rank's rows and writes ``<dir>/result<r>.pt``:

- ``steps``: the stage-2 full-joint step (``run_steps``) over the batches: losses,
  grad norms, the first micro-step's gradients and the trained leaves after the last
  step gathered whole, the shapes of the rank's leaves and optimizer slots against the
  plan's, the rank's bytes, and the FSDP collectives of the first micro-step as
  (phase, leaf, bytes) with the peak of live gathered bytes;
- with ``resume_at`` K the case also saves an epoch checkpoint after step K, restores
  it into a fresh state and runs the remaining steps: the final trained leaves of
  that run, which the test holds bit-equal to the uninterrupted one.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dp_worker  # noqa: E402

PAD = 0


def place(full, cfg, plan_kw=None):
    """(the rank's shards of ``full`` over both axes, the ``--fsdp`` plan)."""
    from projectiontrainer_tpu_torch.parallel import sharding

    kw = plan_kw or {}
    model_plan = sharding.plan_for(full, cfg, **kw)
    local = sharding.shard_params(full, model_plan, axes=(sharding.MODEL_AXIS,))
    plan = sharding.plan_for(local, cfg, fsdp=True, **kw)
    return sharding.shard_params(local, plan, axes=(sharding.DATA_AXIS,)), plan


def _step(case, params, plan):
    """(step, tx, the trained paths) of the stage-2 full-joint recipe of the JAX
    package's ``tests/test_fsdp.py:_run_steps``."""
    from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
    from projectiontrainer_tpu_torch.train import masks, optim, steps

    labels = masks.stage2_labels(params, masks.Stage2Freeze(
        train_llm=True, use_lora=False, train_projector=True, train_vision=True))
    tx, _ = optim.single_group_optimizer(labels, 1e-3, total_steps=10, clip_norm=1.0,
                                         clip_per_module=True, accum_steps=2,
                                         sharded_paths=plan.sharded,
                                         fsdp_paths=plan.data_sharded)
    loss = steps.stage2_loss(case["cfg"], PAD, remat=case.get("remat", False),
                             logits_chunk=64, table_frozen=False)
    step = steps.make_train_step(loss, tx, trainable_mask=masks.bool_mask(labels), plan=plan)
    return step, tx, {p for p, on in leaves_with_paths(masks.bool_mask(labels)) if on}


def _nbytes(tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def run_steps(case: dict, full, rows, directory: str = None) -> dict:
    """Every step of ``case`` on this rank's ``rows`` (numpy dicts) from ``full`` params
    (placed here; one process: the plan splits nothing)."""
    from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.parallel import fsdp
    from projectiontrainer_tpu_torch.train import steps

    params, plan = place(full, case["cfg"])
    step, tx, trained = _step(case, params, plan)
    state = steps.init_state(params, tx)
    first = {}
    update = tx.update

    def capture(grads, opt_state, p):  # the first micro-step's gradients, whole
        if not first:
            first.update({k: plan.gather(k, g) for k, g in grads.items()})
        return update(grads, opt_state, p)

    tx.update = capture
    out = {"losses": [], "grad_norms": [], "plan_data_dims": dict(plan.data_dims),
           "plan_local": dict(plan.local_shapes)}
    batches = [{k: torch.tensor(v) for k, v in b.items()} for b in rows]
    for i, b in enumerate(batches):
        if i == 0:
            fsdp.reset_counts()
            fsdp.track(True)
        state, loss, aux = step(state, b, i)
        if i == 0:
            out.update(events=list(fsdp.LIVE["events"]), live_peak=fsdp.LIVE["peak"],
                       live_after=fsdp.LIVE["bytes"], counts=dict(fsdp.COUNTS))
            fsdp.track(False)
        out["losses"].append(float(loss))
        out["grad_norms"].append(float(aux["grad_norm"]))
        if directory is not None and i + 1 == case.get("resume_at"):
            ckpt = CheckpointManager(os.path.join(directory, "ckpt"), plan=plan,
                                     save_paths=trained)
            ckpt.save_periodic(0, state, {"epoch": 0})
    leaves = dict(unique_leaves_with_paths(params))
    out["first_grads"] = first
    out["params"] = {p: plan.gather(p, x.detach()) for p, x in leaves.items() if p in trained}
    out["shapes"] = {p: tuple(x.shape) for p, x in leaves.items()}
    out["slot_shapes"] = {k: {p: tuple(x.shape) for p, x in v.items()}
                          for k, v in state["opt_state"].items() if isinstance(v, dict)}
    out["local_bytes"] = {"params": _nbytes(leaves.values()),
                          "state": _nbytes(x for v in state["opt_state"].values()
                                           if isinstance(v, dict) for x in v.values())}
    if directory is not None and case.get("resume_at"):
        out["resumed"] = _resume(case, full, batches, plan, directory, trained)
    return out


def _resume(case, full, batches, plan, directory, trained) -> dict:
    """A fresh state restored from the epoch checkpoint, then the remaining steps."""
    from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.train import steps

    params, _ = place(full, case["cfg"])
    step, tx, _ = _step(case, params, plan)
    state = steps.init_state(params, tx)
    CheckpointManager(os.path.join(directory, "ckpt"), plan=plan).restore("epoch_0", state)
    k = case["resume_at"]
    losses = []
    for i, b in enumerate(batches[k:], start=k):
        state, loss, _ = step(state, b, i)
        losses.append(float(loss))
    return {"losses": losses, "params": {
        p: plan.gather(p, x.detach()) for p, x in unique_leaves_with_paths(params)
        if p in trained}}


def main(mesh: str, directory: str) -> None:
    torch.set_num_threads(1)
    from projectiontrainer_tpu_torch.parallel import distributed

    data, model = (int(v) for v in mesh.split("x"))
    rank, world = distributed.initialize("cpu")
    try:
        distributed.setup_mesh(data, model)
        d = distributed.data_rank()
        payload = torch.load(os.path.join(directory, "payload.pt"), weights_only=False)
        results = {}
        for name, case in payload.items():
            rows = [torch_dp_worker.shard(b, d, data) for b in case["batches"]]
            results[name] = run_steps(case, case["params"], rows,
                                      os.path.join(directory, name))
        torch.save(results, os.path.join(directory, f"result{rank}.pt"))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
