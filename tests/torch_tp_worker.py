"""One rank of the port's tensor-parallel CPU tests (``tests/test_torch_tp.py``), run as
its own process over gloo:

    python tests/torch_tp_worker.py <data>x<model> <dir>

with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``PTT_DIST_TIMEOUT_S`` in the environment (``torch_dp_worker.spawn_ranks`` sets them).
It imports torch and the port, never JAX. The rank lays the world out as a data x model
mesh (``distributed.setup_mesh``), slices every case's full params of
``<dir>/payload.pt`` to its model rank's shards (``parallel/sharding.py``), runs the case
on its data rank's rows and writes ``<dir>/result<r>.pt``:

- ``train``: the trainers' step (``run_case``) over the batches: losses, grad norms,
  every trained leaf gathered whole, and the trained leaves the rules replicate, as the
  rank holds them (equal across the model ranks or not), also as bytes after every step;
- ``forward``: the decoder's hidden states and the gradient of a fixed projection of them
  with respect to the input embeddings and the (gathered) q_proj weights;
- ``ce``: the vocab-parallel fused CE (plain versions) and chunked CE on labels that fall
  in either rank's slice, with their gradients;
- ``generate``: greedy and 3-beam tokens from a prefix;
- ``checkpoint``: a ``CheckpointManager`` save of a sharded train state, read back by
  the test in one process;
- ``roundtrip``: ``gather_params`` of the rank's shards, which the test holds to the
  full tree.

``_counts`` holds the model-axis collectives of the whole run by phase
(``tensor_parallel.COUNTS``), ``_counts_by_case`` each case's.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dp_worker  # noqa: E402

PAD = 0


def run_case(case: dict, params, batches, plan=None) -> dict:
    """The trainers' step (``steps.make_train_step`` with their optimizer) over
    ``batches`` (numpy dicts), on full params (``plan`` None) or a model rank's shards:
    the losses and grad norms it reports, and the trainable leaves after the last step
    (gathered whole under a plan), with the rank's own replicated ones apart."""
    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.train import lora, masks, optim, steps

    kind, cfg = case["kind"], case["cfg"]
    accum = case.get("accum", 1)
    total = -(-len(batches) // accum)
    sharded = frozenset() if plan is None else plan.sharded
    remat = case.get("remat", False)
    if kind == "stage1":
        labels = masks.stage1_labels(params)
        tx, _ = optim.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.1,
                                             weight_decay=0.01, clip_norm=5.0,
                                             sharded_paths=sharded)
        loss = steps.stage1_loss(cfg, PAD, remat=remat, logits_chunk=case.get("chunk", 5),
                                 ce_impl=case.get("ce_impl", "chunked"))
    elif kind == "stage2":
        labels = masks.stage2_labels(params, masks.Stage2Freeze(**case["policy"]))
        tx, _ = optim.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.1,
                                             weight_decay=0.01, clip_norm=1.0,
                                             clip_per_module=True, accum_steps=accum,
                                             sharded_paths=sharded)
        lora_cfg = (lora.LoraConfig(r=case["lora_r"], alpha=2 * case["lora_r"],
                                    dropout=case.get("dropout", 0.0))
                    if "lora_r" in case else None)
        loss = steps.stage2_loss(cfg, PAD, lora_cfg=lora_cfg, remat=remat,
                                 logits_chunk=case.get("chunk", 5),
                                 ce_impl=case.get("ce_impl", "chunked"),
                                 table_frozen=lora_cfg is not None)
    else:
        raise ValueError(kind)
    step = steps.make_train_step(loss, tx, trainable_mask=masks.bool_mask(labels), plan=plan)
    state = steps.init_state(params, tx)
    trained = set(state["opt_state"]["mu"])
    losses, norms, replicated_bytes = [], [], []
    for i, b in enumerate(batches):
        state, value, aux = step(state, {k: torch.tensor(v) for k, v in b.items()}, i)
        losses.append(float(value))
        norms.append(float(aux["grad_norm"]))
        if plan is not None:  # the replicated trained leaves' bytes after every step
            replicated_bytes.append(b"".join(
                x.detach().contiguous().view(torch.uint8).numpy().tobytes()
                for p, x in unique_leaves_with_paths(params)
                if p in trained and p not in plan.sharded))
    leaves = [(p, x.detach().clone()) for p, x in unique_leaves_with_paths(params)
              if p in trained]
    out = {"losses": losses, "grad_norms": norms,
           "params": {p: (x if plan is None else plan.gather(p, x)) for p, x in leaves}}
    if plan is not None:
        out["replicated"] = {p: x for p, x in leaves if p not in plan.sharded}
        out["replicated_bytes_by_step"] = replicated_bytes
    return out


def forward_case(case: dict, params, plan=None) -> dict:
    """The decoder over fixed embeddings under ``case['remat']``: hidden states, and the
    gradients of ``sum(hidden * probe)`` with respect to the embeddings and q_proj."""
    from projectiontrainer_tpu_torch.models import decoder

    cfg = case["cfg"]
    embeds = torch.tensor(case["embeds"], requires_grad=True)
    q = params["layers"][0]["attn"]["q_proj"]["weight"].requires_grad_(True)
    hidden, _ = decoder.forward(params, cfg, inputs_embeds=embeds,
                                attention_mask=torch.tensor(case["mask"]),
                                remat=case.get("remat", False))
    (hidden * torch.tensor(case["probe"])).sum().backward()
    gq = q.grad if plan is None else plan.gather("llm/layers/0/attn/q_proj/weight", q.grad)
    return {"hidden": hidden.detach(), "d_embeds": embeds.grad, "d_q": gq}


def ce_case(case: dict, table, plan=None) -> dict:
    """The fused CE (its plain versions here) and the chunked CE on labels spread over
    the whole vocab: per-token nll and the gradients (hidden; the table's slice, gathered,
    for the chunked one)."""
    from projectiontrainer_tpu_torch.ops import fused_ce
    from projectiontrainer_tpu_torch.parallel import tensor_parallel as tp

    out = {}
    labels = torch.tensor(case["labels"])
    g = torch.tensor(case["g"])
    for name in ("fused", "chunked"):
        h = torch.tensor(case["hidden"], requires_grad=True)
        w = table.detach().clone().requires_grad_(True)
        if tp.size() == 1:
            fn = (fused_ce.fused_clm_token_nll if name == "fused" else
                  lambda h_, w_, l_, s: fused_ce.chunked_nll_vocab_parallel(h_, w_, l_, s, 4))
        else:
            fn = (fused_ce.fused_clm_token_nll_vocab_parallel if name == "fused" else
                  lambda h_, w_, l_, s: fused_ce.chunked_nll_vocab_parallel(h_, w_, l_, s, 4))
        nll = fn(h, w, labels, 0.5)
        (nll * g).sum().backward()
        dw = w.grad if plan is None else plan.gather("llm/embed_tokens/embedding", w.grad)
        out[name] = {"nll": nll.detach(), "dh": h.grad, "dw": dw}
    return out


def generate_case(case: dict, params) -> dict:
    from projectiontrainer_tpu_torch.generate import GenerationConfig, generate

    embeds, mask = torch.tensor(case["embeds"]), torch.tensor(case["mask"])
    out = {}
    for beams in (1, 3):
        cfg = GenerationConfig(max_new_tokens=6, num_beams=beams, eos_token_id=1,
                               pad_token_id=PAD)
        out[f"beams{beams}"] = generate(params, case["cfg"], embeds, mask, cfg)
    return out


def checkpoint_case(case: dict, params, plan, directory: str) -> dict:
    """One QLoRA step, then an epoch checkpoint of the sharded state (rank 0 writes the
    gathered leaves); returns the state's trained leaves gathered whole."""
    from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
    from projectiontrainer_tpu_torch.train import lora, masks, optim, steps

    labels = masks.stage2_labels(params, masks.Stage2Freeze(**case["policy"]))
    tx, _ = optim.single_group_optimizer(labels, 3e-3, total_steps=1, clip_norm=1.0,
                                         clip_per_module=True, sharded_paths=plan.sharded)
    lcfg = lora.LoraConfig(r=case["lora_r"], alpha=2 * case["lora_r"], dropout=0.0)
    loss = steps.stage2_loss(case["cfg"], PAD, lora_cfg=lcfg, remat=False, logits_chunk=5,
                             ce_impl="chunked", table_frozen=True)
    step = steps.make_train_step(loss, tx, trainable_mask=masks.bool_mask(labels), plan=plan)
    state = steps.init_state(params, tx)
    state, _, _ = step(state, {k: torch.tensor(v) for k, v in case["batch"].items()}, 0)
    ckpt = CheckpointManager(os.path.join(directory, "ckpt"), plan=plan)
    ckpt.save_periodic(0, state, {"epoch": 0})
    return {"mu": {p: plan.gather(p, x) for p, x in state["opt_state"]["mu"].items()}}


def main(mesh: str, directory: str) -> None:
    torch.set_num_threads(1)
    from projectiontrainer_tpu_torch.parallel import distributed, sharding

    data, model = (int(v) for v in mesh.split("x"))
    rank, world = distributed.initialize("cpu")
    try:
        distributed.setup_mesh(data, model)
        d = distributed.data_rank()
        payload = torch.load(os.path.join(directory, "payload.pt"), weights_only=False)
        from projectiontrainer_tpu_torch.parallel import tensor_parallel

        results, by_case = {}, {}
        for name, case in payload.items():
            before = dict(tensor_parallel.COUNTS)
            kind = case["kind"]
            plan = sharding.plan_for(case["params"], case["cfg"],
                                     prefix=case.get("prefix", ""))
            params = sharding.shard_params(case["params"], plan, case.get("prefix", ""))
            if kind in ("stage1", "stage2"):
                rows = [torch_dp_worker.shard(b, d, data) for b in case["batches"]]
                results[name] = run_case(case, params, rows, plan)
            elif kind == "forward":
                results[name] = forward_case(case, params, plan)
            elif kind == "ce":
                results[name] = ce_case(case, params["llm"]["embed_tokens"]["embedding"],
                                        plan)
            elif kind == "generate":
                results[name] = generate_case(case, params)
            elif kind == "checkpoint":
                results[name] = checkpoint_case(case, params, plan, directory)
            elif kind == "roundtrip":
                from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths

                results[name] = dict(unique_leaves_with_paths(
                    sharding.gather_params(params, plan)))
            else:
                raise ValueError(kind)
            by_case[name] = {k: v - before[k] for k, v in tensor_parallel.COUNTS.items()}
        results["_counts"] = dict(tensor_parallel.COUNTS)
        results["_counts_by_case"] = by_case
        torch.save(results, os.path.join(directory, f"result{rank}.pt"))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
