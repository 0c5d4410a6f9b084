"""The memory and collective budget of the port (``parallel/budget.py``,
``cli/budget.py``) on the small-test preset, on the CPU.

- The state a rank holds at 8 x 1 and 4 x 2 against the JAX budget's
  ``state_bytes_per_device`` (``projectiontrainer_tpu/parallel/budget.py``'s own
  abstract params, FSDP shardings, optimizer state and ``_leaf_local_bytes``, as its
  ``full_joint_budget`` computes them before it compiles): equal but for two things,
  leaf by leaf. The JAX VLM tree carries the SigLIP tower's MAP head (15 leaves, which
  stage 2 never runs, each with Adam moments and an accumulator), which the port's VLM
  does not build; and optax's four int32 counters (Adam's count, MultiSteps' mini-step
  and gradient step, its skip state), which the port keeps as Python ints.
- The fake trace's peak, and its split by category, equal the same tracker's over a
  real CPU run of the same step, to the byte.
- The collectives of the traced micro-step at 2 x 1 equal those of a real 2-process
  gloo run of the same micro-step and apply (``tests/torch_budget_worker.py``).
- The card's trace (meta tensors: no CUDA here) runs the small-test preset, whose towers
  have head dim 32, through the kernels' branch (padded) and launches nothing.
- The CLI prints every key of the report; at a model axis of 8 over the small-test
  preset (replicated KV heads, a whole tower attention) the collectives are the count
  read off the plan.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu.parallel import budget as JB
from projectiontrainer_tpu.parallel import param_shardings
from projectiontrainer_tpu.train import masks as JM
from projectiontrainer_tpu.train import optim as JO
from projectiontrainer_tpu_torch.cli import budget as cli
from projectiontrainer_tpu_torch.ops import flash_attention as FA
from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN
from projectiontrainer_tpu_torch.parallel import budget, distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(batch_per_device=2, q_len=8, a_len=16, accum_steps=2)
REPORT_KEYS = {"kind", "traced_on", "mesh", "model", "batch_global", "batch_per_device",
               "seq", "master_dtype", "remat", "accum_steps", "logits_chunk",
               "state_bytes_per_device", "limit_bytes", "oom", "per_device", "fits",
               "collectives", "trace_s"}


def _jax_state_bytes(n_devices, model_axis):
    """(params, optimizer state, MAP head params) bytes a device holds in the JAX
    budget's state at ``n_devices`` / ``model_axis``, fp32 masters, accumulation 2."""
    cfg = JB.small_test_vlm_cfg()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n_devices]).reshape(
        n_devices // model_axis, model_axis), ("data", "model"))
    p = jax.eval_shape(lambda: JVLM.init(jax.random.key(0), cfg))
    p = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
        s.shape, jnp.float32 if jnp.issubdtype(s.dtype, jnp.floating) else s.dtype), p)
    shardings = param_shardings(p, mesh, fsdp=True)
    labels = JM.stage2_labels(p, JM.Stage2Freeze(train_llm=True, use_lora=False,
                                                 train_projector=True, train_vision=True))
    tx, _ = JO.single_group_optimizer(labels, 1e-5, total_steps=1000, warmup_ratio=0.05,
                                      weight_decay=0.01, clip_norm=1.0, clip_per_module=True,
                                      accum_steps=2)
    opt = jax.eval_shape(tx.init, p)
    st = JB._state_shardings({"params": p, "opt_state": opt,
                              "step": jax.ShapeDtypeStruct((), jnp.int32)}, shardings, mesh)

    def attach(s, sh):
        return jax.ShapeDtypeStruct(getattr(s, "shape", ()), s.dtype, sharding=sh)

    params = jax.tree.map(attach, p, shardings)
    local = lambda tree: sum(JB._leaf_local_bytes(x) for x in jax.tree_util.tree_leaves(tree))
    return (local(params), local(jax.tree.map(attach, opt, st["opt_state"])),
            local(params["vision"]["head"]))


@pytest.mark.parametrize("n_devices,model_axis", [(8, 1), (4, 2)])
def test_state_bytes_equal_the_jax_budget(n_devices, model_axis):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with distributed.fake_world(n_devices, model=model_axis), FakeTensorMode():
        program = budget.build_program(budget.small_test_config(), budget.trace_device("cuda"),
                                       fake=True, master_dtype="fp32", remat="full", **SMALL)
        params, opt = budget.state_tensors(program.state)
        ours = (budget._nbytes(params), budget._nbytes(opt))
    j_params, j_opt, j_head = _jax_state_bytes(n_devices, model_axis)
    counters = 4 * 4  # four int32 scalars of optax's state
    assert ours[0] == j_params - j_head
    assert ours[1] == j_opt - 3 * j_head - counters  # mu, nu and the accumulator
    assert counters <= 1024
    report = budget.full_joint_budget(budget.small_test_config(), n_devices=n_devices,
                                      model_axis=model_axis, **SMALL)
    assert report["state_bytes_per_device"] == sum(ours)
    assert report["fits"] and report["oom"] is None


@pytest.mark.parametrize("remat,accum", [("full", 2), ("none", 1)])
def test_fake_peak_equals_a_real_cpu_run(remat, accum):
    kw = dict(SMALL, accum_steps=accum, remat=remat, device="cpu", n_devices=1)
    fake = budget.full_joint_budget(budget.small_test_config(), **kw)
    real = budget.full_joint_budget(budget.small_test_config(), fake=False, **kw)
    assert (fake["kind"], real["kind"]) == ("fake-trace", "tracked-run")
    assert fake["per_device"] == real["per_device"]
    assert fake["per_device"]["peak_bytes"] == sum(
        v for k, v in fake["per_device"].items() if k != "peak_bytes")
    assert fake["per_device"]["grads_bytes"] > 0 and fake["per_device"]["params_bytes"] > 0
    assert fake["state_bytes_per_device"] == real["state_bytes_per_device"]
    assert fake["limit_bytes"] is None and fake["fits"] is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_collectives_equal_a_real_two_rank_run():
    kw = dict(SMALL, master_dtype="fp32", remat="full")
    traced = budget.full_joint_budget(budget.small_test_config(), n_devices=2, device="cpu",
                                      **kw)["collectives"]
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_budget_worker.py"),
                               json.dumps(kw)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-3000:] for o in outs]
    line = next(l for l in outs[0][0].splitlines() if l.startswith("COLLECTIVES "))
    real = json.loads(line[len("COLLECTIVES "):])
    assert traced == real
    assert traced["all-gather"]["forward"]["count"] > 0
    assert traced["reduce-scatter"]["backward"]["count"] > 0
    assert traced["all-reduce"]["optimizer"]["count"] == 1  # the clip's norms


def test_card_trace_runs_the_kernels_branch():
    before = (FA.launches.value, FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value,
              FLN.launches.value, FLN.bwd_launches.value)
    report = budget.full_joint_budget(budget.small_test_config(), n_devices=8, **SMALL)
    assert report["traced_on"] == "meta" and report["kind"] == "fake-trace"
    assert report["limit_bytes"] == budget.H100_USABLE_BYTES and report["fits"] is True
    assert report["per_device"]["peak_bytes"] % budget.ALLOCATOR_ROUND == 0
    assert (FA.launches.value, FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value,
            FLN.launches.value, FLN.bwd_launches.value) == before
    cpu = budget.full_joint_budget(budget.small_test_config(), n_devices=8, device="cpu",
                                   **SMALL)
    # the plain attention keeps its fp32 scores where the kernels keep none
    assert cpu["per_device"]["peak_bytes"] != report["per_device"]["peak_bytes"]
    assert cpu["collectives"] == report["collectives"]


def test_cli_prints_every_key(capsys):
    cli.main(["--preset", "small-test", "--device", "cpu", "--n_devices", "4",
              "--batch_per_device", "1", "--q_len", "8", "--a_len", "16",
              "--accum_steps", "2"])
    report = json.loads(capsys.readouterr().out)
    assert REPORT_KEYS <= set(report)
    assert set(report["per_device"]) == {"peak_bytes"} | {f"{k}_bytes" for k in budget.CATEGORIES}
    assert report["mesh"] == {"data": 4, "model": 1} and report["batch_global"] == 4
    # the trainer's chunk: the small-test vocabulary (4096) keeps its logits whole
    assert report["model"] == "small-test" and report["logits_chunk"] is None


def test_cli_traces_a_model_axis_that_does_not_divide(capsys):
    """``--n_devices 8 --model_axis 8`` over the small-test preset: its decoder's 8 query
    heads split over 4 KV heads (the KV heads replicated, each rank slicing the one its
    query head reads) and its tower's 4 heads whole, the rest split. The traced
    collectives are the count read off the plan (``sharding.units``): a split unit's
    row-parallel exit all-reduces in the forward and ``copy_to_model`` at its entry in
    the backward; a whole unit neither. Under full remat each decoder block's exit is
    recomputed, a tower layer's MLP exit is not (its last operator: the checkpoint's
    recompute stops at the last tensor the backward needs)."""
    from projectiontrainer_tpu_torch.parallel import sharding

    cli.main(["--preset", "small-test", "--device", "cpu", "--n_devices", "8",
              "--model_axis", "8"])
    report = json.loads(capsys.readouterr().out)
    assert report["mesh"] == {"data": 1, "model": 8} and report["logits_chunk"] is None
    assert report["whole_units"] == ["llm KV heads", "vision attention"]
    cfg = budget.small_test_config()
    llm, vis = (sharding.units(c, 8) for c in (cfg.llm, cfg.vision))
    proj = sharding.units(cfg.projector, 8).mlp
    blocks = cfg.llm.num_layers * (llm.attn + llm.mlp)
    tower = cfg.vision.num_layers * (vis.attn + vis.mlp)
    want = {
        # the logits of the split vocab (no chunk under a vocabulary of 32768)
        "all-gather": {"forward": 1},
        "all-reduce": {
            "forward": tower + proj + blocks + 2 * llm.vocab,  # question and answer lookups
            "recompute": blocks + cfg.vision.num_layers * vis.attn,
            "backward": tower + proj + blocks + llm.vocab,  # the LM head's input
            "grads": 2,      # the partial gradients' sum, the step's grad norm
            "optimizer": 1,  # the clip's norm
        },
    }
    got = {kind: {phase: v["count"] for phase, v in by_phase.items()}
           for kind, by_phase in report["collectives"].items()}
    assert got == want
    assert want["all-reduce"] == {"forward": 9, "recompute": 4, "backward": 8, "grads": 2,
                                  "optimizer": 1}
