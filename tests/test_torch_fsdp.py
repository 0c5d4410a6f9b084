"""ZeRO-3 over the data axis (``--fsdp``) in the port on the CPU, against the JAX package's
``param_shardings(..., fsdp=True)`` and its FSDP train step (``tests/test_fsdp.py``), and
against one port process.

- The layout: for every leaf of the wide VLM of ``tests/test_fsdp.py`` (tower 128/512,
  Qwen3 256/768, vocab 4096) on the meshes {data 4, model 2} and {data 2, model 1}, the
  port's plan names the dims that JAX's specs name, read through the port's ``[out, in]``
  layout; and the rule's own cases (``test_fsdp_axis_helper``) on the JAX layout.
- The bytes: a rank's params and optimizer state (moments, accumulators) at most total /
  data + the replicated residue, and the replicated layout more than 2.5x larger.
- The steps: ``tests/torch_fsdp_worker.py`` ranks (gloo, no JAX) at data 2 and data 2 x
  model 2 run 3 full-joint stage-2 steps of ``_run_steps``'s recipe (accumulation 2,
  per-module clip, fp32) from the same weights (``checkpoint/from_jax.py``); held against
  one port process and against JAX ``_run_steps(fsdp=True)`` on its CPU mesh with the
  JAX test's bounds: losses rtol 1e-5, the first micro-step's gradients rtol 1e-4 / atol
  1e-5, params within 2e-2. The shards and the optimizer slots keep the plan's shapes.
- The gathers: a tied Gemma3 VLM under remat ``True``: each data shard gathered once
  in the forward, once more in the recompute when it sits in a layer, its gradient
  reduce-scattered once (the tied table too: one gather serves the embedding and the
  CE head), and the live gathered bytes never above the top-level leaves (the table,
  the projector, the tower's stem, which the step holds throughout) plus the largest
  layer; under ``'dots'`` the recompute gathers nothing.
- The checkpoints: an epoch checkpoint saved by the ranks mid-accumulation holds whole
  leaves that load in one process, and resuming from it continues bit-equal.
- Gemma3-4B's features at a tiny width (sliding pattern 6, window, rope factor 8,
  ``query_pre_attn_scalar`` 256, 4 query heads over 2 KV heads of 32): the decoder's
  hidden states and gradients against the JAX decoder's.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from projectiontrainer_tpu.core import mesh as JMESH
from projectiontrainer_tpu.core.pytree import path_str
from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu.models import projector as JPROJ
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu.parallel import param_shardings
from projectiontrainer_tpu.parallel.sharding import _with_fsdp_axis
from projectiontrainer_tpu.train import steps as JS
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
from projectiontrainer_tpu_torch.models import decoder as dec
from projectiontrainer_tpu_torch.parallel import sharding
from projectiontrainer_tpu_torch.train import masks, optim

import test_fsdp
import torch_dp_worker
import torch_fsdp_worker

torch.set_num_threads(2)
MESHES = ("2x1", "2x2")
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fsdp_worker.py")


# ------------------------------------------------------------------ models and batches


@functools.cache
def _wide():
    jcfg = test_fsdp._wide_vlm_cfg()
    return jcfg, jax.tree.map(np.asarray, JVLM.init(jax.random.key(0), jcfg))


@functools.cache
def _tied_gemma():
    """A tied Gemma3 VLM whose table, projector, tower MLPs and decoder q/o/MLP leaves
    clear FSDP_MIN_SIZE (the k/v projections, 2 heads of 64, stay replicated)."""
    jcfg = test_fsdp._wide_vlm_cfg()
    llm = JDEC.gemma3_config(vocab_size=512, hidden_size=256, intermediate_size=512,
                             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                             sliding_window=8, sliding_pattern=2, query_pre_attn_scalar=64)
    jcfg = JVLM.VLMConfig(vision=jcfg.vision, llm=llm, projector=JPROJ.ProjectorConfig(
        vision_dim=128, llm_dim=256, expansion_factor=4))
    return jcfg, jax.tree.map(np.asarray, JVLM.init(jax.random.key(1), jcfg))


def _batches(vocab, n=3):
    """``tests/test_fsdp.py:_run_steps``'s batches: 8 rows from rng 7."""
    rng = np.random.default_rng(7)
    return [{"pixel_values": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
             "question_ids": rng.integers(1, vocab, size=(8, 8)),
             "answer_ids": rng.integers(1, vocab, size=(8, 12))} for _ in range(n)]


def _case(name):
    """The port's case: config, full params, batches and step options."""
    if name == "full_joint":
        jcfg, jp = _wide()
        opts = dict(remat=False, resume_at=1, batches=_batches(4096))
    else:
        jcfg, jp = _tied_gemma()
        opts = dict(remat=True if name == "gathers" else "dots", batches=_batches(512, 1))
    return dict(cfg=from_jax.config_from_jax(jcfg), params=from_jax.vlm_params(jp), **opts)


CASES = ("full_joint", "gathers", "gathers_dots")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh: (result dicts by rank, directory)}."""
    out = {}
    for mesh in MESHES:
        d = str(tmp_path_factory.mktemp(f"fsdp{mesh}"))
        torch.save({n: _case(n) for n in CASES}, os.path.join(d, "payload.pt"))
        data, model = (int(v) for v in mesh.split("x"))
        torch_dp_worker.spawn_ranks(mesh, d, data * model, script=WORKER)
        out[mesh] = ([torch.load(os.path.join(d, f"result{r}.pt"), weights_only=False)
                      for r in range(data * model)], d)
    return out


@functools.cache
def _one_process(name):
    case = _case(name)
    return torch_fsdp_worker.run_steps(case, case["params"], case["batches"])


# ------------------------------------------------------------------ the layout


def _expected(jpath: str, ndim: int, spec) -> tuple[str, dict]:
    """(the port's path, {axis: port dim}) of a JAX leaf's spec: a 2-D kernel [in, out]
    is the port's weight [out, in]; the patch kernel [p, p, C, D] the matrix
    [D, p*p*C], whose column blocks are patch rows."""
    if jpath.endswith("patch_embedding/kernel"):
        path, to_port = jpath[:-len("kernel")] + "weight", {3: 0, 0: 1}
    elif jpath.endswith("/kernel") and ndim == 2:
        path, to_port = jpath[:-len("kernel")] + "weight", {0: 1, 1: 0}
    else:
        path, to_port = jpath, {d: d for d in range(ndim)}
    return path, {axis: to_port[d] for d, axis in enumerate(spec) if axis is not None}


@pytest.mark.parametrize("data,model", [(4, 2), (2, 1)])
def test_fsdp_specs_match_jax_param_shardings(data, model):
    jcfg, jp = _wide()
    jmesh = JMESH.build_mesh(JMESH.MeshConfig(data=data, model=model))
    specs = param_shardings(jp, jmesh, fsdp=True)
    cfg, full = from_jax.config_from_jax(jcfg), from_jax.vlm_params(jp)
    kw = dict(model=model, rank=0, data=data, data_rank=0)
    local = sharding.shard_params(full, sharding.plan_for(full, cfg, **kw),
                                  axes=(sharding.MODEL_AXIS,))
    plan = sharding.plan_for(local, cfg, fsdp=True, **kw)
    leaves = {path_str(p): x for p, x in jax.tree_util.tree_leaves_with_path(jp)}
    checked = 0
    for p, s in jax.tree_util.tree_leaves_with_path(specs):
        jpath = path_str(p)
        if jpath.startswith("vision/head/"):
            continue  # the VLM's tower carries no MAP head in the port
        path, want = _expected(jpath, np.ndim(leaves[jpath]), tuple(s.spec))
        if model == 1:
            want.pop("model", None)
        got = {}
        if model > 1 and path in plan.dims:
            got["model"] = plan.dims[path]
        if path in plan.data_dims:
            got["data"] = plan.data_dims[path]
        assert got == want, (path, tuple(s.spec))
        checked += "data" in want
    assert checked >= 15


# (JAX spec, JAX shape) of tests/test_fsdp.py:test_fsdp_axis_helper, and the port leaf
# whose rules give that spec: a ruled kernel, an o_proj kernel, an unruled table
HELPER_CASES = [
    (P(None, "model"), (256, 512), "llm/layers/0/attn/q_proj/weight"),
    (P(), (1024, 256), "vision/position_embedding/embedding"),
    (P(), (256, 1024), "vision/position_embedding/embedding"),
    (P(), (64, 64), "vision/position_embedding/embedding"),
    (P(), (100_000,), "vision/position_embedding/embedding"),
    (P(), (1023, 511), "vision/position_embedding/embedding"),
    (P("model", None), (512, 513), "llm/layers/0/attn/o_proj/weight"),
]


@pytest.mark.parametrize("spec,shape,path", HELPER_CASES)
def test_fsdp_axis_rule_matches_jax(cpu_mesh, spec, shape, path):
    want = tuple(_with_fsdp_axis(spec, shape, cpu_mesh))
    transposed = path.endswith("/weight")
    port_shape = tuple(reversed(shape)) if transposed else shape
    got = sharding.fsdp_dim(path, port_shape, cpu_mesh.shape["data"],
                            model=cpu_mesh.shape["model"])
    jax_dim = want.index("data") if "data" in want else None
    if jax_dim is not None and transposed:
        jax_dim = 1 - jax_dim
    assert got == jax_dim, (want, got)


@pytest.mark.parametrize("data,model", [(4, 2), (4, 1)])
def test_rank_bytes_are_a_data_share_plus_the_residue(data, model):
    """Params + Adam moments + accumulators of every rank against the whole tree's; the
    replicated layout (data-parallel, model shards only) more than 2.5x larger."""
    jcfg, jp = _wide()
    cfg, full = from_jax.config_from_jax(jcfg), from_jax.vlm_params(jp)

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for _, x in unique_leaves_with_paths(tree))

    def state_bytes(params, fsdp_paths=frozenset()):
        labels = masks.stage2_labels(params, masks.Stage2Freeze(
            train_llm=True, use_lora=False, train_projector=True, train_vision=True))
        tx, _ = optim.single_group_optimizer(labels, 1e-4, total_steps=10, accum_steps=2,
                                             fsdp_paths=fsdp_paths)
        state = tx.init(params)
        return nbytes(params) + sum(nbytes(v) for v in state.values() if isinstance(v, dict))

    for r in range(data * model):
        kw = dict(model=model, rank=r % model, data=data, data_rank=r // model)
        model_plan = sharding.plan_for(full, cfg, **kw)
        local = sharding.shard_params(full, model_plan, axes=(sharding.MODEL_AXIS,))
        plan = sharding.plan_for(local, cfg, fsdp=True, **kw)
        shards = sharding.shard_params(local, plan, axes=(sharding.DATA_AXIS,))
        residue = 4 * sum(x.numel() * x.element_size()  # params, mu, nu, acc
                          for p, x in unique_leaves_with_paths(local)
                          if p not in plan.data_sharded)
        ours, replicated = state_bytes(shards, plan.data_sharded), state_bytes(local)
        assert ours <= (replicated - residue) / data + residue + 1, (r, ours)
        assert replicated > 2.5 * ours


# ------------------------------------------------------------------ the steps


def _assert_steps_close(got, losses, grads, params):
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert got["first_grads"].keys() == grads.keys() and grads
    for p, g in grads.items():
        np.testing.assert_allclose(got["first_grads"][p].numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-5, err_msg=p)
    assert got["params"].keys() == params.keys()
    for p, x in params.items():
        d = float((got["params"][p].double() - torch.as_tensor(np.asarray(x)).double())
                  .abs().max())
        assert d < 2e-2, (p, d)


@pytest.mark.parametrize("mesh", MESHES)
def test_full_joint_steps_match_one_process(ranks, mesh):
    ref = _one_process("full_joint")
    assert not ref["plan_data_dims"]  # one process: nothing to shard
    for r in ranks[mesh][0]:
        got = r["full_joint"]
        _assert_steps_close(got, ref["losses"], ref["first_grads"], ref["params"])
        np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"], rtol=1e-5)


@functools.cache
def _jax_reference(mesh):
    """JAX ``_run_steps(fsdp=True)`` on the data x model CPU mesh (losses, trained params
    in the port's layout) and the whole-batch gradient of the first batch."""
    jcfg, jp = _wide()
    data, model = (int(v) for v in mesh.split("x"))
    jmesh = JMESH.build_mesh(JMESH.MeshConfig(data=data, model=model))
    losses, state = test_fsdp._run_steps(jax.tree.map(jnp.asarray, jp), jmesh, jcfg,
                                         fsdp=True)
    params = dict(unique_leaves_with_paths(from_jax.vlm_params(
        jax.tree.map(np.asarray, state["params"]))))
    loss_fn = JS.stage2_loss(jcfg, 0, remat=False, logits_chunk=64, table_frozen=False)
    batch = jax.tree.map(jnp.asarray, _batches(4096, 1)[0])
    g = jax.jit(jax.grad(lambda p, b: loss_fn(p, b, None)[0]))(
        jax.tree.map(jnp.asarray, jp), batch)
    grads = dict(unique_leaves_with_paths(from_jax.vlm_params(jax.tree.map(np.asarray, g))))
    return losses, grads, params


@pytest.mark.parametrize("mesh", MESHES)
def test_full_joint_steps_match_the_jax_fsdp_step(ranks, mesh):
    losses, grads, params = _jax_reference(mesh)
    got = ranks[mesh][0][0]["full_joint"]
    trained = set(got["params"])
    _assert_steps_close(got, losses, {p: g for p, g in grads.items() if p in trained},
                        {p: x for p, x in params.items() if p in trained})


@pytest.mark.parametrize("mesh", MESHES)
def test_shards_and_optimizer_slots_keep_the_plan_layout(ranks, mesh):
    for r in ranks[mesh][0]:
        got = r["full_joint"]
        local = got["plan_local"]
        assert len(local) >= 15
        for p, shape in local.items():
            assert got["shapes"][p] == shape, p
            for slots in got["slot_shapes"].values():
                assert slots[p] == shape, p


# ------------------------------------------------------------------ the gathers


def _events(r, name):
    out = {}
    for phase, path, n in r[name]["events"]:
        out.setdefault(path, {}).setdefault(phase, []).append(n)
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_full_remat_gathers_each_layer_twice_and_the_table_once(ranks, mesh):
    for r in ranks[mesh][0]:
        got = r["gathers"]
        events = _events(r, "gathers")
        sharded = set(got["shapes"]) & set(got["plan_local"])
        assert "llm/embed_tokens/embedding" in sharded and len(sharded) >= 15
        assert set(events) == sharded  # every data shard, under its first path only
        for p, by_phase in events.items():
            in_layer = "/layers/" in p
            assert len(by_phase["forward"]) == 1, p
            assert len(by_phase.get("recompute", [])) == (1 if in_layer else 0), p
            assert len(by_phase["backward"]) == 1, p  # every leaf trains in full-joint
        layers = {}
        for p, by_phase in events.items():
            if "/layers/" in p:
                key = p.split("/layers/")[0] + "/" + p.split("/layers/")[1].split("/")[0]
                layers[key] = layers.get(key, 0) + by_phase["forward"][0]
        top = sum(b["forward"][0] for p, b in events.items() if "/layers/" not in p)
        assert top <= got["live_peak"] <= top + max(layers.values())
        assert got["live_after"] == 0  # nothing gathered outlives the step
        assert got["counts"]["forward"] == len(sharded)


@pytest.mark.parametrize("mesh", MESHES)
def test_dots_remat_keeps_the_gathered_weights(ranks, mesh):
    for r in ranks[mesh][0]:
        events = _events(r, "gathers_dots")
        assert not any("recompute" in b for b in events.values())
        every = sum(b["forward"][0] for b in events.values())
        assert r["gathers_dots"]["live_peak"] == every
        np.testing.assert_allclose(r["gathers_dots"]["losses"], r["gathers"]["losses"],
                                   rtol=1e-6)


# ------------------------------------------------------------------ the checkpoints


@pytest.mark.parametrize("mesh", MESHES)
def test_fsdp_checkpoint_loads_in_one_process(ranks, mesh):
    got, d = ranks[mesh]
    case = _case("full_joint")
    full = dict(unique_leaves_with_paths(case["params"]))
    saved = torch.load(os.path.join(d, "full_joint", "ckpt", "epoch_0.pt"), weights_only=True)
    assert saved["opt_state"]["mini_step"] == 1  # saved inside an accumulation
    for p, x in saved["params"].items():
        assert x.shape == full[p].shape, p  # whole leaves, not a rank's shard
    for slot in ("mu", "nu", "acc"):
        for p, x in saved["opt_state"][slot].items():
            assert x.shape == full[p].shape, (slot, p)
    # restored in one process, it continues as the ranks' resumed run did
    ckpt = CheckpointManager(os.path.join(d, "full_joint", "ckpt"))
    params = case["params"]
    step, tx, trained = torch_fsdp_worker._step(case, params, sharding.plan_for(params,
                                                                                case["cfg"]))
    from projectiontrainer_tpu_torch.train import steps

    state = steps.init_state(params, tx)
    ckpt.restore("epoch_0", state)
    losses = []
    for i, b in enumerate(case["batches"][1:], start=1):
        state, loss, _ = step(state, {k: torch.tensor(v) for k, v in b.items()}, i)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, got[0]["full_joint"]["resumed"]["losses"], rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_fsdp_resume_continues_bit_equal(ranks, mesh):
    for r in ranks[mesh][0]:
        got = r["full_joint"]
        assert got["resumed"]["losses"] == got["losses"][1:]
        assert got["resumed"]["params"].keys() == got["params"].keys()
        for p, x in got["params"].items():
            assert torch.equal(got["resumed"]["params"][p], x), p


# ------------------------------------------------------------------ Gemma3-4B's features


def test_tiny_gemma3_with_the_4b_features_matches_jax():
    """The 4B's sliding pattern, window, rope factor and query scalar with GQA 2 at head
    dim 32: hidden states and every gradient of sum(hidden * probe) within 1e-4 of the
    largest magnitude."""
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=6,
              num_heads=4, num_kv_heads=2, head_dim=32, sliding_window=4)
    cfg = dec.gemma3_4b_config(**kw, attn_impl="plain")
    jcfg = JDEC.gemma3_config(**kw, sliding_pattern=6, rope_scaling_factor=8.0,
                              query_pre_attn_scalar=256)
    assert cfg.layer_types == jcfg.layer_types == ("sliding",) * 5 + ("full",)
    assert (cfg.rope_scaling_factor, cfg.query_pre_attn_scalar) == (8.0, 256)
    jp = JDEC.init(jax.random.key(2), jcfg)
    rng = np.random.default_rng(3)
    embeds = rng.standard_normal((2, 12, 64), dtype=np.float32)
    mask = np.ones((2, 12), np.int32)
    mask[1, :4] = 0
    probe = rng.standard_normal((2, 12, 64), dtype=np.float32)

    def jloss(p, e):
        h, _ = JDEC.forward(p, jcfg, inputs_embeds=e, attention_mask=jnp.asarray(mask))
        return jnp.sum(h * probe), h

    (_, jh), (jgp, jge) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(embeds))
    params = from_jax.decoder_params(jax.tree.map(np.asarray, jp))
    leaves = dict(unique_leaves_with_paths(params))
    for x in leaves.values():
        x.requires_grad_(True)
    e = torch.tensor(embeds, requires_grad=True)
    h, _ = dec.forward(params, cfg, inputs_embeds=e, attention_mask=torch.tensor(mask))
    (h * torch.tensor(probe)).sum().backward()

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=what)

    close(h.detach().numpy(), jh, "hidden")
    close(e.grad.numpy(), jge, "d_embeds")
    grads = dict(unique_leaves_with_paths(from_jax.decoder_params(
        jax.tree.map(np.asarray, jgp))))
    for p, x in leaves.items():
        if p == "embed_tokens/embedding":
            continue  # the forward from embeddings never reads the table
        close(x.grad.numpy(), grads[p], p)
