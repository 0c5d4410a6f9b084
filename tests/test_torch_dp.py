"""Data-parallel training of the port on the CPU: two gloo ranks against one process on
the whole batch and against the JAX package's step on its data mesh.

Each case runs the trainers' step (``steps.make_train_step`` with their optimizer; the
ranks in ``tests/torch_dp_worker.py``, which imports no JAX, each process bounded by
120 s and its collectives by 60 s) over seeded global batches of 4 rows, 2 a rank. Rank
r holds the contiguous rows 2r, 2r + 1 of each global batch: the rows the JAX package's
2-device data mesh gives shard r, so a per-shard loss (stage 0's local negatives)
compares shard for shard. The references:

- the same step in one port process on the whole batch (stage 0's local negatives as 2
  groups of that batch): every loss and grad norm within 1e-6 relative, every trained
  leaf within 1e-6 absolute (the leaves are of order 0.01-1; the sums over two ranks
  round apart from one sum by a few fp32 ulps, which Adam carries into the update of
  a leaf that starts at zero), and the two replicas bit-equal;
- the JAX step (``jit``, the batch sharded over ``data`` on 2 of the 8 virtual CPU
  devices of ``tests/conftest.py``, the params replicated): losses within 1e-4
  relative, each trained leaf within 1e-4 of its largest magnitude.

A leaf whose gradient is zero in exact arithmetic (the key-projection biases; the cls
probe's class-shared biases) moves by Adam-scaled rounding noise on every side: it is
held to the size of the reference's update (at most 3x).

The cases: stage 1 with ranks that hold different numbers of caption tokens (and a
batch whose second rank holds only filler rows); stage 0 with local negatives (a batch
whose second rank has no real row, one with missing images) and with global negatives;
stage 2 full-joint at accumulation 2 with per-module clipping; QLoRA (nf4-mirror base,
LoRA dropout 0); the cls probe with the softmax CE and with the two-way multi-label
loss.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.core import mesh as JMESH
from projectiontrainer_tpu.models import classifier as JC
from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu.models import projector as JPROJ
from projectiontrainer_tpu.models import siglip as JSIG
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu.ops import quant as JQ
from projectiontrainer_tpu.train import lora as JL
from projectiontrainer_tpu.train import masks as JM
from projectiontrainer_tpu.train import optim as JO
from projectiontrainer_tpu.train import steps as JS
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
from projectiontrainer_tpu_torch.models import classifier

import torch_dp_worker

torch.set_num_threads(2)
PAD = 0
WORLD = 2
NUM_CLASSES = 5
FULL_JOINT = dict(train_llm=True, use_lora=False, train_projector=True, train_vision=True)
QLORA = dict(train_llm=False, use_lora=True, train_projector=True, train_vision=False)
NOISE = ("k_proj/bias", "vision/post_layernorm/bias", "mha/v_proj/bias", "mha/out_proj/bias",
         "head/bias")


# ------------------------------------------------------------------ models and batches


@functools.cache
def _vlm(qlora: bool):
    if not qlora:
        jcfg = T.tiny_vlm_cfg()
        jp = jax.jit(JVLM.init, static_argnums=1)(jax.random.key(0), jcfg)
        return jcfg, jax.tree.map(np.asarray, jp)
    llm = JDEC.qwen3_config(vocab_size=128, hidden_size=64, intermediate_size=128,
                            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
    vis = T.tiny_vision_cfg()
    jcfg = JVLM.VLMConfig(vision=vis, llm=llm, projector=JPROJ.ProjectorConfig(
        vision_dim=vis.hidden_size, llm_dim=64, expansion_factor=2))
    jp = JVLM.init(jax.random.key(0), jcfg)
    jp["llm"] = JQ.quantize_decoder(jp["llm"], method="nf4-mirror")
    jp["lora"] = JL.init(jax.random.key(1), jcfg.llm, JL.LoraConfig(r=4, alpha=8))
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(2)
    for layer in jp["lora"]["layers"]:
        for p in layer.values():  # B off zero: the A gradients are nonzero too
            p["b"] = rng.standard_normal(p["b"].shape, dtype=np.float32) * 0.05
    return jcfg, jp


@functools.cache
def _siglip():
    jcfg = T.tiny_siglip_cfg()
    return jcfg, jax.tree.map(np.asarray, jax.jit(JSIG.init, static_argnums=1)(
        jax.random.key(0), jcfg))


@functools.cache
def _classifier():
    vcfg = T.tiny_vision_cfg(image_size=16, patch=8, hidden=32, layers=2, heads=4)
    jcfg = JC.ClassifierConfig(vision=vcfg, num_classes=NUM_CLASSES, num_heads=4,
                               dropout_rate=0.0)
    return jcfg, jax.tree.map(np.asarray, JC.init(jax.random.key(0), jcfg))


def _ids(rng, rows, t, lengths):
    out = np.full((rows, t), PAD, np.int32)
    for i, n in enumerate(lengths):
        out[i, :n] = rng.integers(2, 128, size=n)
    return out


def _stage1_batches():
    """Rank 0's captions long (10-12 tokens), rank 1's short (2-4): unequal counts; in
    the last batch rank 1 holds only filler rows."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(3):
        lengths = list(rng.integers(10, 13, size=2)) + list(rng.integers(2, 5, size=2))
        b = {"pixel_values": rng.standard_normal((4, 32, 32, 3), dtype=np.float32),
             "caption_ids": _ids(rng, 4, 12, lengths)}
        if i == 2:
            b["sample_weight"] = np.array([1, 1, 0, 0], np.float32)
        out.append(b)
    return out


def _stage0_batches():
    """Batch 1: rank 1 holds only fillers; batch 2: rank 0 has a missing image and
    rank 1 a filler row."""
    rng = np.random.default_rng(1)
    out = []
    for i in range(3):
        b = {"pixel_values": rng.standard_normal((4, 32, 32, 3), dtype=np.float32),
             "input_ids": rng.integers(1, 128, size=(4, 16)).astype(np.int32),
             "sample_weight": np.ones(4, np.float32), "valid": np.ones(4, bool)}
        if i == 1:
            b["sample_weight"][2:] = 0
        if i == 2:
            b["valid"][1] = False
            b["sample_weight"][3] = 0
        out.append(b)
    return out


def _stage2_batches(n):
    rng = np.random.default_rng(2)
    out = []
    for i in range(n):
        b = {"pixel_values": rng.standard_normal((4, 32, 32, 3), dtype=np.float32),
             "question_ids": _ids(rng, 4, 5, rng.integers(2, 6, size=4)),
             "answer_ids": _ids(rng, 4, 8, list(rng.integers(6, 9, size=2))
                                + list(rng.integers(3, 5, size=2)))}
        if i == 1:
            b["sample_weight"] = np.array([1, 1, 1, 0], np.float32)
        out.append(b)
    return out


def _cls_batches(multilabel):
    rng = np.random.default_rng(3)
    out = []
    for i in range(3):
        b = {"pixel_values": rng.standard_normal((4, 16, 16, 3), dtype=np.float32)}
        if multilabel:
            b["targets"] = (rng.random((4, NUM_CLASSES)) < 0.4).astype(np.float32)
        else:
            b["target_indices"] = rng.integers(0, NUM_CLASSES, 4).astype(np.int32)
        if i == 1:
            b["sample_weight"] = np.array([1, 1, 1, 0], np.float32)
        out.append(b)
    return out


CASES = ("stage1", "stage0_local", "stage0_global", "stage2_full_joint", "qlora", "cls",
         "cls_two_way")


@functools.cache
def _case(name):
    """(the port's case for ``torch_dp_worker.run_case`` without its params, the JAX
    config, the JAX params as numpy, the port's params converter)"""
    if name == "stage1":
        jcfg, jp = _vlm(False)
        return (dict(kind="stage1", batches=_stage1_batches()), jcfg, jp, from_jax.vlm_params)
    if name.startswith("stage0"):
        jcfg, jp = _siglip()
        shards = WORLD if name == "stage0_local" else 1
        return (dict(kind="stage0", shards=shards, batches=_stage0_batches()), jcfg, jp,
                from_jax.siglip_params)
    if name == "stage2_full_joint":
        jcfg, jp = _vlm(False)
        return (dict(kind="stage2", policy=FULL_JOINT, accum=2, batches=_stage2_batches(4)),
                jcfg, jp, from_jax.vlm_params)
    if name == "qlora":
        jcfg, jp = _vlm(True)
        return (dict(kind="stage2", policy=QLORA, lora_r=4, batches=_stage2_batches(2)),
                jcfg, jp, from_jax.vlm_params)
    jcfg, jp = _classifier()
    return (dict(kind="cls", multilabel=name == "cls_two_way",
                 batches=_cls_batches(name == "cls_two_way")), jcfg, jp,
            from_jax.classifier_params)


def _port_case(name):
    case, jcfg, jp, params_of = _case(name)
    if case["kind"] == "cls":
        cfg = classifier.ClassifierConfig(vision=from_jax.config_from_jax(jcfg.vision),
                                          num_classes=NUM_CLASSES, num_heads=4,
                                          dropout_rate=0.0)
    else:
        cfg = from_jax.config_from_jax(jcfg)
    return {**case, "cfg": cfg, "params": params_of(jp)}


# ------------------------------------------------------------------ the three runs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on 2 gloo ranks: {case: [rank 0's result, rank 1's]}."""
    d = str(tmp_path_factory.mktemp("dp"))
    torch.save({name: _port_case(name) for name in CASES}, os.path.join(d, "payload.pt"))
    torch_dp_worker.spawn_ranks("dp", d, WORLD)
    results = [torch.load(os.path.join(d, f"result{r}.pt"), weights_only=False)
               for r in range(WORLD)]
    return {name: [res[name] for res in results] for name in CASES}


def _jax_run(name):
    case, jcfg, jp, params_of = _case(name)
    kind, accum = case["kind"], case.get("accum", 1)
    total = -(-len(case["batches"]) // accum)
    if kind == "stage1":
        labels = JM.stage1_labels(jp)
        tx, _ = JO.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.1,
                                          weight_decay=0.01, clip_norm=5.0)
        loss = JS.stage1_loss(jcfg, PAD, remat=False, logits_chunk=5, ce_impl="chunked")
    elif kind == "stage0":
        labels = JM.stage0_labels(jp)
        tx, _ = JO.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.3,
                                          weight_decay=0.01, warmup_rounding="floor")
        loss = JS.stage0_loss(jcfg, remat=False, local_negatives_shards=case["shards"])
    elif kind == "stage2":
        labels = JM.stage2_labels(jp, JM.Stage2Freeze(**case["policy"]))
        tx, _ = JO.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.1,
                                          weight_decay=0.01, clip_norm=1.0,
                                          clip_per_module=True, accum_steps=accum)
        lcfg = JL.LoraConfig(r=4, alpha=8, dropout=0.0) if "lora_r" in case else None
        loss = JS.stage2_loss(jcfg, PAD, lora_cfg=lcfg, remat=False, logits_chunk=5,
                              ce_impl="chunked", table_frozen=lcfg is not None)
    else:
        labels = JM.classifier_labels(jp, freeze_vision=False)
        tx, _ = JO.discriminative_optimizer(labels, head_lr=1e-2, backbone_lr=1e-3,
                                            weight_decay=0.01, total_steps=total)
        loss = JS.classifier_loss(jcfg, multilabel=case["multilabel"])
    step = JS.make_train_step(loss, tx, trainable_mask=JM.bool_mask(labels), donate=False)
    mesh = JMESH.build_mesh(JMESH.MeshConfig(data=WORLD, model=1))
    assert mesh.devices.size == WORLD and len(jax.devices()) == 8
    state = jax.device_put(JS.init_state(jax.tree.map(jnp.asarray, jp), tx),
                           NamedSharding(mesh, P()))
    losses = []
    for i, b in enumerate(case["batches"]):
        batch = jax.device_put(jax.tree.map(jnp.asarray, b), NamedSharding(mesh, P("data")))
        state, value, _ = step(state, batch, jax.random.key(i))
        losses.append(float(value))
    trained = dict(unique_leaves_with_paths(params_of(jax.tree.map(np.asarray,
                                                                   state["params"]))))
    return losses, trained


def _initial(name):
    case, _, jp, params_of = _case(name)
    return dict(unique_leaves_with_paths(params_of(jp)))


def _trained_close(name, ours: dict, theirs: dict, tol, *, relative: bool):
    """Each trained leaf within ``tol`` x the largest magnitude of the reference's leaf
    (``relative``), else within ``tol`` absolute; the noise leaves (see the module's
    docstring) hold an update (final - initial) at most 3x the reference's."""
    x0 = _initial(name)
    assert ours.keys() <= theirs.keys() and ours
    for p, x in ours.items():
        mine = (x.float() - x0[p].float()).numpy()
        ref = (theirs[p].float() - x0[p].float()).numpy()
        if p.endswith(NOISE):
            assert np.abs(mine).max() <= 3 * np.abs(ref).max() + 1e-12, p
            continue
        assert np.abs(ref).max() > 0, p  # the leaf trained
        scale = np.abs(theirs[p].float().numpy()).max() if relative else 1.0
        err = np.abs(mine - ref).max()
        assert err <= tol * scale, f"{name} {p}: err {err} vs {scale}"


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_one_process_on_the_whole_batch(ranks, name):
    got = ranks[name]
    case = _port_case(name)
    if case["kind"] == "stage0" and case["shards"] > 1:
        assert case["shards"] == WORLD  # one process: the rank groups of the same batch
    ref = torch_dp_worker.run_case(case, case["params"], case["batches"])
    for r in got:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-6)
        np.testing.assert_allclose(r["grad_norms"], ref["grad_norms"], rtol=1e-6)
        _trained_close(name, r["params"], ref["params"], 1e-6, relative=False)
    # the replicas stay bit-equal
    for p, x in got[0]["params"].items():
        assert torch.equal(x, got[1]["params"][p]), p


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_the_jax_data_mesh(ranks, name):
    jlosses, jparams = _jax_run(name)
    got = ranks[name][0]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    _trained_close(name, got["params"], jparams, 1e-4, relative=True)


def test_stage1_ranks_hold_unequal_token_counts():
    """The case the global mean exists for: a mean of the ranks' means would differ."""
    counts = [[int((torch_dp_worker.shard(b, r, WORLD)["caption_ids"] != PAD).sum())
               for r in range(WORLD)] for b in _stage1_batches()]
    assert all(c0 > 2 * c1 for c0, c1 in counts)


def test_stage0_local_negatives_see_a_rank_without_real_rows():
    b = torch_dp_worker.shard(_stage0_batches()[1], 1, WORLD)
    assert not (b["sample_weight"] * b["valid"]).any()
