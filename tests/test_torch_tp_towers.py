"""Tensor parallelism of stage 0 and the cls probe on the CPU: gloo ranks on a 1 x 2 and
a 2 x 2 data x model mesh against one port process on the whole batch and against the
JAX package on its data x model mesh.

The ranks are ``tests/torch_tp_towers_worker.py`` processes (no JAX; each bounded by
180 s and its collectives by 60 s); each slices the whole params the test built (from the
JAX package's models, through ``checkpoint/from_jax.py``) to its model rank's shards
(``sharding.model_shards``) and runs every case on its data rank's rows. The models: the
tiny SigLIP dual tower of ``testing.tiny_siglip_cfg`` (4 heads, MLP 128, vocab 128, the
MAP head), a wider one whose MLPs reach ``FSDP_MIN_SIZE`` (hidden 128, MLP 512) for
``--fsdp``, and the cls probe over a tiny tower (4 classes, 4 heads).

The cases, each the trainers' step:

- stage 0 with local negatives and the text tower frozen, with global negatives and the
  text tower trained, and (2 x 2) with global negatives under ``--fsdp``;
- the cls probe in Freeze, Unfreeze and 1EpochUnfreeze (the optimizer swapped after the
  first batch), with the softmax CE, with the two-way loss, and (2 x 2) under ``--fsdp``;
  on 1 x 2 also with dropout on (the model ranks of one data rank draw one mask);

and the trainers themselves: ``Stage0Trainer.train()`` (2 epochs, the zero-shot
validation's predictions gathered over the data ranks, a checkpoint and an HF export
each epoch) and ``ClsTrainer.train()`` (1EpochUnfreeze, the evaluation's rows and
AUROC over the data ranks, checkpoints that ``load_classifier`` reads in one process).
Each is held against

- one port process: losses and grad norms within 1e-6 relative, every trained leaf within
  1e-6 absolute, and every trained leaf the model axis leaves whole bit-equal across the
  model ranks of a replica after every step;
- the JAX package (its step under ``jit`` with the params sharded by its rules, and by
  ``param_shardings(fsdp=True)`` under ``--fsdp``, over the data x model virtual mesh
  of ``tests/conftest.py``): within 1e-4 relative.

Also: the port's spec of every leaf of the SigLIP and classifier trees against the JAX
package's ``spec_for_path`` (transposed to ``[out, in]``); the losses that reduce over
the data axis only, on the ranks of one replica; and the model checks that raise for a
SigLIP or classifier config the model axis does not divide.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from safetensors.torch import load_file

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.core import mesh as JMESH
from projectiontrainer_tpu.core.pytree import path_str
from projectiontrainer_tpu.models import classifier as JC
from projectiontrainer_tpu.models import siglip as JSIG
from projectiontrainer_tpu.parallel import param_shardings
from projectiontrainer_tpu.parallel import sharding as JSHARD
from projectiontrainer_tpu.train import masks as JM
from projectiontrainer_tpu.train import optim as JO
from projectiontrainer_tpu.train import steps as JS
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
from projectiontrainer_tpu_torch.models import classifier, siglip
from projectiontrainer_tpu_torch.parallel import sharding
from projectiontrainer_tpu_torch.train import losses, steps, trainer_cls

import torch_dp_worker
import torch_tp_towers_worker as W

torch.set_num_threads(2)
MESHES = ("1x2", "2x2")
NUM_CLASSES = 4
# leaves whose gradient is zero in exact arithmetic: Adam scales their rounding noise to
# about a learning rate a step whatever its size, so each side moves them by up to that.
# In both models the key biases; in the cls probe also the biases its class-shared head
# adds to every class alike (stage 0's MAP head reads the post-LayerNorm bias for real)
NOISE = {"stage0": ("k_proj/bias",),
         "cls": ("k_proj/bias", "vision/post_layernorm/bias", "mha/v_proj/bias",
                 "mha/out_proj/bias")}
NOISE_STEP = 1e-2  # the largest learning rate of the cases (the cls head's)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tp_towers_worker.py")


# ------------------------------------------------------------------ models and batches


@functools.cache
def _siglip(wide=False):
    jcfg = (T.tiny_siglip_cfg(image_size=16, hidden=128, layers=1) if wide
            else T.tiny_siglip_cfg())
    return jcfg, jax.tree.map(np.asarray, jax.jit(JSIG.init, static_argnums=1)(
        jax.random.key(0), jcfg))


@functools.cache
def _classifier(wide=False, head=False, dropout=0.0):
    vcfg = T.tiny_vision_cfg(image_size=16, patch=8, hidden=128 if wide else 32,
                             layers=1 if wide else 2, heads=4, use_head=head)
    jcfg = JC.ClassifierConfig(vision=vcfg, num_classes=NUM_CLASSES, num_heads=4,
                               dropout_rate=dropout)
    return jcfg, jax.tree.map(np.asarray, JC.init(jax.random.key(0), jcfg))


def _port_cfg(jcfg):
    if isinstance(jcfg, JC.ClassifierConfig):
        return classifier.ClassifierConfig(vision=from_jax.config_from_jax(jcfg.vision),
                                           num_classes=jcfg.num_classes,
                                           num_heads=jcfg.num_heads,
                                           dropout_rate=jcfg.dropout_rate)
    return from_jax.config_from_jax(jcfg)


def _port_params(jcfg, jp):
    if isinstance(jcfg, JC.ClassifierConfig):
        return from_jax.classifier_params(jp)
    return from_jax.siglip_params(jp)


def _stage0_batches(image_size):
    """Batch 1: data rank 1 (of 2) holds only fillers; batch 2: a missing image and a
    filler row."""
    rng = np.random.default_rng(1)
    out = []
    for i in range(3):
        b = {"pixel_values": rng.standard_normal((4, image_size, image_size, 3),
                                                 dtype=np.float32),
             "input_ids": rng.integers(1, 128, size=(4, 16)).astype(np.int32),
             "sample_weight": np.ones(4, np.float32), "valid": np.ones(4, bool)}
        if i == 1:
            b["sample_weight"][2:] = 0
        if i == 2:
            b["valid"][1] = False
            b["sample_weight"][3] = 0
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


STAGE0 = ("s0_local_frozen", "s0_global_text", "s0_fsdp")
CLS = ("cls_freeze", "cls_unfreeze", "cls_1epoch", "cls_two_way", "cls_fsdp", "cls_dropout")
STEPS = STAGE0 + CLS
ONLY = {"s0_fsdp": "2x2", "cls_fsdp": "2x2", "cls_dropout": "1x2"}
# the wide models (--fsdp): losses and grad norms within 1e-5 of one process (the bound of
# tests/test_torch_fsdp.py), each trained leaf's update by its cosine
WIDE = ("s0_fsdp", "cls_fsdp")
WIDE_COS, WIDE_COS_JAX = 0.9999, 0.999


@functools.cache
def _case(name, data):
    """(the port's case without its params and config, the JAX config, the JAX params as
    numpy) for a mesh of ``data`` data ranks"""
    if name in STAGE0:
        jcfg, jp = _siglip(wide=name == "s0_fsdp")
        local = name == "s0_local_frozen"
        return (dict(kind="stage0", shards=data if local else 1, local=local,
                     freeze_text=name == "s0_local_frozen", fsdp=name == "s0_fsdp",
                     batches=_stage0_batches(jcfg.vision.image_size)), jcfg, jp)
    jcfg, jp = _classifier(wide=name == "cls_fsdp", dropout=0.1 if name == "cls_dropout" else 0.0)
    mode = {"cls_freeze": "Freeze", "cls_1epoch": "1EpochUnfreeze"}.get(name, "Unfreeze")
    return (dict(kind="cls", multilabel=name == "cls_two_way", freeze_mode=mode, swap_at=1,
                 fsdp=name == "cls_fsdp", batches=_cls_batches(name == "cls_two_way")),
            jcfg, jp)


def _trainer_rows(n, seed, kind):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        if kind == "stage0":
            rows.append({"pixel_values": rng.standard_normal((32, 32, 3), dtype=np.float32),
                         "input_ids": rng.integers(1, 128, size=W.MAX_TEXT_LEN).astype(np.int64),
                         "class_idx": np.int64(i % NUM_CLASSES), "valid": np.bool_(True)})
        else:
            rows.append({"pixel_values": rng.standard_normal((16, 16, 3), dtype=np.float32),
                         "target_indices": np.int64(i % NUM_CLASSES)})
    return rows


TRAINERS = ("s0_trainer", "cls_trainer")


@functools.cache
def _trainer_case(name, mesh):
    """The trainer case at ``mesh``: ``batch`` rows a data rank (8 rows an epoch, 2 steps
    of 4 in all ranks together; 8 validation rows), the one-process batch ``batch_one``.
    On 1 x 2 stage 0 runs local negatives (one group a data rank: the one-process
    batch's); on 2 x 2 the ranks' round-robin rows make the same global batches in
    another order, so stage 0 runs global negatives. The cls probe runs without dropout
    (``cls_dropout`` holds its masks): its class-shared biases move by Adam's rounding
    noise, which shifts every class's logit alike, and the evaluation is held by its
    log-softmax."""
    data = int(mesh.split("x")[0])
    one_by_one = mesh == "1x2"
    if name == "s0_trainer":
        jcfg, jp = _siglip()
        rng = np.random.default_rng(5)
        names = [f"class {c}" for c in range(NUM_CLASSES)]
        case = dict(kind="stage0_trainer", local_negatives=one_by_one,
                    class_ids={n: rng.integers(1, 128, size=W.MAX_TEXT_LEN) for n in names},
                    train=_trainer_rows(8, 6, "stage0"), val=_trainer_rows(8, 7, "stage0"))
    else:
        jcfg, jp = _classifier(head=True)
        case = dict(kind="cls_trainer", train=_trainer_rows(8, 8, "cls"),
                    val=_trainer_rows(8, 9, "cls"))
    return {**case, "batch": 4 // data, "batch_one": 4}, jcfg, jp


def _data(mesh):
    return int(mesh.split("x")[0])


def _port_case(name, mesh):
    if name in TRAINERS:
        case, jcfg, jp = _trainer_case(name, mesh)
    else:
        case, jcfg, jp = _case(name, _data(mesh))
    return {**case, "cfg": _port_cfg(jcfg), "params": _port_params(jcfg, jp)}


def _cases_for(mesh):
    return [n for n in STEPS if ONLY.get(n, mesh) == mesh] + list(TRAINERS)


def _faults_case():
    rng = np.random.default_rng(11)
    return dict(kind="faults", img=rng.standard_normal((4, 8), dtype=np.float32),
                txt=rng.standard_normal((4, 8), dtype=np.float32), scale=float(np.log(10.0)),
                bias=-1.0, logits=rng.standard_normal((4, 3), dtype=np.float32),
                targets=np.array([[1, 0, 1], [0, 1, 0], [1, 1, 0], [0, 0, 1]], np.float32),
                shards=2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on every mesh: {mesh: (result dicts by rank, directory)}."""
    out = {}
    for mesh in MESHES:
        d = str(tmp_path_factory.mktemp(f"tp_towers{mesh}"))
        payload = {n: _port_case(n, mesh) for n in _cases_for(mesh)}
        if mesh == "1x2":
            payload["faults"] = _faults_case()
        torch.save(payload, os.path.join(d, "payload.pt"))
        data, model = (int(v) for v in mesh.split("x"))
        torch_dp_worker.spawn_ranks(mesh, d, data * model, timeout=180, script=WORKER)
        out[mesh] = ([torch.load(os.path.join(d, f"result{r}.pt"), weights_only=False)
                      for r in range(data * model)], d)
    return out


@functools.cache
def _one_process(name, mesh):
    case = _port_case(name, mesh)
    if name in TRAINERS:
        import tempfile

        out = tempfile.mkdtemp(prefix=f"tp_towers_one_{name}_{mesh}_")
        run = W.stage0_trainer_case if name == "s0_trainer" else W.cls_trainer_case
        return {**run(case, case["params"], out, batch=case["batch_one"]), "dir": out}
    return W.run_case(case, case["params"], case["batches"])


def _initial(name, mesh):
    return dict(unique_leaves_with_paths(_port_case(name, mesh)["params"]))


def _cosine(a, b) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _noise(kind, path) -> bool:
    """Whether ``path`` of a ``kind`` model ("stage0" or "cls") is a noise leaf."""
    return path.endswith(NOISE[kind]) or (kind == "cls" and path == "head/bias")


def _trained_close(name, mesh, ours: dict, theirs: dict, tol, *, relative: bool,
                   cos_min=None):
    """Each trained leaf's update against the reference's: within ``tol`` (x the larger of
    the reference leaf's largest magnitude and the most Adam moves it, a learning rate a
    step, when ``relative``), or with ``cos_min`` at cosine >= ``cos_min`` (the wide
    cases: a unit whose gradient vanishes in exact arithmetic, a gelu unit off for every
    row, moves by Adam's +-lr from rounding on each side); a noise leaf's update at most
    3x the reference's plus ``NOISE_STEP`` a step."""
    x0 = _initial(name, mesh)
    n_steps = len(_case(name, _data(mesh))[0]["batches"])
    lr = 3e-3 if name in STAGE0 else 1e-2
    assert ours.keys() <= theirs.keys() and ours
    for p, x in ours.items():
        mine = (x.float() - x0[p].float()).numpy()
        ref = (theirs[p].float() - x0[p].float()).numpy()
        if _noise("stage0" if name in STAGE0 else "cls", p):
            assert np.abs(mine).max() <= 3 * np.abs(ref).max() + NOISE_STEP * n_steps, p
            continue
        assert np.abs(ref).max() > 0, p  # the leaf trained
        if cos_min is not None:
            assert _cosine(mine, ref) >= cos_min, f"{name} {p}: cosine {_cosine(mine, ref)}"
            continue
        scale = (max(np.abs(theirs[p].float().numpy()).max(), lr * n_steps) if relative
                 else 1.0)
        err = np.abs(mine - ref).max()
        assert err <= tol * scale, f"{name} {p}: err {err} vs {scale}"


def _params(names, jax_too=False):
    return [pytest.param(m, n, id=f"{m}-{n}") for m in MESHES for n in names
            if ONLY.get(n, m) == m and not (jax_too and n == "cls_dropout")]


# ------------------------------------------------------------------ against one process


@pytest.mark.parametrize("mesh,name", _params(STEPS))
def test_step_matches_one_process_and_model_replicas_stay_equal(ranks, mesh, name):
    got, _ = ranks[mesh]
    ref = _one_process(name, mesh)
    for r in got:
        if name == "cls_dropout":
            # the first step only: the masks are the one-process masks (the same loss and
            # gradients); from the second step the head's class-shared biases, moved by
            # Adam's rounding noise, meet a feature's mask that differs across classes
            np.testing.assert_allclose(r[name]["losses"][0], ref["losses"][0], rtol=1e-6)
            np.testing.assert_allclose(r[name]["grad_norms"][0], ref["grad_norms"][0],
                                       rtol=1e-6)
            continue
        rtol = 1e-5 if name in WIDE else 1e-6
        np.testing.assert_allclose(r[name]["losses"], ref["losses"], rtol=rtol)
        np.testing.assert_allclose(r[name]["grad_norms"], ref["grad_norms"], rtol=rtol)
        _trained_close(name, mesh, r[name]["params"], ref["params"], 1e-6, relative=False,
                       cos_min=WIDE_COS if name in WIDE else None)
    model = int(mesh.split("x")[1])
    for i, r in enumerate(got):  # the model ranks of a replica: the whole leaves bit-equal
        first = got[i - i % model][name]["model_whole_bytes_by_step"]
        assert len(first) == len(_case(name, _data(mesh))[0]["batches"]) and first[0]
        assert r[name]["model_whole_bytes_by_step"] == first, i


def test_the_cases_cover_the_sharded_leaves(ranks):
    """The trained leaves of the cases include both towers' shards, the MAP head's MLP and
    the text table (the leaves a missed model-axis collective would break)."""
    trained = set(ranks["1x2"][0][0]["s0_global_text"]["params"])
    for path in ("vision/layers/0/attn/q_proj/weight", "vision/layers/0/mlp/fc2/weight",
                 "vision/head/mlp/fc1/weight", "vision/head/mlp/fc1/bias",
                 "text/layers/0/attn/out_proj/weight", "text/token_embedding/embedding",
                 "vision/head/attention/q_proj/weight", "logit_bias"):
        assert path in trained, path
    counts = ranks["1x2"][0][0]["_counts"]
    assert counts["forward"] > 0 and counts["backward"] > 0 and counts["grads"] > 0


# ------------------------------------------------------------------ the trainers


def _logged(logs, key):
    return [row[key] for row in logs if key in row]


def _round_robin(n, data):
    """The order the data ranks' gathered rows come in: rank r's rows r, r + data, ..."""
    return np.concatenate([np.arange(n)[r::data] for r in range(data)])


@pytest.mark.parametrize("mesh", MESHES)
def test_stage0_trainer_and_zero_shot_match_one_process(ranks, mesh):
    got, _ = ranks[mesh]
    ref = _one_process("s0_trainer", mesh)
    order = _round_robin(8, _data(mesh))
    for r in got:
        mine = r["s0_trainer"]
        np.testing.assert_allclose(_logged(mine["logs"], "train/batch_loss"),
                                   _logged(ref["logs"], "train/batch_loss"), rtol=1e-6)
        assert len(_logged(mine["logs"], "train/batch_loss")) == 4
        assert len(mine["zero_shot"]) == len(ref["zero_shot"]) == 2  # one an epoch
        for (pred, target), (ref_pred, ref_target) in zip(mine["zero_shot"], ref["zero_shot"]):
            assert len(pred) == 8  # every validation row once, whatever the model axis
            np.testing.assert_array_equal(target, ref_target[order])
            np.testing.assert_array_equal(pred, ref_pred[order])
        for key in ("zero_shot/accuracy", "zero_shot/f1"):
            np.testing.assert_allclose(_logged(mine["logs"], key), _logged(ref["logs"], key))


@pytest.mark.parametrize("mesh", MESHES)
def test_cls_trainer_and_auroc_match_one_process(ranks, mesh):
    """1EpochUnfreeze across the swap; the evaluation reads each data rank's rows once
    (its logits, in the ranks' order, are the one-process logits) and its AUROC is the
    one-process AUROC."""
    got, _ = ranks[mesh]
    ref = _one_process("cls_trainer", mesh)
    order = _round_robin(8, _data(mesh))
    for r in got:
        mine = r["cls_trainer"]
        np.testing.assert_allclose(_logged(mine["logs"], "train/batch_loss"),
                                   _logged(ref["logs"], "train/batch_loss"), rtol=1e-6)
        assert _logged(mine["logs"], "tower_frozen") == [0.0, 1.0]
        assert len(mine["evaluations"]) == 3  # each epoch's and the final one
        for (logits, targets), (ref_logits, ref_targets) in zip(mine["evaluations"],
                                                                ref["evaluations"]):
            assert logits.shape == (8, NUM_CLASSES)
            np.testing.assert_array_equal(targets, ref_targets[order])
            mine_ls, ref_ls = (torch.log_softmax(torch.tensor(x), -1).numpy()
                               for x in (logits, ref_logits[order]))
            np.testing.assert_allclose(mine_ls, ref_ls, rtol=0, atol=1e-6 * np.abs(ref_ls).max())
        np.testing.assert_allclose(mine["final"], ref["final"], rtol=1e-6)
        assert np.isfinite(mine["final"][2])  # the AUROC
        np.testing.assert_allclose(_logged(mine["logs"], "val/auc"),
                                   _logged(ref["logs"], "val/auc"), rtol=1e-6)


def _rel_dist(a, b) -> float:
    """||a - b|| / ||b||: after 4 Adam steps at lr 1e-2 an element whose gradient all but
    vanished moves by a part of lr that rounding decides, so whole leaves are held by
    their distance, not element by element."""
    a, b = (np.asarray(v, np.float64) for v in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("mesh", MESHES)
def test_checkpoints_saved_under_tp_load_in_one_process(ranks, mesh):
    """The stage-0 epoch checkpoint and HF export, and the cls probe's, hold whole leaves
    within 1e-5 (relative distance) of the one-process run's; the cls checkpoint rebuilds
    the classifier alone."""
    _, d = ranks[mesh]
    s0, cls_one = _one_process("s0_trainer", mesh)["dir"], _one_process("cls_trainer", mesh)["dir"]
    for kind, ours, theirs in (
            ("stage0", os.path.join(d, "s0_trainer", "checkpoints", "epoch_1.pt"),
             os.path.join(s0, "checkpoints", "epoch_1.pt")),
            ("cls", os.path.join(d, "cls_trainer", "EXPT", "checkpoints", "epoch_1.pt"),
             os.path.join(cls_one, "EXPT", "checkpoints", "epoch_1.pt"))):
        mine, ref = (torch.load(p, weights_only=True) for p in (ours, theirs))
        assert mine["step"] == ref["step"] == 4
        for part in ("params", "mu", "nu"):
            a = mine["params"] if part == "params" else mine["opt_state"][part]
            b = ref["params"] if part == "params" else ref["opt_state"][part]
            assert a.keys() == b.keys() and a, part
            for p, x in b.items():
                assert a[p].shape == x.shape, p  # whole, not a rank's shard
                if _noise(kind, p):
                    continue  # moved by Adam's rounding noise (_trained_close)
                assert _rel_dist(a[p], x) <= 1e-5, f"{part} {p}: {_rel_dist(a[p], x)}"
    hf = [load_file(os.path.join(root, "epoch_2", "model.safetensors"))
          for root in (os.path.join(d, "s0_trainer"), s0)]
    assert hf[0].keys() == hf[1].keys()
    for k, x in hf[1].items():
        assert hf[0][k].shape == x.shape, k
        got, want = hf[0][k].numpy(), x.numpy()
        if k.endswith("k_proj.bias"):
            continue  # moved by Adam's rounding noise (_trained_close)
        if k.endswith("in_proj_bias"):  # the MAP head's packed q, k, v biases: k apart
            third = len(want) // 3
            got, want = (np.delete(v, slice(third, 2 * third)) for v in (got, want))
        assert _rel_dist(got, want) <= 1e-5, f"{k}: {_rel_dist(got, want)}"
    cfg, _, params = trainer_cls.load_classifier(os.path.join(d, "cls_trainer", "EXPT"),
                                                 "epoch_1", device="cpu")
    assert cfg.freeze_mode == "1EpochUnfreeze"
    saved = torch.load(os.path.join(d, "cls_trainer", "EXPT", "checkpoints", "epoch_1.pt"),
                       weights_only=True)["params"]
    for p, x in unique_leaves_with_paths(params):
        assert torch.equal(x, saved[p]), p


# ------------------------------------------------------------------ against JAX


def _jax_run(name, mesh):
    case, jcfg, jp = _case(name, _data(mesh))
    data, model = (int(v) for v in mesh.split("x"))
    total = len(case["batches"])
    if case["kind"] == "stage0":
        labels = JM.stage0_labels(jp, freeze_text=case["freeze_text"])
        tx, _ = JO.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.3,
                                          weight_decay=0.01, warmup_rounding="floor")
        loss = JS.stage0_loss(jcfg, remat=False, local_negatives_shards=case["shards"])
        variants = {False: (labels, tx)}
        frozen_at = [False] * total
    else:
        loss = JS.classifier_loss(jcfg, multilabel=case["multilabel"])
        mode = case["freeze_mode"]
        frozen_at = [mode == "Freeze" or (mode == "1EpochUnfreeze" and i >= case["swap_at"])
                     for i in range(total)]
        variants = {}
        for frozen in sorted(set(frozen_at)):
            labels = JM.classifier_labels(jp, freeze_vision=frozen)
            variants[frozen] = (labels, JO.discriminative_optimizer(
                labels, head_lr=1e-2, backbone_lr=1e-3, weight_decay=0.01,
                total_steps=total)[0])
    built = {k: (JS.make_train_step(loss, tx, trainable_mask=JM.bool_mask(labels),
                                    donate=False), tx) for k, (labels, tx) in variants.items()}
    jmesh = JMESH.build_mesh(JMESH.MeshConfig(data=data, model=model))
    params = jax.device_put(jax.tree.map(jnp.asarray, jp),
                            param_shardings(jp, jmesh, fsdp=case["fsdp"]))
    state = JS.init_state(params, built[frozen_at[0]][1])
    losses_ = []
    for i, b in enumerate(case["batches"]):
        step, tx = built[frozen_at[i]]
        if i and frozen_at[i] != frozen_at[i - 1]:
            state = JS.swap_optimizer(state, tx)
        batch = jax.device_put(jax.tree.map(jnp.asarray, b), NamedSharding(jmesh, P("data")))
        state, value, _ = step(state, batch, jax.random.key(i))
        losses_.append(float(value))
    trained = dict(unique_leaves_with_paths(_port_params(jcfg, jax.tree.map(
        np.asarray, state["params"]))))
    return losses_, trained


@pytest.mark.parametrize("mesh,name", _params(STEPS, jax_too=True))
def test_step_matches_the_jax_data_model_mesh(ranks, mesh, name):
    jlosses, jparams = _jax_run(name, mesh)
    got = ranks[mesh][0][0][name]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    _trained_close(name, mesh, got["params"], jparams, 1e-4, relative=True,
                   cos_min=WIDE_COS_JAX if name in WIDE else None)


# ------------------------------------------------------------------ the sharding rules


def _model_dim(jpath, ndim, spec):
    """The port's dim that the model axis splits for the JAX leaf at ``jpath`` of
    ``spec``: a 2-D kernel's dims swap in the port's ``[out, in]`` weight."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if "model" not in spec:
        return None
    d = spec.index("model")
    return 1 - d if jpath.endswith("/kernel") and ndim == 2 else d


@pytest.mark.parametrize("name", ["siglip", "classifier"])
def test_the_port_specs_are_the_jax_spec_for_path(name):
    jcfg, jp = _siglip() if name == "siglip" else _classifier(head=True)
    params = _port_params(jcfg, jp)
    port = dict(unique_leaves_with_paths(params))
    plan = sharding.plan_for(params, _port_cfg(jcfg), model=2, rank=0)
    seen = set()
    for p, leaf in jax.tree_util.tree_leaves_with_path(jp):
        jpath = path_str(p)
        path = jpath[:-len("kernel")] + "weight" if jpath.endswith("/kernel") else jpath
        assert path in port, jpath
        want = _model_dim(jpath, np.ndim(leaf), JSHARD.spec_for_path(jpath))
        assert sharding.sharded_dim(path) == want, (jpath, want)
        assert plan.dims.get(path) == want, path
        seen.add(path)
    assert seen == set(port)
    # what the JAX rules shard and leave whole in these two trees
    shards = {"vision/layers/0/attn/q_proj/weight": 0, "vision/layers/0/attn/out_proj/weight": 1,
              "vision/layers/0/mlp/fc1/weight": 0, "vision/layers/0/mlp/fc2/weight": 1,
              "vision/head/mlp/fc1/weight": 0, "vision/head/mlp/fc2/weight": 1}
    whole = ["vision/head/attention/q_proj/weight", "vision/head/probe",
             "vision/head/layernorm/scale", "vision/patch_embedding/weight"]
    if name == "siglip":
        shards["text/token_embedding/embedding"] = 0
        whole += ["text/head/weight", "logit_scale", "logit_bias"]
    else:
        whole += ["queries", "mha/q_proj/weight", "mha/out_proj/weight", "head/weight"]
    assert {p: plan.dims.get(p) for p in shards} == shards
    assert all(p in port and p not in plan.dims for p in whole)
    assert "vision/head/mlp/fc1/bias" in plan.partial


# ------------------------------------------------------------------ the data axis only


def test_losses_reduce_over_the_data_axis_only(ranks):
    """On 1 x 2 the two ranks hold one replica's rows: the pairwise loss with global
    negatives, the two-way loss over the ranks and the stage-0 loss split into 2 groups
    of negatives are the one-process losses on each rank (reduced over the world, rank 1
    scored its images against the wrong diagonal, the two-way loss halved, and the
    groups were counted by the world)."""
    case = _faults_case()
    img, txt = torch.tensor(case["img"]), torch.tensor(case["txt"])
    scale, bias = torch.tensor(case["scale"]), torch.tensor(case["bias"])
    pairwise = float(losses.siglip_pairwise_loss(img, txt, scale, bias))
    two_way = float(losses.two_way_multilabel_loss(torch.tensor(case["logits"]),
                                                   torch.tensor(case["targets"])))
    groups = np.mean([float(losses.siglip_pairwise_loss(img[i:i + 2], txt[i:i + 2], scale,
                                                        bias)) for i in (0, 2)])
    for r in ranks["1x2"][0]:
        got = r["faults"]
        np.testing.assert_allclose(got["pairwise"], pairwise, rtol=1e-6)
        np.testing.assert_allclose(got["two_way"], two_way, rtol=1e-6)
        np.testing.assert_allclose(got["stage0_local"], groups, rtol=1e-6)
    assert abs(groups - pairwise) > 1e-3  # the two groupings differ


@pytest.mark.parametrize("what", ["vision_heads", "vision_mlp", "text_heads", "text_mlp",
                                  "text_vocab", "classifier_tower"])
def test_an_indivisible_tower_raises(what):
    """``check_config`` reads a SigLIP dual tower and a classifier (the JAX package
    replicates what does not divide; explicit TP cannot)."""
    cfg = _port_cfg(T.tiny_siglip_cfg())
    vision, text = cfg.vision, cfg.text
    import dataclasses

    bad = {"vision_heads": ("vision", dict(num_heads=3, hidden_size=33)),
           "vision_mlp": ("vision", dict(intermediate_size=127)),
           "text_heads": ("text", dict(num_heads=3, hidden_size=33)),
           "text_mlp": ("text", dict(intermediate_size=127)),
           "text_vocab": ("text", dict(vocab_size=127)),
           "classifier_tower": ("vision", dict(num_heads=3, hidden_size=33))}[what]
    sharding.check_config(cfg, 2)
    if bad[0] == "vision":
        vision = dataclasses.replace(vision, **bad[1])
    else:
        text = dataclasses.replace(text, **bad[1])
    model_cfg = (classifier.ClassifierConfig(vision=vision, num_classes=4)
                 if what == "classifier_tower" else siglip.SiglipConfig(vision=vision, text=text))
    with pytest.raises(ValueError, match="does not divide"):
        sharding.check_config(model_cfg, 2)


@pytest.mark.parametrize("name", ["siglip", "classifier"])
def test_whole_towers_under_a_model_axis_raise(name):
    """``check_local`` reads the vision tower's q_proj: whole leaves on a model rank raise;
    the rank's shards pass."""
    jcfg, jp = _siglip() if name == "siglip" else _classifier()
    cfg, full = _port_cfg(jcfg), _port_params(jcfg, jp)
    plan = sharding.plan_for(full, cfg, model=2, rank=1)
    with pytest.raises(ValueError, match="shard the params"):
        sharding.check_local(full, cfg, plan)
    sharding.check_local(sharding.shard_params(full, plan), cfg, plan)


def test_stage0_loss_counts_groups_by_the_data_ranks():
    """One process: ``local_negatives_shards`` splits the batch into that many groups."""
    case = _faults_case()
    img, txt = torch.tensor(case["img"]), torch.tensor(case["txt"])
    scale, bias = torch.tensor([case["scale"]]), torch.tensor([case["bias"]])
    original = siglip.forward_contrastive
    siglip.forward_contrastive = lambda *a, **k: (img, txt, scale, bias)
    try:
        loss = steps.stage0_loss(None, local_negatives_shards=2)(
            {"vision": {"patch_embedding": {"weight": torch.zeros(1)}}},
            {"pixel_values": torch.zeros(4), "input_ids": None})[0]
    finally:
        siglip.forward_contrastive = original
    want = np.mean([float(losses.siglip_pairwise_loss(img[i:i + 2], txt[i:i + 2], scale[0],
                                                      bias[0])) for i in (0, 2)])
    np.testing.assert_allclose(float(loss), want, rtol=1e-6)
