"""The port's stage 0 (SigLIP contrastive training) against the JAX package's, fp32 on
the CPU.

Weights come from ``siglip.init(jax.random.key(0), testing.tiny_siglip_cfg())`` and
cross through ``checkpoint/from_jax.siglip_params``; batches are numpy draws from a
seed. Tolerances: 1e-6 relative for the loss alone, 1e-4 of the reference's largest
magnitude for towers, losses and gradients (fp32 sums in another order).

- ``siglip_pairwise_loss`` with and without ``sample_weight``;
- the dual tower's ``forward_contrastive`` and ``logits_per_image``;
- ``stage0_loss``: loss and the gradient of every trainable leaf, one and two negative
  shards, with a filler row and an invalid row;
- a 24-step loss curve of ``make_train_step(stage0_loss)`` + AdamW with the warmup
  rounded down, against JAX's train step with optax;
- ``Stage0Trainer``: zero-shot metrics equal to the JAX trainer's on the same weights,
  and ``cli/train_stage0`` end to end on tiny HF snapshots: the loss falls, ``--resume``
  repeats the epoch-1 losses exactly, the HF export reloads (through both packages)
  to the trained weights and the same logits.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.models import siglip as JSIG
from projectiontrainer_tpu.train import losses as JL
from projectiontrainer_tpu.train import masks as JM
from projectiontrainer_tpu.train import optim as JO
from projectiontrainer_tpu.train import steps as JS
from projectiontrainer_tpu_torch.checkpoint import from_jax, hf_import
from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.cli import train_stage0
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
from projectiontrainer_tpu_torch.models import siglip
from projectiontrainer_tpu_torch.train import losses, masks, optim, steps
from projectiontrainer_tpu_torch.train.trainer_stage0 import zero_shot_prf

torch.set_num_threads(2)


def rel_close(ours, theirs, tol=1e-4):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    err = np.abs(ours - theirs).max()
    assert err <= tol * max(np.abs(theirs).max(), 1e-30), f"max err {err} vs {np.abs(theirs).max()}"


@functools.cache
def _jax_model():
    jcfg = T.tiny_siglip_cfg()
    return jcfg, jax.tree.map(np.asarray, jax.jit(JSIG.init, static_argnums=1)(
        jax.random.key(0), jcfg))


def _models():
    jcfg, jparams = _jax_model()
    return jcfg, jparams, from_jax.config_from_jax(jcfg), from_jax.siglip_params(jparams)


def _batch(rng, b=4, image=32, t=16, vocab=128, filler=False, invalid=False):
    batch = {"pixel_values": rng.standard_normal((b, image, image, 3), dtype=np.float32),
             "input_ids": rng.integers(1, vocab, size=(b, t)).astype(np.int32)}
    if filler:
        batch["sample_weight"] = np.array([1.0] * (b - 1) + [0.0], np.float32)
    if invalid:
        batch["valid"] = np.array([True, False] + [True] * (b - 2))
    return batch


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("weighted", [False, True])
def test_siglip_pairwise_loss_matches_jax(weighted):
    rng = np.random.default_rng(0)
    img = rng.standard_normal((6, 16), dtype=np.float32)
    txt = rng.standard_normal((6, 16), dtype=np.float32)
    img[5] = img[0]  # a filler row repeats a real one
    w = np.array([1, 1, 1, 1, 1, 0], np.float32) if weighted else None
    theirs = JL.siglip_pairwise_loss(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(2.3),
                                     jnp.asarray(-10.0),
                                     sample_weight=None if w is None else jnp.asarray(w))
    ours = losses.siglip_pairwise_loss(torch.tensor(img), torch.tensor(txt), torch.tensor(2.3),
                                       torch.tensor(-10.0),
                                       sample_weight=None if w is None else torch.tensor(w))
    rel_close(ours, theirs, 1e-6)


def test_dual_tower_matches_jax():
    jcfg, jp, cfg, p = _models()
    b = _batch(np.random.default_rng(1))
    jimg, jtxt, _, _ = JSIG.forward_contrastive(jp, jcfg, jnp.asarray(b["pixel_values"]),
                                                jnp.asarray(b["input_ids"]))
    img, txt, scale, bias = siglip.forward_contrastive(p, cfg, torch.tensor(b["pixel_values"]),
                                                       torch.tensor(b["input_ids"]))
    rel_close(img, jimg)
    rel_close(txt, jtxt)
    assert scale.dtype == bias.dtype == torch.float32
    rel_close(siglip.logits_per_image(p, cfg, torch.tensor(b["pixel_values"]),
                                      torch.tensor(b["input_ids"])),
              JSIG.logits_per_image(jp, jcfg, jnp.asarray(b["pixel_values"]),
                                    jnp.asarray(b["input_ids"])))


def _trainable_leaves(params):
    mask = dict(leaves_with_paths(masks.bool_mask(masks.stage0_labels(params))))
    return [(path, x) for path, x in leaves_with_paths(params) if mask[path]]


@pytest.mark.parametrize("shards,filler,invalid", [(1, True, False), (2, True, True),
                                                   (1, False, True)])
def test_stage0_loss_and_grads_match_jax(shards, filler, invalid):
    jcfg, jp, cfg, p = _models()
    batch = _batch(np.random.default_rng(2), filler=filler, invalid=invalid)
    jloss_fn = JS.stage0_loss(jcfg, remat=False, local_negatives_shards=shards)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda pr, bt: jloss_fn(pr, bt, None)[0]))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))

    train = _trainable_leaves(p)
    for _, x in train:
        x.requires_grad_(True)
    loss, _ = steps.stage0_loss(cfg, remat=True, local_negatives_shards=shards)(
        p, _torch_batch(batch))
    grads = torch.autograd.grad(loss, [x for _, x in train])
    rel_close(loss, jloss)
    theirs = dict(leaves_with_paths(from_jax.siglip_params(jax.tree.map(np.asarray, jgrads))))
    assert {path for path, _ in train} == {path for path in theirs
                                           if not path.startswith(("text/", "logit_scale"))}
    for (path, _), g in zip(train, grads):
        if path.endswith("k_proj/bias"):
            # zero in exact arithmetic (it adds one constant to a whole softmax row):
            # both sides hold rounding noise of ~1e-7
            assert max(float(g.abs().max()), float(np.abs(np.asarray(theirs[path])).max())) < 1e-6
        else:
            rel_close(g, theirs[path])


def test_frozen_text_tower_builds_no_graph():
    _, _, cfg, p = _models()
    for _, x in leaves_with_paths(p["vision"]):
        x.requires_grad_(True)
    b = _torch_batch(_batch(np.random.default_rng(3)))
    img, txt, _, _ = siglip.forward_contrastive(p, cfg, b["pixel_values"], b["input_ids"])
    assert img.requires_grad and not txt.requires_grad
    p["text"]["head"]["weight"].requires_grad_(True)  # a text tower that trains
    _, txt, _, _ = siglip.forward_contrastive(p, cfg, b["pixel_values"], b["input_ids"])
    assert txt.requires_grad


def test_remat_dots_raises():
    """'dots' is ported (tests/test_torch_remat_dots.py): the tower runs under it as under
    full remat; a value that names no policy raises."""
    _, _, cfg, p = _models()
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    with torch.enable_grad():
        dots, _ = siglip.vision_forward(p["vision"], cfg.vision, x, remat="dots")
        full, _ = siglip.vision_forward(p["vision"], cfg.vision, x, remat=True)
    assert torch.equal(dots, full)
    with pytest.raises(ValueError, match="remat"):
        siglip.vision_forward(p["vision"], cfg.vision, x, remat="everything")


def test_stage0_labels_freeze_policy():
    _, _, _, p = _models()
    on = lambda labels: {k for k, v in leaves_with_paths(masks.bool_mask(labels)) if v}  # noqa
    default = on(masks.stage0_labels(p))
    assert "logit_bias" in default and "logit_scale" not in default
    assert not any(k.startswith("text/") for k in default)
    assert "vision/head/probe" in default
    partial = on(masks.stage0_labels(p, freeze_text=False, freeze_logit_scale=False,
                                     freeze_layers_ratio=0.5, num_vision_layers=2))
    assert "logit_scale" in partial and "text/head/weight" in partial
    assert not any(k.startswith("vision/layers/0/") for k in partial)
    assert any(k.startswith("vision/layers/1/") for k in partial)


def test_loss_curve_matches_jax_train_step():
    """24 micro-steps at accumulation 2 = 12 updates; warmup ratio 0.3 of 12 is 3.6
    steps, rounded DOWN to 3 as stage 0 does (stage 1 rounds up to 4)."""
    jcfg, jp, cfg, p = _models()
    rng = np.random.default_rng(4)
    batches = [_batch(rng, filler=(i == 3)) for i in range(4)] * 6
    kw = dict(total_steps=12, warmup_ratio=0.3, weight_decay=0.01, accum_steps=2,
              warmup_rounding="floor")

    jlabels = JM.stage0_labels(jp)
    jtx, _ = JO.single_group_optimizer(jlabels, 3e-3, **kw)
    jstep = JS.make_train_step(JS.stage0_loss(jcfg, remat=False), jtx,
                               trainable_mask=JM.bool_mask(jlabels), donate=False)
    jstate = JS.init_state(jax.tree.map(jnp.asarray, jp), jtx)
    jlosses = []
    for i, b in enumerate(batches):
        jstate, loss, _ = jstep(jstate, jax.tree.map(jnp.asarray, b), jax.random.key(i))
        jlosses.append(float(loss))

    p0 = {path: x.clone() for path, x in leaves_with_paths(p)}
    labels = masks.stage0_labels(p)
    tx, schedule = optim.single_group_optimizer(labels, 3e-3, **kw)
    assert schedule(3) == pytest.approx(3e-3)  # warmup over by step 3
    step = steps.make_train_step(steps.stage0_loss(cfg), tx, trainable_mask=masks.bool_mask(labels))
    state = steps.init_state(p, tx)
    ours = [float(step(state, _torch_batch(b))[1]) for b in batches]
    np.testing.assert_allclose(ours, jlosses, rtol=1e-4)
    assert ours[20] < ours[0]
    theirs = dict(leaves_with_paths(from_jax.siglip_params(
        jax.tree.map(np.asarray, jstate["params"]))))
    for path, x in leaves_with_paths(state["params"]):
        # a key bias moves on rounding noise only (its gradient is zero in exact
        # arithmetic, and Adam scales noise up to the learning rate) and never moves
        # the loss: the curve above covers it
        if not path.endswith("k_proj/bias"):
            rel_close(x - p0[path], np.asarray(theirs[path]) - p0[path].numpy())  # the update itself


def test_zero_shot_prf_matches_jax_metrics():
    from projectiontrainer_tpu.eval import metrics as JMET

    rng = np.random.default_rng(5)
    for n_classes in (2, 4, 7):
        pred, target = rng.integers(0, n_classes, 30), rng.integers(0, n_classes - 1, 30)
        ours, theirs = zero_shot_prf(pred, target), JMET.zero_shot_prf(pred, target)
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert ours[k] == pytest.approx(theirs[k], abs=1e-12), k


def test_min_save_epoch(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every_n_epochs=1, min_save_epoch=2)
    state = {"params": {"w": torch.ones(2)}, "opt_state": {"count": 0, "mu": {"w": torch.zeros(2)}},
             "step": 0}
    assert [mgr.save_periodic(e, state) for e in range(4)] == [False, False, True, True]
    assert sorted(os.listdir(tmp_path)) == ["epoch_2.pt", "epoch_3.pt"]


# ---------------------------------------------------------------------------- trainer + CLI


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny SigLIP snapshot with the word tokenizer saved inside it, and a corpus."""
    from transformers import SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("torch_stage0")
    tok = T.word_tokenizer()
    torch.manual_seed(0)
    model_dir = str(base / "siglip-tiny")
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4, vocab_size=len(tok.get_vocab()),
                                     max_position_embeddings=16).to_dict(),
    )).save_pretrained(model_dir)
    tok.save_pretrained(model_dir)
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=12, image_size=32)
    return model_dir, root, manifest


def _argv(snapshot, out, *extra):
    model_dir, root, manifest = snapshot
    return ["--model_name", model_dir, "--image_root", root, "--train_json", manifest,
            "--output_dir", out, "--img_size", "32", "--batch_size", "3", "--num_epochs", "3",
            "--learning_rate", "1e-2", "--warmup_ratio", "0.0", "--max_text_len", "16",
            "--val_split", "0.25", "--min_save_epoch", "0", "--logging_steps", "1",
            "--num_workers", "2", "--mixed_precision", "no", "--disable_wandb",
            "--device", "cpu", "--seed", "0", *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_exports_and_resumes(snapshot, tmp_path):
    from projectiontrainer_tpu.checkpoint import hf_import as JHF

    out = str(tmp_path / "run")
    result = train_stage0.main(_argv(snapshot, out))
    rows = _metrics(out)
    epochs = [r["train/epoch_loss"] for r in rows if "train/epoch_loss" in r]
    batch = [r["train/batch_loss"] for r in rows if "train/batch_loss" in r]
    assert len(epochs) == 3 and len(batch) == 9  # 9 train samples at batch 3
    assert np.isfinite(batch).all() and epochs[-1] < epochs[0]
    assert sum("zero_shot/accuracy" in r for r in rows) == 3
    assert result["best_zero_shot_accuracy"] is not None
    for tag in ("best_model", "epoch_1", "epoch_2", "epoch_3"):
        assert os.path.exists(os.path.join(out, tag, "model.safetensors")), tag
    assert os.path.exists(os.path.join(out, "epoch_3", "tokenizer.json"))

    # the last export holds the trained weights and reloads through both packages
    final = torch.load(os.path.join(out, "checkpoints", "final.pt"), weights_only=True)
    cfg, params = hf_import.load_siglip(os.path.join(out, "epoch_3"))
    leaves = dict(leaves_with_paths(params))
    assert set(final["params"]) <= set(leaves)
    for path, x in final["params"].items():
        torch.testing.assert_close(leaves[path], x, rtol=0, atol=0)
    jcfg, jparams = JHF.load_siglip(os.path.join(out, "epoch_3"), attn_impl="xla", norm_impl="xla")
    b = _batch(np.random.default_rng(6), t=16, vocab=cfg.text.vocab_size)
    rel_close(siglip.logits_per_image(params, cfg, torch.tensor(b["pixel_values"]),
                                      torch.tensor(b["input_ids"])),
              JSIG.logits_per_image(jparams, jcfg, jnp.asarray(b["pixel_values"]),
                                    jnp.asarray(b["input_ids"])))

    # resume from the epoch-0 checkpoint: epochs 1-2 repeat the uninterrupted losses
    resumed = str(tmp_path / "resumed")
    shutil.copytree(out, resumed)
    ckpts = os.path.join(resumed, "checkpoints")
    for name in os.listdir(ckpts):
        if name != "epoch_0.pt":
            os.remove(os.path.join(ckpts, name))
    n_before = len(_metrics(resumed))
    train_stage0.main(_argv(snapshot, resumed, "--resume"))
    new = _metrics(resumed)[n_before:]
    assert new[0]["resumed_from_epoch"] == 0
    np.testing.assert_array_equal([r["train/batch_loss"] for r in new if "train/batch_loss" in r],
                                  batch[3:])


# --num_loader_procs runs since the feeder port (test_cli_trains_on_the_process_feeder
# below), --mesh_data since the data-parallel port (below), --fsdp since the ZeRO-3 port
# (tests/test_torch_fsdp_cli.py), --mesh_model since the tensor-parallel port of the
# towers (tests/test_torch_tp_towers.py): a model axis of 2 needs 2 processes, so a
# process that no launcher started (a world of one) refuses it with the mesh's error
@pytest.mark.parametrize("flag,match", [(["--mesh_model", "2"], "does not divide the world"),
                                        (["--mesh_data", "1", "--mesh_model", "2"],
                                         "needs 2 processes")])
def test_cli_refuses_what_is_not_ported(snapshot, tmp_path, monkeypatch, flag, match):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=match):
        train_stage0.main(_argv(snapshot, str(tmp_path / "x"), *flag))


# --mesh_data resolves over the world of processes (core/mesh.py): one process that no
# launcher started is a world of one, and -1 with several GPUs visible needs a process
# for each; under the launcher it trains data parallel (tests/test_torch_launch.py,
# tests/test_torch_dp.py)
@pytest.mark.parametrize("flag,match", [
    (["--mesh_data", "2"], "projectiontrainer-torch-launch"),
    (["--mesh_data", "-1", "--device", "cuda"], "projectiontrainer-torch-launch"),
    (["--mesh_model", "-1"], "at most one mesh axis may be -1")])
def test_cli_mesh_data_resolves_over_the_world(snapshot, tmp_path, monkeypatch, flag, match):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=match):
        train_stage0.main(_argv(snapshot, str(tmp_path / "x"), *flag))


def test_cli_trains_on_the_process_feeder_with_online_augmentation(snapshot, tmp_path):
    """--use_online_augmentation --num_loader_procs 2: the training images are decoded
    and augmented on two worker processes; the run trains and exports."""
    from projectiontrainer_tpu_torch.data import feeder

    out = str(tmp_path / "aug")
    try:
        result = train_stage0.main(_argv(snapshot, out, "--num_epochs", "2",
                                         "--use_online_augmentation", "--num_loader_procs", "2"))
        pools = list(feeder._pools.values())
        assert [p.num_workers for p in pools] == [2]
    finally:
        feeder.close_pools()
    batch = [r["train/batch_loss"] for r in _metrics(out) if "train/batch_loss" in r]
    assert len(batch) == 6 and np.isfinite(batch).all()
    assert result["best_zero_shot_accuracy"] is not None
    for tag in ("best_model", "epoch_1", "epoch_2"):
        assert os.path.exists(os.path.join(out, tag, "model.safetensors")), tag
    # the augmentation changed what the tower saw: the loss curve is not the plain one
    plain = str(tmp_path / "plain")
    train_stage0.main(_argv(snapshot, plain, "--num_epochs", "2"))
    assert batch != [r["train/batch_loss"] for r in _metrics(plain) if "train/batch_loss" in r]


def test_trainer_with_augmentation_and_process_feeder_matches_jax_trainer(snapshot, tmp_path):
    """Both trainers from the same weights, with use_online_augmentation and
    num_loader_procs=2 and the same seed: the per-step losses within 1e-4 relative
    (the workers draw the same per-sample seeds; the augmented pixels agree)."""
    from projectiontrainer_tpu.core.config import Stage0Config as JStage0Config
    from projectiontrainer_tpu.data import datasets as jdatasets
    from projectiontrainer_tpu.data import feeder as jfeeder
    from projectiontrainer_tpu.train.trainer_stage0 import Stage0Trainer as JStage0Trainer
    from projectiontrainer_tpu_torch.core.config import Stage0Config
    from projectiontrainer_tpu_torch.data import datasets, feeder
    from projectiontrainer_tpu_torch.train.trainer_stage0 import Stage0Trainer

    _, root, manifest = snapshot
    tok = T.word_tokenizer()
    jcfg, _ = _jax_model()
    jcfg = JSIG.SiglipConfig(vision=jcfg.vision,
                             text=JSIG.TextConfig(**{**jcfg.text.__dict__,
                                                     "vocab_size": len(tok.get_vocab())}))
    jp = jax.tree.map(np.asarray, JSIG.init(jax.random.key(2), jcfg))
    common = dict(batch_size=4, num_epochs=2, max_text_len=16, mixed_precision="no",
                  learning_rate=1e-3, warmup_ratio=0.0, disable_wandb=True, seed=0,
                  logging_steps=1, save_every_n_epochs=0, use_online_augmentation=True,
                  num_loader_procs=2)
    data = dict(image_root=root, tokenizer=tok, image_size=32, max_text_len=16, augment=True,
                seed=0)
    try:
        jtrainer = JStage0Trainer(
            JStage0Config(output_dir=str(tmp_path / "j"), mesh_data=1, **common),
            model_cfg=jcfg, params=jax.tree.map(jnp.asarray, jp), tokenizer=tok,
            train_dataset=jdatasets.ContrastiveDataset.from_json(manifest, **data),
            val_dataset=None, class_names=[])
        jtrainer.train()
    finally:
        jfeeder._close_pools()
    try:
        trainer = Stage0Trainer(
            Stage0Config(output_dir=str(tmp_path / "t"), device="cpu", **common),
            model_cfg=from_jax.config_from_jax(jcfg), params=from_jax.siglip_params(jp),
            tokenizer=tok, train_dataset=datasets.ContrastiveDataset.from_json(manifest, **data),
            val_dataset=None, class_names=[])
        trainer.train()
        assert list(feeder._pools) == [(32, 2, feeder.WORKER_OMP_THREADS)]
    finally:
        feeder.close_pools()
    theirs = [r["train/batch_loss"] for r in _metrics(str(tmp_path / "j"))
              if "train/batch_loss" in r]
    ours = [r["train/batch_loss"] for r in _metrics(str(tmp_path / "t"))
            if "train/batch_loss" in r]
    assert len(ours) == len(theirs) == 6
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=0)


def test_zero_shot_validation_matches_jax_trainer(snapshot, tmp_path):
    """Both trainers on the same weights and validation set give the same metrics."""
    from projectiontrainer_tpu.core.config import Stage0Config as JStage0Config
    from projectiontrainer_tpu.data import datasets
    from projectiontrainer_tpu.train.trainer_stage0 import Stage0Trainer as JStage0Trainer
    from projectiontrainer_tpu_torch.core.config import Stage0Config
    from projectiontrainer_tpu_torch.train.trainer_stage0 import Stage0Trainer

    model_dir, root, manifest = snapshot
    tok = T.word_tokenizer()
    ds = datasets.ContrastiveDataset(datasets.load_manifest(manifest), image_root=root,
                                     tokenizer=tok, image_size=32, max_text_len=16)
    jcfg, jp = _jax_model()
    jcfg = JSIG.SiglipConfig(vision=jcfg.vision,
                             text=JSIG.TextConfig(**{**jcfg.text.__dict__,
                                                     "vocab_size": len(tok.get_vocab())}))
    jp = jax.tree.map(np.asarray, JSIG.init(jax.random.key(1), jcfg))
    common = dict(batch_size=5, num_epochs=1, max_text_len=16, mixed_precision="no",
                  disable_wandb=True, seed=0, num_workers=1)
    jtrainer = JStage0Trainer(JStage0Config(output_dir=str(tmp_path / "j"), mesh_data=1, **common),
                              model_cfg=jcfg, params=jax.tree.map(jnp.asarray, jp),
                              tokenizer=tok, train_dataset=ds, val_dataset=ds,
                              class_names=ds.class_names)
    trainer = Stage0Trainer(Stage0Config(output_dir=str(tmp_path / "t"), device="cpu", **common),
                            model_cfg=from_jax.config_from_jax(jcfg),
                            params=from_jax.siglip_params(jp), tokenizer=tok, train_dataset=ds,
                            val_dataset=ds, class_names=ds.class_names)
    theirs, ours = jtrainer.validate_zero_shot(0), trainer.validate_zero_shot(0)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k] == pytest.approx(theirs[k], abs=1e-9), k


def test_stage0_path_imports_no_jax():
    """The stage-0 modules run a tiny train step without JAX ever being imported."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from projectiontrainer_tpu_torch.cli import train_stage0\n"
        "from projectiontrainer_tpu_torch.checkpoint import export, hf_import\n"
        "from projectiontrainer_tpu_torch.models import siglip\n"
        "from projectiontrainer_tpu_torch.train import masks, optim, steps\n"
        "cfg = siglip.SiglipConfig(\n"
        "    vision=siglip.VisionConfig(32, 64, 1, 4, image_size=16, patch_size=8),\n"
        "    text=siglip.TextConfig(32, 64, 1, 4, vocab_size=16, max_position_embeddings=8))\n"
        "p = siglip.init(torch.Generator().manual_seed(0), cfg)\n"
        "labels = masks.stage0_labels(p)\n"
        "tx, _ = optim.single_group_optimizer(labels, 1e-3, total_steps=1)\n"
        "step = steps.make_train_step(steps.stage0_loss(cfg), tx,\n"
        "                             trainable_mask=masks.bool_mask(labels))\n"
        "batch = {'pixel_values': torch.randn(2, 16, 16, 3),\n"
        "         'input_ids': torch.randint(0, 16, (2, 8))}\n"
        "_, loss, _ = step(steps.init_state(p, tx), batch)\n"
        "assert torch.isfinite(loss)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=repo, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
