"""The port's cls probe trainer and CLIs end to end on the CPU, fp32 (``--mixed_precision
no``), against the JAX package's.

- ``ClsTrainer`` in each freeze mode (and the two-way multi-label loss) over a synthetic
  7-image corpus (16 px; a stratified 4 / 3 split, batch 3: a straggler batch with a
  filler row), from one set of weights (the JAX ``classifier.init`` with a MAP head,
  carried by ``from_jax.classifier_params``), dropout off: every step's loss within
  1e-4 relative of the JAX trainer's across 2 epochs (and the 1EpochUnfreeze swap);
  ``results.tsv`` with the same header and rows (values within 1e-4 relative); the
  tower moves exactly when it should; the best and the epoch-1 checkpoint, evaluated by
  ``cls_test`` alone (the two-way run: by ``sweep.evaluate_all_checkpoints``), give the
  trainer's own validation numbers;
- ``cli/cls_train`` ``--resume`` from the epoch-1 checkpoint (the first periodic one:
  checkpoints are kept every 2 epochs) repeats the uninterrupted run's epoch-2 and
  epoch-3 losses exactly, dropout on;
- ``cls_train`` -> ``cls_test`` -> ``cls_evaluate_experiment`` -> ``run_experiments``
  (two experiments on slots ``cpu;cpu``) over a tiny HF snapshot;
- ``balanced_sample`` writes what the JAX CLI writes;
- the flags whose machinery is not ported raise.
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
from projectiontrainer_tpu.core import config as jconfig
from projectiontrainer_tpu.core.mesh import MeshConfig, build_mesh
from projectiontrainer_tpu.data import datasets as jdatasets
from projectiontrainer_tpu.models import classifier as JC
from projectiontrainer_tpu.train import trainer_cls as JT
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.cli import (balanced_sample, cls_evaluate_experiment, cls_test,
                                             cls_train, run_experiments)
from projectiontrainer_tpu_torch.core.config import ClsConfig
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
from projectiontrainer_tpu_torch.data import datasets
from projectiontrainer_tpu_torch.eval import sweep
from projectiontrainer_tpu_torch.models import classifier
from projectiontrainer_tpu_torch.train.trainer_cls import ClsTrainer

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = "Pneumonia,Edema,Cardiomegaly,No Finding,Atelectasis"  # 5; the corpus uses 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root, manifest = T.synthetic_corpus(str(tmp_path_factory.mktemp("cls_corpus")), n=7,
                                        image_size=16)
    samples = datasets.load_manifest(manifest)
    train_s, val_s = datasets.stratified_split(samples, val_ratio=0.25, seed=0)
    assert (len(train_s), len(val_s)) == (4, 3)
    val_json = os.path.join(os.path.dirname(manifest), "val.json")
    with open(val_json, "w") as f:
        json.dump(val_s, f)
    return root, manifest, train_s, val_s, val_json


@functools.cache
def _jax_model():
    vcfg = T.tiny_vision_cfg(image_size=16, patch=8, hidden=32, layers=2, heads=4, use_head=True)
    jcfg = JC.ClassifierConfig(vision=vcfg, num_classes=5, num_heads=4, dropout_rate=0.0)
    return jcfg, jax.tree.map(np.asarray, JC.init(jax.random.key(1), jcfg))


def _recording(trainer, losses, on_call=None):
    """Wrap each step variant of a trainer (either package's) to record its losses."""
    for key, (fn, tx, schedule) in list(trainer._steps.items()):
        def step(state, batch, rng, _fn=fn, _key=key):
            if on_call is not None:
                on_call(_key, state)
            state, loss, aux = _fn(state, batch, rng)
            losses.append(float(loss))
            return state, loss, aux

        trainer._steps[key] = (step, tx, schedule)


def _results(path):
    with open(path) as f:
        lines = f.read().strip().splitlines()
    return lines[0], [[float(v) for v in line.split("\t")] for line in lines[1:]]


def _tower(params):
    return {p: x.detach().clone() for p, x in leaves_with_paths(params["vision"])}


@pytest.mark.parametrize("mode", ["Freeze", "Unfreeze", "1EpochUnfreeze", "two_way"])
def test_trainer_matches_jax(corpus, tmp_path, mode):
    root, manifest, train_s, val_s, val_json = corpus
    two_way = mode == "two_way"
    common = dict(exp_id="E", class_names=CLASSES, freeze_mode="Freeze" if two_way else mode,
                  image_root=root, data_json=manifest, img_size=16, batch_size=3, epochs=2,
                  lr=1e-3, bb_lr=1e-3, num_workers=1, disable_wandb=True, dropout_rate=0.0,
                  mixed_precision="no", seed=0, multilabel_two_way=two_way)
    jcfg, jp = _jax_model()
    names = CLASSES.split(",")

    def make(pkg, s):
        if two_way:
            return pkg.MultiLabelClassificationDataset(s, image_root=root, class_names=names,
                                                       image_size=16)
        return pkg.ClassificationDataset(s, image_root=root, class_names=names, image_size=16)

    jtrainer = JT.ClsTrainer(
        jconfig.ClsConfig(output_base_dir=str(tmp_path / "jax"), mesh_data=1, **common),
        model_cfg=jcfg, params=jax.tree.map(jnp.asarray, jp),
        train_dataset=make(jdatasets, train_s), val_dataset=make(jdatasets, val_s),
        mesh=build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1]))
    theirs = []
    _recording(jtrainer, theirs)
    jtrainer.train()

    cfg = classifier.ClassifierConfig(vision=from_jax.config_from_jax(jcfg.vision),
                                      num_classes=5, num_heads=4, dropout_rate=0.0)
    trainer = ClsTrainer(ClsConfig(output_base_dir=str(tmp_path / "port"), device="cpu",
                                   **common),
                         model_cfg=cfg, params=from_jax.classifier_params(jp),
                         train_dataset=make(datasets, train_s), val_dataset=make(datasets, val_s))
    towers = [_tower(trainer.state["params"])]
    seen = set()

    def on_call(frozen, state):  # the tower as the first step of each variant finds it
        if frozen not in seen:
            seen.add(frozen)
            towers.append(_tower(state["params"]))

    ours = []
    _recording(trainer, ours, on_call)
    result = trainer.train()
    towers.append(_tower(trainer.state["params"]))

    assert len(ours) == len(theirs) == 4  # 2 epochs of 2 batches (3 + 1 real rows)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    assert [e["tower_frozen"] for e in result["epochs"]] == [
        trainer._epoch_frozen(0), trainer._epoch_frozen(1)]
    same = lambda a, b: all(torch.equal(a[p], b[p]) for p in a)  # noqa: E731
    if mode in ("Freeze", "two_way"):
        assert same(towers[0], towers[-1])
    elif mode == "Unfreeze":
        assert not same(towers[0], towers[-1])
    else:  # moved in epoch 0, bit-equal through epoch 1
        first, at_swap, end = towers[0], towers[2], towers[-1]
        assert not same(first, at_swap) and same(at_swap, end)

    exp_dir = str(tmp_path / "port" / "E")
    header, rows = _results(os.path.join(exp_dir, "results.tsv"))
    jheader, jrows = _results(str(tmp_path / "jax" / "E" / "results.tsv"))
    assert header == jheader == "Epoch\tTrain Loss\tVal Loss\tVal Acc\tVal AUC"
    assert [r[0] for r in rows] == [r[0] for r in jrows] == [0, 1]
    np.testing.assert_allclose(np.asarray(rows), np.asarray(jrows), rtol=1e-4, atol=2e-6)

    # the checkpoints alone rebuild the classifier and give the trainer's own numbers
    best_epoch = trainer.ckpt.metadata("best")["epoch"]
    if two_way:
        got = {r["epoch"]: r for r in sweep.evaluate_all_checkpoints(exp_dir, make(datasets, val_s),
                                                                     batch_size=3, device="cpu")}
        assert list(got) == [1]
        assert f"{got[1]['loss']:.6f}" == f"{rows[1][2]:.6f}"
        return
    for name, epoch in (("best", best_epoch), ("epoch_1", 1)):
        report = cls_test.main(["--exp_dir", exp_dir, "--checkpoint", name, "--test_json", val_json,
                                "--image_root", root, "--img_size", "16", "--batch_size", "3",
                                "--device", "cpu"])
        row = rows[epoch]
        assert [f"{report[k]:.6f}" for k in ("loss", "accuracy", "auc")] == [
            f"{v:.6f}" for v in row[2:]], name


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny SigLIP snapshot (its vision tower has a MAP head) and a 10-image corpus."""
    from transformers import SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("cls_snapshot")
    torch.manual_seed(0)
    model_dir = str(base / "siglip-tiny")
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4, vocab_size=64,
                                     max_position_embeddings=16).to_dict(),
    )).save_pretrained(model_dir)
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=10, image_size=32)
    return model_dir, root, manifest


def _train_argv(snapshot, base, *extra):
    model_dir, root, manifest = snapshot
    return ["--exp_id", "EXPT", "--class_names", "Pneumonia,Edema,Cardiomegaly,No Finding",
            "--vision_model_name", model_dir, "--data_json", manifest, "--image_root", root,
            "--output_base_dir", base, "--img_size", "32", "--batch_size", "4", "--lr", "1e-3",
            "--bb_lr", "1e-4", "--num_workers", "1", "--mixed_precision", "no",
            "--logging_steps", "1", "--device", "cpu", *extra]


def _batch_losses(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [r["train/batch_loss"] for r in map(json.loads, f) if "train/batch_loss" in r]


def test_cli_resume_repeats_losses(snapshot, tmp_path):
    """1EpochUnfreeze with dropout on: the epoch-1 checkpoint (post-swap variant, the
    tower epoch 0 trained) resumes into the uninterrupted run's losses, bit for bit."""
    base = str(tmp_path / "run")
    out = cls_train.main(_train_argv(snapshot, base, "--freeze_mode", "1EpochUnfreeze",
                                     "--epochs", "4"))
    exp_dir = os.path.join(base, "EXPT")
    losses = _batch_losses(exp_dir)
    assert len(losses) == 4 * 2 and np.isfinite(losses).all()  # 8 train samples at batch 4
    assert [e["tower_frozen"] for e in out["epochs"]] == [False, True, True, True]
    ckpts = os.path.join(exp_dir, "checkpoints")
    assert {"epoch_1.pt", "epoch_3.pt", "best.pt"} <= set(os.listdir(ckpts))
    saved = torch.load(os.path.join(ckpts, "epoch_1.pt"), weights_only=True)
    assert any(p.startswith("vision/layers/") for p in saved["params"])  # the whole tower
    assert not any(p.startswith("vision/") for p in saved["opt_state"]["mu"])

    resumed = str(tmp_path / "resumed")
    shutil.copytree(base, resumed)
    rckpts = os.path.join(resumed, "EXPT", "checkpoints")
    for name in os.listdir(rckpts):
        if name != "epoch_1.pt":
            os.remove(os.path.join(rckpts, name))
    tsv = os.path.join(resumed, "EXPT", "results.tsv")
    with open(tsv) as f:
        full = f.read().splitlines(keepends=True)
    with open(tsv, "w") as f:  # as a run stopped after epoch 1 leaves it
        f.writelines(full[:3])
    n_before = len(_batch_losses(os.path.join(resumed, "EXPT")))
    cls_train.main(_train_argv(snapshot, resumed, "--freeze_mode", "1EpochUnfreeze",
                               "--epochs", "4", "--resume"))
    again = _batch_losses(os.path.join(resumed, "EXPT"))[n_before:]
    np.testing.assert_array_equal(again, losses[4:])
    _, rows = _results(tsv)
    _, full_rows = _results(os.path.join(exp_dir, "results.tsv"))
    assert rows == full_rows and [r[0] for r in rows] == [0, 1, 2, 3]


def test_cli_chain(snapshot, tmp_path, monkeypatch):
    """cls_train -> cls_test -> cls_evaluate_experiment -> run_experiments (CPU slots)."""
    model_dir, root, manifest = snapshot
    base = str(tmp_path / "cls")
    cls_train.main(_train_argv(snapshot, base, "--freeze_mode", "Unfreeze", "--epochs", "2"))
    exp_dir = os.path.join(base, "EXPT")
    report = cls_test.main(["--exp_dir", exp_dir, "--test_json", manifest, "--image_root", root,
                            "--img_size", "32", "--device", "cpu",
                            "--roc_plot", str(tmp_path / "roc.png")])
    assert 0.0 <= report["accuracy"] <= 1.0 and np.isfinite(report["auc"])
    assert np.asarray(report["confusion_matrix"]).sum() == 10
    assert os.path.exists(tmp_path / "roc.png")

    swept = cls_evaluate_experiment.main([
        "--exp_id", "EXPT", "--output_base_dir", base, "--test_json", manifest,
        "--image_root", root, "--img_size", "32", "--device", "cpu",
        "--plot", str(tmp_path / "metrics.png")])
    assert [r["checkpoint"] for r in swept["results"]] == ["epoch_1"]
    assert all(np.isfinite([swept["results"][0][k] for k in ("loss", "accuracy", "auc")]))
    assert swept["best"].startswith("BEST_RESULT\tEXPT\t") and len(swept["best"].split("\t")) == 6
    assert os.path.exists(tmp_path / "metrics.png")

    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps([["G1", "Pneumonia,Edema", "Freeze", False, False],
                                ["G2", "Edema,Cardiomegaly,No Finding", "1EpochUnfreeze",
                                 True, False]]))
    monkeypatch.setenv("PYTHONPATH", REPO)
    lines = run_experiments.main([
        "--data_json", manifest, "--image_root", root, "--output_base_dir", str(tmp_path / "grid"),
        "--vision_model_name", model_dir, "--epochs", "2", "--grid_json", str(grid),
        "--device_slots", "cpu;cpu", "--img_size", "32", "--batch_size", "4", "--num_workers",
        "1", "--mixed_precision", "no"])
    assert sorted(line.split("\t")[1] for line in lines) == ["G1", "G2"]
    with open(tmp_path / "grid" / "all_experiments_summary.tsv") as f:
        summary = f.read().strip().splitlines()
    assert summary[0].startswith("ExpID") and len(summary) == 3
    for line in lines:
        assert line.split("\t")[5].endswith(".pt")


def test_slot_env():
    assert sweep.slot_env("cpu")["CUDA_VISIBLE_DEVICES"] == ""
    assert sweep.slot_args("cpu") == ["--device", "cpu"]
    assert sweep.slot_env("1,2")["CUDA_VISIBLE_DEVICES"] == "1,2" and sweep.slot_args("1,2") == []
    assert set(sweep.slot_env("0")) - set(os.environ) <= {"CUDA_VISIBLE_DEVICES"}


@pytest.mark.parametrize("labels,size,seed", [("Pneumonia, No Finding", 5, 42),
                                              ("Edema,Cardiomegaly,Missing", 7, 3),
                                              ("Pneumonia,Edema,Cardiomegaly,No Finding", 40, 0)])
def test_balanced_sample_matches_jax_cli(tmp_path, labels, size, seed):
    from projectiontrainer_tpu.cli import balanced_sample as jbalanced_sample

    _, manifest = T.synthetic_corpus(str(tmp_path), n=23, image_size=8)
    args = ["--input_json", manifest, "--candidate_labels", labels, "--sample_size", str(size),
            "--seed", str(seed)]
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    balanced_sample.main(args + ["--output_path", ours])
    jbalanced_sample.main(args + ["--output_path", theirs])
    with open(ours) as a, open(theirs) as b:
        got, ref = json.load(a), json.load(b)
    assert got == ref and len(got) > 0


# --num_loader_procs runs since the feeder port, on threads here
# (test_cli_num_loader_procs_falls_back_to_threads below), --mesh_data since the
# data-parallel port (below), --fsdp since the ZeRO-3 port (tests/test_torch_fsdp_cli.py),
# --mesh_model since the tensor-parallel port of the towers
# (tests/test_torch_tp_towers.py): a model axis of 2 needs 2 processes, so a process
# that no launcher started (a world of one) refuses it with the mesh's error
@pytest.mark.parametrize("flag", [["--mesh_model", "2"]])
def test_cli_refuses_what_is_not_ported(snapshot, tmp_path, monkeypatch, flag):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="does not divide the world"):
        cls_train.main(_train_argv(snapshot, str(tmp_path / "x"), *flag))


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
        cls_train.main(_train_argv(snapshot, str(tmp_path / "x"), *flag))


def test_cli_num_loader_procs_falls_back_to_threads(snapshot, tmp_path, caplog):
    """ClassificationDataset lacks the process feeder's protocol, so --num_loader_procs
    reads on threads, as the JAX package's supports_process_feed decides: said once in
    the log, no pool made, the losses those of a run without the flag."""
    from projectiontrainer_tpu_torch.data import feeder

    caplog.set_level("INFO", logger="projectiontrainer_tpu_torch")
    cls_train.main(_train_argv(snapshot, str(tmp_path / "procs"), "--freeze_mode", "Freeze",
                               "--epochs", "1", "--num_loader_procs", "2"))
    said = [r.getMessage() for r in caplog.records if "--num_loader_procs" in r.getMessage()]
    assert len(said) == 1 and "threads" in said[0] and not feeder._pools
    cls_train.main(_train_argv(snapshot, str(tmp_path / "threads"), "--freeze_mode", "Freeze",
                               "--epochs", "1"))
    got, ref = (_batch_losses(os.path.join(tmp_path, d, "EXPT")) for d in ("procs", "threads"))
    assert len(got) == 2 and got == ref
