"""The stage-0 and cls CLIs of the port over the model axis through the launcher, on the
CPU: ``launch --simulate 2 <stage> -- ... --mesh_data 1 --mesh_model 2`` (two gloo ranks,
one replica) against the same CLI in one process, on a tiny local SigLIP snapshot (4
heads, MLP 64, the word tokenizer's vocab of 20 inside it) and a synthetic corpus, fp32.

Held: the same losses (within 1e-5 relative: every epoch carries the ranks' rounding of
the row-parallel sums into the next step), the same evaluation (the zero-shot accuracy;
the cls probe's validation loss, accuracy and AUROC), and checkpoints and HF exports of
whole leaves within 1e-4 (relative distance) of the one-process run's: 4-6 Adam steps at
lr 1e-2 carry the ranks' rounding into ~2e-5 of a leaf.
"""

import json
import os

import numpy as np
import pytest
import torch
from safetensors.torch import load_file

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu_torch.cli import cls_train, train_stage0

import test_torch_tp

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny SigLIP snapshot (with its MAP head) with the word tokenizer saved inside
    it, and a corpus of 12 images."""
    from transformers import SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("torch_tp_towers_cli")
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


def _metrics(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _logged(rows, key):
    return [r[key] for r in rows if key in r]


def _launch_tp(stage, argv):
    rc, logs = test_torch_tp._launch(["--simulate", "2", "--timeout", "60", "--feeder_procs",
                                      "0", stage, "--", *argv, "--mesh_data", "1",
                                      "--mesh_model", "2"])
    assert rc == 0, logs[-4000:]
    return logs


# leaves whose gradient is zero in exact arithmetic (the key biases, packed into the MAP
# head's in_proj_bias in an HF export; the cls probe's class-shared biases): Adam moves
# them by rounding noise, differently on each side, so they are held by their shapes only
NOISE = ("k_proj.bias", "k_proj/bias", "in_proj_bias", "post_layernorm/bias",
         "mha/v_proj/bias", "mha/out_proj/bias")


def _close(a: dict, b: dict, tol):
    assert a.keys() == b.keys() and a
    for k, x in b.items():
        assert a[k].shape == x.shape, k  # whole, not a rank's shard
        if k.endswith(NOISE) or k == "head/bias":
            continue
        # by the leaf's distance: an element whose gradient all but vanished moves by a
        # part of lr that rounding decides
        dist = float((a[k].double() - x.double()).norm() / x.double().norm().clamp_min(1e-30))
        assert dist <= tol, f"{k}: {dist}"


def _stage0_argv(snapshot, out):
    model_dir, root, manifest = snapshot
    return ["--model_name", model_dir, "--image_root", root, "--train_json", manifest,
            "--output_dir", out, "--img_size", "32", "--batch_size", "3", "--num_epochs", "2",
            "--learning_rate", "1e-2", "--warmup_ratio", "0.0", "--max_text_len", "16",
            "--val_split", "0.25", "--min_save_epoch", "0", "--logging_steps", "1",
            "--num_workers", "1", "--mixed_precision", "no", "--disable_wandb",
            "--no-freeze_text_encoder", "--seed", "0"]


def test_launch_trains_stage0_over_the_model_axis(snapshot, tmp_path):
    """Both towers trained (the text tower's vocab-sharded table too), the zero-shot
    validation each epoch, an HF export and a checkpoint each epoch written whole."""
    one = str(tmp_path / "one")
    train_stage0.main(_stage0_argv(snapshot, one) + ["--device", "cpu"])
    tp = str(tmp_path / "tp")
    _launch_tp("stage0", _stage0_argv(snapshot, tp))
    ours, ref = _metrics(tp), _metrics(one)
    assert len(_logged(ours, "train/batch_loss")) == 6  # 9 training samples at batch 3
    np.testing.assert_allclose(_logged(ours, "train/batch_loss"),
                               _logged(ref, "train/batch_loss"), rtol=1e-5)
    assert _logged(ours, "zero_shot/accuracy") == _logged(ref, "zero_shot/accuracy")
    for tag in ("epoch_1", "epoch_2"):
        _close(load_file(os.path.join(tp, tag, "model.safetensors")),
               load_file(os.path.join(one, tag, "model.safetensors")), 1e-4)
    saved = [torch.load(os.path.join(d, "checkpoints", "epoch_1.pt"), weights_only=True)
             for d in (tp, one)]
    _close(saved[0]["params"], saved[1]["params"], 1e-4)


def test_launch_trains_the_cls_probe_over_the_model_axis(snapshot, tmp_path):
    """1EpochUnfreeze: the tower trains in epoch 0 only, results.tsv repeats the
    one-process run's rows, and the checkpoint holds every leaf whole. Dropout off: with
    it on, the class-shared biases that Adam moves by rounding noise meet masks that
    differ across classes, and the losses part by ~1e-4 from the second step
    (``tests/test_torch_tp_towers.py`` holds the masks themselves, ``cls_dropout``)."""
    model_dir, root, manifest = snapshot
    argv = ["--exp_id", "EXPT", "--class_names", "Pneumonia,Edema,Cardiomegaly,No Finding",
            "--vision_model_name", model_dir, "--data_json", manifest, "--image_root", root,
            "--img_size", "32", "--batch_size", "4", "--lr", "1e-3", "--bb_lr", "1e-4",
            "--num_workers", "1", "--mixed_precision", "no", "--logging_steps", "1",
            "--freeze_mode", "1EpochUnfreeze", "--epochs", "2", "--dropout_rate", "0.0"]
    one = str(tmp_path / "one")
    cls_train.main(argv + ["--output_base_dir", one, "--device", "cpu"])
    tp = str(tmp_path / "tp")
    _launch_tp("cls", argv + ["--output_base_dir", tp])
    ours, ref = _metrics(os.path.join(tp, "EXPT")), _metrics(os.path.join(one, "EXPT"))
    np.testing.assert_allclose(_logged(ours, "train/batch_loss"),
                               _logged(ref, "train/batch_loss"), rtol=1e-5)
    assert _logged(ours, "tower_frozen") == [0.0, 1.0]
    tsv = [np.loadtxt(os.path.join(d, "EXPT", "results.tsv"), skiprows=1) for d in (tp, one)]
    assert tsv[0].shape == (2, 5)
    np.testing.assert_allclose(tsv[0], tsv[1], rtol=1e-5)
    saved = [torch.load(os.path.join(d, "EXPT", "checkpoints", "epoch_1.pt"),
                        weights_only=True) for d in (tp, one)]
    _close(saved[0]["params"], saved[1]["params"], 1e-4)
    assert "vision/head/mlp/fc1/weight" in saved[0]["params"]
