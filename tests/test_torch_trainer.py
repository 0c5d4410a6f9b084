"""The port's stage-1 trainer and CLI end to end on the CPU: tiny local HF snapshots
(saved with ``save_pretrained``), ``testing.synthetic_corpus`` images and captions,
``python -m projectiontrainer_tpu_torch.cli.train_stage1`` as a user runs it.

Checks that the loss falls over two epochs, that the exported projector reads back
unchanged through the JAX package's ``export.load_projector``, that ``--resume`` from
an epoch checkpoint and from a mid-epoch ``--save_steps`` checkpoint continues with
the very losses of an uninterrupted run, that ``--watch_gradients`` logs the
projector's gradient statistics, and that the flags whose machinery is not ported
raise.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.checkpoint import export as jexport
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.cli import train_stage1
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    from transformers import Gemma3TextConfig, SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.gemma3.modeling_gemma3 import Gemma3ForCausalLM
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("torch_snapshots")
    torch.manual_seed(0)
    vis_dir, llm_dir = str(base / "siglip-tiny"), str(base / "gemma3-tiny")
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4, vocab_size=64,
                                     max_position_embeddings=16).to_dict(),
    )).save_pretrained(vis_dir)
    tok = T.word_tokenizer()
    Gemma3ForCausalLM(Gemma3TextConfig(
        vocab_size=len(tok.get_vocab()), hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1, head_dim=16,
        sliding_window=8, query_pre_attn_scalar=16, max_position_embeddings=256,
    )).save_pretrained(llm_dir)
    tok.save_pretrained(llm_dir)
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=8, image_size=32)
    return vis_dir, llm_dir, root, manifest


def _argv(snapshots, out, *extra):
    vis, llm, root, manifest = snapshots
    return ["--image_root", root, "--train_json", manifest, "--val_json", manifest,
            "--output_dir", out, "--vision_model_name", vis, "--llm_name", llm,
            "--img_size", "32", "--batch_size", "3", "--num_epochs", "2",
            "--learning_rate", "3e-3", "--max_caption_len", "16", "--save_every_n_epochs", "1",
            "--logging_steps", "1", "--num_workers", "2", "--disable_wandb",
            "--device", "cpu", "--seed", "0", *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_exports_and_resumes(snapshots, tmp_path):
    out = str(tmp_path / "run")
    result = train_stage1.main(_argv(snapshots, out, "--save_steps", "4", "--watch_gradients",
                                     "--watch_log_freq", "3"))
    rows = _metrics(out)
    epochs = [r["train/epoch_loss"] for r in rows if "train/epoch_loss" in r]
    batch = [r["train/batch_loss"] for r in rows if "train/batch_loss" in r]
    assert len(epochs) == 2 and len(batch) == 6  # 8 samples at batch 3: 3 steps an epoch
    assert np.isfinite(batch).all()
    assert epochs[1] < epochs[0]
    assert all("val/loss" in r for r in rows if "validation/last_word_accuracy" in r)
    assert np.isfinite(result["train/epoch_loss"])
    assert sum("gradients/projector/fc1/weight.norm" in r for r in rows) == 2  # steps 3, 6

    # the exported projector reads back through the JAX package unchanged
    for tag in ("final", "best", "epoch_1"):
        assert os.path.exists(os.path.join(out, f"projector_{tag}.bin"))
    _, jproj = jexport.load_projector(out, prefer=("final",))
    final = torch.load(os.path.join(out, "checkpoints", "final.pt"), weights_only=True)
    for name, tensor in leaves_with_paths(from_jax.projector_params(jproj)):
        np.testing.assert_array_equal(tensor.numpy(),
                                      final["params"][f"projector/{name}"].numpy())

    # resume from the epoch-0 checkpoint: epoch 1 repeats the uninterrupted run's losses
    resumed = str(tmp_path / "resumed")
    shutil.copytree(out, resumed)
    ckpts = os.path.join(resumed, "checkpoints")
    for name in os.listdir(ckpts):
        if name != "epoch_0.pt":
            os.remove(os.path.join(ckpts, name))
    n_before = len(_metrics(resumed))
    train_stage1.main(_argv(snapshots, resumed, "--resume"))
    new = _metrics(resumed)[n_before:]
    assert new[0]["resumed_at_step"] == 3
    again = [r["train/batch_loss"] for r in new if "train/batch_loss" in r]
    np.testing.assert_array_equal(again, batch[3:])

    # resume mid-epoch from step_4 (--save_steps): epoch 1 skips the batch step 4 took
    mid = str(tmp_path / "mid")
    shutil.copytree(out, mid)
    ckpts = os.path.join(mid, "checkpoints")
    for name in os.listdir(ckpts):
        if name != "step_4.pt":
            os.remove(os.path.join(ckpts, name))
    n_before = len(_metrics(mid))
    train_stage1.main(_argv(snapshots, mid, "--resume"))
    new = _metrics(mid)[n_before:]
    assert new[0]["resumed_at_step"] == 4
    np.testing.assert_array_equal([r["train/batch_loss"] for r in new if "train/batch_loss" in r],
                                  batch[4:])


# --mesh_data resolves over the world of processes (core/mesh.py): one process that no
# launcher started is a world of one, and -1 with several GPUs visible needs a process
# for each; under the launcher it trains data parallel (tests/test_torch_launch.py,
# tests/test_torch_dp.py), and a model axis needs its ranks too (tests/test_torch_tp.py)
@pytest.mark.parametrize("flag,match", [
    (["--mesh_data", "2"], "projectiontrainer-torch-launch"),
    (["--mesh_data", "-1", "--device", "cuda"], "projectiontrainer-torch-launch"),
    (["--mesh_model", "-1"], "at most one mesh axis may be -1"),
    (["--mesh_model", "2"], "projectiontrainer-torch-launch"),
    (["--mesh_data", "1", "--mesh_model", "2"], "projectiontrainer-torch-launch")])
def test_cli_mesh_data_resolves_over_the_world(snapshots, tmp_path, monkeypatch, flag, match):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=match):
        train_stage1.main(_argv(snapshots, str(tmp_path / "x"), *flag))


def test_cli_num_loader_procs_feeds_from_processes(snapshots, tmp_path):
    """--num_loader_procs 2 decodes the training and validation images on two worker
    processes (Stage1PairDataset has the feeder's protocol): the same pixels as the
    thread feed, so the same losses, bit for bit."""
    from projectiontrainer_tpu_torch.data import feeder

    procs, threads = str(tmp_path / "procs"), str(tmp_path / "threads")
    try:
        train_stage1.main(_argv(snapshots, procs, "--num_epochs", "1", "--num_loader_procs", "2"))
        assert [p.num_workers for p in feeder._pools.values()] == [2]
    finally:
        feeder.close_pools()
    train_stage1.main(_argv(snapshots, threads, "--num_epochs", "1"))
    got, ref = ([(r.get("train/batch_loss"), r.get("val/loss")) for r in _metrics(out)
                 if "train/batch_loss" in r or "val/loss" in r] for out in (procs, threads))
    assert len(got) >= 3 and got == ref


def test_cli_profiles_a_window_and_splits_it_by_span(snapshots, tmp_path):
    """--profile_dir: a Chrome trace of steps 1-2 and their host time split over the
    step's spans (forward and backward apart); the profiled steps stay out of the
    step timer's numbers."""
    out = str(tmp_path / "run")
    prof = os.path.join(out, "profile")
    result = train_stage1.main(_argv(snapshots, out, "--num_epochs", "1", "--batch_size", "2",
                                     "--profile_dir", prof, "--profile_start_step", "1",
                                     "--profile_num_steps", "2"))
    assert os.listdir(prof) == ["trace_step1.json"]
    split = {k[len("profile/"):]: v for r in _metrics(out) for k, v in r.items()
             if k.startswith("profile/")}
    for name in ("tower_fwd", "projector_fwd", "projector_bwd", "decoder_fwd", "decoder_bwd",
                 "lm_head_ce_fwd", "lm_head_ce_bwd", "optimizer_fwd"):
        assert split[f"{name}_ms"] > 0, name
    assert "tower_bwd_ms" not in split  # the tower is frozen
    parts = sum(v for k, v in split.items() if k != "total_ms")
    assert split["total_ms"] == pytest.approx(parts)
    assert result["steps_per_sec"] > 0  # step 0 warms up, 1-2 are profiled, 3 is timed


class _StalledCaptions:
    """Tiny stage-1 samples: the first ``free`` load at once (the warm-up batch), every
    later one waits until ``release`` is set and then takes ``delay`` seconds."""

    def __init__(self, n, delay, *, free, release):
        self.n, self.delay, self.free, self.release = n, delay, free, release
        self.calls = 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import time

        self.calls += 1  # one loader thread: the calls come one at a time
        if self.calls > self.free:
            if not self.release.wait(120):
                raise TimeoutError("the step timer never closed its first window")
            time.sleep(self.delay)
        rng = np.random.default_rng(i)
        caption = np.zeros(12, np.int32)
        caption[:6] = rng.integers(2, 128, size=6)
        return {"pixel_values": rng.standard_normal((32, 32, 3), dtype=np.float32),
                "caption_ids": caption}


def test_step_time_includes_a_stalled_feed(tmp_path):
    """The step timer's window opens before the trainer asks the feed for a batch. The
    warm-up batch loads at once; the timed batches load only after the timer has closed
    its first window, two samples of 0.15 s each on one loader thread, so the prefetching
    feed cannot run ahead of the timed steps and each of them waits ~0.3 s for its batch,
    whatever the warm-up step costs and however fast the tiny model's step is."""
    import threading

    import jax

    from projectiontrainer_tpu.models import vlm as JVLM
    from projectiontrainer_tpu_torch.core.config import Stage1Config
    from projectiontrainer_tpu_torch.train.trainer_stage1 import Stage1Trainer

    jcfg = T.tiny_vlm_cfg()
    jparams = jax.tree.map(np.asarray, jax.jit(JVLM.init, static_argnums=1)(
        jax.random.key(0), jcfg))
    tok = type("Tok", (), {"pad_token_id": 0, "eos_token_id": 1,
                           "decode": lambda self, ids, skip_special_tokens=True: ""})()
    cfg = Stage1Config(output_dir=str(tmp_path), batch_size=2, num_epochs=1, logging_steps=1,
                       num_workers=1, device="cpu", save_every_n_epochs=0, disable_wandb=True,
                       img_size=32, max_caption_len=12, seed=0)
    release = threading.Event()
    trainer = Stage1Trainer(cfg, vlm_cfg=from_jax.config_from_jax(jcfg),
                            params=from_jax.vlm_params(jparams), tokenizer=tok,
                            train_dataset=_StalledCaptions(8, 0.15, free=2, release=release))
    window_end = trainer.timer.window_end

    def window_end_then_release():
        window_end()
        release.set()

    trainer.timer.window_end = window_end_then_release
    result = trainer.train()
    assert trainer.timer.measured_steps == 3  # 4 steps, the first one warms up
    # the three timed windows hold the 0.9 s of loading, less the gaps between them
    assert result["step_time_ms"] >= 0.9 * 2 * 150
