"""The port's launcher (``cli/launch.py``): argument routing, feeder sizing, the refusals,
and a 2-rank ``--simulate`` stage-1 run of the real CLI on the CPU, in the pattern of
the JAX package's ``tests/test_launch.py``.

The simulated run (tiny local HF snapshots, 8 samples, batch 2 a rank, 2 epochs, fp32
compute; the launcher a subprocess bounded by 150 s, each collective by 60 s) must:
log every step's loss within 1e-5 of that one-process run's, bring up both
ranks over gloo, end with the same result (epoch loss, best validation loss) on each
rank, write the metrics, checkpoints and projector exports once (rank 0), and end with
the projector of one process trained at batch 4 on the same samples within 1e-5.
Stages 0 and 2 and the cls probe run the same way (2 ranks, tiny snapshots): every rank
ends with the same result, and rank 0 writes what each evaluation gathers from every
rank (stage 0's zero-shot accuracy, stage 2's validation examples, the cls
``results.tsv``). A rank that fails fails the launch. ``--simulate 2 --devices_per_host
2`` starts 4 ranks (2 simulated hosts of 2), and stage 1 at ``--mesh_data 2`` over that
world of 4 trains on ranks 0-1 as the 2-rank world does (its losses within 1e-5 of one
process at twice the batch) while ranks 2-3, beyond the mesh, say so and exit 0;
``--devices_per_host`` without ``--simulate`` is refused.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu_torch.cli import launch, train_stage1

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_split_argv_routing():
    pre, stage, rest = launch._split_argv(["--simulate", "2", "stage1", "--", "--batch_size", "2"])
    assert (pre, stage, rest) == (["--simulate", "2"], "stage1", ["--batch_size", "2"])
    # without the '--' separator
    _, stage, rest = launch._split_argv(["stage2", "--num_epochs", "1"])
    assert stage == "stage2" and rest == ["--num_epochs", "1"]
    # an entry in place of a stage: its args follow '--'
    pre, stage, rest = launch._split_argv(["--entry", "m:f", "--", "--a", "1"])
    assert (pre, stage, rest) == (["--entry", "m:f"], None, ["--a", "1"])
    assert set(launch.STAGES) == {"stage0", "stage1", "stage2", "cls", "experiments"}


def test_feeder_injection(monkeypatch):
    assert launch._inject_feeder(["--a", "1"], "3") == ["--a", "1", "--num_loader_procs", "3"]
    argv = ["--num_loader_procs", "7"]
    assert launch._inject_feeder(argv, "3") == argv  # an explicit stage setting wins
    assert launch._inject_feeder(["--a"], "keep") == ["--a"]
    # auto: the host's cores - 2, at most 4 a local rank
    monkeypatch.setattr(os, "sched_getaffinity", lambda _: set(range(32)))
    assert launch._inject_feeder([], "auto", 2) == ["--num_loader_procs", "8"]
    assert launch._inject_feeder([], "auto", 8) == ["--num_loader_procs", "30"]


@pytest.mark.parametrize("argv", [["--nproc_per_node", "2", "stage1"],
                                  ["--nproc_per_node", "2", "--backend", "nccl", "stage1"]])
def test_more_ranks_than_gpus_under_nccl_raises(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one GPU"):
        launch.main(argv + ["--", "--device", "cuda"])


@pytest.mark.parametrize("argv", [["--simulate", "2", "--backend", "nccl", "stage1"],
                                  ["--simulate", "2", "stage1", "--", "--device", "cuda"],
                                  ["--nproc_per_node", "1"],
                                  ["--devices_per_host", "2", "stage1"],
                                  ["--simulate", "2", "--devices_per_host", "0", "stage1"]])
def test_launcher_refuses_what_it_cannot_run(argv):
    with pytest.raises(SystemExit) as e:
        launch.main(argv)
    assert e.value.code == 2


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    from transformers import Gemma3TextConfig, SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.gemma3.modeling_gemma3 import Gemma3ForCausalLM
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("launch_snapshots")
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
    tok.save_pretrained(vis_dir)  # stage 0 reads its tokenizer from the SigLIP snapshot
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=8, image_size=32)
    return vis_dir, llm_dir, root, manifest


def _stage_argv(snapshots, out, batch):
    vis, llm, root, manifest = snapshots
    return ["--image_root", root, "--train_json", manifest, "--val_json", manifest,
            "--output_dir", out, "--vision_model_name", vis, "--llm_name", llm,
            "--img_size", "32", "--batch_size", str(batch), "--num_epochs", "2",
            "--learning_rate", "3e-3", "--max_caption_len", "16", "--save_every_n_epochs", "1",
            "--logging_steps", "1", "--num_workers", "2", "--disable_wandb", "--seed", "0",
            "--mixed_precision", "no"]


def _launch(argv, timeout=150):
    """The launcher in a process group of its own (its ranks with it), killed whole at
    the timeout; returns (exit code, output)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen([sys.executable, "-m", "projectiontrainer_tpu_torch.cli.launch",
                             *argv], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"the launch hung:\n{out[-4000:]}")
    return proc.returncode, out


def test_simulated_two_rank_stage1_matches_one_process_at_twice_the_batch(snapshots, tmp_path):
    out = str(tmp_path / "dp")
    rc, logs = _launch(["--simulate", "2", "--timeout", "60", "--feeder_procs", "0", "stage1",
                        "--", *_stage_argv(snapshots, out, 2)])
    assert rc == 0, logs[-4000:]
    assert "backend=gloo" in logs
    for r in range(2):
        assert f"[rank {r}] launch: rank {r}/2, local rank {r}/2, backend=gloo" in logs
    results = [json.loads(line.split(" result ", 1)[1]) for line in logs.splitlines()
               if " launch: rank " in line and " result " in line]
    assert len(results) == 2
    for key in ("train/epoch_loss", "best_val_loss"):
        assert results[0][key] == results[1][key], key

    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train/batch_loss"] for r in rows if "train/batch_loss" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()  # 8 samples at 2 x 2: 2 steps
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
        "best.pt", "epoch_0.pt", "epoch_1.pt", "final.pt", "manager.json"]

    one = str(tmp_path / "one")
    train_stage1.main(_stage_argv(snapshots, one, 4) + ["--device", "cpu"])
    with open(os.path.join(one, "metrics.jsonl")) as f:
        one_losses = [r["train/batch_loss"] for r in map(json.loads, f) if "train/batch_loss" in r]
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
    ours = torch.load(os.path.join(out, "checkpoints", "final.pt"), weights_only=True)["params"]
    theirs = torch.load(os.path.join(one, "checkpoints", "final.pt"), weights_only=True)["params"]
    assert ours.keys() == theirs.keys() and ours
    for p, x in ours.items():
        err = float((x - theirs[p]).abs().max())
        assert err <= 1e-5 * float(theirs[p].abs().max()), (p, err)
    for tag in ("final", "best", "epoch_1"):
        assert os.path.exists(os.path.join(out, f"projector_{tag}.bin"))


def test_a_failing_rank_fails_the_launch(snapshots, tmp_path):
    rc, logs = _launch(["--simulate", "2", "--timeout", "60", "--feeder_procs", "0", "stage1",
                        "--", *_stage_argv(snapshots, str(tmp_path / "x"), 2),
                        "--no_such_flag"])
    assert rc == 2, logs[-4000:]
    assert "unrecognized arguments: --no_such_flag" in logs


def _other_stage_argv(snapshots, stage, out):
    vis, llm, root, manifest = snapshots
    common = ["--img_size", "32", "--num_workers", "2", "--logging_steps", "1",
              "--mixed_precision", "no"]
    if stage == "stage0":
        return common + ["--model_name", vis, "--image_root", root, "--train_json", manifest,
                         "--output_dir", out, "--batch_size", "2", "--num_epochs", "1",
                         "--max_text_len", "16", "--val_split", "0.25", "--min_save_epoch",
                         "0", "--disable_wandb"]
    if stage == "stage2":
        return common + ["--image_root", root, "--train_json", manifest, "--val_json", manifest,
                         "--output_dir", out, "--vision_model_name", vis, "--llm_name", llm,
                         "--batch_size", "2", "--gradient_accumulation_steps", "2",
                         "--num_epochs", "1", "--max_q_len", "16", "--max_a_len", "16",
                         "--eval_max_new_tokens", "8", "--disable_wandb", "--unfreeze_llm",
                         "--unfreeze_projection_layer", "--train_ve_first_epoch"]
    return common + ["--exp_id", "EXPT", "--class_names", "Pneumonia,Edema,Cardiomegaly,No Finding",
                     "--freeze_mode", "1EpochUnfreeze", "--vision_model_name", vis,
                     "--data_json", manifest, "--image_root", root, "--output_base_dir", out,
                     "--batch_size", "4", "--epochs", "2", "--lr", "1e-3", "--bb_lr", "1e-4"]


# what rank 0 writes from the rows every rank evaluated
WRITTEN = {"stage0": ("best_model/model.safetensors", "metrics.jsonl"),
           "stage2": ("validation_examples/epoch_0_examples.txt", "checkpoint-epoch_0"),
           "cls": ("EXPT/results.tsv", "EXPT/checkpoints/best.pt")}


@pytest.mark.parametrize("stage", ["stage0", "stage2", "cls"])
def test_simulated_two_rank_run_of_every_trainer(snapshots, tmp_path, stage):
    out = str(tmp_path / stage)
    rc, logs = _launch(["--simulate", "2", "--timeout", "60", "--feeder_procs", "0", stage,
                        "--", *_other_stage_argv(snapshots, stage, out)])
    assert rc == 0, logs[-4000:]
    results = [json.loads(line.split(" result ", 1)[1]) for line in logs.splitlines()
               if " launch: rank " in line and " result " in line]
    assert len(results) == 2 and np.isfinite(results[0]["train/epoch_loss"])
    for key in ("train/epoch_loss", "best_zero_shot_accuracy", "best"):
        assert results[0].get(key) == results[1].get(key), key
    for path in WRITTEN[stage]:
        assert os.path.exists(os.path.join(out, path)), path
    if stage == "cls":
        with open(os.path.join(out, "EXPT", "results.tsv")) as f:
            assert len(f.readlines()) == 3  # the header and one row an epoch, written once
    if stage == "stage2":
        with open(os.path.join(out, WRITTEN[stage][0])) as f:
            # every rank's real validation rows: the 8 samples, gathered
            assert f.read().count("QUESTION: ") == 8


def test_devices_per_host_and_a_mesh_smaller_than_the_world(snapshots, tmp_path):
    out = str(tmp_path / "prefix")
    rc, logs = _launch(["--simulate", "2", "--devices_per_host", "2", "--timeout", "60",
                        "--feeder_procs", "0", "stage1", "--",
                        *_stage_argv(snapshots, out, 2), "--mesh_data", "2"])
    assert rc == 0, logs[-4000:]
    for r in range(4):  # 2 simulated hosts of 2 ranks
        assert f"[rank {r}] launch: rank {r}/4, local rank {r % 2}/2, backend=gloo" in logs
    for r in (2, 3):
        assert f"rank {r} is idle: the mesh --mesh_data 2 x --mesh_model 1" in logs
    results = {int(line.split(" launch: rank ", 1)[1].split()[0]):
               json.loads(line.split(" result ", 1)[1]) for line in logs.splitlines()
               if " launch: rank " in line and " result " in line}
    assert sorted(results) == [0, 1]
    assert results[0]["train/epoch_loss"] == results[1]["train/epoch_loss"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [r["train/batch_loss"] for r in map(json.loads, f) if "train/batch_loss" in r]
    one = str(tmp_path / "one")
    train_stage1.main(_stage_argv(snapshots, one, 4) + ["--device", "cpu"])
    with open(os.path.join(one, "metrics.jsonl")) as f:
        one_losses = [r["train/batch_loss"] for r in map(json.loads, f) if "train/batch_loss" in r]
    assert len(losses) == 4
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
