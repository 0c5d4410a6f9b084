"""``--fsdp`` through the port's CLIs on the CPU: every trainer run by the launcher as 2
gloo ranks (``launch --simulate 2``), each for an epoch or two on local HF snapshots
wide enough that the ``--fsdp`` rule shards leaves (``FSDP_MIN_SIZE`` = 65 536
elements: MLP widths of 512 over hidden sizes of 128 and 256; the nf4-mirror codes of
the QLoRA base too).

Each run must end on both ranks with the same result and finite losses, log that the
data axis holds shards, and write whole leaves (rank 0 gathers the shards): stage-2
full-joint with ``--train_ve_first_epoch`` over 2 epochs (the tower's freeze and the
optimizer swap crossed; its step losses within 1e-5 of one process at twice the batch,
fp32, and its exported decoder whole and within 1e-5 of that run's), stage 2 with
``--enable_qlora``, stage 2 with ``--remat dots``, stage 1, stage 0 and the cls probe.
The launcher is a subprocess bounded by 150 s, each collective by 60 s.
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

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = "Pneumonia,Edema,Cardiomegaly,No Finding"


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """A SigLIP dual tower (128 wide, MLP 512), a Gemma3 decoder (256 wide, MLP 512,
    4 heads over 2 KV heads of 64) and a Qwen3 one of the same widths, with a corpus of
    8 samples."""
    from transformers import (Gemma3TextConfig, Qwen3Config, SiglipConfig, SiglipTextConfig,
                              SiglipVisionConfig)
    from transformers.models.gemma3.modeling_gemma3 import Gemma3ForCausalLM
    from transformers.models.qwen3.modeling_qwen3 import Qwen3ForCausalLM
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("fsdp_snapshots")
    torch.manual_seed(0)
    vis, gemma, qwen = (str(base / n) for n in ("siglip", "gemma3", "qwen3"))
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(hidden_size=128, intermediate_size=512,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(hidden_size=128, intermediate_size=512,
                                     num_hidden_layers=2, num_attention_heads=4, vocab_size=64,
                                     max_position_embeddings=16).to_dict(),
    )).save_pretrained(vis)
    tok = T.word_tokenizer()
    wide = dict(vocab_size=len(tok.get_vocab()), hidden_size=256, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                max_position_embeddings=256)
    Gemma3ForCausalLM(Gemma3TextConfig(**wide, sliding_window=64,
                                       query_pre_attn_scalar=64)).save_pretrained(gemma)
    Qwen3ForCausalLM(Qwen3Config(**wide)).save_pretrained(qwen)
    for d in (vis, gemma, qwen):
        tok.save_pretrained(d)
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=8, image_size=32)
    return {"vis": vis, "gemma": gemma, "qwen": qwen, "root": root, "manifest": manifest}


def _argv(s, stage, out, *, batch=2):
    common = ["--img_size", "32", "--num_workers", "2", "--logging_steps", "1",
              "--mixed_precision", "no", "--seed", "0"]
    if stage == "stage0":
        return common + ["--model_name", s["vis"], "--image_root", s["root"], "--train_json",
                         s["manifest"], "--output_dir", out, "--batch_size", str(batch),
                         "--num_epochs", "1", "--max_text_len", "16", "--val_split", "0.25",
                         "--min_save_epoch", "0", "--disable_wandb"]
    if stage == "cls":
        return common + ["--exp_id", "EXPT", "--class_names", CLASSES, "--freeze_mode",
                         "1EpochUnfreeze", "--vision_model_name", s["vis"], "--data_json",
                         s["manifest"], "--image_root", s["root"], "--output_base_dir", out,
                         "--batch_size", str(batch), "--epochs", "2", "--lr", "1e-3",
                         "--bb_lr", "1e-4"]
    shared = common + ["--image_root", s["root"], "--train_json", s["manifest"], "--val_json",
                       s["manifest"], "--output_dir", out, "--vision_model_name", s["vis"],
                       "--batch_size", str(batch), "--disable_wandb"]
    if stage == "stage1":
        return shared + ["--llm_name", s["gemma"], "--num_epochs", "1", "--learning_rate",
                         "3e-3", "--max_caption_len", "16"]
    s2 = shared + ["--gradient_accumulation_steps", "2", "--max_q_len", "16", "--max_a_len",
                   "16", "--eval_max_new_tokens", "4", "--eval_num_beams", "3",
                   "--eval_example_batches", "1"]
    if stage == "stage2_qlora":
        return s2 + ["--llm_name", s["qwen"], "--num_epochs", "1", "--enable_qlora",
                     "--quant_method", "nf4-mirror", "--lora_r", "16", "--lora_alpha", "32",
                     "--learning_rate", "2e-3"]
    joint = s2 + ["--llm_name", s["gemma"], "--unfreeze_llm", "--unfreeze_projection_layer",
                  "--learning_rate", "1e-4"]
    if stage == "stage2_dots":
        return joint + ["--num_epochs", "1", "--remat", "dots"]
    return joint + ["--num_epochs", "2", "--train_ve_first_epoch"]


STAGE = {"stage0": "stage0", "cls": "cls", "stage1": "stage1", "stage2_qlora": "stage2",
         "stage2_dots": "stage2", "stage2_full_joint": "stage2"}
# a checkpoint each run writes (rank 0, every leaf gathered whole)
CHECKPOINT = {"stage0": "checkpoints/final.pt", "cls": "EXPT/checkpoints/epoch_1.pt",
              "stage1": "checkpoints/final.pt", "stage2_qlora": "checkpoints/epoch_0.pt",
              "stage2_dots": "checkpoints/epoch_0.pt",
              "stage2_full_joint": "checkpoints/epoch_1.pt"}


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


def _whole_shapes(s, stage) -> dict:
    """{path: shape} of the model each run starts from, built whole in this process."""
    from projectiontrainer_tpu_torch.checkpoint import hf_import
    from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
    from projectiontrainer_tpu_torch.train import setup

    if stage == "stage0":
        _, params = hf_import.load_siglip(s["vis"], device="cpu")
    elif stage == "cls":
        _, vision = hf_import.load_siglip_vision(s["vis"], device="cpu", head=True)
        params = {"vision": vision}
    else:
        llm = s["qwen"] if stage == "stage2_qlora" else s["gemma"]
        _, params = setup.build_vlm(s["vis"], llm, device="cpu")
    return {p: tuple(x.shape) for p, x in unique_leaves_with_paths(params)}


def _losses(path, key):
    with open(path) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


@pytest.mark.parametrize("run", list(STAGE))
def test_fsdp_trains_through_the_launcher(snapshots, tmp_path, run):
    out = str(tmp_path / run)
    rc, logs = _launch(["--simulate", "2", "--timeout", "60", "--feeder_procs", "0",
                        STAGE[run], "--", *_argv(snapshots, run, out), "--fsdp",
                        "--mesh_data", "2"])
    assert rc == 0, logs[-4000:]
    line = next(l for l in logs.splitlines() if "--fsdp: " in l)
    assert int(line.split("--fsdp: ", 1)[1].split()[0]) > 0, line  # some leaves sharded
    results = [json.loads(l.split(" result ", 1)[1]) for l in logs.splitlines()
               if " launch: rank " in l and " result " in l]
    assert len(results) == 2 and np.isfinite(results[0]["train/epoch_loss"])
    for key in ("train/epoch_loss", "best_zero_shot_accuracy", "best", "best_val_loss"):
        assert results[0].get(key) == results[1].get(key), key

    saved = torch.load(os.path.join(out, CHECKPOINT[run]), weights_only=True)["params"]
    whole = _whole_shapes(snapshots, run)
    assert saved
    for p, x in saved.items():  # whole leaves, not a rank's shard
        if p in whole:
            assert tuple(x.shape) == whole[p], p
        assert torch.isfinite(x.float()).all(), p

    if run == "stage2_full_joint":
        from safetensors.torch import load_file

        from projectiontrainer_tpu_torch.cli import train_stage2

        metrics = os.path.join(out, "metrics.jsonl")
        assert [r for r in map(json.loads, open(metrics)) if "ve_trained" in r][-1][
            "ve_trained"] == 0.0
        one = str(tmp_path / "one")
        train_stage2.main(_argv(snapshots, run, one, batch=4) + ["--device", "cpu"])
        ours = _losses(metrics, "train/step_loss")
        assert len(ours) == 4  # 2 epochs of 2 global batches of 4
        np.testing.assert_allclose(ours, _losses(os.path.join(one, "metrics.jsonl"),
                                                 "train/step_loss"), rtol=1e-5)
        llm = "checkpoint-epoch_1/language_model/model.safetensors"
        got, ref = load_file(os.path.join(out, llm)), load_file(os.path.join(one, llm))
        assert got.keys() == ref.keys()
        for k, x in ref.items():
            assert got[k].shape == x.shape, k
            err = float((got[k].float() - x.float()).abs().max())
            assert err <= 1e-5 * max(float(x.float().abs().max()), 1.0), (k, err)


def test_full_joint_launcher_passes_flags_the_cli_parses(tmp_path):
    """``launchers/run_stage2_full_joint_h100.sh`` (BASELINE config #4's recipe) hands
    the launcher flags that ``train_stage2`` parses: the full-joint policy with
    ``--train_ve_first_epoch``, ``--fsdp`` and ``--mesh_data`` = the ranks."""
    from projectiontrainer_tpu_torch.core.config import Stage2Config, from_args, parser_for

    stub = tmp_path / "projectiontrainer-torch-launch"
    stub.write_text('#!/bin/bash\nprintf "%s\\n" "$@"\n')
    stub.chmod(0o755)
    env = {**os.environ, "PATH": f"{tmp_path}:{os.environ['PATH']}", "NPROC": "4"}
    out = subprocess.run(["bash", os.path.join(REPO, "launchers",
                                               "run_stage2_full_joint_h100.sh")],
                         env=env, capture_output=True, text=True, check=True).stdout
    argv = out.splitlines()
    assert argv[:6] == ["--nproc_per_node", "4", "--backend", "nccl", "--feeder_procs",
                        "auto"] and argv[6:8] == ["stage2", "--"]
    cfg = from_args(Stage2Config, parser_for(Stage2Config, "").parse_args(argv[8:]))
    assert cfg.fsdp and cfg.mesh_data == 4 and cfg.train_ve_first_epoch
    assert cfg.unfreeze_llm and cfg.unfreeze_projection_layer and not cfg.enable_qlora
    assert (cfg.master_dtype, cfg.remat, cfg.llm_name) == ("fp32", "full",
                                                           "/models/gemma-3-4b-it")
