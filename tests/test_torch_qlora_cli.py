"""The port's QLoRA training CLIs end to end on the CPU: tiny local HF snapshots (a
Qwen3 decoder and a SigLIP tower saved with ``save_pretrained``),
``testing.synthetic_corpus`` images and questions, ``train_stage2 --enable_qlora`` and
``train_stage1 --enable_qlora`` as a user runs them, fp32 (``--mixed_precision no``).

Checks that a QLoRA run trains only the adapters (and the projector it is told to)
over a frozen quantized base, writes each epoch's adapter in PEFT format with the
quant method in its metadata, that ``--resume`` quantizes the base by the saved method
(not the flag's) and repeats the uninterrupted run's losses exactly, dropout included,
that ``--resume_qlora_adapter_path`` starts from a saved adapter, that a profiled
step reports the ``dequant`` span inside the decoder's, and that stage 1 trains its
projector over a quantized frozen base.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from safetensors.torch import load_file

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu_torch.checkpoint import export
from projectiontrainer_tpu_torch.cli import train_stage1, train_stage2

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    from transformers import Qwen3Config, SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.qwen3.modeling_qwen3 import Qwen3ForCausalLM
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("torch_qlora_snapshots")
    torch.manual_seed(0)
    vis_dir, llm_dir = str(base / "siglip-tiny"), str(base / "qwen3-tiny")
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4, vocab_size=64,
                                     max_position_embeddings=16).to_dict(),
    )).save_pretrained(vis_dir)
    tok = T.word_tokenizer()
    Qwen3ForCausalLM(Qwen3Config(
        vocab_size=len(tok.get_vocab()), hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=256)).save_pretrained(llm_dir)
    tok.save_pretrained(llm_dir)
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=8, image_size=32)
    return vis_dir, llm_dir, root, manifest


def _argv(snapshots, out, *extra):
    vis, llm, root, manifest = snapshots
    return ["--image_root", root, "--train_json", manifest, "--val_json", manifest,
            "--output_dir", out, "--vision_model_name", vis, "--llm_name", llm,
            "--img_size", "32", "--batch_size", "2", "--gradient_accumulation_steps", "2",
            "--num_epochs", "2", "--learning_rate", "3e-3", "--warmup_ratio", "0.1",
            "--max_q_len", "16", "--max_a_len", "16", "--enable_qlora", "--lora_r", "4",
            "--lora_alpha", "8", "--lora_dropout", "0.1", "--unfreeze_projection_layer",
            "--mixed_precision", "no", "--eval_max_new_tokens", "4", "--eval_num_beams", "2",
            "--eval_example_batches", "1", "--logging_steps", "1", "--num_workers", "2",
            "--disable_wandb", "--device", "cpu", "--seed", "0", *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(rows):
    return [r["train/step_loss"] for r in rows if "train/step_loss" in r]


def _ckpt(out, name):
    return torch.load(os.path.join(out, "checkpoints", f"{name}.pt"), weights_only=True)


@pytest.fixture(scope="module")
def qlora_run(snapshots, tmp_path_factory):
    """2 epochs of 4 micro-steps, accumulation 2, over an int8 base (not the default
    nf4-mirror, so a resume that ignored the saved method would show)."""
    out = str(tmp_path_factory.mktemp("qlora") / "run")
    train_stage2.main(_argv(snapshots, out, "--quant_method", "int8"))
    return out


def test_cli_trains_the_adapters_and_writes_peft_adapters(qlora_run):
    out = qlora_run
    losses = _losses(_metrics(out))
    assert len(losses) == 8 and np.isfinite(losses).all()
    state = _ckpt(out, "epoch_1")
    groups = {p.split("/")[0] for p in state["params"]}
    assert groups == {"lora", "projector"}  # the base never trains: it is not saved
    assert set(state["opt_state"]["mu"]) == set(state["params"])
    assert state["metadata"] == {"epoch": 1, "quant_method": "int8"}
    for e in range(2):
        ckpt_dir = os.path.join(out, f"checkpoint-epoch_{e}")
        lm = os.path.join(ckpt_dir, "language_model")
        assert sorted(os.listdir(lm)) == ["adapter_config.json", "adapter_model.safetensors"]
        with open(os.path.join(lm, "adapter_config.json")) as f:
            cfg = json.load(f)
        assert (cfg["r"], cfg["lora_alpha"], cfg["peft_type"]) == (4, 8, "LORA")
        with open(os.path.join(ckpt_dir, "metadata.json")) as f:
            assert json.load(f)["quant_method"] == "int8"
        with open(os.path.join(out, "validation_examples", f"epoch_{e}_examples.txt")) as f:
            assert f.read().count("GENERATED: ") == 2
    sd = load_file(os.path.join(out, "checkpoint-epoch_1", "language_model",
                                "adapter_model.safetensors"))
    assert len(sd) == 2 * 7 * 2
    b = sd["base_model.model.model.layers.1.mlp.down_proj.lora_B.weight"]
    assert b.shape == (64, 4) and bool(b.abs().max() > 0)  # B moved off PEFT's zeros
    assert sd["base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight"].shape == (4, 64)
    adapters, _ = export.load_adapter(os.path.join(out, "checkpoint-epoch_1", "language_model"))
    for i, layer in enumerate(adapters["layers"]):
        for t, p in layer.items():
            for k in ("a", "b"):
                assert torch.equal(p[k], state["params"][f"lora/layers/{i}/{t}/{k}"])


def test_resume_keeps_the_quant_method_and_repeats_the_losses(snapshots, qlora_run, tmp_path):
    """--resume from epoch 0 without --quant_method int8: the saved method wins, the
    base is quantized again bit for bit, and epoch 1 (dropout on) repeats the
    uninterrupted run's losses exactly."""
    out = qlora_run
    resumed = str(tmp_path / "resumed")
    shutil.copytree(out, resumed)
    ckpts = os.path.join(resumed, "checkpoints")
    for name in os.listdir(ckpts):
        if name not in ("epoch_0.pt", "manager.json"):
            os.remove(os.path.join(ckpts, name))
    n_before = len(_metrics(resumed))
    train_stage2.main(_argv(snapshots, resumed, "--resume"))
    new = _metrics(resumed)[n_before:]
    assert new[0]["resumed_at_step"] == 4
    np.testing.assert_array_equal(_losses(new), _losses(_metrics(out))[4:])
    assert _ckpt(resumed, "epoch_1")["metadata"]["quant_method"] == "int8"
    for p, x in _ckpt(out, "epoch_1")["params"].items():
        assert torch.equal(_ckpt(resumed, "epoch_1")["params"][p], x), p


def test_resume_qlora_adapter_path_starts_from_the_adapter(snapshots, qlora_run, tmp_path):
    """--resume_qlora_adapter_path: a run at learning rate 0 writes back the very
    adapter it started from."""
    src = os.path.join(qlora_run, "checkpoint-epoch_0", "language_model")
    out = str(tmp_path / "from_adapter")
    train_stage2.main(_argv(snapshots, out, "--resume_qlora_adapter_path", src,
                            "--learning_rate", "0", "--num_epochs", "1", "--quant_method",
                            "nf4"))
    a = load_file(os.path.join(src, "adapter_model.safetensors"))
    b = load_file(os.path.join(out, "checkpoint-epoch_0", "language_model",
                               "adapter_model.safetensors"))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert _ckpt(out, "epoch_0")["metadata"]["quant_method"] == "nf4"


def test_stage1_cli_over_a_quantized_base(snapshots, tmp_path):
    vis, llm, root, manifest = snapshots
    out = str(tmp_path / "s1")
    result = train_stage1.main([
        "--image_root", root, "--train_json", manifest, "--val_json", manifest,
        "--output_dir", out, "--vision_model_name", vis, "--llm_name", llm,
        "--img_size", "32", "--batch_size", "2", "--num_epochs", "1",
        "--max_caption_len", "16", "--logging_steps", "1", "--num_workers", "2",
        "--disable_wandb", "--device", "cpu", "--enable_qlora", "--quant_method", "nf4",
        "--mixed_precision", "no"])
    assert np.isfinite(result["train/epoch_loss"])
    state = _ckpt(out, "final")
    assert {p.split("/")[0] for p in state["params"]} == {"projector"}
    assert state["metadata"]["quant_method"] == "nf4"
    assert os.path.exists(os.path.join(out, "projector_final.bin"))


def test_cli_profiles_the_dequantization_inside_the_decoder(snapshots, tmp_path):
    """--profile_dir over a QLoRA run: the ``dequant`` span inside ``decoder`` is reported
    apart (forward, and the remat recompute in the backward) and is not added to the
    total twice."""
    out = str(tmp_path / "prof")
    prof = os.path.join(out, "profile")
    train_stage2.main(_argv(snapshots, out, "--num_epochs", "1", "--profile_dir", prof,
                            "--profile_start_step", "1", "--profile_num_steps", "2"))
    split = {k[len("profile/"):]: v for r in _metrics(out) for k, v in r.items()
             if k.startswith("profile/")}
    for name in ("decoder_fwd", "decoder_bwd", "decoder/dequant_fwd", "decoder/dequant_bwd",
                 "lm_head_ce_fwd", "optimizer_fwd"):
        assert split[f"{name}_ms"] > 0, name
    assert split["decoder/dequant_fwd_ms"] < split["decoder_fwd_ms"]
    roots = sum(v for k, v in split.items() if k != "total_ms" and "/" not in k)
    assert split["total_ms"] == pytest.approx(roots)
