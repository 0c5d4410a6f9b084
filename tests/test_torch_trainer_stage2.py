"""The port's stage-2 trainer and CLI end to end on the CPU: tiny local HF snapshots
(saved with ``save_pretrained``), ``testing.synthetic_corpus`` images and questions,
``python -m projectiontrainer_tpu_torch.cli.train_stage2`` with the full-joint flags
(``--unfreeze_llm --unfreeze_projection_layer --train_ve_first_epoch``) as a user runs
it, fp32 (``--mixed_precision no``).

Checks that the tower trains in epoch 0 only, that the checkpoints hold it after the
swap (an epoch-1 ``--resume`` continues with the uninterrupted run's very losses), that
a run stopped right after a mid-accumulation ``--save_steps`` checkpoint of epoch 0
resumes across the swap with the same losses, that ``language_model/model.safetensors``
reads back through the JAX package's ``load_flat_safetensors`` as the trained LLM, that
the generated validation examples equal, token for token, what the JAX package's
``vlm.question_prefix`` + ``generate`` give on the same params and batch (greedy beams),
that a profiled step splits into the tower's backward too, and that the flags whose
machinery is not ported raise.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.checkpoint import export as jexport
from projectiontrainer_tpu.generate import GenerationConfig as JGenerationConfig
from projectiontrainer_tpu.generate import generate as jgenerate
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.cli import train_stage2
from projectiontrainer_tpu_torch.core.config import Stage2Config
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
from projectiontrainer_tpu_torch.data import datasets
from projectiontrainer_tpu_torch.train.trainer_stage2 import Stage2Trainer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    from transformers import Gemma3TextConfig, SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.gemma3.modeling_gemma3 import Gemma3ForCausalLM
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("torch_stage2_snapshots")
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
    # a window wide enough that the answers (after 15 visual tokens and a question
    # bucket of 32) see the image: with a narrower one the tower gets no gradient
    Gemma3ForCausalLM(Gemma3TextConfig(
        vocab_size=len(tok.get_vocab()), hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1, head_dim=16,
        sliding_window=64, query_pre_attn_scalar=16, max_position_embeddings=256,
    )).save_pretrained(llm_dir)
    tok.save_pretrained(llm_dir)
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=8, image_size=32)
    return vis_dir, llm_dir, root, manifest


def _argv(snapshots, out, *extra):
    vis, llm, root, manifest = snapshots
    return ["--image_root", root, "--train_json", manifest, "--val_json", manifest,
            "--output_dir", out, "--vision_model_name", vis, "--llm_name", llm,
            "--img_size", "32", "--batch_size", "2", "--gradient_accumulation_steps", "2",
            "--num_epochs", "3", "--learning_rate", "3e-3", "--warmup_ratio", "0.1",
            "--max_q_len", "16", "--max_a_len", "16", "--unfreeze_llm",
            "--unfreeze_projection_layer", "--train_ve_first_epoch", "--mixed_precision", "no",
            "--eval_max_new_tokens", "4", "--eval_num_beams", "2", "--eval_example_batches", "1",
            "--logging_steps", "1", "--num_workers", "2", "--disable_wandb", "--device", "cpu",
            "--seed", "0", *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(rows):
    return [r["train/step_loss"] for r in rows if "train/step_loss" in r]


def _ckpt(out, name):
    return torch.load(os.path.join(out, "checkpoints", f"{name}.pt"), weights_only=True)


def _vision(payload):
    return {p: x for p, x in payload["params"].items() if p.startswith("vision/")}


class _Preempted(Exception):
    pass


@pytest.fixture(scope="module")
def full_run(snapshots, tmp_path_factory):
    """3 epochs of 4 micro-steps (8 samples at batch 2), accumulation 2, a step
    checkpoint every 3 micro-steps (only the newest is kept)."""
    out = str(tmp_path_factory.mktemp("stage2") / "run")
    result = train_stage2.main(_argv(snapshots, out, "--save_steps", "3"))
    return out, result


def test_cli_trains_the_tower_in_epoch0_only_and_exports(snapshots, full_run):
    out, result = full_run
    rows = _metrics(out)
    losses = _losses(rows)
    assert len(losses) == 12 and np.isfinite(losses).all() and np.isfinite(result["train/epoch_loss"])
    assert [r["ve_trained"] for r in rows if "ve_trained" in r] == [1.0, 0.0, 0.0]
    assert sum("val/loss" in r for r in rows) == 3

    # the tower moved in epoch 0 and not after; the checkpoints after the swap hold it
    from projectiontrainer_tpu_torch.checkpoint import hf_import

    _, snapshot_tower = hf_import.load_siglip_vision(snapshots[0], dtype=torch.float32)
    snap = {f"vision/{p}": x for p, x in leaves_with_paths(snapshot_tower)}
    towers = [_vision(_ckpt(out, f"epoch_{e}")) for e in range(3)]
    assert set(towers[0]) == set(towers[1]) == set(towers[2]) == set(snap)
    assert all(not torch.equal(towers[0][p], snap[p]) for p in snap if not p.endswith("k_proj/bias"))
    for p in snap:
        assert torch.equal(towers[1][p], towers[0][p]) and torch.equal(towers[2][p], towers[0][p])
    epoch2 = _ckpt(out, "epoch_2")
    assert not any(p.startswith("vision/") for p in epoch2["opt_state"]["mu"])
    assert "llm/embed_tokens/embedding" in epoch2["params"]
    assert "llm/lm_head/weight" not in epoch2["params"]

    # the reference's checkpoint-epoch_N/ layout; the LLM reads back through the JAX
    # package's loader as the trained one, the tied table once
    for e in range(3):
        ckpt_dir = os.path.join(out, f"checkpoint-epoch_{e}")
        assert sorted(os.listdir(ckpt_dir)) == ["language_model", "metadata.json",
                                                "projection_layer"]
        with open(os.path.join(ckpt_dir, "metadata.json")) as f:
            assert json.load(f)["epoch"] == e
        with open(os.path.join(out, "validation_examples", f"epoch_{e}_examples.txt")) as f:
            assert f.read().count("GENERATED: ") == 2  # one batch of two
    jllm = jexport.load_flat_safetensors(
        os.path.join(out, "checkpoint-epoch_2", "language_model", "model.safetensors"))
    assert "lm_head" not in jllm
    ours = {f"llm/{p}": x for p, x in leaves_with_paths(from_jax.decoder_params(jllm))
            if not p.startswith("lm_head/")}
    assert set(ours) == {p for p in epoch2["params"] if p.startswith("llm/")}
    for p, x in ours.items():
        assert torch.equal(x, epoch2["params"][p]), p
    _, jproj = jexport.load_projector(os.path.join(out, "checkpoint-epoch_2", "projection_layer"))
    for p, x in leaves_with_paths(from_jax.projector_params(jproj)):
        assert torch.equal(x, epoch2["params"][f"projector/{p}"]), p


def test_resume_from_epoch1_keeps_the_epoch0_tower(snapshots, full_run, tmp_path):
    """Epoch 1's checkpoint was saved after the swap, when the tower had no optimizer
    state; the resumed epoch 2 repeats the uninterrupted run's losses exactly."""
    out, _ = full_run
    resumed = str(tmp_path / "resumed")
    shutil.copytree(out, resumed)
    ckpts = os.path.join(resumed, "checkpoints")
    for name in os.listdir(ckpts):
        if name not in ("epoch_1.pt", "manager.json"):
            os.remove(os.path.join(ckpts, name))
    n_before = len(_metrics(resumed))
    train_stage2.main(_argv(snapshots, resumed, "--resume"))
    new = _metrics(resumed)[n_before:]
    assert new[0]["resumed_at_step"] == 8
    np.testing.assert_array_equal(_losses(new), _losses(_metrics(out))[8:])
    tower = _vision(_ckpt(resumed, "epoch_2"))
    for p, x in _vision(_ckpt(out, "epoch_0")).items():
        assert torch.equal(tower[p], x), p


def test_resume_mid_accumulation_of_epoch0_crosses_the_swap(snapshots, full_run, tmp_path,
                                                             monkeypatch):
    """A run stopped right after its step-3 checkpoint (epoch 0, half an accumulation
    held) resumes with --resume: epoch 0's last batch, the swap, epochs 1-2, every loss
    the uninterrupted run's."""
    out, _ = full_run
    stopped = str(tmp_path / "stopped")
    save_step = CheckpointManager.save_step

    def save_then_stop(self, step, state, metadata=None):
        save_step(self, step, state, metadata)
        raise _Preempted(step)

    monkeypatch.setattr(CheckpointManager, "save_step", save_then_stop)
    with pytest.raises(_Preempted):
        train_stage2.main(_argv(snapshots, stopped, "--save_steps", "3"))
    monkeypatch.setattr(CheckpointManager, "save_step", save_step)
    assert sorted(os.listdir(os.path.join(stopped, "checkpoints"))) == ["step_3.pt"]
    assert _ckpt(stopped, "step_3")["opt_state"]["mini_step"] == 1
    n_before = len(_metrics(stopped))
    train_stage2.main(_argv(snapshots, stopped, "--resume"))
    new = _metrics(stopped)[n_before:]
    assert new[0]["resumed_at_step"] == 3
    np.testing.assert_array_equal(_losses(new), _losses(_metrics(out))[3:])


def test_generated_examples_match_jax_token_for_token(snapshots, tmp_path):
    """One validation batch through ``Stage2Trainer.generate_ids`` (fp32, 3 greedy
    beams) against the JAX package's ``question_prefix`` + ``generate`` on the same
    params and the same left-aligned questions; the examples decode those ids."""
    tok = T.word_tokenizer()
    jcfg = T.tiny_vlm_cfg(llm_vocab=len(tok.get_vocab()))
    jparams = jax.tree.map(np.asarray, jax.jit(JVLM.init, static_argnums=1)(
        jax.random.key(0), jcfg))
    _, _, root, manifest = snapshots
    data = datasets.Stage2VQADataset.from_json(manifest, image_root=root, tokenizer=tok,
                                               image_size=32, max_q_len=16, max_a_len=16)
    cfg = Stage2Config(output_dir=str(tmp_path), batch_size=4, num_epochs=1, device="cpu",
                       mixed_precision="no", unfreeze_llm=True, unfreeze_projection_layer=True,
                       eval_max_new_tokens=6, eval_num_beams=3, eval_do_sample=False,
                       num_workers=1, disable_wandb=True, img_size=32, max_q_len=16,
                       max_a_len=16)
    trainer = Stage2Trainer(cfg, vlm_cfg=from_jax.config_from_jax(jcfg),
                            params=from_jax.vlm_params(jparams), tokenizer=tok,
                            train_dataset=data, val_dataset=data)
    batch = next(iter(trainer._feed(data, trainer._val_plan)))
    ids = trainer.generate_ids(batch).numpy()

    from projectiontrainer_tpu_torch.train import common

    q_left = common.left_align_padding(batch["question_ids"].numpy(), trainer.pad_id)
    embeds, mask = JVLM.question_prefix(jparams, jcfg, jnp.asarray(batch["pixel_values"].numpy()),
                                        jnp.asarray(q_left), pad_token_id=trainer.pad_id)
    jids = np.asarray(jgenerate(
        jparams["llm"], jcfg.llm, embeds, mask,
        JGenerationConfig(max_new_tokens=6, num_beams=3, do_sample=False, top_p=0.9, top_k=50,
                          eos_token_id=tok.eos_token_id, pad_token_id=trainer.pad_id,
                          length_penalty=1.0),
        key=jax.random.key(0)))
    np.testing.assert_array_equal(ids, jids)
    examples = trainer._generate_examples(batch)
    assert [g for _, _, g in examples] == [trainer._decode(row) for row in jids]
    assert len(examples) == 4 and all(q.startswith("What disease") for q, _, _ in examples)


def test_cli_profiles_the_tower_backward_in_epoch0(snapshots, tmp_path):
    out = str(tmp_path / "prof")
    prof = os.path.join(out, "profile")
    train_stage2.main(_argv(snapshots, out, "--num_epochs", "1", "--profile_dir", prof,
                            "--profile_start_step", "1", "--profile_num_steps", "2"))
    assert os.listdir(prof) == ["trace_step1.json"]
    split = {k[len("profile/"):]: v for r in _metrics(out) for k, v in r.items()
             if k.startswith("profile/")}
    for name in ("tower_fwd", "tower_bwd", "projector_fwd", "projector_bwd", "decoder_fwd",
                 "decoder_bwd", "lm_head_ce_fwd", "lm_head_ce_bwd", "optimizer_fwd"):
        assert split[f"{name}_ms"] > 0, name


# --mesh_data resolves over the world of processes (core/mesh.py): one process that no
# launcher started is a world of one, and -1 with several GPUs visible needs a process
# for each; under the launcher it trains data parallel (tests/test_torch_launch.py,
# tests/test_torch_dp.py), and a model axis needs its ranks too (tests/test_torch_tp.py)
@pytest.mark.parametrize("flag,match", [
    (["--mesh_data", "2"], "projectiontrainer-torch-launch"),
    (["--mesh_data", "-1", "--device", "cuda"], "projectiontrainer-torch-launch"),
    (["--mesh_model", "-1"], "at most one mesh axis may be -1"),
    (["--mesh_model", "2"], "projectiontrainer-torch-launch"),
    (["--mesh_data", "-1", "--mesh_model", "2"], "projectiontrainer-torch-launch")])
def test_cli_mesh_data_resolves_over_the_world(snapshots, tmp_path, monkeypatch, flag, match):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=match):
        train_stage2.main(_argv(snapshots, str(tmp_path / "x"), *flag))


def test_cli_num_loader_procs_reads_on_threads(snapshots, full_run, tmp_path, caplog):
    """Stage 2 reads images on threads, as the JAX package's bucket-planned feed does:
    --num_loader_procs is said once in the log, makes no pool, and the run repeats the
    losses of the run without it."""
    from projectiontrainer_tpu_torch.data import feeder

    caplog.set_level("INFO", logger="projectiontrainer_tpu_torch")
    out = str(tmp_path / "procs")
    train_stage2.main(_argv(snapshots, out, "--save_steps", "3", "--num_loader_procs", "2"))
    said = [r.getMessage() for r in caplog.records if "--num_loader_procs" in r.getMessage()]
    assert len(said) == 1 and "threads" in said[0] and not feeder._pools
    assert _losses(_metrics(out)) == _losses(_metrics(full_run[0]))
