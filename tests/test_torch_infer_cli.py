"""The port's stage-1 captioning (``infer_stage1``) and generation evaluation
(``infer_generation``) CLIs end to end on the CPU, on tiny HF snapshots written here (a
SigLIP tower and a Llama decoder with Llama-3 rope scaling and a tied table, with the
words of ``testing.word_tokenizer``) and a stage-1 projector, against the JAX
package's CLIs of the same names.

The CLIs store the towers in bf16, where the port runs its tower in bf16 and the JAX
package promotes it to fp32 (a deliberate divergence). Token identity is held with
both packages' ``setup.build_vlm`` storing them in fp32: each ``main`` then gives the
same caption, the same answers and the same summary (``--candidate_labels`` counts
included), greedy and with 3 beams, with a LoRA adapter merged."""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.cli import infer_generation as jgeneration
from projectiontrainer_tpu.cli import infer_stage1 as jstage1
from projectiontrainer_tpu.train import setup as jsetup
from projectiontrainer_tpu_torch.checkpoint import export
from projectiontrainer_tpu_torch.cli import infer_generation, infer_stage1
from projectiontrainer_tpu_torch.models import decoder as dec
from projectiontrainer_tpu_torch.models import projector as proj
from projectiontrainer_tpu_torch.train import lora, setup

torch.set_num_threads(2)
LABELS = "Pneumonia,Edema,Cardiomegaly,No Finding"


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    from transformers import LlamaConfig, SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.llama.modeling_llama import LlamaForCausalLM
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("torch_infer_cli")
    tok = T.word_tokenizer()
    torch.manual_seed(0)
    vis, llm = str(base / "siglip-tiny"), str(base / "llama-tiny")
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4, vocab_size=64,
                                     max_position_embeddings=16).to_dict(),
    )).save_pretrained(vis)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=len(tok.get_vocab()), hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=500_000.0, rms_norm_eps=1e-5, max_position_embeddings=256,
        tie_word_embeddings=True, initializer_range=0.3,
        rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 16},
    )).save_pretrained(llm)
    tok.save_pretrained(llm)
    pdir = str(base / "s1")
    pcfg = proj.ProjectorConfig(vision_dim=32, llm_dim=64, expansion_factor=2)
    export.save_projector(proj.init(torch.Generator().manual_seed(1), pcfg), pcfg, pdir)
    # a LoRA adapter with B off zero, in PEFT format (both packages read it)
    llm_cfg = dec.from_hf_config(_json(os.path.join(llm, "config.json")))
    lcfg = lora.LoraConfig(r=4, alpha=8)
    gen = torch.Generator().manual_seed(2)
    adapters = lora.init(gen, llm_cfg, lcfg)
    for layer in adapters["layers"]:
        for p in layer.values():
            p["b"] = torch.randn(p["b"].shape, generator=gen) * 0.2
    adapter = export.save_peft_adapter(adapters, lcfg, str(base / "adapter"))
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=10, image_size=32)
    return dict(vis=vis, llm=llm, projector=pdir, adapter=adapter, root=root,
                manifest=manifest)


@pytest.fixture
def fp32_towers(monkeypatch):
    """Both packages' ``build_vlm`` store the towers and the decoder in fp32."""
    monkeypatch.setattr(setup, "build_vlm",
                        functools.partial(setup.build_vlm, frozen_dtype=torch.float32))
    monkeypatch.setattr(jsetup, "build_vlm",
                        functools.partial(jsetup.build_vlm, frozen_dtype=jnp.float32))


def _stage1_argv(s, nb):
    return ["--image_path", os.path.join(s["root"], "cxr_3.jpg"), "--vision_model_name",
            s["vis"], "--llm_name", s["llm"], "--projection_path", s["projector"],
            "--img_size", "32", "--max_new_tokens", "24", "--num_beams", str(nb),
            "--repetition_penalty", "1.3"]


def test_infer_stage1_main_end_to_end(snapshots):
    text = infer_stage1.main(_stage1_argv(snapshots, 3) + ["--device", "cpu"])
    assert isinstance(text, str) and text.strip()


@pytest.mark.parametrize("nb", [1, 3])
def test_infer_stage1_caption_matches_jax(snapshots, fp32_towers, nb):
    ours = infer_stage1.main(_stage1_argv(snapshots, nb) + ["--device", "cpu"])
    theirs = jstage1.main(_stage1_argv(snapshots, nb))
    assert ours == theirs and len(ours.split()) >= 4


def test_caption_image_takes_an_image_in_memory(snapshots, fp32_towers):
    """A path and the same image already decoded give the same caption."""
    from projectiontrainer_tpu_torch.data import image as I
    from projectiontrainer_tpu_torch.generate import GenerationConfig

    cfg, params = setup.build_vlm(snapshots["vis"], snapshots["llm"],
                                  device=torch.device("cpu"),
                                  stage1_projector_path=snapshots["projector"])
    tok = setup.load_tokenizer(snapshots["llm"])
    gen = GenerationConfig(max_new_tokens=8, eos_token_id=tok.eos_token_id, pad_token_id=0)
    path = os.path.join(snapshots["root"], "cxr_1.jpg")
    kw = dict(img_size=32, gen_cfg=gen)
    assert (infer_stage1.caption_image(path, cfg, params, tok, **kw)
            == infer_stage1.caption_image(np.asarray(I.load_image(path)), cfg, params, tok, **kw))


def _generation_argv(s, out, nb, *extra):
    return ["--input_json", s["manifest"], "--image_root", s["root"], "--output_json", out,
            "--vision_model_name", s["vis"], "--llm_name", s["llm"],
            "--projector_path", s["projector"], "--img_size", "32", "--batch_size", "4",
            "--max_q_len", "16", "--max_length", "8", "--num_beams", str(nb),
            "--candidate_labels", LABELS, *extra]


def test_infer_generation_main_end_to_end(snapshots, tmp_path):
    out = str(tmp_path / "gen.json")
    acc = infer_generation.main(_generation_argv(snapshots, out, 3, "--verbose",
                                                 "--device", "cpu"))
    report = _json(out)
    assert report["accuracy"] == acc and 0.0 <= acc <= 1.0
    assert len(report["results"]) == 10  # batches of 4, 4 and 2
    assert all(isinstance(r["generated_answer"], str) for r in report["results"])


class _Recorder:
    def __init__(self):
        self.lines = []

    def info(self, msg, *args):
        self.lines.append(msg % args)


@pytest.mark.parametrize("nb,adapter", [(1, False), (3, False), (3, True)])
def test_infer_generation_matches_jax(snapshots, fp32_towers, tmp_path, nb, adapter):
    extra = ["--adapter_path", snapshots["adapter"]] if adapter else []
    ours_path, theirs_path = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    ours = infer_generation.main(_generation_argv(snapshots, ours_path, nb, *extra,
                                                  "--device", "cpu"))
    theirs = jgeneration.main(_generation_argv(snapshots, theirs_path, nb, *extra))
    report, want = _json(ours_path), _json(theirs_path)
    assert ours == theirs and report == want
    answers = [r["generated_answer"] for r in report["results"]]
    assert sum(bool(a.strip()) for a in answers) >= 5
    labels = [c for c in LABELS.split(",")]
    lines_ours, lines_theirs = _Recorder(), _Recorder()
    infer_generation.display_summary(report["results"], lines_ours, labels)
    jgeneration.display_summary(want["results"], lines_theirs, labels)
    assert lines_ours.lines == lines_theirs.lines
    assert any("prediction distribution" in line for line in lines_ours.lines)


def test_adapter_changes_the_answers(snapshots, fp32_towers, tmp_path):
    plain, merged = str(tmp_path / "plain.json"), str(tmp_path / "merged.json")
    infer_generation.main(_generation_argv(snapshots, plain, 1, "--device", "cpu"))
    infer_generation.main(_generation_argv(snapshots, merged, 1, "--device", "cpu",
                                           "--adapter_path", snapshots["adapter"]))
    assert _json(plain)["results"] != _json(merged)["results"]


@pytest.mark.parametrize("both", [["--max_new_tokens", "6"], ["--max_new_tokens=6"]])
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_max_length_conflicts_with_max_new_tokens(snapshots, tmp_path, both, pkg, capsys):
    mod = infer_generation if pkg == "port" else jgeneration
    with pytest.raises(SystemExit) as err:
        mod.main(_generation_argv(snapshots, str(tmp_path / "x.json"), 1, *both))
    assert err.value.code == 2 and "alias for --max_new_tokens" in capsys.readouterr().err


def test_prompt_and_device_defaults():
    args = infer_generation.build_parser().parse_args([
        "--vision_model_name", "v", "--llm_name", "l", "--projector_path", "p"])
    assert args.prompt == jgeneration.DIAGNOSTIC_PROMPT and args.device == "cuda"
    assert infer_stage1.build_parser().parse_args(
        ["--image_path", "i", "--vision_model_name", "v", "--llm_name", "l",
         "--projection_path", "p"]).device == "cuda"
