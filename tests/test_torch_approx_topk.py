"""``approx_top_k`` (``infer_vqa_stage2 --approx_topk``) in the port, against the JAX
package, fp32 on the CPU.

The JAX package reads the flag only in the sampled beam search's per-beam candidate
scan, where it takes ``jax.lax.approx_max_k``; off the TPU XLA computes that as an
exact top-k (pinned here at this file's shapes), and the port takes its exact top-k
there with the flag set or not. So greedy and deterministic beam decoding with the flag
give the JAX package's tokens, sampled beam search with the flag gives the tokens it
gives without it under the same ``torch.Generator``, and the CLI runs with the flag:
greedy and 3-beam answers equal the JAX CLI's (both packages' ``build_vlm`` storing the
towers in fp32, as ``test_torch_infer_cli.py`` holds them), and 3-beam sampling answers
every sample as it does without the flag."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.cli import infer_vqa_stage2 as jvqa
from projectiontrainer_tpu.generate import GenerationConfig as JGenerationConfig
from projectiontrainer_tpu.generate import decode as JD
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu.train import setup as jsetup
from projectiontrainer_tpu_torch.checkpoint import export, from_jax
from projectiontrainer_tpu_torch.cli import infer_vqa_stage2 as vqa
from projectiontrainer_tpu_torch.generate import GenerationConfig, generate
from projectiontrainer_tpu_torch.models import projector as proj
from projectiontrainer_tpu_torch.train import setup

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def prefix():
    jcfg = T.tiny_vlm_cfg()
    jparams = jax.tree.map(np.asarray, JVLM.init(jax.random.key(1), jcfg))
    rng = np.random.default_rng(2)
    pixels = rng.standard_normal((2, 32, 32, 3), dtype=np.float32)
    q_ids = rng.integers(1, 128, size=(2, 9))
    q_ids[1, :3] = 0  # left padding
    embeds, mask = JVLM.question_prefix(jparams, jcfg, jnp.asarray(pixels),
                                        jnp.asarray(q_ids), pad_token_id=0)
    return dict(jcfg=jcfg, jp=jparams, cfg=from_jax.config_from_jax(jcfg),
                p=from_jax.vlm_params(jparams), embeds=np.asarray(embeds),
                mask=np.asarray(mask))


def _port(s, generator=None, **kw):
    return generate(s["p"]["llm"], s["cfg"].llm, torch.tensor(s["embeds"]),
                    torch.tensor(s["mask"]), GenerationConfig(**kw), generator).numpy()


@pytest.mark.parametrize("num_beams", [1, 3])
def test_deterministic_decoding_with_the_flag_matches_jax(prefix, num_beams):
    kw = dict(max_new_tokens=12, num_beams=num_beams, repetition_penalty=1.8,
              length_penalty=1.2, top_k=5, pad_token_id=0, approx_top_k=True)
    theirs = np.asarray(JD.generate(prefix["jp"]["llm"], prefix["jcfg"].llm,
                                    jnp.asarray(prefix["embeds"]), jnp.asarray(prefix["mask"]),
                                    JGenerationConfig(**kw)))
    ours = _port(prefix, **kw)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, _port(prefix, **{**kw, "approx_top_k": False}))


@pytest.mark.parametrize("top_k", [5, 200])  # inside the vocab of 128, and clamped to it
def test_sampled_beam_search_is_the_exact_one(prefix, top_k):
    kw = dict(max_new_tokens=10, num_beams=3, do_sample=True, temperature=0.7,
              top_k=top_k, top_p=0.9, repetition_penalty=1.3, eos_token_id=7, pad_token_id=0)
    runs = [_port(prefix, torch.Generator().manual_seed(seed), approx_top_k=flag, **kw)
            for seed in (0, 1) for flag in (True, False)]
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[2], runs[3])
    assert runs[0].shape == (2, 10)


@pytest.mark.parametrize("shape,k,ties", [((6, 128), 5, False), ((6, 128), 50, False),
                                          ((6, 1000), 50, True), ((6, 262_144), 50, False)])
def test_approx_max_k_is_exact_off_the_tpu(shape, k, ties):
    """The semantics the port relies on: on the CPU, ``approx_max_k`` (the JAX package's
    candidate scan under the flag) equals ``top_k``, values and indices, ties included."""
    rng = np.random.default_rng(k + shape[1])
    x = rng.standard_normal(shape, dtype=np.float32)
    if ties:
        x = np.round(x * 2) / 2  # many equal values
    vals, idx = jax.lax.approx_max_k(jnp.asarray(x), k)
    tvals, tidx = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(np.asarray(vals), np.asarray(tvals))
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(tidx))


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    from transformers import (Gemma3TextConfig, SiglipConfig, SiglipTextConfig,
                              SiglipVisionConfig)
    from transformers.models.gemma3.modeling_gemma3 import Gemma3ForCausalLM
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("torch_approx_topk")
    tok = T.word_tokenizer()
    torch.manual_seed(0)
    vis, llm = str(base / "siglip-tiny"), str(base / "gemma3-tiny")
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4, vocab_size=64,
                                     max_position_embeddings=16).to_dict(),
    )).save_pretrained(vis)
    Gemma3ForCausalLM(Gemma3TextConfig(
        vocab_size=len(tok.get_vocab()), hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1, head_dim=16,
        sliding_window=64, query_pre_attn_scalar=16, max_position_embeddings=256,
        initializer_range=0.3)).save_pretrained(llm)
    tok.save_pretrained(llm)
    pdir = str(base / "projector")
    pcfg = proj.ProjectorConfig(vision_dim=32, llm_dim=32, expansion_factor=2)
    export.save_projector(proj.init(torch.Generator().manual_seed(1), pcfg), pcfg, pdir)
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=6, image_size=32)
    return dict(vis=vis, llm=llm, projector=pdir, root=root, manifest=manifest)


@pytest.fixture
def fp32_towers(monkeypatch):
    """Both packages' ``build_vlm`` store the towers and the decoder in fp32."""
    monkeypatch.setattr(setup, "build_vlm",
                        functools.partial(setup.build_vlm, frozen_dtype=torch.float32))
    monkeypatch.setattr(jsetup, "build_vlm",
                        functools.partial(jsetup.build_vlm, frozen_dtype=jnp.float32))


def _argv(s, out, nb, *extra):
    return ["--input_json", s["manifest"], "--image_root", s["root"], "--output_json", out,
            "--vision_model_name", s["vis"], "--llm_name", s["llm"],
            "--projector_path", s["projector"], "--img_size", "32", "--batch_size", "4",
            "--max_q_len", "16", "--max_new_tokens", "10", "--num_beams", str(nb), *extra]


@pytest.mark.parametrize("nb", [1, 3])
def test_cli_with_the_flag_matches_jax(snapshots, fp32_towers, tmp_path, nb):
    ours = vqa.main(_argv(snapshots, str(tmp_path / "ours.json"), nb, "--approx_topk",
                          "--device", "cpu"))
    theirs = jvqa.main(_argv(snapshots, str(tmp_path / "theirs.json"), nb, "--approx_topk"))
    answers = [r["generated_answer"] for r in ours]
    assert len(answers) == 6 and answers == [r["generated_answer"] for r in theirs]
    assert sum(bool(a.strip()) for a in answers) >= 4
    assert os.path.exists(tmp_path / "ours.json")


def test_cli_sampled_beams_with_the_flag(snapshots, tmp_path):
    """Sampled 3-beam answers (the scan the flag names), the flag on and off: every
    sample answered, the same answers (one seed, one exact scan)."""
    runs = [vqa.main(_argv(snapshots, str(tmp_path / f"{i}.json"), 3, "--do_sample",
                           "--device", "cpu", *flag))
            for i, flag in enumerate((["--approx_topk"], []))]
    assert len(runs[0]) == 6
    assert [r["generated_answer"] for r in runs[0]] == [r["generated_answer"] for r in runs[1]]
