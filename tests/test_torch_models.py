"""The port's models against the JAX package's on shared weights, fp32 on the CPU.

Weights come from ``vlm.init(jax.random.key(0), testing.tiny_vlm_cfg())`` and cross
through ``checkpoint/from_jax.py``; inputs are numpy draws from a seed. Tolerance:
1e-4 of the reference's largest magnitude (the bar the JAX package met against HF)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.generate import decode as JD
from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu.models import projector as JPROJ
from projectiontrainer_tpu.models import siglip as JSIG
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu_torch.checkpoint import from_jax, hf_import
from projectiontrainer_tpu_torch.generate import decode as D
from projectiontrainer_tpu_torch.models import decoder as dec
from projectiontrainer_tpu_torch.models import projector as proj
from projectiontrainer_tpu_torch.models import siglip, vlm

torch.set_num_threads(2)


def rel_close(ours, theirs, tol=1e-4):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape
    err = np.abs(ours - theirs).max()
    assert err <= tol * np.abs(theirs).max(), f"max err {err} vs scale {np.abs(theirs).max()}"


@pytest.fixture(scope="module")
def models():
    jcfg = T.tiny_vlm_cfg()
    jparams = jax.tree.map(np.asarray, JVLM.init(jax.random.key(0), jcfg))
    return jcfg, jparams, from_jax.config_from_jax(jcfg), from_jax.vlm_params(jparams)


def _prefix_inputs(seed=0, image=32, vocab=128):
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((2, image, image, 3), dtype=np.float32)
    q_ids = rng.integers(1, vocab, size=(2, 7))
    q_ids[1, :3] = 0  # left padding
    return pixels, q_ids


def test_config_carries_across(models):
    jcfg, _, cfg, _ = models
    assert cfg.llm.layer_types == jcfg.llm.layer_types
    assert cfg.llm.attn_scale == jcfg.llm.attn_scale
    assert vlm.num_visual_tokens(cfg) == JVLM.num_visual_tokens(jcfg)
    assert cfg.vision.head_dim == jcfg.vision.head_dim


def test_vision_tower(models):
    jcfg, jp, cfg, p = models
    pixels, _ = _prefix_inputs()
    theirs, _ = JSIG.vision_forward(jp["vision"], jcfg.vision, jnp.asarray(pixels))
    rel_close(siglip.vision_forward(p["vision"], cfg.vision, torch.tensor(pixels))[0], theirs)


def test_projector_exact_gelu(models):
    jcfg, jp, cfg, p = models
    x = np.random.default_rng(1).standard_normal((2, 5, 32), dtype=np.float32)
    rel_close(proj.forward(p["projector"], torch.tensor(x)),
              JPROJ.forward(jp["projector"], jnp.asarray(x)))


def test_decoder_forward_logits(models):
    jcfg, jp, cfg, p = models
    ids = np.random.default_rng(2).integers(0, 128, size=(2, 20))
    mask = np.ones((2, 20), np.int32)
    mask[0, :4] = 0
    jh, _ = JDEC.forward(jp["llm"], jcfg.llm, input_ids=jnp.asarray(ids),
                         attention_mask=jnp.asarray(mask))
    th, _ = dec.forward(p["llm"], cfg.llm, input_ids=torch.tensor(ids),
                        attention_mask=torch.tensor(mask))
    rel_close(dec.logits(p["llm"], cfg.llm, th), JDEC.logits(jp["llm"], jcfg.llm, jh))


def test_question_prefix(models):
    jcfg, jp, cfg, p = models
    pixels, q_ids = _prefix_inputs()
    je, jm = JVLM.question_prefix(jp, jcfg, jnp.asarray(pixels), jnp.asarray(q_ids),
                                  pad_token_id=0)
    te, tm = vlm.question_prefix(p, cfg, torch.tensor(pixels), torch.tensor(q_ids), 0)
    rel_close(te, je)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("nb", [1, 3])
def test_prefill_and_split_cache_decode_logits(models, nb):
    """Prefill through the monolithic cache, split it, then two decode steps over the
    split cache (prefix shared by nb rows each): logits equal the JAX package's."""
    jcfg, jp, cfg, p = models
    pixels, q_ids = _prefix_inputs(seed=3)
    je, jm = JVLM.question_prefix(jp, jcfg, jnp.asarray(pixels), jnp.asarray(q_ids),
                                  pad_token_id=0)
    te, tm = vlm.question_prefix(p, cfg, torch.tensor(pixels), torch.tensor(q_ids), 0)
    b, plen = te.shape[:2]
    jcache, jlog, jlast, _ = JD._prefill(jp["llm"], jcfg.llm, je, jm, plen)
    tcache, tlog, tlast, _ = D._prefill(p["llm"], cfg.llm, te, tm, plen)
    rel_close(tlog, jlog)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))

    jcache, jpm = JDEC.split_cache(jcache, jcfg.llm, b * nb, 4, prefix_mask=jm)
    tcache, tpm = dec.split_cache(tcache, cfg.llm, b * nb, 4, prefix_mask=tm)
    rel_close(tcache[0]["kp"], jcache[0]["kp"])
    tokens = np.random.default_rng(4).integers(0, 128, size=(2, b * nb))
    jlast, tlast = jnp.repeat(jlast, nb), tlast.repeat_interleave(nb)
    for t in range(2):
        jemb = JDEC.embed(jp["llm"], jcfg.llm, jnp.asarray(tokens[t])[:, None])
        jh, jcache = JDEC.forward(jp["llm"], jcfg.llm, inputs_embeds=jemb, attention_mask=jpm,
                                  positions=(jlast + 1 + t)[:, None], cache=jcache,
                                  q_offset=t, prefix_len=plen)
        tl, tcache = D._step(p["llm"], cfg.llm, torch.tensor(tokens[t]), tlast, t, tpm,
                             tcache, plen, te.dtype)
        rel_close(tl, JDEC.logits(jp["llm"], jcfg.llm, jh)[:, 0])


def test_tied_head_is_the_embedding_table(models):
    _, _, _, p = models
    assert p["llm"]["lm_head"]["weight"] is p["llm"]["embed_tokens"]["embedding"]


def test_plain_impl_matches_kernel_wrappers_on_cpu(models):
    """attn_impl/norm_impl='plain' (the end-to-end reference on the card) and the
    kernel wrappers (plain versions on the CPU) give the same prefix."""
    _, _, cfg, p = models
    plain = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, attn_impl="plain", norm_impl="plain"),
        llm=dataclasses.replace(cfg.llm, attn_impl="plain"))
    pixels, q_ids = _prefix_inputs(seed=5)
    a, _ = vlm.question_prefix(p, cfg, torch.tensor(pixels), torch.tensor(q_ids), 0)
    b, _ = vlm.question_prefix(p, plain, torch.tensor(pixels), torch.tensor(q_ids), 0)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_hf_snapshot_import(tmp_path):
    """config.json + safetensors snapshots load into the port and agree with the JAX
    package's HF import of the same snapshot."""
    from transformers import (
        Gemma3TextConfig, SiglipConfig, SiglipTextConfig, SiglipVisionConfig,
    )
    from transformers.models.gemma3.modeling_gemma3 import Gemma3ForCausalLM
    from transformers.models.siglip.modeling_siglip import SiglipModel

    from projectiontrainer_tpu.checkpoint import hf_import as JHF

    torch.manual_seed(0)
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, vocab_size=64, max_position_embeddings=16).to_dict(),
    )).save_pretrained(tmp_path / "vis")
    Gemma3ForCausalLM(Gemma3TextConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, head_dim=16, sliding_window=8,
        query_pre_attn_scalar=16, max_position_embeddings=256)).save_pretrained(tmp_path / "llm")

    vcfg, vparams = hf_import.load_siglip_vision(str(tmp_path / "vis"))
    jvcfg, jvparams = JHF.load_siglip(str(tmp_path / "vis"), attn_impl="xla", norm_impl="xla")
    pixels, q_ids = _prefix_inputs(seed=6, vocab=64)
    theirs, _ = JSIG.vision_forward(jvparams["vision"], jvcfg.vision, jnp.asarray(pixels))
    rel_close(siglip.vision_forward(vparams, vcfg, torch.tensor(pixels))[0], theirs)

    lcfg, lparams = hf_import.load_decoder(str(tmp_path / "llm"))
    jlcfg, jlparams = JHF.load_decoder(str(tmp_path / "llm"), attn_impl="xla")
    assert lcfg.layer_types == jlcfg.layer_types
    jh, _ = JDEC.forward(jlparams, jlcfg, input_ids=jnp.asarray(q_ids))
    th, _ = dec.forward(lparams, lcfg, input_ids=torch.tensor(q_ids))
    rel_close(dec.logits(lparams, lcfg, th), JDEC.logits(jlparams, jlcfg, jh))


# ------------------------------------------------------------------ Qwen3


def _jax_qwen3_vlm():
    llm = JDEC.qwen3_config(vocab_size=128, hidden_size=64, intermediate_size=128,
                            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
    vis = T.tiny_vision_cfg()
    return JVLM.VLMConfig(vision=vis, llm=llm, projector=JPROJ.ProjectorConfig(
        vision_dim=vis.hidden_size, llm_dim=64, expansion_factor=2))


def test_qwen3_config_matches_jax():
    ours, theirs = dec.qwen3_config(), JDEC.qwen3_config()
    for f in dataclasses.fields(dec.DecoderConfig):
        if f.name != "attn_impl":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.attn_scale == theirs.attn_scale and not ours.tie_embeddings


@pytest.mark.parametrize("nb", [1, 3])
def test_qwen3_prefill_and_split_cache_decode_logits(nb):
    """The serving path over a Qwen3 decoder (GQA 4/2, untied head): the prefill's
    logits and two split-cache decode steps equal the JAX package's."""
    jcfg = _jax_qwen3_vlm()
    jp = jax.tree.map(np.asarray, JVLM.init(jax.random.key(1), jcfg))
    cfg, p = from_jax.config_from_jax(jcfg), from_jax.vlm_params(jp)
    assert "lm_head" in jp["llm"] and p["llm"]["lm_head"]["weight"] is not (
        p["llm"]["embed_tokens"]["embedding"])
    pixels, q_ids = _prefix_inputs(seed=7)
    je, jm = JVLM.question_prefix(jp, jcfg, jnp.asarray(pixels), jnp.asarray(q_ids),
                                  pad_token_id=0)
    te, tm = vlm.question_prefix(p, cfg, torch.tensor(pixels), torch.tensor(q_ids), 0)
    b, plen = te.shape[:2]
    jcache, jlog, jlast, _ = JD._prefill(jp["llm"], jcfg.llm, je, jm, plen)
    tcache, tlog, tlast, _ = D._prefill(p["llm"], cfg.llm, te, tm, plen)
    rel_close(tlog, jlog)
    jcache, jpm = JDEC.split_cache(jcache, jcfg.llm, b * nb, 3, prefix_mask=jm)
    tcache, tpm = dec.split_cache(tcache, cfg.llm, b * nb, 3, prefix_mask=tm)
    tokens = np.random.default_rng(8).integers(0, 128, size=(2, b * nb))
    jlast, tlast = jnp.repeat(jlast, nb), tlast.repeat_interleave(nb)
    for t in range(2):
        jemb = JDEC.embed(jp["llm"], jcfg.llm, jnp.asarray(tokens[t])[:, None])
        jh, jcache = JDEC.forward(jp["llm"], jcfg.llm, inputs_embeds=jemb, attention_mask=jpm,
                                  positions=(jlast + 1 + t)[:, None], cache=jcache,
                                  q_offset=t, prefix_len=plen)
        tl, tcache = D._step(p["llm"], cfg.llm, torch.tensor(tokens[t]), tlast, t, tpm,
                             tcache, plen, te.dtype)
        rel_close(tl, JDEC.logits(jp["llm"], jcfg.llm, jh)[:, 0])


def test_qwen3_snapshot_against_jax_and_hf(tmp_path):
    """A tiny HF ``Qwen3ForCausalLM`` snapshot (the pattern of
    tests/test_decoder_parity.py): the port's import gives HF's hidden states and
    logits, and the JAX package's, within 1e-4."""
    from transformers import Qwen3Config
    from transformers.models.qwen3.modeling_qwen3 import Qwen3ForCausalLM

    from projectiontrainer_tpu.checkpoint import hf_import as JHF

    torch.manual_seed(1)
    hf = Qwen3ForCausalLM(Qwen3Config(
        vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rope_theta=1_000_000.0,
        max_position_embeddings=128, attn_implementation="eager")).eval()
    hf.save_pretrained(tmp_path / "qwen3")
    cfg, params = hf_import.load_decoder(str(tmp_path / "qwen3"))
    jcfg, jparams = JHF.load_decoder(str(tmp_path / "qwen3"), attn_impl="xla")
    for f in dataclasses.fields(dec.DecoderConfig):
        if f.name != "attn_impl":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    ids = np.random.default_rng(9).integers(0, 96, size=(2, 11))
    with torch.no_grad():
        out = hf(input_ids=torch.tensor(ids), output_hidden_states=True)
        th, _ = dec.forward(params, cfg, input_ids=torch.tensor(ids))
        ours = dec.logits(params, cfg, th)
    rel_close(th, out.hidden_states[-1].numpy())
    rel_close(ours, out.logits.numpy())
    jh, _ = JDEC.forward(jparams, jcfg, input_ids=jnp.asarray(ids))
    rel_close(ours, JDEC.logits(jparams, jcfg, jh))
