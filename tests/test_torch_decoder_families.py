"""The Llama and Mistral decoder families in the port against the JAX package, fp32 on
the CPU: ``from_hf_config`` on transformers' ``LlamaConfig`` / ``MistralConfig`` dicts
gives JAX's ``DecoderConfig`` field for field (llama3 and linear rope scaling; Mistral
slides every layer with the one theta); an unknown rope type raises; the decoder's
logits agree within 1e-4 relative (Llama-3 rope scaling at positions past the original
maximum, Mistral's window shorter than the sequence); greedy and 3-beam ``generate``
give the same tokens; and a saved ``*ForCausalLM`` snapshot (a tied Llama, an untied
Mistral) loads into the port to HF's own logits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu.generate import GenerationConfig as JGenerationConfig
from projectiontrainer_tpu.generate import generate as jgenerate
from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu_torch.checkpoint import from_jax, hf_import
from projectiontrainer_tpu_torch.generate import GenerationConfig, generate
from projectiontrainer_tpu_torch.models import decoder as dec

torch.set_num_threads(2)

LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 16}


def _llama(rope_scaling=LLAMA3, **kw):
    from transformers import LlamaConfig

    base = dict(vocab_size=97, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, rope_theta=500_000.0,
                rms_norm_eps=1e-5, max_position_embeddings=128, rope_scaling=rope_scaling)
    return LlamaConfig(**{**base, **kw})


def _mistral(**kw):
    from transformers import MistralConfig

    base = dict(vocab_size=97, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, rope_theta=10_000.0,
                sliding_window=6, max_position_embeddings=128)
    return MistralConfig(**{**base, **kw})


HF_CONFIGS = {
    "llama3": lambda: _llama(),
    "llama3_tied": lambda: _llama(tie_word_embeddings=True),
    "llama_linear": lambda: _llama({"type": "linear", "factor": 2.0}),
    "llama_plain": lambda: _llama(None),
    "llama_head_dim": lambda: _llama(head_dim=32),
    "mistral": lambda: _mistral(),
    "mistral_no_window": lambda: _mistral(sliding_window=None),
}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "attn_impl"}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_from_hf_config_equals_jax(name):
    hf = HF_CONFIGS[name]()
    ours, theirs = dec.from_hf_config(hf.to_dict()), JDEC.from_hf_config(hf)
    assert _fields(ours) == _fields(theirs)
    assert not ours.qk_norm and not ours.embed_scale and ours.act == "silu"
    assert ours.rope_local_theta is None  # every layer rotates by rope_theta
    if name.startswith("mistral") and hf.sliding_window:
        assert set(ours.layer_types) == {"sliding"} and ours.sliding_window == 6


@pytest.mark.parametrize("rope_scaling", [{"rope_type": "yarn", "factor": 4.0},
                                          {"type": "dynamic", "factor": 2.0}])
def test_unknown_rope_type_raises(rope_scaling):
    cfg = _llama(None).to_dict()
    cfg["rope_scaling"] = rope_scaling
    with pytest.raises(ValueError, match="rope_scaling"):
        dec.from_hf_config(cfg)


def _models(name, seed=0):
    hf = HF_CONFIGS[name]()
    jcfg = JDEC.from_hf_config(hf)
    jparams = jax.tree.map(np.asarray, JDEC.init(jax.random.key(seed), jcfg))
    return jcfg, jparams, dec.from_hf_config(hf.to_dict()), from_jax.decoder_params(jparams)


@pytest.mark.parametrize("name", ["llama3", "llama3_tied", "llama_linear", "mistral"])
def test_logits_match_jax_past_the_original_maximum(name):
    """40 positions: past Llama-3's original maximum of 16 and Mistral's window of 6;
    sample 0 left-padded over 7 slots."""
    jcfg, jparams, cfg, params = _models(name)
    assert "q_norm" not in params["layers"][0]["attn"]
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, size=(2, 40))
    mask = np.ones((2, 40), np.int32)
    mask[0, :7] = 0
    jh, _ = JDEC.forward(jparams, jcfg, input_ids=jnp.asarray(ids),
                         attention_mask=jnp.asarray(mask))
    theirs = np.asarray(JDEC.logits(jparams, jcfg, jh))
    with torch.no_grad():
        h, _ = dec.forward(params, cfg, input_ids=torch.tensor(ids),
                           attention_mask=torch.tensor(mask))
        ours = dec.logits(params, cfg, h).numpy()
    valid = mask.astype(bool)
    scale = np.abs(theirs[valid]).max()
    assert np.abs(ours[valid] - theirs[valid]).max() <= 1e-4 * scale


def test_decoder_params_round_trip_without_qk_norms():
    """``decoder_params_to_jax`` inverts ``decoder_params`` for a tree without q/k norms,
    the tied head left out as the JAX tree leaves it."""
    _, jparams, _, params = _models("llama3_tied")
    back = from_jax.decoder_params_to_jax(params)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda x: x.numpy(), back))[0])
    assert len(flat_j) == len(flat_b)
    for path, x in flat_j:
        np.testing.assert_array_equal(flat_b[path], x)


@pytest.mark.parametrize("name", ["llama3", "mistral"])
@pytest.mark.parametrize("nb", [1, 3])
def test_generate_matches_jax(name, nb):
    """The prefix is 20 embedding slots (sample 0 left-padded over 5) and 24 tokens are
    generated: past Llama-3's original maximum, and Mistral's window of 6 slides over
    the prefix and the generated tokens alike."""
    jcfg, jparams, cfg, params = _models(name, seed=2)
    rng = np.random.default_rng(3)
    embeds = rng.standard_normal((2, 20, cfg.hidden_size), dtype=np.float32)
    mask = np.ones((2, 20), np.int32)
    mask[0, :5] = 0
    kw = dict(max_new_tokens=24, num_beams=nb, repetition_penalty=1.3,
              length_penalty=1.2 if nb > 1 else 1.0, pad_token_id=0)
    theirs = np.asarray(jgenerate(jparams, jcfg, jnp.asarray(embeds), jnp.asarray(mask),
                                  JGenerationConfig(**kw)))
    ours = generate(params, cfg, torch.tensor(embeds), torch.tensor(mask),
                    GenerationConfig(**kw)).numpy()
    np.testing.assert_array_equal(ours, theirs)
    assert len(set(ours[0].tolist())) > 2  # not one repeated token


@pytest.mark.parametrize("name,tied", [("llama3", True), ("mistral", False)])
def test_snapshot_loads_to_hf_logits(name, tied, tmp_path):
    """A saved ``LlamaForCausalLM`` (tied: no ``lm_head.weight`` in the file) or
    ``MistralForCausalLM`` (untied) through ``hf_import.load_decoder``: HF's logits
    within 1e-4 relative, at 40 positions."""
    from transformers import AutoModelForCausalLM

    hf_cfg = HF_CONFIGS[name]()
    hf_cfg.tie_word_embeddings = tied
    torch.manual_seed(4)
    model = AutoModelForCausalLM.from_config(hf_cfg).eval()
    model.save_pretrained(str(tmp_path))
    cfg, params = hf_import.load_decoder(str(tmp_path), dtype=torch.float32)
    assert cfg.tie_embeddings == tied
    assert (params["lm_head"]["weight"] is params["embed_tokens"]["embedding"]) == tied
    ids = torch.tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 40)))
    with torch.no_grad():
        want = model(input_ids=ids).logits.numpy()
        h, _ = dec.forward(params, cfg, input_ids=ids)
        got = dec.logits(params, cfg, h).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
