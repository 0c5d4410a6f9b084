"""The port's LoRA adapters (``train/lora.py``) against the JAX package's, on the CPU.

Adapters and inputs are numpy draws from a seed handed to both packages (the port's
``a`` [r, in] / ``b`` [out, r] are the transposes of JAX's), with B drawn nonzero: at
PEFT's init B = 0 and the delta vanishes. ``apply_delta`` and ``merge_into_decoder``
(over a dense and each quantized base) within 1e-5 of the reference's largest
magnitude. The dropout masks come from torch's generator, not JAX's, so they are held
to JAX's threshold formula instead: the keep rate and the inverted-dropout scale
``alpha / r * 65536 / thresh``. A layer recomputed under remat draws the forward's
mask: gradients equal those of the same layer without remat.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu.ops import quant as JQ
from projectiontrainer_tpu.train import lora as JL
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.models import decoder as dec
from projectiontrainer_tpu_torch.ops import quant
from projectiontrainer_tpu_torch.train import lora

torch.set_num_threads(2)


def rel_close(ours, theirs, tol=1e-5):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    err = np.abs(ours - theirs).max()
    assert err <= tol * np.abs(theirs).max(), f"max err {err} vs {np.abs(theirs).max()}"


def _qwen3(layers=2):
    return JDEC.qwen3_config(vocab_size=96, hidden_size=64, intermediate_size=128,
                             num_layers=layers, num_heads=4, num_kv_heads=2, head_dim=16)


def _jax_lora(jcfg, lcfg, seed=0, b_std=0.05):
    """JAX adapters (numpy) with B drawn from N(0, b_std) instead of PEFT's zeros."""
    tree = jax.tree.map(np.asarray, JL.init(jax.random.key(seed), jcfg, lcfg))
    rng = np.random.default_rng(seed + 100)
    for layer in tree["layers"]:
        for p in layer.values():
            p["b"] = rng.standard_normal(p["b"].shape, dtype=np.float32) * b_std
    return tree


def test_config_checks_dropout_and_scaling():
    assert lora.LoraConfig(r=16, alpha=32).scaling == JL.LoraConfig(r=16, alpha=32).scaling == 2.0
    assert lora.TARGETS == JL.TARGETS
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout"):
            lora.LoraConfig(dropout=bad)


def test_init_is_peft_semantics():
    cfg = from_jax.config_from_jax(_qwen3())
    lcfg = lora.LoraConfig(r=8, alpha=16)
    tree = lora.init(torch.Generator().manual_seed(0), cfg, lcfg)
    assert len(tree["layers"]) == 2 and set(tree["layers"][0]) == set(lora.TARGETS)
    dims = lora.target_dims(cfg)
    a_all = []
    for t, p in tree["layers"][1].items():
        assert p["a"].shape == (8, dims[t][0]) and p["b"].shape == (dims[t][1], 8)
        assert not bool(p["b"].any())
        a_all.append(p["a"].flatten())
    assert float(torch.cat(a_all).std()) == pytest.approx(1 / 8, rel=0.1)


@pytest.mark.parametrize("target", ["q_proj", "o_proj", "down_proj"])
def test_apply_delta_matches_jax(target):
    jcfg = _qwen3(layers=1)
    lcfg = lora.LoraConfig(r=4, alpha=8, dropout=0.0)
    jl = _jax_lora(jcfg, JL.LoraConfig(r=4, alpha=8, dropout=0.0))
    ours = from_jax.lora_params(jl)
    din, dout = lora.target_dims(from_jax.config_from_jax(jcfg))[target]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, din), dtype=np.float32)
    y = rng.standard_normal((2, 5, dout), dtype=np.float32)
    theirs = JL.apply_delta(jax.tree.map(jnp.asarray, jl["layers"][0]), target,
                            JL.LoraConfig(r=4, alpha=8, dropout=0.0), jnp.asarray(x),
                            jnp.asarray(y))
    got = lora.apply_delta(ours["layers"][0], target, lcfg, torch.tensor(x), torch.tensor(y))
    rel_close(got, theirs)
    # an unadapted target and a layer without adapters pass y through
    assert lora.apply_delta({}, target, lcfg, torch.tensor(x), torch.tensor(y)) is not None
    assert torch.equal(lora.apply_delta(None, target, lcfg, torch.tensor(x), torch.tensor(y)),
                       torch.tensor(y))


@pytest.mark.parametrize("p", [0.05, 0.5])
def test_dropout_keep_rate_and_scale_follow_the_threshold(p):
    thresh = lora.dropout_threshold(p)
    assert thresh == min(int(round((1 - p) * 65536)), 65535)
    mask = lora.dropout_mask((64, 4096), seed=7, p=p, device="cpu")
    n = mask.numel()
    keep = thresh / 65536.0
    assert abs(float(mask.float().mean()) - keep) < 5 * (keep * (1 - keep) / n) ** 0.5
    assert torch.equal(mask, lora.dropout_mask((64, 4096), seed=7, p=p, device="cpu"))
    # the branch: scaling * 65536 / thresh * (x * mask) A^T B^T
    lcfg = lora.LoraConfig(r=2, alpha=6, dropout=p)
    rng = np.random.default_rng(2)
    layer = {"q_proj": {"a": torch.tensor(rng.standard_normal((2, 8), dtype=np.float32)),
                        "b": torch.tensor(rng.standard_normal((3, 2), dtype=np.float32))}}
    x = torch.tensor(rng.standard_normal((4, 8), dtype=np.float32))
    got = lora.apply_delta(layer, "q_proj", lcfg, x, torch.zeros(4, 3), seed=11)
    m = lora.dropout_mask(x.shape, 11, p, "cpu")
    want = 3.0 * 65536.0 / thresh * ((x * m) @ layer["q_proj"]["a"].T @ layer["q_proj"]["b"].T)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_dropout_seeds_differ_by_layer_and_target():
    seeds = {lora.dropout_seed(5, i, t) for i in range(36) for t in lora.TARGETS}
    assert len(seeds) == 36 * 7
    assert lora.dropout_seed(5, 0, "q_proj") != lora.dropout_seed(6, 0, "q_proj")
    assert lora.dropout_seed(5, 3, "up_proj") == lora.dropout_seed(5, 3, "up_proj")


@pytest.mark.parametrize("base", ["dense", "nf4-mirror"])
def test_remat_with_dropout_gives_the_gradients_without_remat(base):
    """One layer at dropout 0.5: torch.utils.checkpoint recomputes it in the backward;
    each mask is seeded by (step, layer, target), so the recompute draws the forward's
    bits and every LoRA gradient equals the un-remated layer's."""
    jcfg = _qwen3(layers=1)
    cfg = from_jax.config_from_jax(jcfg)
    params = from_jax.decoder_params(jax.tree.map(np.asarray, JDEC.init(jax.random.key(0), jcfg)))
    if base != "dense":
        params = quant.quantize_decoder(params, method=base)
    lcfg = lora.LoraConfig(r=4, alpha=8, dropout=0.5)
    adapters = from_jax.lora_params(_jax_lora(jcfg, JL.LoraConfig(r=4, alpha=8)))
    leaves = [x for layer in adapters["layers"] for p in layer.values() for x in p.values()]
    x = torch.tensor(np.random.default_rng(3).standard_normal((2, 9, 64), dtype=np.float32))

    def grads(remat, seed=17):
        for t in leaves:
            t.requires_grad_(True)
        h, _ = dec.forward(params, cfg, inputs_embeds=x, remat=remat, lora=adapters,
                           lora_cfg=lcfg, lora_seed=seed)
        return torch.autograd.grad(h.square().sum(), leaves)

    plain, remat = grads(False), grads(True)
    for a, b in zip(remat, plain):
        assert torch.equal(a, b)
    other = grads(False, seed=18)  # another step's masks: another gradient
    assert any(not torch.equal(a, b) for a, b in zip(other, plain))


@pytest.mark.parametrize("base", ["dense", "int8", "nf4", "nf4-mirror"])
def test_merge_into_decoder_matches_jax(base):
    jcfg = _qwen3()
    jp = jax.tree.map(np.asarray, JDEC.init(jax.random.key(0), jcfg))
    jlcfg = JL.LoraConfig(r=4, alpha=8)
    jl = _jax_lora(jcfg, jlcfg, seed=1)
    jbase = (jax.tree.map(jnp.asarray, jp) if base == "dense"
             else JQ.quantize_decoder(jax.tree.map(jnp.asarray, jp), method=base))
    theirs = JL.merge_into_decoder(jbase, jax.tree.map(jnp.asarray, jl), jlcfg)
    ours_base = from_jax.decoder_params(jax.tree.map(np.asarray, jbase))
    ours = lora.merge_into_decoder(ours_base, from_jax.lora_params(jl),
                                   lora.LoraConfig(r=4, alpha=8))
    for i in range(2):
        for blk, names in (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                           ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for n in names:
                w = ours["layers"][i][blk][n]["weight"]
                assert w.dtype == (torch.float32 if base == "dense" else torch.bfloat16)
                rel_close(w.T, theirs["layers"][i][blk][n]["kernel"])
    # the input tree is untouched, and what no adapter touches is shared
    assert quant.is_quantized(ours_base["layers"][0]["attn"]["q_proj"]) == (base != "dense")
    assert ours["embed_tokens"] is ours_base["embed_tokens"]
    ids = np.random.default_rng(4).integers(0, 96, size=(2, 10))
    jh, _ = JDEC.forward(theirs, jcfg, input_ids=jnp.asarray(ids))
    th, _ = dec.forward(ours, from_jax.config_from_jax(jcfg), input_ids=torch.tensor(ids))
    rel_close(th, jh)


@pytest.mark.parametrize("base", ["dense", "nf4-mirror"])
def test_decoder_forward_with_adapters_matches_jax(base):
    """The unmerged path: every projection adds its delta inside the decoder (no
    dropout), hidden states within 1e-5 of JAX's; merged and unmerged agree over a
    dense base."""
    jcfg = _qwen3()
    cfg = from_jax.config_from_jax(jcfg)
    jp = jax.tree.map(np.asarray, JDEC.init(jax.random.key(0), jcfg))
    jbase = (jax.tree.map(jnp.asarray, jp) if base == "dense"
             else JQ.quantize_decoder(jax.tree.map(jnp.asarray, jp), method=base))
    jlcfg = JL.LoraConfig(r=4, alpha=8, dropout=0.0)
    jl = _jax_lora(jcfg, jlcfg, seed=2)
    ids = np.random.default_rng(5).integers(0, 96, size=(2, 10))
    jh, _ = JDEC.forward(jbase, jcfg, input_ids=jnp.asarray(ids),
                         lora=jax.tree.map(jnp.asarray, jl), lora_cfg=jlcfg)
    base_t = from_jax.decoder_params(jax.tree.map(np.asarray, jbase))
    adapters, lcfg = from_jax.lora_params(jl), lora.LoraConfig(r=4, alpha=8, dropout=0.0)
    th, _ = dec.forward(base_t, cfg, input_ids=torch.tensor(ids), lora=adapters, lora_cfg=lcfg)
    rel_close(th, jh)
    if base == "dense":
        mh, _ = dec.forward(lora.merge_into_decoder(base_t, adapters, lcfg), cfg,
                            input_ids=torch.tensor(ids))
        rel_close(mh, jh)


def test_lora_tree_carries_across_both_ways():
    jl = _jax_lora(_qwen3(), JL.LoraConfig(r=4, alpha=8), seed=3)
    ours = from_jax.lora_params(jl)
    assert ours["layers"][0]["down_proj"]["a"].shape == (4, 128)
    back = from_jax.lora_params_to_jax(ours)
    for i, layer in enumerate(jl["layers"]):
        for t, p in layer.items():
            for k in ("a", "b"):
                np.testing.assert_array_equal(back["layers"][i][t][k].numpy(), p[k])
