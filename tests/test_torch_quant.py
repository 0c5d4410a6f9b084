"""The port's weight-only quantization (``ops/quant.py``) against the JAX package's, on
the CPU.

Weights are numpy draws from a seed, handed to both packages (the port's ``[out, in]``
is the transpose of JAX's ``[in, out]``). Codes and scales must be bit-identical to
JAX's (transposed), dequantized values equal; ``quantized_matmul`` and a quantized
tiny decoder forward (Gemma3 and Qwen3 widths, fp32) within 1e-5 of the reference's
largest magnitude; the NF4 mirror within 1/254 of its block scale of exact NF4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu.ops import quant as JQ
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.models import decoder as dec
from projectiontrainer_tpu_torch.ops import quant

torch.set_num_threads(2)
METHODS = ("int8", "nf4", "nf4-mirror")
SHAPES = ((48, 32), (128, 96), (192, 64))  # [in, out]; 48 is a block of its own


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel_close(ours, theirs, tol=1e-5):
    ours, theirs = _np(ours).astype(np.float32), np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    err = np.abs(ours - theirs).max()
    assert err <= tol * np.abs(theirs).max(), f"max err {err} vs {np.abs(theirs).max()}"


def _leaves_equal(port: dict, jax_q: dict):
    """Every leaf of a port quantized linear equals the JAX one's transpose, bit for bit."""
    assert port.keys() == jax_q.keys()
    for k in port:
        theirs = np.asarray(jax_q[k])
        theirs = theirs.T if theirs.ndim == 2 else theirs
        ours = _np(port[k])
        assert ours.dtype == theirs.dtype, (k, ours.dtype, theirs.dtype)
        np.testing.assert_array_equal(ours, theirs, err_msg=k)


def _jax_quantize(w, method):
    return JQ.quantize_linear({"kernel": jnp.asarray(w)}, method=method)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("wtype", ["fp32", "bf16"])
def test_codes_and_scales_bit_identical_to_jax(method, shape, wtype):
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape, dtype=np.float32) * 0.05
    if wtype == "bf16":  # a bf16 frozen base, quantized from its bf16 values
        w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    theirs = _jax_quantize(w, method)
    ours = quant.quantize_linear({"weight": torch.tensor(w.T.copy())}, method=method)
    _leaves_equal(ours, theirs)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jw = {"int8": lambda q: JQ.dequantize(q, dtype=jdt),
              "nf4": lambda q: JQ.dequantize_nf4(q, dtype=jdt),
              "nf4-mirror": lambda q: JQ.dequantize_block_int8(q, dtype=jdt)}[method](theirs)
        got = quant.dequantize_any(ours, dtype=tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(jw, np.float32).T)


def test_nf4_midpoint_ties_bit_identical():
    """Values exactly on the codebook's midpoints (and both ends, and zero) take the
    same side in ``torch.searchsorted`` as in ``jnp.searchsorted``."""
    mid = (JQ.NF4_CODE[1:] + JQ.NF4_CODE[:-1]) / 2.0
    col = np.concatenate([mid, -mid, JQ.NF4_CODE, [0.0, 1.0, -1.0]]).astype(np.float32)
    col = np.resize(col, 64)
    col[0] = 1.0  # the block's absmax is 1: the normalised values are the column itself
    w = np.stack([col, -col, col * 0.5], axis=1)  # [64, 3]
    theirs = _jax_quantize(w, "nf4")
    ours = quant.quantize_linear({"weight": torch.tensor(w.T.copy())}, method="nf4")
    _leaves_equal(ours, theirs)


def test_mirror_within_1_over_254_of_exact_nf4():
    rng = np.random.default_rng(11)
    w = torch.tensor(rng.standard_normal((96, 128), dtype=np.float32) * 0.05)
    exact = quant.quantize_nf4(w)
    mirror = quant.nf4_int8_mirror(exact)
    assert mirror["qvalues_block"].dtype == torch.int8 and quant.is_quantized(mirror)
    d_exact = quant.dequantize_nf4(exact, dtype=torch.float32)
    d_mirror = quant.dequantize_block_int8(mirror, dtype=torch.float32)
    bound = exact["block_scales"].repeat_interleave(64, dim=1) / 254.0
    assert bool(((d_exact - d_mirror).abs() <= bound + 1e-7).all())
    assert quant.quantization_error(mirror, w) < 0.17  # NF4's bound plus the 1/254 slack


@pytest.mark.parametrize("method", METHODS)
def test_quantized_matmul_matches_jax(method):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 48), dtype=np.float32) * 0.05
    b = rng.standard_normal((48,), dtype=np.float32)
    x = rng.standard_normal((3, 5, 64), dtype=np.float32)
    jq = JQ.quantize_linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, method=method)
    tq = quant.quantize_linear({"weight": torch.tensor(w.T.copy()), "bias": torch.tensor(b)},
                               method=method)
    rel_close(quant.quantized_matmul(tq, torch.tensor(x)),
              JQ.quantized_matmul(jq, jnp.asarray(x)))


@pytest.mark.parametrize("method", METHODS)
def test_quantization_error_matches_jax(method):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((128, 64), dtype=np.float32) * 0.05
    ours = quant.quantization_error(
        quant.quantize_linear({"weight": torch.tensor(w.T.copy())}, method=method), w.T)
    assert ours == pytest.approx(JQ.quantization_error(_jax_quantize(w, method), w), rel=1e-6)


def _tiny(family):
    if family == "gemma3":
        return JDEC.gemma3_config(vocab_size=96, hidden_size=64, intermediate_size=192,
                                  num_layers=2, num_heads=2, num_kv_heads=1, head_dim=16,
                                  sliding_window=8, query_pre_attn_scalar=16)
    return JDEC.qwen3_config(vocab_size=96, hidden_size=64, intermediate_size=128,
                             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("family", ["gemma3", "qwen3"])
def test_quantized_decoder_forward_matches_jax(method, family):
    """The port quantizes its own (converted) weights and runs the decoder; JAX does the
    same with its tree. Hidden states within 1e-5; the quantized trees carry across
    bit for bit; embeddings, norms and the head stay dense."""
    jcfg = _tiny(family)
    jp = jax.tree.map(np.asarray, JDEC.init(jax.random.key(0), jcfg))
    cfg = from_jax.config_from_jax(jcfg)
    ours = quant.quantize_decoder(from_jax.decoder_params(jp), method=method)
    theirs = JQ.quantize_decoder(jax.tree.map(jnp.asarray, jp), method=method)
    for name in ("q_proj", "o_proj"):
        _leaves_equal(ours["layers"][1]["attn"][name], theirs["layers"][1]["attn"][name])
    _leaves_equal(ours["layers"][0]["mlp"]["down_proj"], theirs["layers"][0]["mlp"]["down_proj"])
    carried = from_jax.decoder_params(jax.tree.map(np.asarray, theirs))
    for key in ours["layers"][0]["mlp"]["gate_proj"]:
        assert torch.equal(carried["layers"][0]["mlp"]["gate_proj"][key],
                           ours["layers"][0]["mlp"]["gate_proj"][key])
    assert "weight" in ours["lm_head"] and "scale" in ours["layers"][0]["input_norm"]
    assert ours["embed_tokens"]["embedding"] is not None
    assert not quant.is_quantized(ours["lm_head"])

    ids = np.random.default_rng(2).integers(0, 96, size=(2, 12))
    mask = np.ones((2, 12), np.int32)
    mask[1, :3] = 0
    forward = jax.jit(lambda p, i, m: JDEC.forward(p, jcfg, input_ids=i, attention_mask=m)[0])
    jh = forward(theirs, jnp.asarray(ids), jnp.asarray(mask))
    th, _ = dec.forward(ours, cfg, input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask))
    rel_close(th, jh)
