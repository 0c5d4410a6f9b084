"""The port's building blocks (projectiontrainer_tpu_torch.ops.layers / .attention)
against the JAX package's, on the same numpy inputs, fp32 on the CPU (tolerance 1e-5:
the same fp32 math in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from projectiontrainer_tpu.ops import attention as JA
from projectiontrainer_tpu.ops import layers as JL
from projectiontrainer_tpu_torch.ops import attention as TA
from projectiontrainer_tpu_torch.ops import layers as TL

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(ours, theirs, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), **(tol or TOL))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_linear_embedding(rng):
    x = rng.standard_normal((3, 5, 8), dtype=np.float32)
    w = rng.standard_normal((8, 6), dtype=np.float32)
    b = rng.standard_normal(6, dtype=np.float32)
    _close(TL.linear({"weight": torch.tensor(w.T), "bias": torch.tensor(b)}, torch.tensor(x)),
           JL.linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x)))
    table = rng.standard_normal((11, 4), dtype=np.float32)
    ids = rng.integers(0, 11, size=(2, 7))
    _close(TL.embedding_lookup({"embedding": torch.tensor(table)}, torch.tensor(ids)),
           JL.embedding_lookup({"embedding": jnp.asarray(table)}, jnp.asarray(ids)))


def test_linear_promotes_to_wider_params(rng):
    """fp32 projector weights over a bf16 input compute in fp32, return bf16."""
    x = torch.tensor(rng.standard_normal((4, 8), dtype=np.float32)).to(torch.bfloat16)
    p = {"weight": torch.tensor(rng.standard_normal((3, 8), dtype=np.float32)),
         "bias": torch.zeros(3)}
    y = TL.linear(p, x)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, (x.float() @ p["weight"].T).to(torch.bfloat16))


def test_layernorm(rng):
    x = rng.standard_normal((4, 6, 16), dtype=np.float32) * 3 + 1
    s, b = rng.standard_normal(16, dtype=np.float32), rng.standard_normal(16, dtype=np.float32)
    _close(TL.layernorm({"scale": torch.tensor(s), "bias": torch.tensor(b)}, torch.tensor(x)),
           JL.layernorm({"scale": jnp.asarray(s), "bias": jnp.asarray(b)}, jnp.asarray(x)))


@pytest.mark.parametrize("zero_centered", [False, True])
def test_rmsnorm(rng, zero_centered):
    x = rng.standard_normal((4, 6, 16), dtype=np.float32)
    s = rng.standard_normal(16, dtype=np.float32) * 0.1
    _close(TL.rmsnorm({"scale": torch.tensor(s)}, torch.tensor(x), zero_centered=zero_centered),
           JL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), zero_centered=zero_centered))


@pytest.mark.parametrize("name", ["gelu_tanh", "gelu", "silu"])
def test_activations(rng, name):
    x = rng.standard_normal((5, 33), dtype=np.float32) * 3
    _close(TL.ACTIVATIONS[name](torch.tensor(x)), JL.ACTIVATIONS[name](jnp.asarray(x)))


@pytest.mark.parametrize("scaling", [
    dict(),
    dict(scaling_factor=4.0),
    dict(llama3_scaling=(8.0, 1.0, 4.0, 64.0)),
])
def test_rope(rng, scaling):
    pos = rng.integers(0, 500, size=(2, 9))
    sin, cos = TL.rope_frequencies(16, torch.tensor(pos), theta=10000.0, **scaling)
    jsin, jcos = JL.rope_frequencies(16, jnp.asarray(pos), theta=10000.0, **scaling)
    _close(sin, jsin, rtol=1e-5, atol=2e-5)
    _close(cos, jcos, rtol=1e-5, atol=2e-5)
    x = rng.standard_normal((2, 9, 3, 16), dtype=np.float32)
    _close(TL.apply_rope(torch.tensor(x), sin, cos),
           JL.apply_rope(jnp.asarray(x), jsin, jcos), rtol=1e-5, atol=5e-5)


def test_conv_patchify_hwio(rng):
    """The HWIO conv kernel flattened to the space-to-depth matrix matches JAX."""
    img = rng.standard_normal((2, 16, 24, 3), dtype=np.float32)
    kern = rng.standard_normal((4, 4, 3, 10), dtype=np.float32)
    bias = rng.standard_normal(10, dtype=np.float32)
    ours = TL.conv_patchify({"weight": torch.tensor(kern.reshape(-1, 10).T),
                             "bias": torch.tensor(bias)}, torch.tensor(img), patch=4)
    theirs = JL.conv_patchify({"kernel": jnp.asarray(kern), "bias": jnp.asarray(bias)},
                              jnp.asarray(img), patch=4)
    assert ours.shape == (2, 24, 10)
    _close(ours, theirs, rtol=1e-5, atol=3e-5)


ATTN_CASES = {
    "plain": dict(),
    "causal": dict(causal=True),
    "causal_window": dict(causal=True, window=3),
    "kv_mask": dict(kv_mask=True),
    "causal_mask_window": dict(causal=True, window=4, kv_mask=True),
    "q_offset": dict(causal=True, q_offset=5, tq=3),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)])
def test_dot_product_attention(rng, case, heads):
    kw = dict(ATTN_CASES[case])
    hq, hkv = heads
    tq = kw.pop("tq", 8)
    tk = 8
    q = rng.standard_normal((2, tq, hq, 16), dtype=np.float32)
    k = rng.standard_normal((2, tk, hkv, 16), dtype=np.float32)
    v = rng.standard_normal((2, tk, hkv, 16), dtype=np.float32)
    mask = None
    if kw.pop("kv_mask", False):
        mask = np.ones((2, tk), bool)
        mask[1, :5] = False  # left padding: its first rows are fully masked under causal
    ours = TA.dot_product_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                    kv_mask=None if mask is None else torch.tensor(mask), **kw)
    theirs = JA.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      kv_mask=None if mask is None else jnp.asarray(mask), **kw)
    _close(ours, theirs)


def test_fully_masked_rows_are_zero(rng):
    q = torch.tensor(rng.standard_normal((1, 6, 2, 8), dtype=np.float32))
    k = torch.tensor(rng.standard_normal((1, 6, 1, 8), dtype=np.float32))
    mask = torch.tensor([[0, 0, 0, 1, 1, 1]], dtype=torch.bool)
    out = TA.dot_product_attention(q, k, k, causal=True, kv_mask=mask)
    assert torch.equal(out[0, :3], torch.zeros_like(out[0, :3]))
    assert out[0, 3:].abs().sum() > 0
