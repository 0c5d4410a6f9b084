"""Head dims the attention kernels do not take: the port zero-pads them on the card to
the next width a kernel takes (``ops/flash_attention.py:flash_attention_padded``,
``ops/decode_attention.py:decode_attention_padded``), as the JAX package pads inside its
flash kernel; 512 is the widest.

The pad helpers, run here through the plain versions at the padded width, against the
JAX package's ``flash_attention`` in interpret mode (forward and the three gradients)
and its ``decode_attention`` (the XLA path, which it takes at these dims), fp32, the
same numpy inputs, at D = 32, 80, 96, 100, and at 288, 320, 384 (padded to 512) and 512
itself; tolerance 1e-5 absolute and relative. Then the card's branch on meta tensors
(which stand for the card in the budget's trace): a head dim outside the kernels' set
goes through the pad (320 too), 512 goes straight to the kernels, and one above 512
raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu.ops import decode_attention as JDA
from projectiontrainer_tpu.ops import flash_attention as JFA
from projectiontrainer_tpu_torch.ops import decode_attention as DA
from projectiontrainer_tpu_torch.ops import flash_attention as FA

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = (32, 80, 96, 100, 288, 320, 384, 512)
CASES = {
    "tower": dict(hq=4, hkv=4, causal=False, window=None, pad=False),
    "decoder": dict(hq=4, hkv=2, causal=True, window=16, pad=True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", DIMS)
def test_padded_flash_matches_pallas(d, case):
    c = CASES[case]
    rng = np.random.default_rng(d)
    b, t = 2, 40
    q = rng.standard_normal((b, t, c["hq"], d), dtype=np.float32)
    k = rng.standard_normal((b, t, c["hkv"], d), dtype=np.float32)
    v = rng.standard_normal((b, t, c["hkv"], d), dtype=np.float32)
    w = rng.standard_normal((b, t, c["hq"], d), dtype=np.float32)  # the output's cotangent
    mask = None
    if c["pad"]:
        mask = np.ones((b, t), np.int32)
        mask[1, :13] = 0
    kw = dict(causal=c["causal"], window=c["window"])
    width = FA.padded_head_dim(d)
    assert width in FA.HEAD_DIMS and width >= d

    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = FA.flash_attention_padded(qt, kt, vt, kv_mask=None if mask is None
                                         else torch.tensor(mask), **kw)
    assert out.shape == (b, t, c["hq"], d) and lse.shape == (b, c["hq"], t)
    (out * torch.tensor(w)).sum().backward()

    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        return (JFA.flash_attention(q, k, v, kv_mask=jmask, interpret=True, **kw) * w).sum()

    theirs = JFA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 kv_mask=jmask, interpret=True, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(theirs), **TOL)
    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, ours, g in zip("qkv", (qt.grad, kt.grad, vt.grad), grads):
        np.testing.assert_allclose(ours.numpy(), np.asarray(g), err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("d", DIMS)
def test_padded_decode_matches_xla(d):
    rng = np.random.default_rng(10 + d)
    b, nb, hq, hkv, p, g, t = 2, 3, 4, 2, 24, 12, 7
    q = rng.standard_normal((b * nb, hq, d), dtype=np.float32)
    kp, vp = (rng.standard_normal((b, hkv, p, d), dtype=np.float32) for _ in range(2))
    kg, vg = (rng.standard_normal((b * nb, hkv, g, d), dtype=np.float32) for _ in range(2))
    pm = np.ones((b, p), np.int32)
    pm[1, :7] = 0
    kw = dict(t=t, prefix_len=p, scale=d ** -0.5, window=20)
    ours = DA.decode_attention_padded(*map(torch.tensor, (q, kp, vp, kg, vg)),
                                      prefix_mask=torch.tensor(pm), **kw)
    assert ours.shape == (b * nb, hq, d)
    theirs = JDA.decode_attention(*map(jnp.asarray, (q, kp, vp, kg, vg)),
                                  prefix_mask=jnp.asarray(pm), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_padded_widths():
    assert [FA.padded_head_dim(d) for d in (1, 64, 65, 72, 73, 128, 200, 256, 257, 320, 512)] == [
        64, 64, 72, 72, 128, 128, 256, 256, 512, 512, 512]
    assert [FA.padded_head_dim(d, DA.HEAD_DIMS) for d in (32, 72, 96, 129, 288)] == [
        64, 128, 128, 256, 512]
    for widths in (FA.HEAD_DIMS, DA.HEAD_DIMS):
        with pytest.raises(ValueError, match="513.*512"):
            FA.padded_head_dim(513, widths)


def test_card_branch_pads_on_meta_tensors():
    """Meta tensors take the kernels' branch (the budget's stand-in for the card): a
    head dim outside the kernels' set is padded there (320 to 512), 512 runs as it is,
    the merged layout too, and the shapes that come back are the caller's; nothing is
    launched; above 512 the wrapper raises with the limit in the message."""
    before = (FA.launches.value, FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value)
    for d in (32, 80, 96, 100, 320, 512):
        q = torch.empty(2, 64, 4, d, dtype=torch.bfloat16, device="meta", requires_grad=True)
        k = torch.empty(2, 64, 2, d, dtype=torch.bfloat16, device="meta", requires_grad=True)
        out, lse = FA.flash_attention(q, k, k, causal=True, window=16)
        assert out.shape == q.shape and lse.shape == (2, 4, 64)
        dq, dk = torch.autograd.grad(out.float().sum(), [q, k])
        assert dq.shape == q.shape and dk.shape == k.shape
        qm = torch.empty(2, 64, 4 * d, dtype=torch.bfloat16, device="meta")
        assert FA.flash_attention_merged(qm, qm, qm, heads=4, kv_heads=4).shape == qm.shape
    assert (FA.launches.value, FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value) == before
    big = torch.empty(1, 8, 2, 513, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="513.*512"):
        FA.flash_attention(big, big, big)
