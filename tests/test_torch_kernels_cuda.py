"""The port's kernels against their plain versions ON THE CARD (marker ``cuda``).

These need an NVIDIA GPU, ``nvcc`` and ``triton`` and skip elsewhere; on a machine
with a card run them with ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
Inputs are bf16; the reference is the plain version evaluated in fp32 on the same
inputs; tolerance atol = rtol = 2e-2 (bf16 output rounding plus fp32 sums taken in
another order)."""

import numpy as np
import pytest
import torch

from projectiontrainer_tpu_torch.ops import decode_attention as DA
from projectiontrainer_tpu_torch.ops import flash_attention as FA
from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

pytestmark = pytest.mark.cuda
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no interpret mode)")
    return torch.device("cuda")


def _bf16(rng, shape, device):
    return torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=device).to(
        torch.bfloat16)


@pytest.mark.parametrize("d", [64, 1000, 1152])
def test_layernorm_kernel(card, d):
    rng = np.random.default_rng(0)
    x = _bf16(rng, (300, d), card)
    p = {"scale": _bf16(rng, (d,), card), "bias": _bf16(rng, (d,), card)}
    before = FLN.launches.value
    got = FLN.layernorm(p, x)
    assert FLN.launches.value == before + 1
    ref = FLN.layernorm_reference({k: v.float() for k, v in p.items()}, x.float())
    torch.testing.assert_close(got.float(), ref, **TOL)


@pytest.mark.parametrize("d,hq,hkv,causal,window,pad", [
    (64, 4, 4, False, None, False),
    (128, 4, 2, True, None, True),
    (256, 4, 1, True, 37, True),
])
def test_flash_kernel(card, d, hq, hkv, causal, window, pad):
    rng = np.random.default_rng(1)
    b, t = 2, 150
    q = _bf16(rng, (b, t, hq, d), card)
    k, v = _bf16(rng, (b, t, hkv, d), card), _bf16(rng, (b, t, hkv, d), card)
    mask = None
    if pad:
        mask = torch.ones((b, t), dtype=torch.int32, device=card)
        mask[1, :70] = 0
    kw = dict(causal=causal, window=window, kv_mask=mask)
    out, lse = FA.flash_attention(q, k, v, **kw)
    ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(out.float(), ref, **TOL)
    if pad:
        assert torch.all(out[1, :70] == 0)
        torch.testing.assert_close(lse[0], ref_lse[0], **TOL)
    else:
        torch.testing.assert_close(lse, ref_lse, **TOL)


def test_flash_kernel_rejects_unsupported(card):
    q = torch.zeros((1, 8, 2, 72), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        FA.flash_attention(q.float()[..., :64], q.float()[..., :64], q.float()[..., :64])


@pytest.mark.parametrize("t,window", [(0, None), (9, 16), (40, None)])
def test_decode_kernel(card, t, window):
    rng = np.random.default_rng(2)
    b, nb, hq, hkv, p, g, d = 3, 3, 4, 2, 77, 41, 128
    q = _bf16(rng, (b * nb, hq, d), card)
    kp, vp = _bf16(rng, (b, hkv, p, d), card), _bf16(rng, (b, hkv, p, d), card)
    kg, vg = _bf16(rng, (b * nb, hkv, g, d), card), _bf16(rng, (b * nb, hkv, g, d), card)
    pm = torch.ones((b, p), dtype=torch.int32, device=card)
    pm[2, :30] = 0
    kw = dict(prefix_mask=pm, t=t, prefix_len=p, scale=d ** -0.5, window=window)
    got = DA.decode_attention(q, kp, vp, kg, vg, **kw)
    ref = DA.decode_attention_reference(*(x.float() for x in (q, kp, vp, kg, vg)), **kw)
    torch.testing.assert_close(got.float(), ref, **TOL)
