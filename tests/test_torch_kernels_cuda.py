"""The port's kernels against their plain versions ON THE CARD (marker ``cuda``).

These need an NVIDIA GPU, ``nvcc`` and ``triton`` and skip elsewhere; on a machine
with a card run them with ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
Inputs are bf16; the reference is the plain version evaluated in fp32 on the same
inputs; tolerance atol = rtol = 2e-2 (bf16 output rounding plus fp32 sums taken in
another order) for the forward kernels, 2e-2 x max |reference| for the backward ones."""

import numpy as np
import pytest
import torch

from projectiontrainer_tpu_torch.ops import decode_attention as DA
from projectiontrainer_tpu_torch.ops import flash_attention as FA
from projectiontrainer_tpu_torch.ops import fused_ce as CE
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


@pytest.mark.parametrize("d", [64, 1000, 1152, 20480, 24577])
def test_layernorm_kernel(card, d):
    rng = np.random.default_rng(0)
    x = _bf16(rng, (300, d), card)
    p = {"scale": _bf16(rng, (d,), card), "bias": _bf16(rng, (d,), card)}
    before = FLN.launches.value
    got = FLN.layernorm(p, x)
    assert FLN.launches.value == before + 1
    ref = FLN.layernorm_reference({k: v.float() for k, v in p.items()}, x.float())
    torch.testing.assert_close(got.float(), ref, **TOL)


def _qkv(rng, b, t, hq, hkv, d, card, sliced=False):
    """q, k, v; `sliced`: views into one [B, T, (Hq + 2 Hkv) * D] tensor (a fused
    projection's output split and viewed by head: non-contiguous, strided over T)."""
    if not sliced:
        return (_bf16(rng, (b, t, hq, d), card), _bf16(rng, (b, t, hkv, d), card),
                _bf16(rng, (b, t, hkv, d), card))
    fused = _bf16(rng, (b, t, (hq + 2 * hkv) * d), card)
    return tuple(x.view(b, t, -1, d) for x in fused.split([hq * d, hkv * d, hkv * d], dim=-1))


def _pad_mask(b, t, pad, n, card):
    if not pad:
        return None
    mask = torch.ones((b, t), dtype=torch.int32, device=card)
    if pad == "left":
        mask[1, :n] = 0
    else:
        mask[1, t - n:] = 0
    return mask


# K1's tiles: 128 query rows a CTA (two warpgroups of 64), 128 keys a stage (64 at D = 256)
@pytest.mark.parametrize("t,d,hq,hkv,causal,window,pad,sliced", [
    (150, 64, 4, 4, False, None, None, False),
    (150, 72, 4, 4, False, None, None, False),     # so400m's head dim: zero-filled to 80 / 128
    (150, 72, 4, 2, True, 37, "left", False),      # a window smaller than one tile
    (150, 128, 4, 2, True, None, "left", False),
    (150, 256, 4, 1, True, 37, "left", False),     # GQA 4/1 at D = 256
    (64, 72, 4, 4, False, None, None, False),      # the text tower's T: one warpgroup leaves
    (1, 64, 2, 2, True, None, None, False),
    (127, 128, 8, 2, True, None, "right", False),  # one below a tile; GQA 8/2 at D = 128
    (129, 128, 8, 2, False, None, None, True),     # one above a tile, sliced q/k/v
    (63, 256, 4, 1, True, None, None, False),      # one below / above the 64-key tile
    (65, 256, 4, 1, True, 37, "left", True),
    (300, 64, 4, 4, True, None, "left", True),     # left padding masks a whole query tile
    (300, 72, 4, 2, True, 37, "left", False),
    (300, 1024, 4, 1, True, 100, "left", False),   # above 512: the cluster kernel, 2 CTAs
    (150, 640, 4, 4, False, None, None, True),
    (129, 576, 4, 2, True, None, "right", False),  # uneven slices: 192 + 128 | 128 + 128
    (300, 2048, 4, 2, True, 100, "left", True),    # 4 CTAs
    (150, 2112, 4, 2, True, 37, "left", False),    # 5 CTAs, uneven slices
    (129, 4160, 2, 1, False, None, None, False),   # 9 CTAs, uneven slices
    (150, 8192, 4, 2, True, 37, "left", False),    # K1's reach: 16 CTAs
    (70, 8256, 2, 1, True, None, "right", False),  # past it: the column blocks
])
def test_flash_kernel(card, t, d, hq, hkv, causal, window, pad, sliced):
    rng = np.random.default_rng(1)
    b = 2
    q, k, v = _qkv(rng, b, t, hq, hkv, d, card, sliced)
    n_pad = min(t - 1, 140 if t >= 300 else 70)
    mask = _pad_mask(b, t, pad, n_pad, card)
    kw = dict(causal=causal, window=window, kv_mask=mask)
    before = FA.launches.value
    out, lse = FA.flash_attention(q, k, v, **kw)
    assert FA.launches.value == before + 1
    ref, ref_lse = FA.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(out.float(), ref, **TOL)
    if pad == "left":
        assert torch.all(out[1, :n_pad] == 0)
        torch.testing.assert_close(lse[0], ref_lse[0], **TOL)
        torch.testing.assert_close(lse[1, :, n_pad:], ref_lse[1, :, n_pad:], **TOL)
    else:
        torch.testing.assert_close(lse, ref_lse, **TOL)


@pytest.mark.parametrize("t,d,hq,hkv,causal", [(150, 64, 4, 4, False), (1024, 72, 4, 4, False),
                                               (300, 128, 4, 2, True), (300, 256, 4, 1, True),
                                               (300, 1024, 4, 1, True), (200, 640, 4, 4, False),
                                               (200, 576, 4, 2, True), (300, 2048, 4, 2, True),
                                               (129, 4160, 4, 1, True), (150, 8192, 4, 2, False)])
def test_flash_forward_fp32_copy_and_reruns(card, t, d, hq, hkv, causal):
    """The fp32 copy of O that the forward writes for the backward's delta rounds to the
    bf16 O of the same launch, and a rerun gives the same bits (no sum of the kernel
    changes its order from run to run)."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 2, t, hq, hkv, d, card)
    kw = dict(scale=d ** -0.5, causal=causal, window=None, kv_mask=None)
    out, lse, out32 = FA._launch(q, k, v, out_f32=True, **kw)
    assert out32.dtype == torch.float32
    assert torch.equal(out32.to(torch.bfloat16), out)
    for _ in range(2):
        again = FA._launch(q, k, v, out_f32=True, **kw)
        assert all(torch.equal(a, b) for a, b in zip((out, lse, out32), again))


def test_flash_kernel_rejects_unsupported(card):
    q = torch.zeros((1, 8, 2, 520), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="512"):  # no kernel's width; the launch pads nothing
        FA._launch(q, q, q, scale=0.05, causal=False, window=None, kv_mask=None)
    with pytest.raises(TypeError):
        FA.flash_attention(q.float()[..., :64], q.float()[..., :64], q.float()[..., :64])
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q, scale=-0.125)  # the softmax's max assumes scale > 0
    with pytest.raises(ValueError):
        FA.flash_attention(q, q[:, :4], q[:, :4])  # self-attention shapes only
    odd = torch.zeros((1, 8, 2, 68), dtype=torch.bfloat16, device=card)[..., 4:]
    with pytest.raises(ValueError):
        FA.flash_attention(odd, odd, odd)  # rows not 16-byte aligned: no tensor map


# K3 splits the live keys of each (batch, KV head) over CTAs (ops/decode_attention.py:
# decode_plan): b, nb, hq, hkv, p, g, d, t, window, pad ("left": sample 2 padded over
# its first 30 slots; "splits": over its first 300, whole splits without a live key)
@pytest.mark.parametrize("b,nb,hq,hkv,p,g,d,t,window,pad", [
    (3, 3, 4, 2, 77, 41, 128, 0, None, "left"),
    (3, 3, 4, 2, 77, 41, 128, 9, 16, "left"),
    (3, 3, 4, 2, 77, 41, 128, 40, None, "left"),
    (8, 3, 4, 1, 831, 32, 256, 31, None, "left"),      # the served shape
    (8, 3, 4, 1, 831, 32, 256, 31, 512, "left"),       # the window starts inside a split
    (1, 3, 4, 1, 831, 32, 256, 31, None, None),        # one request
    (3, 3, 4, 1, 831, 32, 256, 17, None, "splits"),
    (3, 3, 4, 1, 831, 32, 256, 17, 600, "splits"),
    (8, 3, 4, 1, 831, 1024, 256, 1000, None, "left"),  # max_new_tokens 1024
    (8, 3, 4, 1, 831, 1024, 256, 1000, 512, "left"),
    (2, 2, 8, 2, 150, 20, 64, 19, 64, "left"),
    (2, 24, 4, 1, 831, 32, 256, 31, None, "left"),    # 96 rows a KV head: 2 row groups
    (3, 17, 32, 8, 300, 32, 64, 17, 100, "splits"),   # 68 rows: Llama at 17 beams
    (1, 1, 96, 1, 300, 16, 64, 15, None, None),       # 96 query heads on one KV head
    (2, 3, 40, 1, 150, 16, 128, 15, None, "left"),    # 40 heads a beam: groups of its rows
    (3, 3, 8, 1, 831, 32, 512, 31, None, "left"),     # head dim 512: 24 rows, 2 groups
    (2, 3, 4, 1, 300, 16, 320, 15, 200, "left"),      # 320, padded to 512
    (8, 3, 4, 1, 831, 32, 1024, 31, None, "left"),    # above 512: a cluster of 4 slices
    (2, 24, 4, 1, 300, 16, 1024, 15, 100, "splits"),  # ... and 96 rows in row groups
    (2, 3, 4, 1, 300, 16, 640, 15, None, "left"),     # 640, padded to 768
    (2, 3, 4, 2, 300, 16, 768, 15, 200, "splits"),    # the narrowest cluster: 3 CTAs
    (2, 3, 4, 1, 300, 16, 2048, 15, 100, "left"),     # 8 CTAs of one 256-column block
    (2, 3, 4, 1, 150, 16, 2304, 15, None, "left"),    # 5 CTAs of 2, 2, 2, 2, 1 blocks
    (2, 3, 4, 1, 300, 16, 4096, 15, 100, "left"),     # 8 CTAs of 2 blocks, a window
    (2, 3, 4, 2, 300, 16, 4096, 15, None, "splits"),
    (1, 12, 4, 1, 150, 16, 4096, 15, None, "left"),   # 48 rows: row groups of <= 32
    (2, 3, 4, 1, 150, 16, 4352, 15, 100, "left"),     # 6 CTAs of 3, 3, 3, 3, 3, 2 blocks
])
def test_decode_kernel(card, b, nb, hq, hkv, p, g, d, t, window, pad):
    """Within atol = rtol = 2e-2 of the plain version in fp32, a rerun bit-equal (the
    partials are combined in split order, a cluster's partial scores summed in slice
    order), and more CTAs than (batch, KV head) pairs."""
    rng = np.random.default_rng(2)
    q = _bf16(rng, (b * nb, hq, d), card)
    kp, vp = _bf16(rng, (b, hkv, p, d), card), _bf16(rng, (b, hkv, p, d), card)
    kg, vg = _bf16(rng, (b * nb, hkv, g, d), card), _bf16(rng, (b * nb, hkv, g, d), card)
    pm = torch.ones((b, p), dtype=torch.int32, device=card)
    if pad:
        pm[min(2, b - 1), :30 if pad == "left" else 300] = 0
    kw = dict(prefix_mask=pm, t=t, prefix_len=p, scale=d ** -0.5, window=window)
    before = DA.launches.value
    got = DA.decode_attention(q, kp, vp, kg, vg, **kw)
    assert DA.launches.value == before + 1
    ref = DA.decode_attention_reference(*(x.float() for x in (q, kp, vp, kg, vg)), **kw)
    torch.testing.assert_close(got.float(), ref, **TOL)
    for _ in range(2):
        assert torch.equal(got, DA.decode_attention(q, kp, vp, kg, vg, **kw))
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    width = DA.padded_width(d)
    assert DA.decode_plan(b, nb, hkv, p, g, t, p, window, sms, n_rep=hq // hkv,
                          d=width)["ctas"] > b * hkv


def _rel_close(got, ref, rel=2e-2):
    """Backward kernels: max |err| <= rel * max |ref| (bf16-rounded P / dS / softmax
    factors feed long fp32 sums, so elementwise bounds do not fit small entries)."""
    got, ref = got.float(), ref.float()
    assert bool(got.isfinite().all())
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= rel * scale, f"max err {err} vs max |ref| {scale}"


# K4's tiles: 128 keys a CTA and 64 queries a stage (32 queries at D = 128; 64 keys and
# 32 queries at D = 256); K5's: 128 queries a CTA and 64 keys a stage (32 at D = 256)
@pytest.mark.parametrize("b,t,hq,hkv,d,causal,window,pad,sliced", [
    (2, 150, 4, 2, 128, True, None, "right", False),
    (2, 150, 4, 4, 64, False, None, None, False),
    (2, 150, 4, 1, 256, True, 37, "left", False),      # left padding: fully masked query rows
    (4, 1087, 4, 1, 256, True, 512, "right", False),   # the stage-1 decoder's shape
    (2, 150, 4, 4, 72, False, None, None, False),      # so400m's head dim
    (2, 150, 4, 2, 72, True, 37, "left", False),       # a window smaller than one tile
    (2, 1024, 16, 16, 72, False, None, None, False),   # the stage-0 tower's T and heads
    (2, 64, 4, 4, 72, False, None, None, False),       # one warpgroup of keys leaves
    (2, 1, 2, 2, 64, True, None, None, False),
    (2, 127, 8, 2, 128, True, None, "right", False),   # one below a tile; GQA 8/2 at D = 128
    (2, 129, 8, 2, 128, False, None, None, True),      # one above a tile, sliced q/k/v
    (2, 63, 4, 4, 64, True, 37, None, True),
    (2, 65, 4, 1, 256, True, None, "left", False),     # one above K4's 64 keys at D = 256
    (2, 127, 4, 1, 256, True, 37, "right", True),
    (2, 300, 4, 4, 64, True, None, "left", True),      # left padding masks whole tiles
    (2, 300, 4, 2, 72, True, 37, "left", False),
    (2, 150, 4, 1, 512, True, 37, "left", False),      # head dim 512: columns split
    (2, 257, 4, 4, 512, False, None, "right", True),
    (2, 150, 4, 1, 1024, True, 37, "left", False),     # above 512: K4, K5 on the cluster kernel
    (2, 257, 4, 2, 640, False, None, "right", True),
    (2, 300, 4, 4, 576, True, None, None, False),      # uneven slices
    (2, 257, 8, 2, 1024, False, None, "right", True),
    (2, 300, 4, 2, 2048, True, 100, "left", True),     # the widest portable cluster: 8 CTAs
    (2, 200, 4, 1, 2112, True, 37, "right", False),    # 9 CTAs, uneven slices
    (2, 300, 4, 2, 4096, True, 100, "left", True),     # the widest cluster: 16 CTAs
    (2, 129, 2, 1, 4160, False, None, "right", False),  # K4, K5: two passes of 16 rows a stage
    (2, 150, 4, 2, 6144, True, 37, "left", False),     # passes of 128 | 64
    (2, 200, 4, 2, 8192, True, 100, "right", True),    # the reach of K4 and K5
    (2, 150, 4, 2, 8192, True, None, "left", False),
    (2, 70, 2, 1, 8256, True, None, "right", False),   # past every reach: the column blocks
])
def test_flash_backward_kernels(card, b, t, hq, hkv, d, causal, window, pad, sliced):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, b, t, hq, hkv, d, card, sliced)
    do = _bf16(rng, (b, t, hq, d), card)
    n_pad = min(t - 1, 140 if t >= 300 else (60 if pad == "right" else 70))
    mask = _pad_mask(b, t, pad, n_pad, card)
    kw = dict(causal=causal, window=window)
    out, lse = FA.flash_attention(q, k, v, kv_mask=mask, **kw)
    before = (FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value)
    dq, dk, dv = FA.flash_attention_bwd(q, k, v, mask, out, lse, do, **kw)
    assert (FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value) == (before[0] + 1, before[1] + 1)
    refs = FA.flash_attention_bwd_reference(q.float(), k.float(), v.float(), mask, out.float(),
                                            lse, do.float(), **kw)
    if t == 1:  # one key: dS, so dq and dk, are zero in exact arithmetic
        assert float(dq.float().abs().max()) <= 1e-5 and float(dk.float().abs().max()) <= 1e-5
        _rel_close(dv, refs[2])
    else:
        for got, ref in zip((dq, dk, dv), refs):
            _rel_close(got, ref)
    if pad == "left":
        assert torch.all(dq[1, :n_pad] == 0)
        assert torch.all(dk[1, :n_pad] == 0) and torch.all(dv[1, :n_pad] == 0)


@pytest.mark.parametrize("t,d,hq,hkv,causal,window", [(300, 64, 4, 4, False, None),
                                                      (1024, 72, 4, 4, False, None),
                                                      (300, 128, 8, 2, True, 37),
                                                      (300, 256, 4, 1, True, None),
                                                      (300, 1024, 4, 1, True, 100),
                                                      (200, 640, 4, 4, False, None),
                                                      (200, 576, 4, 2, False, None),
                                                      (300, 2048, 4, 2, True, 64),
                                                      (150, 2112, 4, 1, True, 37),
                                                      (150, 4096, 4, 2, True, None),
                                                      (150, 4160, 4, 2, True, None),
                                                      (150, 6144, 4, 2, True, 37),
                                                      (129, 8192, 4, 1, False, None)])
def test_flash_dkv_reruns_are_bit_equal(card, t, d, hq, hkv, causal, window):
    """Each element of dK, dV and dQ is summed by one thread in program order (the query
    heads of a KV head inside the CTA too): a rerun gives the same bits."""
    rng = np.random.default_rng(12)
    q, k, v = _qkv(rng, 2, t, hq, hkv, d, card)
    do = _bf16(rng, (2, t, hq, d), card)
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    out, lse = FA.flash_attention(q, k, v, **kw)
    mask, do, delta = FA.prepare_bwd(q, k, v, None, out, lse, do)
    dk, dv = FA.launch_bwd_dkv(q, k, v, mask, do, lse, delta, **kw)
    dq = FA.launch_bwd_dq(q, k, v, mask, do, lse, delta, **kw)
    for _ in range(2):
        dk2, dv2 = FA.launch_bwd_dkv(q, k, v, mask, do, lse, delta, **kw)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
        assert torch.equal(dq, FA.launch_bwd_dq(q, k, v, mask, do, lse, delta, **kw))


@pytest.mark.parametrize("t,d,hq,hkv,causal,window,route", [
    (150, 640, 4, 2, True, 37, "cluster"),      # 3 CTAs, uneven slices
    (300, 1024, 4, 1, True, 100, "cluster"),    # leg 6b's width: 4 CTAs
    (300, 2048, 4, 2, False, None, "cluster"),  # the widest portable cluster: 8 CTAs
    (150, 2112, 4, 1, True, None, "cluster"),   # 9 CTAs (non-portable), uneven slices
    (150, 4096, 4, 2, True, 37, "cluster"),     # the widest cluster: 16 CTAs
    (129, 4160, 4, 1, True, None, "cluster passes"),  # two passes, 16 keys a stage
    (150, 6144, 4, 2, True, 37, "cluster passes"),    # passes of 128 | 64
    (129, 8192, 4, 2, False, None, "cluster passes"),  # the reach
    (70, 8256, 2, 1, True, None, "column blocks"),    # the first width past it
])
def test_dq_kernel_above_512(card, t, d, hq, hkv, causal, window, route):
    """K5 above 512 on its plan's route (the cluster kernel up to 4096, in two passes up to
    8192, the column blocks past it) against its plain version, with right padding, a
    rerun bit-equal."""
    assert FA.dq_plan(d)["route"] == route
    rng = np.random.default_rng(13)
    q, k, v = _qkv(rng, 2, t, hq, hkv, d, card)
    do = _bf16(rng, (2, t, hq, d), card)
    mask = _pad_mask(2, t, "right", 40, card)
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    out, lse = FA.flash_attention(q, k, v, kv_mask=mask, **kw)
    mask, do, delta = FA.prepare_bwd(q, k, v, mask, out, lse, do)
    before = FA.bwd_dq_launches.value
    dq = FA.launch_bwd_dq(q, k, v, mask, do, lse, delta, **kw)
    assert FA.bwd_dq_launches.value == before + 1
    ref = FA.flash_attention_bwd_reference(q.float(), k.float(), v.float(), mask, out.float(),
                                           lse, do.float(), **kw)[0]
    _rel_close(dq, ref)
    assert torch.equal(dq, FA.launch_bwd_dq(q, k, v, mask, do, lse, delta, **kw))


@pytest.mark.parametrize("t,d,hq,hkv,causal,window,route", [
    (200, 2112, 4, 1, True, None, "cluster"),  # 9 CTAs (non-portable), uneven slices
    (300, 3072, 4, 2, True, 64, "cluster"),    # 12 CTAs
    (150, 4096, 4, 1, False, None, "cluster"),  # the widest cluster: 16 CTAs
    (129, 4160, 4, 2, True, None, "cluster passes"),  # two passes, 16 queries a stage
    (200, 6144, 4, 1, True, 100, "cluster passes"),   # passes of 128 | 64
    (150, 8192, 4, 2, True, 37, "cluster passes"),    # the reach
    (70, 8256, 2, 1, True, None, "column blocks"),    # the first width past it
])
def test_dkv_kernel_past_2048(card, t, d, hq, hkv, causal, window, route):
    """K4 past head dim 2048 on its plan's route (clusters of 9-16 CTAs up to 4096, 16 CTAs
    in two passes up to 8192, the column blocks past it) against its plain version, with
    right padding, a rerun bit-equal."""
    assert FA.dkv_plan(d)["route"] == route
    rng = np.random.default_rng(14)
    q, k, v = _qkv(rng, 2, t, hq, hkv, d, card)
    do = _bf16(rng, (2, t, hq, d), card)
    mask = _pad_mask(2, t, "right", 40, card)
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    out, lse = FA.flash_attention(q, k, v, kv_mask=mask, **kw)
    mask, do, delta = FA.prepare_bwd(q, k, v, mask, out, lse, do)
    before = FA.bwd_dkv_launches.value
    dk, dv = FA.launch_bwd_dkv(q, k, v, mask, do, lse, delta, **kw)
    assert FA.bwd_dkv_launches.value == before + 1
    _, rk, rv = FA.flash_attention_bwd_reference(q.float(), k.float(), v.float(), mask,
                                                 out.float(), lse, do.float(), **kw)
    _rel_close(dk, rk)
    _rel_close(dv, rv)
    dk2, dv2 = FA.launch_bwd_dkv(q, k, v, mask, do, lse, delta, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_nonportable_clusters_are_placed(card):
    """K4 and K5 in clusters of 9-16 CTAs (head dims 2304-4096, 256 a CTA) and in 16 CTAs
    of two passes (4160-8192, at each stage count of the plans), K1 in 9-16 (4160-8192, 512
    a CTA) at their plans' shared memory: the card holds at least one such cluster at once
    (the occupancy query on the kernel allowed non-portable sizes); K1 at 4096 in 8."""
    for c in range(9, 17):
        for kind in ("dkv", "dq"):
            assert FA.cluster_plan(256 * c, kind)["cluster"] == c
            assert FA.cluster_fit(256 * c, kind) >= 1, (kind, c)
    for d in (4160, 6144, 6208, 7232, 8192):
        for kind in ("dkv", "dq"):
            assert FA.cluster_plan(d, kind)["cluster"] == 16
            assert FA.cluster_fit(d, kind) >= 1, (kind, d)
    assert FA.cluster_plan(4096, "fwd")["cluster"] == 8 and FA.cluster_fit(4096, "fwd") >= 1
    for d, c in ((4160, 9), (4608, 9), (5120, 10), (6144, 12), (8192, 16)):
        assert FA.cluster_plan(d, "fwd")["cluster"] == c
        assert FA.cluster_fit(d, "fwd") >= 1, ("fwd", d)


def test_cluster_launch_outside_the_plan_raises(card):
    """A cluster size or ring other than the plan's is refused by the kernel's entry point
    (K4 at 17 CTAs, K1 at 16 where its plan is 8, K1 at 17 past its reach, K4 at 8192 with
    stages of 32 queries or 8 CTAs, K5 past its reach) and raised by the wrapper's check: nothing is retried at another size."""
    from projectiontrainer_tpu_torch.kernels import _build

    lib = _build.library()
    assert lib.flash_attn_cluster_fit(1, 4096, 17, 3, 32) == -1
    assert lib.flash_attn_cluster_fit(0, 4096, 16, 2, 32) == -1
    assert lib.flash_attn_cluster_fit(0, 8256, 17, 2, 32) == -1
    assert lib.flash_attn_cluster_fit(0, 8192, 16, 2, 32) >= 1
    assert lib.flash_attn_cluster_fit(1, 8192, 16, 2, 32) == -1
    assert lib.flash_attn_cluster_fit(2, 4160, 16, 4, 32) == -1
    assert lib.flash_attn_cluster_fit(1, 8192, 8, 2, 16) == -1
    assert lib.flash_attn_cluster_fit(2, 8256, 16, 2, 16) == -1
    assert lib.flash_attn_cluster_fit(1, 8192, 16, 2, 16) >= 1
    rng = np.random.default_rng(15)
    q, k, v = _qkv(rng, 1, 64, 2, 1, 4096, card)
    do = _bf16(rng, (1, 64, 2, 4096), card)
    out, lse = FA.flash_attention(q, k, v)
    mask, do, delta = FA.prepare_bwd(q, k, v, None, out, lse, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    plan = FA.dkv_plan(4096)
    err = lib.flash_attn_cluster_bwd_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, 64, 2, 1, 4096,
        FA._strides(q, k, v, do, dk, dv), FA._bwd_maps(q, k, v, do, plan), 17,
        plan["stages"], plan["bq"], 4096 ** -0.5, 0, 0, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="cudaError"):
        _build.check("flash_attn_cluster_bwd_dkv_bf16", err)


@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 128), (8, 2, 128), (16, 16, 72), (4, 2, 640),
                                      (4, 4, 1024)])
def test_flash_merged_layout(card, hq, hkv, d):
    """Head-merged [B, T, H*D] tensors run through the same kernels as views; forward
    and gradients against the plain attention of the [B, T, H, D] views."""
    from projectiontrainer_tpu_torch.ops.attention import dot_product_attention

    rng = np.random.default_rng(7)
    b, t = 2, 1024
    qm = _bf16(rng, (b, t, hq * d), card).requires_grad_(True)
    km, vm = (_bf16(rng, (b, t, hkv * d), card).requires_grad_(True) for _ in range(2))
    g = _bf16(rng, (b, t, hq * d), card)
    before = (FA.launches.value, FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value)
    out = FA.flash_attention_merged(qm, km, vm, heads=hq, kv_heads=hkv)
    out.backward(g)
    assert (FA.launches.value, FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value) == tuple(
        n + 1 for n in before)
    q, k, v = (x.detach().float().view(b, t, -1, d).requires_grad_(True) for x in (qm, km, vm))
    ref = dot_product_attention(q, k, v).reshape(b, t, hq * d)
    ref.backward(g.float())
    torch.testing.assert_close(out.float(), ref, **TOL)
    for got, want in ((qm.grad, q.grad), (km.grad, k.grad), (vm.grad, v.grad)):
        _rel_close(got.reshape(want.shape), want)


@pytest.mark.parametrize("d", [72, 640])  # 640: K1 and K4 on the cluster kernels
@pytest.mark.parametrize("spread,floor", [(0.2, 0.999), (0.05, None)])
def test_flash_autograd_gradients_on_nearly_equal_tokens(card, spread, floor, d):
    """Tokens whose q, k and v share a common part (x3) 15x / 60x their spread (a
    trained tower's last layers): dQ lives in the small remainder of K, and |O| is
    large. The backward's delta = rowsum(dO * O) must agree with the kernels' own
    sum_j P dP (the forward's fp32 O, normalised by the sum of the bf16 weights its PV
    product applied), and a row of the dS that enters the dK/dQ products must sum to
    zero far below bf16's rounding (dS as bf16 hi + lo): see csrc/flash_attn_*.cu.
    dq, dk and dv within 0.001 of plain bf16 attention's cosine to fp32, and at
    `floor` or above where plain bf16 reads >= 0.999 too; the sum over tokens of dk
    (zero in exact arithmetic) no noisier than 3x plain bf16's. On the H100, with
    delta from the fp32 O normalised by the fp32 sum: dq 0.943 at spread 0.2, 0.174 at
    0.05; with O normalised by the bf16 sum but dS a single bf16: 0.9994 and 0.991;
    plain bf16: 0.9997 and 0.9955."""
    from projectiontrainer_tpu_torch.ops.attention import dot_product_attention

    rng = np.random.default_rng(10)
    b, t, h = 2, 512, 4
    common = 3 * rng.standard_normal((1, 1, h, d)).astype(np.float32)
    q, k, v = (torch.tensor(common + spread * rng.standard_normal((b, t, h, d), dtype=np.float32),
                            device=card).to(torch.bfloat16) for _ in range(3))
    g = _bf16(rng, (b, t, h, d), card)
    kernel_in = [x.clone().requires_grad_(True) for x in (q, k, v)]
    plain_in = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref_in = [x.float().requires_grad_(True) for x in (q, k, v)]
    FA.flash_attention(*kernel_in)[0].backward(g)
    dot_product_attention(*plain_in).backward(g)
    dot_product_attention(*ref_in).backward(g.float())

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a.float().flatten(), b.flatten(), dim=0))

    for kern, plain, ref in zip(kernel_in, plain_in, ref_in):
        c_kernel, c_plain = cos(kern.grad, ref.grad), cos(plain.grad, ref.grad)
        assert c_kernel >= c_plain - 1e-3, (c_kernel, c_plain)
        if floor is not None:
            assert min(c_kernel, c_plain) >= floor, (c_kernel, c_plain)
    noise = [float(x[1].grad.float().sum(1).norm()) for x in (kernel_in, plain_in)]
    assert noise[0] <= 3 * noise[1], noise


def test_flash_autograd_runs_the_backward_kernels(card):
    rng = np.random.default_rng(5)
    q, k, v = (_bf16(rng, (2, 96, 2, 128), card).requires_grad_(True) for _ in range(3))
    before = FA.bwd_dq_launches.value
    out, _ = FA.flash_attention(q, k, v, causal=True)
    out.float().square().sum().backward()
    assert FA.bwd_dq_launches.value == before + 1
    assert all(bool(x.grad.isfinite().all()) for x in (q, k, v))


def test_flash_backward_rejects_unsupported(card):
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=card)
    out, lse = FA.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        FA.flash_attention_bwd(q, q, q, None, out, lse, q.float())
    with pytest.raises(ValueError):
        FA.flash_attention_bwd(q, q, q, None, out, lse[:, :1], q)
    with pytest.raises(ValueError):
        FA.flash_attention_bwd(q, q, q, None, out[:, :4], lse, q)  # out of another shape


@pytest.mark.parametrize("n,d,dtype,ragged", [
    (300, 64, torch.bfloat16, True), (16, 1152, torch.bfloat16, False),
    (1000, 1152, torch.bfloat16, False), (16384, 1152, torch.bfloat16, True),
    (529, 1152, torch.bfloat16, True), (1001, 1152, torch.bfloat16, True),
    (16383, 1152, torch.bfloat16, True), (4608, 1024, torch.bfloat16, True),
    (1001, 1152, torch.float32, True), (4608, 4096, torch.bfloat16, True),
    (16384, 1004, torch.bfloat16, True), (16, 1001, torch.bfloat16, False),
    (200, 1001, torch.float32, False), (4096, 6144, torch.bfloat16, True),
    (2048, 8192, torch.bfloat16, True), (300, 4104, torch.float32, True),
    (2048, 20480, torch.bfloat16, False), (1000, 24577, torch.bfloat16, False),  # clusters
    (2, 32768, torch.bfloat16, False), (300, 20480, torch.float32, False),
    (512, 32768, torch.bfloat16, False), (16, 19369, torch.bfloat16, False),
    (100, 20483, torch.float32, False), (64, 40000, torch.bfloat16, False),   # streamed
])
def test_layernorm_backward_kernel(card, n, d, dtype, ragged):
    """K8's dx, dscale and dbias against the plain backward, each within 2e-2 x
    max |reference|, in one launch. On a 132-SM H100 the ragged row counts leave some
    CTA's last ring stage part-filled (checked): its slots past the band's end are never
    loaded and must add nothing to the sums."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = FLN.bwd_plan(n, d, sms, torch.empty((), dtype=dtype).element_size())
    if sms == 132:
        assert FLN.bwd_ragged(n, plan) == ragged, plan
    rng = np.random.default_rng(8)
    x, dy = _bf16(rng, (n, d), card).to(dtype), _bf16(rng, (n, d), card).to(dtype)
    scale = _bf16(rng, (d,), card) * 0.5 + 1
    before = FLN.bwd_launches.value
    got = FLN.layernorm_bwd(x, dy, scale, 1e-6)
    torch.cuda.synchronize()
    assert FLN.bwd_launches.value == before + 1
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    ref = FLN.layernorm_bwd_reference(x.float(), dy.float(), scale.float(), 1e-6)
    for a, b in zip(got, ref):
        _rel_close(a, b)
    # the partial sums are added in a fixed order: a second run gives the same bits
    again = FLN.layernorm_bwd(x, dy, scale, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_layernorm_backward_kernel_strided_rows_and_fp32_scale(card):
    """Rows read through a row stride (a slice of wider rows) and an fp32 scale: the
    same numbers as the plain backward."""
    rng = np.random.default_rng(10)
    wide = _bf16(rng, (700, 1280), card)
    x, dy = wide[:, :1152], _bf16(rng, (700, 1152), card)
    scale = (_bf16(rng, (1152,), card) * 0.5 + 1).float()
    got = FLN.layernorm_bwd(x, dy, scale, 1e-6)
    ref = FLN.layernorm_bwd_reference(x.float(), dy.float(), scale, 1e-6)
    for a, b in zip(got, ref):
        _rel_close(a, b)


def test_layernorm_backward_kernel_refuses(card):
    """A D wider than one ring row fits streams its rows; another dtype or dy of another
    shape raise:
    there is no fallback. Rows that are not 16-byte aligned and the widths the kernel
    used to refuse (1156, 4104) are taken, by the row warps' cp.async: the plain
    backward's numbers."""
    rng = np.random.default_rng(11)
    x, g = _bf16(rng, (64, 1160), card), _bf16(rng, (64, 1160), card)
    scale = torch.ones(1152, dtype=torch.bfloat16, device=card)
    rows = x.view(-1)[:63 * 1156].view(63, 1156)[:, :1152]  # row stride 2312 bytes
    g_rows = g.view(-1)[:63 * 1156].view(63, 1156)[:, :1152]
    big, g_big = _bf16(rng, (4, 4104), card), _bf16(rng, (4, 4104), card)
    for args in ((x[:, 4:1156], g[:, :1152], scale),  # base 8 bytes off
                 (rows, g_rows, scale),
                 (x[:, :1156], g[:, :1156], torch.ones(1156, device=card)),
                 (big, g_big, torch.ones(4104, device=card))):
        got = FLN.layernorm_bwd(*args, 1e-6)
        ref = FLN.layernorm_bwd_reference(*(a.float() for a in args), 1e-6)
        for a, b in zip(got, ref):
            _rel_close(a, b)
    wide, g_wide = _bf16(rng, (4, 19369), card), _bf16(rng, (4, 19369), card)
    scale_wide = torch.ones(19369, device=card)  # one ring row no longer fits: a cluster
    assert FLN.bwd_plan(4, 19369, 132)["route"] == "cluster"
    for a, b in zip(FLN.layernorm_bwd(wide, g_wide, scale_wide, 1e-6),
                    FLN.layernorm_bwd_reference(wide.float(), g_wide.float(), scale_wide, 1e-6)):
        _rel_close(a, b)
    with pytest.raises(TypeError):
        h = x[:, :1152].half()
        FLN.layernorm_bwd(h, h, scale, 1e-6)
    with pytest.raises(ValueError):
        FLN.layernorm_bwd(x[:, :1152], x[:32, :1152], scale, 1e-6)


def test_layernorm_cluster_grid_that_cannot_be_resident_raises(card):
    """The cluster route's grid barrier needs every CTA resident: a plan of more clusters
    than fit at once is refused with a CUDA error, launches nothing and does not hang."""
    rng = np.random.default_rng(12)
    x, dy = _bf16(rng, (600, 20480), card), _bf16(rng, (600, 20480), card)
    scale = torch.ones(20480, device=card)
    plan = FLN.bwd_plan(600, 20480, 132, clusters=600)
    before = FLN.bwd_launches.value
    with pytest.raises(RuntimeError, match="cudaError"):
        FLN.layernorm_bwd(x, dy, scale, 1e-6, plan=plan)
    assert FLN.bwd_launches.value == before
    torch.cuda.synchronize()


def test_layernorm_autograd_runs_both_kernels(card):
    rng = np.random.default_rng(9)
    x = _bf16(rng, (4, 100, 1152), card).requires_grad_(True)
    p = {"scale": (_bf16(rng, (1152,), card) * 0.5 + 1).requires_grad_(True),
         "bias": _bf16(rng, (1152,), card).requires_grad_(True)}
    before = (FLN.launches.value, FLN.bwd_launches.value)
    FLN.layernorm(p, x).float().square().sum().backward()
    assert (FLN.launches.value, FLN.bwd_launches.value) == (before[0] + 1, before[1] + 1)
    assert x.grad.dtype == torch.bfloat16 and p["scale"].grad.dtype == torch.bfloat16
    assert all(bool(t.grad.isfinite().all()) for t in (x, p["scale"], p["bias"]))


@pytest.mark.parametrize("n,v,d", [(100, 1000, 128), (300, 5000, 256), (2048, 262144, 1152),
                                   (1, 128, 64), (257, 1025, 1152), (1000, 5001, 1152),
                                   (64, 2000, 2560)])
def test_fused_ce_kernels(card, n, v, d):
    """lse and nll within 1e-3 absolute; dh, and its softmax part dh + g * W[label]
    alone, within 2e-2 x max |reference|. The table's scale gives logits of std 5 (a
    peaked softmax, so a lost vocab split moves lse and the softmax part), and g
    differs per row and is exact in bf16 (so the kernel's bf16 (p - onehot) * g is
    exactly -g at a label of negligible p)."""
    rng = np.random.default_rng(6)
    h = _bf16(rng, (n, d), card)
    w = (_bf16(rng, (v, d), card) * (5 / d ** 0.5)).contiguous()
    labels = torch.tensor(rng.integers(0, v, size=n), dtype=torch.int32, device=card)
    labels[0] = v - 1  # the ragged vocab tail
    g = torch.tensor(rng.uniform(0.5, 1.5, size=n).astype(np.float32) / n,
                     device=card).to(torch.bfloat16).float()
    before = (CE.fwd_launches.value, CE.bwd_launches.value)
    lse, nll = CE.fused_ce_fwd(h, w, labels)
    dh = CE.fused_ce_bwd(h, w, labels, lse, g)
    assert (CE.fwd_launches.value, CE.bwd_launches.value) == (before[0] + 1, before[1] + 1)
    rlse, rnll = CE.fused_ce_reference(h.float(), w.float(), labels)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    torch.testing.assert_close(nll, rnll, atol=1e-3, rtol=0)
    rdh = CE.fused_ce_bwd_reference(h.float(), w.float(), labels, rlse, g)
    onehot = g[:, None] * w[labels.long()].float()
    _rel_close(dh, rdh)
    _rel_close(dh + onehot, rdh + onehot)


@pytest.mark.parametrize("n,v,d", [(300, 5000, 256), (2048, 262144, 1152)])
def test_fused_ce_reruns_are_bit_equal(card, n, v, d):
    """No sum of either kernel changes its order from run to run: each scratch element
    is owned by one thread, and the vocab splits are combined in a fixed order."""
    rng = np.random.default_rng(7)
    h = _bf16(rng, (n, d), card)
    w = (_bf16(rng, (v, d), card) * (5 / d ** 0.5)).contiguous()
    labels = torch.tensor(rng.integers(0, v, size=n), dtype=torch.int32, device=card)
    g = torch.tensor(rng.uniform(0.5, 1.5, size=n).astype(np.float32) / n, device=card)
    lse, nll = CE.fused_ce_fwd(h, w, labels)
    dh = CE.fused_ce_bwd(h, w, labels, lse, g)
    for _ in range(2):
        lse2, nll2 = CE.fused_ce_fwd(h, w, labels)
        assert torch.equal(lse, lse2) and torch.equal(nll, nll2)
        assert torch.equal(dh, CE.fused_ce_bwd(h, w, labels, lse, g))


def test_fused_ce_rejects_unsupported(card):
    h = torch.zeros((8, 1280), dtype=torch.bfloat16, device=card)
    labels = torch.zeros(8, dtype=torch.int32, device=card)
    CE.fused_ce_fwd(h, h, labels)  # hidden sizes above 1216 are taken since the TMA ring
    with pytest.raises(ValueError):
        CE.fused_ce_fwd(h, h[:, :1216].contiguous(), labels)  # table of another width
    with pytest.raises(ValueError):
        CE.fused_ce_fwd(h[:, :96].contiguous(), h[:, :96].contiguous(), labels)  # not /64
    with pytest.raises(TypeError):
        CE.fused_ce_fwd(h[:, :128].float(), h[:, :128].float(), labels)
    with pytest.raises(ValueError):
        CE.fused_ce_fwd(h[:, :128].contiguous(), h[:, :128].contiguous(), labels.long())
    with pytest.raises(ValueError):
        CE.fused_ce_fwd(h.t(), h.t(), labels)  # not contiguous


def test_device_ms_leaves_the_host_out(card):
    """``device_ms`` queues its launches behind a spinning kernel, so a kernel of a few
    microseconds reads as such, not as the tens of microseconds the host takes to launch
    it; a product of known size reads no less than the card's peak allows."""
    from projectiontrainer_tpu_torch.utils.timing import device_ms

    x = torch.zeros(1024, device=card)
    assert device_ms(lambda: x.add_(1.0)) < 0.02
    a = torch.zeros((4096, 4096), dtype=torch.bfloat16, device=card)
    assert device_ms(lambda: a @ a) >= 2 * 4096 ** 3 / 989e12 * 1e3
