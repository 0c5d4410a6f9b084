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
    (72, 4, 4, False, None, False),     # so400m's head dim, padded to 80 in the kernel
    (72, 4, 2, True, 37, True),
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
    q = torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16, device=card)
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


def _rel_close(got, ref, rel=2e-2):
    """Backward kernels: max |err| <= rel * max |ref| (bf16-rounded P / dS / softmax
    factors feed long fp32 sums, so elementwise bounds do not fit small entries)."""
    got, ref = got.float(), ref.float()
    assert bool(got.isfinite().all())
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= rel * scale, f"max err {err} vs max |ref| {scale}"


@pytest.mark.parametrize("b,t,hq,hkv,d,causal,window,pad", [
    (2, 150, 4, 2, 128, True, None, "right"),
    (2, 150, 4, 4, 64, False, None, None),
    (2, 150, 4, 1, 256, True, 37, "left"),      # left padding: fully masked query rows
    (4, 1087, 4, 1, 256, True, 512, "right"),   # the stage-1 decoder's shape
    (2, 150, 4, 4, 72, False, None, None),      # so400m's head dim
    (2, 150, 4, 2, 72, True, 37, "left"),
    (2, 1024, 16, 16, 72, False, None, None),   # the stage-0 tower's T and heads
])
def test_flash_backward_kernels(card, b, t, hq, hkv, d, causal, window, pad):
    rng = np.random.default_rng(4)
    q, do = _bf16(rng, (b, t, hq, d), card), _bf16(rng, (b, t, hq, d), card)
    k, v = _bf16(rng, (b, t, hkv, d), card), _bf16(rng, (b, t, hkv, d), card)
    mask = None
    if pad:
        mask = torch.ones((b, t), dtype=torch.int32, device=card)
        if pad == "right":
            mask[1, t - 60:] = 0
        else:
            mask[1, :70] = 0
    kw = dict(causal=causal, window=window)
    out, lse = FA.flash_attention(q, k, v, kv_mask=mask, **kw)
    before = (FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value)
    dq, dk, dv = FA.flash_attention_bwd(q, k, v, mask, out, lse, do, **kw)
    assert (FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value) == (before[0] + 1, before[1] + 1)
    refs = FA.flash_attention_bwd_reference(q.float(), k.float(), v.float(), mask, out.float(),
                                            lse, do.float(), **kw)
    for got, ref in zip((dq, dk, dv), refs):
        _rel_close(got, ref)
    if pad == "left":
        assert torch.all(dq[1, :70] == 0)


@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 128), (8, 2, 128), (16, 16, 72)])
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


@pytest.mark.parametrize("spread,floor", [(0.2, 0.999), (0.05, None)])
def test_flash_autograd_gradients_on_nearly_equal_tokens(card, spread, floor):
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
    b, t, h, d = 2, 512, 4, 72
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


@pytest.mark.parametrize("n,d,ragged", [
    (300, 64, False), (16, 1152, False), (1000, 1152, False), (16384, 1152, False),
    (529, 1152, True), (1001, 1152, True), (16383, 1152, True),
])
def test_layernorm_backward_kernel(card, n, d, ragged):
    """K8's dx, dscale and dbias against the plain backward, each within 2e-2 x
    max |reference|. The ragged row counts leave the last program's block part-empty
    on a 132-SM H100 (checked): its rows past the end must add nothing to the sums."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    rows, programs = FLN.bwd_grid(n, sms)
    if sms == 132:
        assert (rows * programs > n) == ragged, (rows, programs)
    rng = np.random.default_rng(8)
    x, dy = _bf16(rng, (n, d), card), _bf16(rng, (n, d), card)
    scale = _bf16(rng, (d,), card) * 0.5 + 1
    before = FLN.bwd_launches.value
    got = FLN.layernorm_bwd(x, dy, scale, 1e-6)
    assert FLN.bwd_launches.value == before + 1
    ref = FLN.layernorm_bwd_reference(x.float(), dy.float(), scale.float(), 1e-6)
    for a, b in zip(got, ref):
        _rel_close(a, b)
    # the partial sums are added in a fixed order: a second run gives the same bits
    again = FLN.layernorm_bwd(x, dy, scale, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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
