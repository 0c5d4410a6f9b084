"""The plain backward of the port's flash attention and its fused linear + CE against
the JAX package's Pallas kernels (interpret mode on the CPU), fp32, same numpy inputs.

- Flash attention: ``jax.vjp`` of ``flash_attention(..., interpret=True)`` (the custom
  VJP runs ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``) against ``torch.autograd`` of
  the port's ``flash_attention``, which on CPU tensors runs the FlashAttention-2
  formulas of ``flash_attention_bwd_reference``. Tolerance 1e-4 of the reference's
  largest magnitude (fp32 sums in another order).
- Head dim 72 (so400m): the same, non-causal and unmasked as the towers run it.
- ``flash_attention_merged`` on head-merged [B, T, H*D] tensors against the merged-lane
  kernels' ``_flash_lanes`` (interpret mode), D = 128 and D = 72 (its zero-pad branch),
  forward and gradients. Tolerance 1e-4 of the reference's largest magnitude.
- LayerNorm backward: ``layernorm_bwd_reference`` against ``_bwd(..., interpret=True)``
  and the port's autograd function against ``jax.grad`` of ``_fused_ln``, at a row
  count that leaves the JAX kernel's last row block ragged (its block cut to 16 rows).
  Tolerance 1e-5 relative.
- Fused CE: ``fused_clm_token_nll(..., interpret=True)`` and its VJP against the
  port's, with a vocab that is not a multiple of the kernels' tile (a ragged tail);
  the table's gradient is zero by contract. Tolerance 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu.ops import flash_attention as JFA
from projectiontrainer_tpu.ops import fused_ce as JCE
from projectiontrainer_tpu.ops import fused_layernorm as JFLN
from projectiontrainer_tpu_torch.ops import flash_attention as FA
from projectiontrainer_tpu_torch.ops import fused_ce as CE
from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN
from projectiontrainer_tpu_torch.train import steps

torch.set_num_threads(2)


def rel_close(ours, theirs, tol):
    ours = ours.detach().numpy()
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape
    err = np.abs(ours - theirs).max()
    assert err <= tol * max(np.abs(theirs).max(), 1e-30), f"max err {err}"


BWD_CASES = {
    "gqa_causal_right_pad": dict(hq=4, hkv=1, causal=True, window=None, pad="right"),
    "gqa_window_left_pad": dict(hq=4, hkv=2, causal=True, window=9, pad="left"),
    "mha_tower": dict(hq=2, hkv=2, causal=False, window=None, pad=None),
    "window_no_mask": dict(hq=2, hkv=1, causal=True, window=16, pad=None),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_backward_plain_matches_pallas_vjp(case):
    c = BWD_CASES[case]
    rng = np.random.default_rng(3)
    b, t, d = 2, 40, 16
    q = rng.standard_normal((b, t, c["hq"], d), dtype=np.float32)
    k = rng.standard_normal((b, t, c["hkv"], d), dtype=np.float32)
    v = rng.standard_normal((b, t, c["hkv"], d), dtype=np.float32)
    g = rng.standard_normal((b, t, c["hq"], d), dtype=np.float32)
    mask = None
    if c["pad"] == "right":
        mask = np.ones((b, t), np.int32)
        mask[1, 29:] = 0
    elif c["pad"] == "left":
        mask = np.ones((b, t), np.int32)
        mask[1, :13] = 0  # rows 0..12 of batch 1 see no valid key: fully masked
    kw = dict(scale=d ** -0.5, causal=c["causal"], window=c["window"])

    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda q_, k_, v_: JFA.flash_attention(
        q_, k_, v_, kv_mask=jmask, interpret=True, **kw), *map(jnp.asarray, (q, k, v)))
    jdq, jdk, jdv = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    before = (FA.launches.value, FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value)
    out, _ = FA.flash_attention(tq, tk, tv, kv_mask=None if mask is None else torch.tensor(mask),
                                **kw)
    out.backward(torch.tensor(g))
    assert (FA.launches.value, FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value) == before
    for ours, theirs in ((tq.grad, jdq), (tk.grad, jdk), (tv.grad, jdv)):
        rel_close(ours, theirs, 1e-4)
    if c["pad"] == "left":
        assert torch.all(tq.grad[1, :13] == 0)  # fully masked rows get no gradient


def test_flash_backward_reference_matches_autograd_of_plain_attention():
    """The written-out FA-2 formulas against torch autograd through the plain
    attention (the oracle both share), GQA and a window."""
    from projectiontrainer_tpu_torch.ops.attention import dot_product_attention

    rng = np.random.default_rng(4)
    q, k, v, g = (torch.tensor(rng.standard_normal(s, dtype=np.float32), requires_grad=True)
                  for s in ((2, 24, 4, 8), (2, 24, 2, 8), (2, 24, 2, 8), (2, 24, 4, 8)))
    mask = torch.ones((2, 24), dtype=torch.int32)
    mask[0, 20:] = 0
    kw = dict(scale=0.3, causal=True, window=7)
    out = dot_product_attention(q, k, v, kv_mask=mask, **kw)
    out.backward(g.detach())
    _, lse = FA.flash_attention_reference(q.detach(), k.detach(), v.detach(), kv_mask=mask, **kw)
    ours = FA.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), mask,
                                            out.detach(), lse, g.detach(), **kw)
    for mine, ref in zip(ours, (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(mine, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [96, 64])
def test_flash_head_dim_72_plain_matches_pallas_vjp(t):
    """so400m's head dim (the Pallas kernel fills Mosaic's lanes with zeros; the CUDA
    kernels pad to 80 in shared memory), non-causal and unmasked as in the towers."""
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal((2, t, 4, 72), dtype=np.float32) for _ in range(4))
    jout, vjp = jax.vjp(lambda q_, k_, v_: JFA.flash_attention(
        q_, k_, v_, bq=32, bk=32, interpret=True), *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, _ = FA.flash_attention(tq, tk, tv)
    out.backward(torch.tensor(g))
    rel_close(out, jout, 1e-4)
    for ours, theirs in zip((tq.grad, tk.grad, tv.grad), jgrads):
        rel_close(ours, theirs, 1e-4)


@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 128), (4, 2, 128), (4, 4, 72)])
def test_flash_merged_matches_jax_lanes(hq, hkv, d):
    """The merged-lane kernels' math (rows 4-6 of the kernel table) through the port's
    ``flash_attention_merged``: [B, T, H*D] in, views of the same storage inside."""
    rng = np.random.default_rng(8)
    b, t = 2, 128
    q = rng.standard_normal((b, t, hq, d), dtype=np.float32)
    k, v = (rng.standard_normal((b, t, hkv, d), dtype=np.float32) for _ in range(2))
    g = rng.standard_normal((b, t, hq, d), dtype=np.float32)
    jout, vjp = jax.vjp(lambda q_, k_, v_: JFA._flash_lanes(q_, k_, v_, d ** -0.5, 64, 64, True),
                        *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    qm, km, vm = (torch.tensor(x.reshape(b, t, -1), requires_grad=True) for x in (q, k, v))
    out = FA.flash_attention_merged(qm, km, vm, heads=hq, kv_heads=hkv)
    assert out.shape == (b, t, hq * d)
    out.backward(torch.tensor(g.reshape(b, t, -1)))
    rel_close(out.reshape(b, t, hq, d), jout, 1e-4)
    for ours, theirs in zip((qm.grad, km.grad, vm.grad), jgrads):
        rel_close(ours.reshape(theirs.shape), theirs, 1e-4)
    with pytest.raises(ValueError, match="heads"):
        FA.flash_attention_merged(qm[..., :-1], km, vm, heads=hq, kv_heads=hkv)


def _ln_case(rows, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * 2.0 + 0.3).astype(np.float32)
    scale = (rng.standard_normal(d) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(d) * 0.1).astype(np.float32)
    dy = rng.standard_normal((rows, d)).astype(np.float32)
    return x, scale, bias, dy


@pytest.mark.parametrize("rows", [40, 48])
def test_layernorm_bwd_reference_matches_pallas(monkeypatch, rows):
    """40 rows leave the JAX kernel's last 16-row block ragged (its masked products)."""
    monkeypatch.setattr(JFLN, "_BLOCK_ROWS", 16)
    x, scale, _, dy = _ln_case(rows, 128, 9)
    jdx, jds, jdb = JFLN._bwd(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(scale), eps=1e-6,
                              interpret=True)
    dx, ds, db = FLN.layernorm_bwd_reference(torch.tensor(x), torch.tensor(dy),
                                             torch.tensor(scale), 1e-6)
    for ours, theirs in ((dx, jdx), (ds, jds), (db, jdb)):
        rel_close(ours, theirs, 1e-5)


def test_layernorm_autograd_matches_jax_grad(monkeypatch):
    """The port's LayerNorm (plain forward and backward on the CPU, inside the same
    ``torch.autograd.Function`` the kernels use) against ``jax.grad`` of the Pallas
    custom VJP."""
    monkeypatch.setattr(JFLN, "_BLOCK_ROWS", 16)
    x, scale, bias, dy = _ln_case(40, 128, 10)
    x3 = x.reshape(2, 20, 128)

    def jloss(x_, s_, b_):
        return jnp.sum(JFLN._fused_ln(x_.reshape(40, 128), s_, b_, 1e-6, True) * dy)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x3, scale, bias)))
    tx, ts, tb = (torch.tensor(a, requires_grad=True) for a in (x3, scale, bias))
    before = (FLN.launches.value, FLN.bwd_launches.value)
    out = FLN.layernorm({"scale": ts, "bias": tb}, tx, eps=1e-6)
    (out.reshape(40, 128) * torch.tensor(dy)).sum().backward()
    assert (FLN.launches.value, FLN.bwd_launches.value) == before  # CPU: plain versions
    for ours, theirs in zip((tx.grad, ts.grad, tb.grad), jgrads):
        rel_close(ours, theirs, 1e-5)


# (n, d, bytes an element, ragged) on a 132-SM H100: the row counts the card checks
# (the stage-0 tower's 16384, the MAP head's 16, the ViT-L tower's 4608 at D = 1024),
# fp32 rows and the widest D the kernel takes
@pytest.mark.parametrize("n,d,itemsize,ragged", [
    (16, 1152, 2, False), (529, 1152, 2, True), (1000, 1152, 2, False), (1001, 1152, 2, True),
    (16383, 1152, 2, True), (16384, 1152, 2, True), (4608, 1024, 2, True), (300, 64, 2, True),
    (1001, 1152, 4, True), (16384, 4096, 2, True), (16384, 4096, 4, True), (1, 8, 4, True),
])
def test_layernorm_bwd_plan(n, d, itemsize, ragged):
    """K8's plan: every row in exactly one CTA's band, bands that differ by at most one
    row, at most one CTA an SM (fewer at few rows, one for up to two stages of rows), the
    ring within the 227 KB a block may use, and part-filled last stages where the card's
    ragged cases need them."""
    plan = FLN.bwd_plan(n, d, 132, itemsize)
    bands = FLN.bwd_bands(n, plan["ctas"])
    covered = np.zeros(n, np.int64)
    for start, count in bands:
        covered[start:start + count] += 1
    assert (covered == 1).all()
    counts = [count for _, count in bands]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    assert plan["ctas"] == (1 if n <= 2 * plan["rows"] else min(132, -(-n // plan["rows"])))
    assert plan["smem_bytes"] == FLN.bwd_smem_bytes(d, itemsize, plan["rows"], plan["stages"])
    assert plan["smem_bytes"] <= FLN.SMEM_LIMIT and plan["stages"] >= 3
    assert FLN.bwd_ragged(n, plan) == ragged


@pytest.mark.parametrize("d", [1024, 1152])
def test_layernorm_bwd_plan_keeps_loads_in_flight(d):
    """At the towers' widths in bf16, 8 rows a stage and 4 stages: while one stage is
    read, three (>= 64 KB of x and dy) are in flight on each SM."""
    plan = FLN.bwd_plan(16384, d, 132)
    assert (plan["rows"], plan["stages"]) == (8, 4)
    assert (plan["stages"] - 1) * plan["rows"] * 2 * d * 2 >= 64 * 1024


@pytest.mark.parametrize("n,d", [(16, 19369), (16, 20000), (16, 65536), (16, -8), (16, 0),
                                 (0, 1152)])
def test_layernorm_bwd_plan_refuses(n, d):
    """D must be at least 1 and there must be rows. Above 19,368, where one ring row of
    x and dy and the fp32 scale no longer fit in the 227 KB of shared memory a block may
    use (and the plan used to raise), a row is cut over a cluster up to 32,768 columns,
    and wider rows are streamed (any width below, tests/test_torch_layernorm_widths.py)."""
    if n > 0 and d > 19368:
        plan = FLN.bwd_plan(n, d, 132)
        if d <= 32768:
            assert plan["route"] == "cluster" and plan["bands"] == n
        else:
            assert plan["streamed"] and plan["stages"] == 0 and plan["ctas"] == n
        return
    with pytest.raises(ValueError):
        FLN.bwd_plan(n, d, 132)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_fused_ce_plain_matches_pallas(scale):
    rng = np.random.default_rng(5)
    n, d, v = 37, 128, 300  # v is not a multiple of any vocab tile: a ragged tail
    h = rng.standard_normal((n, d), dtype=np.float32)
    w = rng.standard_normal((v, d), dtype=np.float32) * 0.1
    labels = rng.integers(0, v, size=n).astype(np.int32)
    labels[v % n] = v - 1  # a label in the ragged tail
    g = rng.standard_normal(n, dtype=np.float32)

    jnll, vjp = jax.vjp(lambda h_, w_: JCE.fused_clm_token_nll(
        h_, w_, jnp.asarray(labels), scale, True), jnp.asarray(h), jnp.asarray(w))
    jdh, jdw = vjp(jnp.asarray(g))

    th, tw = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    before = (CE.fwd_launches.value, CE.bwd_launches.value)
    nll = CE.fused_clm_token_nll(th, tw, torch.tensor(labels), scale)
    nll.backward(torch.tensor(g))
    assert (CE.fwd_launches.value, CE.bwd_launches.value) == before
    rel_close(nll, jnll, 1e-5)
    rel_close(th.grad, jdh, 1e-5)
    assert not np.asarray(jdw).any() and not tw.grad.any()  # zero by contract


def test_fused_ce_reference_pair_matches_autograd():
    """The plain forward/backward pair against torch autograd of log-softmax CE."""
    rng = np.random.default_rng(6)
    h = torch.tensor(rng.standard_normal((300, 16), dtype=np.float32), requires_grad=True)
    w = torch.tensor(rng.standard_normal((50, 16), dtype=np.float32))
    labels = torch.tensor(rng.integers(0, 50, size=300), dtype=torch.int32)
    g = torch.tensor(rng.standard_normal(300, dtype=np.float32))
    logits = (h @ w.t()) * 0.7
    nll = torch.logsumexp(logits, -1) - logits.gather(1, labels[:, None].long())[:, 0]
    nll.backward(g)
    lse, ours = CE.fused_ce_reference(h.detach(), w, labels, 0.7)
    torch.testing.assert_close(ours, nll.detach(), rtol=1e-5, atol=1e-5)
    dh = CE.fused_ce_bwd_reference(h.detach(), w, labels, lse, g, 0.7) * 0.7
    torch.testing.assert_close(dh, h.grad, rtol=1e-5, atol=1e-5)


def test_resolve_ce_impl_contract():
    with pytest.raises(ValueError, match="frozen vocab table"):
        steps._resolve_ce_impl("fused", table_frozen=False, hidden_size=128)
    with pytest.raises(ValueError, match="128"):
        steps._resolve_ce_impl("fused", table_frozen=True, hidden_size=48)
    assert steps._resolve_ce_impl("auto", True, 1152, on_card=True) == "fused"
    assert steps._resolve_ce_impl("auto", True, 1152, on_card=False) == "chunked"
    assert steps._resolve_ce_impl("auto", False, 1152, on_card=True) == "chunked"
    assert steps._resolve_ce_impl("auto", True, 48, on_card=True) == "chunked"
    assert steps._resolve_ce_impl("fused", True, 1152) == "fused"
