"""Head dims the attention kernels do not take: the port zero-pads them on the card to
the next width a kernel takes (``ops/flash_attention.py:flash_attention_padded``,
``ops/decode_attention.py:decode_attention_padded``), as the JAX package pads inside its
flash kernel. Above 512 the wide kernels take every multiple of 64 (flash) and of 256
(decode); nothing raises.

The pad helpers, run here through the plain versions at the padded width, against the
JAX package's ``flash_attention`` in interpret mode (forward and the three gradients)
and its ``decode_attention`` (the XLA path, which it takes at these dims), fp32, the
same numpy inputs, at D = 32, 80, 96, 100, at 288, 320, 384 (padded to 512) and 512
itself, and at 576, 640 and 1024 (the wide kernels' widths; decode pads 576 and 640 to
768); tolerance 1e-5 absolute and relative. Then the card's branch on meta tensors
(which stand for the card in the budget's trace): a head dim outside the kernels' set
goes through the pad (320 and 600 too), 512 and the multiples of 64 above it go
straight to the kernels, 513 is padded to 576. The plans above 512: K1 on the cluster
kernel up to 4096, K4 and K5 up to 8192 (two passes over the output columns past 4096),
past that on the column blocks; K3 on a cluster at every width, more than one 256-column
block a CTA past 2048. The plain backward (the CPU's K4 and K5) against the JAX package's
at head dims past 4096, where the card runs the two passes."""

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
DIMS = (32, 80, 96, 100, 288, 320, 384, 512, 576, 640, 1024)
CASES = {
    "tower": dict(hq=4, hkv=4, causal=False, window=None, pad=False),
    "decoder": dict(hq=4, hkv=2, causal=True, window=16, pad=True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", DIMS)
def test_padded_flash_matches_pallas(d, case):
    c = CASES[case]
    rng = np.random.default_rng(d)
    b, t = 2, 40 if d <= 512 else 24  # above 512: fewer rows, for the file's time
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
    assert FA.takes_head_dim(width) and width >= d

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


@pytest.mark.parametrize("d", [576, 640, 1024])
def test_merged_matches_pallas_above_512(d):
    """``flash_attention_merged`` on head-merged [B, T, H*D] tensors (views of the same
    storage, padded like any other above 512) against the JAX package's flash attention
    on the [B, T, H, D] view, forward and gradients, GQA 4/2."""
    rng = np.random.default_rng(20 + d)
    b, t = 2, 16
    q = rng.standard_normal((b, t, 4 * d), dtype=np.float32)
    k, v = (rng.standard_normal((b, t, 2 * d), dtype=np.float32) for _ in range(2))
    w = rng.standard_normal((b, t, 4 * d), dtype=np.float32)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = FA.flash_attention_merged(qt, kt, vt, heads=4, kv_heads=2)
    assert out.shape == (b, t, 4 * d)
    (out * torch.tensor(w)).sum().backward()

    def attend(q_, k_, v_):
        o = JFA.flash_attention(q_.reshape(b, t, 4, d), k_.reshape(b, t, 2, d),
                                v_.reshape(b, t, 2, d), interpret=True)
        return o.reshape(b, t, -1)

    theirs, vjp = jax.vjp(attend, *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(theirs), **TOL)
    grads = vjp(jnp.asarray(w))
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
    """Up to 512 the next kernel width; above it the next multiple of 64 (flash) or of
    256 (decode), where 513 used to raise."""
    assert [FA.padded_head_dim(d) for d in (1, 64, 65, 72, 73, 128, 200, 256, 257, 320, 512)] == [
        64, 64, 72, 72, 128, 128, 256, 256, 512, 512, 512]
    assert [FA.padded_head_dim(d, DA.HEAD_DIMS) for d in (32, 72, 96, 129, 288)] == [
        64, 128, 128, 256, 512]
    assert [FA.padded_head_dim(d) for d in (513, 576, 600, 640, 1000, 1024)] == [
        576, 576, 640, 640, 1024, 1024]
    assert [DA.padded_width(d) for d in (96, 513, 576, 640, 768, 1000, 1024)] == [
        128, 768, 768, 768, 768, 1024, 1024]
    assert all(FA.takes_head_dim(d) for d in (576, 640, 1024, 4096))
    assert not any(FA.takes_head_dim(d) for d in (80, 513, 600))
    assert DA.takes_head_dim(1024) and not DA.takes_head_dim(640)


def test_card_branch_pads_on_meta_tensors():
    """Meta tensors take the kernels' branch (the budget's stand-in for the card): a
    head dim outside the kernels' set is padded there (320 to 512, 600 to 640), 512 and
    the wide kernels' widths run as they are, the merged layout too, and the shapes that
    come back are the caller's; nothing is launched; 513, which used to raise, is padded
    to 576."""
    before = (FA.launches.value, FA.bwd_dkv_launches.value, FA.bwd_dq_launches.value)
    for d in (32, 80, 96, 100, 320, 512, 576, 600, 1024):
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
    out, lse = FA.flash_attention(big, big, big)
    assert out.shape == big.shape and lse.shape == (1, 2, 8)
    assert FA.dq_plan(FA.padded_head_dim(513))["slices"] == [128, 64, 128, 64, 128, 64]
    assert FA.forward_plan(FA.padded_head_dim(513))["slices"] == [192, 128, 128, 128]


@pytest.mark.parametrize("d,blocks", [(576, 5), (640, 5), (1024, 8), (4096, 32), (4160, 33),
                                      (6144, 48), (8192, 64), (8256, 65)])
def test_wide_plans(d, blocks):
    """The plans above 512: K1's clusters up to 4096 and their column blocks past it
    (4160: 64-row tiles over 128-column blocks, the last of 64, the scores over 64-column
    chunks); K4's and K5's clusters up to 4096 (16 CTAs there), two passes over the output
    columns on 16 CTAs from 4160 to 8192 (16 rows a ring stage),
    the column blocks past 8192; the same tile ranges as the kernels'."""
    fwd, dkv, dq = FA.forward_plan(d), FA.dkv_plan(d), FA.dq_plan(d)
    column_blocks = {"col_block": 128, "col_blocks": blocks, "chunk": 64}
    if d > FA.REACH["fwd"]:
        assert fwd == {"route": "column blocks", "bq": 64, "bk": 64, **column_blocks}
    else:
        assert fwd["route"] == "cluster" and sum(fwd["slices"]) == d
        assert {k: fwd[k] for k in ("bq", "bk")} == {"bq": 64, "bk": 32}
    if d <= 4096:
        assert dkv["route"] == "cluster" and sum(dkv["slices"]) == d
        assert {k: dkv[k] for k in ("bk", "bq")} == {"bk": 64, "bq": 32}
        assert dq["route"] == "cluster" and dq["slices"] == dkv["slices"]
        assert {k: dq[k] for k in ("bq", "bk")} == {"bq": 64, "bk": 32}
    elif d <= FA.REACH["dkv"]:
        ring = 16
        assert dkv["route"] == dq["route"] == "cluster passes"
        assert dkv["passes"] == dq["passes"] == 2 and dkv["cluster"] == dq["cluster"] == 16
        assert sum(dkv["slices"]) == d and dq["slices"] == dkv["slices"]
        assert {k: dkv[k] for k in ("bk", "bq")} == {"bk": 64, "bq": ring}
        assert {k: dq[k] for k in ("bq", "bk")} == {"bq": 64, "bk": ring}
    else:
        assert dkv == {"route": "column blocks", "bk": 64, "bq": 64, **column_blocks}
        assert dq == {"route": "column blocks", "bq": 64, "bk": 64, **column_blocks}
    assert FA.kv_tile_range(128, 64, 64, 1024, True, 512) == (0, 3)
    assert FA.q_tile_range(128, 64, 64, 1024, True, 512) == (2, 11)
    for bad in (520, 600):
        with pytest.raises(ValueError, match="multiple of 64"):
            FA.forward_plan(bad)


@pytest.mark.parametrize("d", [4160, 6144, 8192])
def test_plain_backward_past_4096_matches_pallas(d):
    """The plain K4 and K5 (``flash_attention_bwd_reference``, what the CPU runs where the
    card runs the two-pass cluster kernels) against the JAX package's backward (its Pallas
    kernels in interpret mode) at head dims past 4096: T = 16, GQA 2/1, causal with a
    window of 5, the second row's last 4 keys padded; fp32, 1e-4."""
    rng = np.random.default_rng(30 + d // 64)
    b, t, hq, hkv = 2, 16, 2, 1
    q = rng.standard_normal((b, t, hq, d), dtype=np.float32)
    k, v = (rng.standard_normal((b, t, hkv, d), dtype=np.float32) for _ in range(2))
    do = rng.standard_normal((b, t, hq, d), dtype=np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, t - 4:] = 0
    kw = dict(causal=True, window=5)
    tq, tk, tv, tm = (torch.tensor(x) for x in (q, k, v, mask))
    out, lse = FA.flash_attention_reference(tq, tk, tv, kv_mask=tm, scale=d ** -0.5, **kw)
    ours = FA.flash_attention_bwd_reference(tq, tk, tv, tm, out, lse, torch.tensor(do),
                                            scale=d ** -0.5, **kw)

    def attend(q_, k_, v_):
        return JFA.flash_attention(q_, k_, v_, kv_mask=jnp.asarray(mask), interpret=True, **kw)

    theirs, vjp = jax.vjp(attend, *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-4)
    for name, mine, g in zip("qkv", ours, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(mine.numpy(), np.asarray(g), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("d,rows,cluster,groups,slices", [
    (768, 64, 3, 1, [256] * 3), (1024, 64, 4, 1, [256] * 4), (2048, 64, 8, 1, [256] * 8),
    (2304, 32, 5, 1, [512] * 4 + [256]), (4096, 32, 8, 1, [512] * 8),
    (4352, 32, 6, 1, [768] * 5 + [512])])
def test_wide_decode_plan(d, rows, cluster, groups, slices):
    """K3 above 512: one route, a split on a cluster whose CTAs hold 256-column blocks,
    one each up to 2048 and ceil(d / 2048) at most past it (q and O held at the CTA's
    width: 64 rows a CTA up to 2048, 32 past it); more rows a KV head in row groups."""
    assert DA.max_rows(d) == rows and DA.smem_bytes(d, rows) <= DA.SMEM_LIMIT
    assert DA.smem_bytes(d, 2 * rows) > DA.SMEM_LIMIT
    plan = DA.decode_plan(8, 3, 1, 831, 32, 31, 831, None, 132, n_rep=4, d=d)
    assert plan["route"] == "cluster" and plan["groups"] == groups
    assert plan["cluster"] == cluster == DA.cluster_size(d) and plan["slices"] == slices
    assert plan["ctas"] == cluster * 8 * (groups * plan["p_splits"] + 3 * plan["g_splits"])
    assert plan["chunk"] % DA.TILE_KEYS == 0 and plan["ctas"] > 8
    grouped = DA.decode_plan(2, 24, 1, 300, 16, 15, 300, None, 132, n_rep=4, d=d)
    assert grouped["beams_per_group"] * grouped["reps_per_group"] <= rows
    assert grouped["groups"] == -(-24 // grouped["beams_per_group"])
