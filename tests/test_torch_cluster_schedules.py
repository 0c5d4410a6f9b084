"""The thread-block cluster schedules of K4 and K5 above head dim 512, of K3 above 512 and
of K8 above 19,368 columns (``csrc/flash_attn_cluster.cu`` ``cluster_dkv_kernel`` and
``cluster_dq_kernel``, ``csrc/decode_attention.cu`` route "cluster",
``csrc/layernorm_bwd.cu`` ``layernorm_bwd_cluster_kernel``), emulated in torch fp32 on the
CPU as the kernels cut the work, and held against the JAX package.

K4: the plan's (``ops/flash_attention.py:dkv_plan``) 64-row key tiles and, for each query
head of the KV head in turn, the 32-query tiles each visits (``q_tile_range``; past 4096 16
queries and two passes over the output columns), in each pass; each tile's S^T and dP^T as the warpgroups' partial products over their column runs
(their slices of every pass), summed in slice order; P^T = exp2(S^T scale log2(e) - lse log2(e)) on valid pairs, 0 elsewhere; dS^T = P^T
(dP^T - delta) as hi + lo, two bf16 terms; each warpgroup's dV slice of the pass += P^T dO
and dK slice += dS_hi^T Q + dS_lo^T Q (P stays fp32 here: the kernel rounds it once to bf16 as
its A operand, a rounding of the card's bf16 inputs that the card tests hold). K5: the
plan's (``dq_plan``) 64-row query tiles and the 32-key tiles each visits
(``kv_tile_range``); S and dP summed in slice order the same way; dS = P (dP - delta) as
hi + lo; each warpgroup's dQ slice of the pass += dS_hi K + dS_lo K. Both against
``jax.vjp`` of the JAX package's ``flash_attention`` (``interpret=True``) at D = 640 to
8192 (2112: 9 CTAs of uneven slices; 4096: 16, the widest cluster; 4160, 6144 and 8192:
two passes of 16-row tiles, 4160's with one slice of 128 columns), causal with a window,
GQA and ragged key padding.

K3: the plan's (``ops/decode_attention.py:decode_plan``) row groups and splits; each 32-key
tile's scores as the C CTAs' partial products, each CTA's summed over its 256-column
blocks and the CTAs' summed in rank order; one online softmax for all CTAs; each block's
P V; each split's partial (m, l, O slice) combined in split order. Against
``decode_attention`` of the JAX package (its XLA path, which it takes above 512) at D =
768 and 1024 (a block a CTA) and 2304 and 4096 (two blocks a CTA, 2304's last CTA one),
with a window, ragged prefix padding and 96 query rows a KV head (row groups).

K8: the plan's (``ops/fused_layernorm.py:bwd_plan``) bands a cluster and slices a CTA; a
row's sum, then its centred squares, sum(g) and sum(g * (x - mean)), each as the slices'
partials summed in slice order; dx a slice at a time; the column sums in row order over a
band, then over the bands in band order. Against ``jax.vjp`` of the JAX package's
``layernorm`` at 20480 and 24577 on a few rows (its XLA path there).

Numpy inputs from a seed, fp32; tolerance: K4's dV, K5 and K3 1e-5 absolute and relative,
K4's dK and K8 max |error| within 1e-5 of max |reference| (K8: fp32 sums in another order;
K4's dK: dS as hi + lo, see its test). Then the plans'
cluster edges: every column in exactly one slice, slices that differ by at most one
16-byte vector (K8) or one 256-column block (K3), the cluster size at the edges of each
count of blocks a CTA, shared memory within the 227 KB a block may use, and the cluster
route's least tiles a split."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu.ops import decode_attention as JDA
from projectiontrainer_tpu.ops import flash_attention as JFA
from projectiontrainer_tpu.ops import fused_layernorm as JFLN
from projectiontrainer_tpu_torch.ops import decode_attention as DA
from projectiontrainer_tpu_torch.ops import flash_attention as FA
from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN
from projectiontrainer_tpu_torch.ops.attention import NEG_INF

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
REL = 1e-5


def _slices(widths):
    cuts = np.cumsum([0] + list(widths))
    return [slice(int(lo), int(hi)) for lo, hi in zip(cuts[:-1], cuts[1:])]


# ---------------------------------------------------------------------------- K4 and K5


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _backward_inputs(q, k, v, do, *, scale, causal, window, kv_mask):
    """The plain forward's lse [B, Hq, T] and delta = rowsum(dO O) [B, T, Hq] (the forward
    kernel's, on the card), and the valid (query, key) pairs [B, T, T]."""
    b, t = q.shape[:2]
    out, lse = FA.flash_attention_reference(q, k, v, scale=scale, causal=causal,
                                            window=window, kv_mask=kv_mask)
    i = torch.arange(t)
    valid = kv_mask.bool()[:, None, :] if kv_mask is not None else torch.ones(b, 1, t, dtype=bool)
    if causal:
        valid = valid & (i[None, :] <= i[:, None])
    if window:
        valid = valid & (i[:, None] - i[None, :] < window)
    return lse, (do * out).sum(-1), valid.expand(b, t, t)


def _cluster_columns(plan):
    """The plan's columns as the kernel cuts them: each warpgroup's run (its slices of
    every pass), over which it contracts the scores, in slice order g = 2 r + w; and each
    pass's output slices, [pass][g]. A CTA's blocks are its warpgroups' runs in order, a
    run its passes' slices in order (``csrc/flash_attn_cluster.cu:Slices``)."""
    wgs = 2 * plan["cluster"]
    per_pass = [plan["slices"][p * wgs:(p + 1) * wgs] for p in range(plan["passes"])]
    runs, out, pos = [], [[None] * len(per_pass[0]) for _ in per_pass], 0
    for g in range(len(per_pass[0])):
        start = pos
        for p, widths in enumerate(per_pass):
            out[p][g] = slice(pos, pos + widths[g])
            pos += widths[g]
        runs.append(slice(start, pos))
    assert pos == sum(map(sum, per_pass))
    return runs, out


def cluster_dkv(q, k, v, do, *, scale, causal, window, kv_mask):
    """dK and dV as the cluster kernel computes them, in fp32."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    plan = FA.dkv_plan(d)
    assert plan["route"] in ("cluster", "cluster passes")
    rows, queries = plan["bk"], plan["bq"]
    runs, passes = _cluster_columns(plan)
    lse, delta, valid = _backward_inputs(q, k, v, do, scale=scale, causal=causal,
                                         window=window, kv_mask=kv_mask)
    log2e = 1.0 / np.log(2.0)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for bi in range(b):
        for hk in range(hkv):
            for k0 in range(0, t, rows):
                ks = slice(k0, min(t, k0 + rows))
                kk, vv = k[bi, ks, hk], v[bi, ks, hk]
                for slices in passes:  # each pass forms the scores again
                    acc_dk = [torch.zeros(ks.stop - k0, sl.stop - sl.start) for sl in slices]
                    acc_dv = [torch.zeros_like(a) for a in acc_dk]
                    for h in range(hk * n_rep, (hk + 1) * n_rep):  # the KV head's query heads
                        for qt in range(*FA.q_tile_range(k0, rows, queries, t, causal, window)):
                            qs = slice(qt * queries, min(t, qt * queries + queries))
                            qq, dd = q[bi, qs, h], do[bi, qs, h]
                            s = sum(kk[:, sl] @ qq[:, sl].T for sl in runs)  # S^T
                            dp = sum(vv[:, sl] @ dd[:, sl].T for sl in runs)  # dP^T
                            p = torch.exp2(s * (scale * log2e) - lse[bi, h, None, qs] * log2e)
                            p = torch.where(valid[bi, qs, ks].T, p, 0.0)
                            ds = p * (dp - delta[bi, None, qs, h])
                            hi = _bf16(ds)
                            lo = _bf16(ds - hi)
                            acc_dv = [a + p @ dd[:, sl] for a, sl in zip(acc_dv, slices)]
                            acc_dk = [a + hi @ qq[:, sl] + lo @ qq[:, sl]
                                      for a, sl in zip(acc_dk, slices)]
                    for sl, a_dk, a_dv in zip(slices, acc_dk, acc_dv):
                        dk[bi, ks, hk, sl] = a_dk * scale
                        dv[bi, ks, hk, sl] = a_dv
    return dk, dv


def cluster_dq(q, k, v, do, *, scale, causal, window, kv_mask):
    """dQ as the cluster kernel computes it, in fp32, with the plain forward's lse and O
    (the forward kernel's, on the card) for P and delta."""
    b, t, hq, d = q.shape
    n_rep = hq // k.shape[2]
    plan = FA.dq_plan(d)
    assert plan["route"] in ("cluster", "cluster passes")
    rows, keys = plan["bq"], plan["bk"]
    runs, passes = _cluster_columns(plan)
    lse, delta, valid = _backward_inputs(q, k, v, do, scale=scale, causal=causal,
                                         window=window, kv_mask=kv_mask)
    log2e = 1.0 / np.log(2.0)
    dq = torch.zeros_like(q)
    for bi in range(b):
        for h in range(hq):
            hk = h // n_rep
            for q0 in range(0, t, rows):
                qs = slice(q0, min(t, q0 + rows))
                for slices in passes:  # each pass forms the scores again
                    acc = [torch.zeros(qs.stop - q0, sl.stop - sl.start) for sl in slices]
                    for kt in range(*FA.kv_tile_range(q0, rows, keys, t, causal, window)):
                        ks = slice(kt * keys, min(t, kt * keys + keys))
                        kk, vv = k[bi, ks, hk], v[bi, ks, hk]
                        s = sum(q[bi, qs, h, sl] @ kk[:, sl].T for sl in runs)
                        dp = sum(do[bi, qs, h, sl] @ vv[:, sl].T for sl in runs)
                        p = torch.exp2(s * (scale * log2e) - lse[bi, h, qs, None] * log2e)
                        p = torch.where(valid[bi, qs, ks], p, 0.0)
                        ds = p * (dp - delta[bi, qs, h, None])
                        hi = _bf16(ds)
                        lo = _bf16(ds - hi)
                        acc = [a + hi @ kk[:, sl] + lo @ kk[:, sl] for a, sl in zip(acc, slices)]
                    for sl, a in zip(slices, acc):
                        dq[bi, qs, h, sl] = a * scale
    return dq


# b, t, hq, hkv, d, causal, window, ragged key padding
DQ_CASES = [
    (2, 70, 4, 2, 640, True, 40, True),    # GQA, a window, two query tiles, padding
    (1, 70, 4, 1, 1024, True, None, True),
    (1, 40, 2, 1, 2048, False, None, False),  # the widest portable cluster: 8 CTAs
    (1, 40, 4, 2, 2112, True, 24, True),      # 9 CTAs, uneven slices (three of 64 columns)
    (1, 40, 4, 2, 4096, True, 24, True),      # the widest cluster: 16 CTAs
    (1, 40, 4, 2, 4160, True, 24, True),      # two passes of 16-key tiles
    (1, 40, 2, 1, 6144, False, None, True),   # 128 | 64
    (1, 40, 4, 2, 8192, True, 24, True),      # the reach: 128 | 128
]
DKV_CASES = [
    (2, 70, 4, 2, 640, True, 40, True),    # two key tiles, three query tiles a query head
    (1, 40, 4, 2, 2112, True, 24, True),
    (1, 40, 4, 2, 4096, True, 24, True),
    (1, 40, 4, 2, 4160, True, 24, True),   # two passes of 16-query tiles
    (1, 40, 2, 1, 6144, False, None, True),  # 128 | 64
    (1, 40, 4, 2, 8192, True, 24, True),   # the reach: 128 | 128
]


@functools.lru_cache(maxsize=None)
def _case_grads(case):
    """The case's numpy inputs (q, k, v, dO, mask) from its seed and the JAX package's
    (dq, dk, dv): ``jax.vjp`` of its flash attention in interpret mode, once a case."""
    b, t, hq, hkv, d, causal, window, ragged = case
    rng = np.random.default_rng(d + t)
    q, do = (rng.standard_normal((b, t, hq, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, t, hkv, d), dtype=np.float32) for _ in range(2))
    mask = np.ones((b, t), np.int32)
    if ragged:
        for i, n in enumerate(rng.integers(1, t // 3, size=b)):
            mask[i, -n:] = 0  # right padding of varied length
    kw = dict(scale=d ** -0.5, causal=causal, window=window)

    def attend(q_, k_, v_):
        return JFA.flash_attention(q_, k_, v_, kv_mask=jnp.asarray(mask), interpret=True, **kw)

    _, vjp = jax.vjp(attend, *map(jnp.asarray, (q, k, v)))
    return (q, k, v, do, mask), tuple(map(np.asarray, vjp(jnp.asarray(do))))


def _emulated(fn, case):
    (q, k, v, do, mask), grads = _case_grads(case)
    d, causal, window = case[4:7]
    ours = fn(*map(torch.tensor, (q, k, v, do)), kv_mask=torch.tensor(mask),
              scale=d ** -0.5, causal=causal, window=window)
    return ours, grads


@pytest.mark.parametrize("case", DQ_CASES)
def test_cluster_dq_matches_jax(case):
    ours, (theirs, _, _) = _emulated(cluster_dq, case)
    np.testing.assert_allclose(ours.numpy(), theirs, **TOL)


@pytest.mark.parametrize("case", DKV_CASES)
def test_cluster_dkv_matches_jax(case):
    """dV elementwise within 1e-5; dK's max |error| within 1e-5 of max |dK|: dS enters as
    hi + lo, two bf16 terms that keep about 16 of its 24 bits, summed over every query row
    a key sees in each of its query heads, so an element near 0 carries an error of a few
    millionths of max |dK| (1.4e-5 at 4096, max |dK| 4.5; the JAX package's fp32 dK is
    within 4.8e-6 of fp64 there, this schedule's within 1.4e-5)."""
    (dk, dv), (_, jdk, jdv) = _emulated(cluster_dkv, case)
    np.testing.assert_allclose(dv.numpy(), jdv, **TOL)
    assert np.abs(dk.numpy() - jdk).max() <= REL * np.abs(jdk).max()


# ---------------------------------------------------------------------------- K3


def _group_rows(plan, nb, n_rep):
    """Each row group's (beams, reps), in the kernel's order of groups."""
    bpg, rpg = plan["beams_per_group"], plan["reps_per_group"]
    n_rg = -(-n_rep // rpg)
    return [(range(grp // n_rg * bpg, min(nb, grp // n_rg * bpg + bpg)),
             range(grp % n_rg * rpg, min(n_rep, grp % n_rg * rpg + rpg)))
            for grp in range(plan["groups"])]


def cluster_decode(q, kp, vp, kg, vg, *, prefix_mask, t, prefix_len, scale, window, sms=132):
    """Decode attention as the cluster route computes it, in fp32."""
    r, hq, d = q.shape
    b, hkv, p, _ = kp.shape
    g, nb, n_rep = kg.shape[2], r // b, hq // hkv
    plan = DA.decode_plan(b, nb, hkv, p, g, t, prefix_len, window, sms, n_rep=n_rep, d=d)
    assert plan["route"] == "cluster" and sum(plan["slices"]) == d
    # each CTA's 256-column blocks, in rank order
    ctas = [[slice(sl.start + lo, sl.start + lo + 256) for lo in range(0, sl.stop - sl.start, 256)]
            for sl in _slices(plan["slices"])]
    blocks = [blk for cta in ctas for blk in cta]
    c = plan["chunk"]
    out = torch.full((r, hq, d), float("nan"))
    for bi in range(b):
        for h in range(hkv):
            for beams, reps in _group_rows(plan, nb, n_rep):
                rows = [(bm, h * n_rep + rep) for bm in beams for rep in reps]
                x = torch.stack([q[bi * nb + bm, hh] for bm, hh in rows])
                # the group's splits in the kernel's order: the prefix, then each beam's own
                splits = [(None, lo, min(p, lo + c)) for lo in
                          range(plan["p_begin"], plan["p_begin"] + plan["p_splits"] * c, c)]
                splits += [(beam, lo, min(plan["g_end"], lo + c)) for beam in beams for lo in
                           range(plan["g_begin"], plan["g_begin"] + plan["g_splits"] * c, c)]
                parts = []
                for beam, lo, hi in splits:
                    if beam is None:
                        keys, vals = kp[bi, h], vp[bi, h]
                        live = prefix_mask[bi].bool()
                        mine = list(range(len(rows)))
                    else:
                        keys, vals = kg[bi * nb + beam, h], vg[bi * nb + beam, h]
                        live = torch.ones(g, dtype=torch.bool)
                        mine = [i for i, (bm, _) in enumerate(rows) if bm == beam]
                    xs = x[mine]
                    m = torch.full((len(mine),), NEG_INF)
                    l = torch.zeros(len(mine))
                    o = [torch.zeros(len(mine), 256) for _ in blocks]
                    for j0 in range(lo, hi, 32):  # a tile: 32 keys
                        j1 = min(hi, j0 + 32)
                        s = sum(sum(xs[:, blk] @ keys[j0:j1, blk].T for blk in cta)
                                for cta in ctas) * scale
                        s = s.masked_fill(~live[j0:j1], NEG_INF)
                        m_new = torch.maximum(m, s.max(-1).values)
                        pr = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m_new[:, None]), 0.0)
                        corr = torch.exp(m - m_new)
                        l = l * corr + pr.sum(-1)
                        o = [oc * corr[:, None] + pr @ vals[j0:j1, blk] for oc, blk in zip(o, blocks)]
                        m = m_new
                    parts.append((mine, m, l, torch.cat(o, -1)))
                # the combine of each row over its covering splits, in split order
                for i, (bm, hh) in enumerate(rows):
                    cover = [(pm[pos], pl[pos], po[pos]) for mine, pm, pl, po in parts
                             for pos, row in enumerate(mine) if row == i]
                    mt = max(mc for mc, _, _ in cover)
                    lt = sum(lc * torch.exp(mc - mt) for mc, lc, _ in cover)
                    ot = sum(torch.exp(mc - mt) * oc for mc, _, oc in cover)
                    out[bi * nb + bm, hh] = ot / lt
    return out, plan


# b, nb, hq, hkv, d, p, g, t, window: 768 and 1024 (a block a CTA), 2304 and 4096 (two)
DECODE_CASES = [
    (2, 3, 4, 2, 768, 70, 12, 7, 40),      # a window, ragged prefix padding
    (2, 3, 4, 1, 1024, 70, 12, 11, None),
    (2, 24, 4, 1, 1024, 40, 8, 5, None),   # 96 query rows a KV head: row groups
    (1, 24, 4, 1, 768, 40, 8, 7, 20),      # ... and a window
    (2, 3, 4, 1, 2304, 70, 12, 7, 40),     # 5 CTAs of 2, 2, 2, 2, 1 blocks, a window
    (2, 3, 4, 2, 4096, 70, 12, 11, None),  # 8 CTAs of 2
    (1, 12, 4, 1, 4096, 40, 8, 5, 20),     # 48 rows a KV head: row groups of 32 at most
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_cluster_decode_matches_xla(case):
    b, nb, hq, hkv, d, p, g, t, window = case
    rng = np.random.default_rng(d + nb)
    q = rng.standard_normal((b * nb, hq, d), dtype=np.float32)
    kp, vp = (rng.standard_normal((b, hkv, p, d), dtype=np.float32) for _ in range(2))
    kg, vg = (rng.standard_normal((b * nb, hkv, g, d), dtype=np.float32) for _ in range(2))
    pm = np.ones((b, p), np.int32)
    for i, n in enumerate(rng.integers(1, p // 2, size=b)):
        pm[i, :n] = 0  # ragged left padding
    kw = dict(t=t, prefix_len=p, scale=d ** -0.5, window=window)
    ours, plan = cluster_decode(*map(torch.tensor, (q, kp, vp, kg, vg)),
                                prefix_mask=torch.tensor(pm), **kw)
    if nb * hq // hkv > DA.max_rows(d):
        assert plan["groups"] > 1
    theirs = JDA.decode_attention(*map(jnp.asarray, (q, kp, vp, kg, vg)),
                                  prefix_mask=jnp.asarray(pm), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


# ---------------------------------------------------------------------------- K8


def cluster_layernorm_bwd(x, dy, scale, eps, plan):
    """(dx, dscale, dbias) of rows [N, D] as the cluster kernel computes them, in fp32."""
    n, d = x.shape
    assert plan["route"] == "cluster" and sum(plan["slices"]) == d
    cuts = np.cumsum([0] + plan["slices"])
    slices = [slice(lo, hi) for lo, hi in zip(cuts[:-1], cuts[1:])]
    dx = torch.empty_like(x)
    bands = FLN.bwd_bands(n, FLN.band_count(plan))
    part = torch.zeros(len(bands), 2, d)
    for k, (row0, count) in enumerate(bands):
        for row in range(row0, row0 + count):
            xr, g = x[row], dy[row] * scale
            mean = sum(xr[sl].sum() for sl in slices) / d
            xc = xr - mean
            sq, sgs, sgx = (sum(v[sl].sum() for sl in slices)
                            for v in (xc * xc, g, g * xc))
            rstd = torch.rsqrt(sq / d + eps)
            gm, gxm = sgs / d, rstd * sgx / d
            dx[row] = torch.cat([rstd * (g[sl] - gm - xc[sl] * rstd * gxm) for sl in slices])
            part[k, 0] += dy[row] * (xc * rstd)
            part[k, 1] += dy[row]
    sums = part[0].clone()
    for k in range(1, len(bands)):
        sums += part[k]
    return dx, sums[0], sums[1]


@pytest.mark.parametrize("n,d", [(6, 20480), (5, 24577)])
def test_cluster_layernorm_bwd_matches_jax(n, d):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((n, d)) * 2.0 + 0.3).astype(np.float32)
    scale = (rng.standard_normal(d) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(d) * 0.1).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    plan = FLN.bwd_plan(n, d, 132, 4, clusters=2)  # two bands: rows and bands both summed
    assert plan["bands"] == 2
    ours = cluster_layernorm_bwd(*map(torch.tensor, (x, dy, scale)), 1e-6, plan)

    def ln(x_, s_, b_):
        return JFLN.layernorm({"scale": s_, "bias": b_}, x_, eps=1e-6)

    _, vjp = jax.vjp(ln, *map(jnp.asarray, (x, scale, bias)))
    jdx, jds, jdb = vjp(jnp.asarray(dy))
    for a, b in zip(ours, (jdx, jds, jdb)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= REL * np.abs(b).max()


# ---------------------------------------------------------------------------- plans


@pytest.mark.parametrize("d,cluster,blocks", [
    (768, 3, [1] * 3), (1024, 4, [1] * 4), (1536, 6, [1] * 6), (2048, 8, [1] * 8),
    (2304, 5, [2, 2, 2, 2, 1]), (4096, 8, [2] * 8), (4352, 6, [3, 3, 3, 3, 3, 2]),
    (6144, 8, [3] * 8), (6400, 7, [4, 4, 4, 4, 3, 3, 3])])
def test_decode_cluster_reach(d, cluster, blocks):
    """K3's one route above 512: the d / 256 blocks dealt over at most 8 CTAs, at most
    ceil(d / 2048) a CTA in as few CTAs as that takes, counts that differ by at most one and
    the widest first; q and O at the CTA's width: 64 rows a CTA up to 2048, 32 to 6144, 16
    past it, in shared memory."""
    plan = DA.decode_plan(8, 3, 1, 831, 32, 31, 831, None, 132, n_rep=4, d=d)
    assert plan["route"] == "cluster" and plan["cluster"] == cluster == DA.cluster_size(d)
    assert plan["slices"] == [256 * n for n in blocks] and sum(plan["slices"]) == d
    assert max(blocks) == -(-d // 2048) and max(blocks) - min(blocks) <= 1
    rows = DA.max_rows(d)
    assert rows == (64 if d <= 2048 else 32 if d <= 6144 else 16)
    for r in (1, 8, 9, 12, 16, 17, 32, 48, 64):
        assert r > rows or DA.smem_bytes(d, r) <= DA.SMEM_LIMIT
    assert DA.smem_bytes(d, 2 * rows) > DA.SMEM_LIMIT


@pytest.mark.parametrize("d", [2304, 4096, 4352, 6144])
def test_decode_cluster_shared_memory(d):
    """The cluster CTA's shared memory, term by term as csrc/decode_attention.cu lays it
    out at the plan's rows (the ring of 4 blocks of K or V, q in bf16 and O in fp32 at the
    widest CTA's width, the scores, the exchange, the statistics), within 227 KB and over
    it at twice the rows."""
    rows, widest = DA.max_rows(d), max(DA.cluster_slices(d)) // 256
    q_rows = 8 if rows <= 8 else -(-rows // 16) * 16
    want = (4 * 32 * 264 * 2 + widest * q_rows * 264 * 2 + widest * rows * 256 * 4
            + rows * 32 * 4 + DA.exchange_bytes(rows, DA.cluster_size(d)) + rows * 12)
    assert DA.smem_bytes(d, rows) == want <= DA.SMEM_LIMIT < DA.smem_bytes(d, 2 * rows)


def test_decode_cluster_rows():
    """q and O held at the CTA's width: 64 rows a CTA up to 2048, so 96 rows a KV head (24
    beams of 4 query heads) take two row groups of 48 where the card has few SMs to fill;
    32 rows at 4096, so groups of at most 32 there; one row fits at widths the column
    blocks took (41,216), the q rows of a split of 8 or fewer held as 8."""
    wide = DA.decode_plan(2, 24, 1, 300, 16, 15, 300, None, 4, n_rep=4, d=1024)
    assert (wide["groups"], wide["beams_per_group"], wide["reps_per_group"]) == (2, 12, 4)
    assert DA.group_shape(4, 24, 4, 4096, 4) == (8, 4)  # 32 rows: 3 groups of 8 beams
    assert DA.max_rows(41216) >= 1 and DA.smem_bytes(41216, 1) <= DA.SMEM_LIMIT


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", [19369, 20480, 24577, 28000, 32768])
def test_layernorm_cluster_slices(d, itemsize):
    """K8's cluster: C = ceil(D / 4096) CTAs (5 at 20480, 8 at 32768), every column in
    exactly one slice, slices of whole 16-byte vectors differing by at most one vector
    (the last may end short at D), none wider than 4096 columns (the column sums in
    registers), shared memory within 227 KB."""
    plan = FLN.bwd_plan(4096, d, 132, itemsize)
    vec = 16 // itemsize
    assert plan["route"] == "cluster" and plan["cluster"] == -(-d // 4096)
    widths = plan["slices"]
    assert len(widths) == plan["cluster"] and sum(widths) == d
    assert all(w % vec == 0 for w in widths[:-1]) and max(widths) <= 4096
    vectors = [-(-w // vec) for w in widths]
    assert max(vectors) - min(vectors) <= 1
    assert plan["smem_bytes"] == FLN.bwd_cluster_smem(d, itemsize, plan["cluster"], plan["slots"])
    assert plan["smem_bytes"] <= FLN.SMEM_LIMIT
    assert FLN.bwd_cluster_smem(d, itemsize, plan["cluster"], plan["slots"] + 1) > FLN.SMEM_LIMIT \
        or plan["slots"] == FLN.BWD_CLUSTER_SLOTS
    assert plan["ctas"] == plan["bands"] * plan["cluster"] <= 132


@pytest.mark.parametrize("d,cluster", [(20480, 5), (24577, 7), (32768, 8), (32769, None),
                                       (40000, None)])
def test_layernorm_cluster_reach(d, cluster):
    """Up to 8 x 4096 columns a row is cut over a cluster; wider rows stream."""
    plan = FLN.bwd_plan(300, d, 132)
    if cluster is None:
        assert plan["route"] == "streamed" and plan["stages"] == 0
    else:
        assert plan["route"] == "cluster" and plan["cluster"] == cluster


@pytest.mark.parametrize("case,chunk", [
    ((2, 3, 1, 703, 16, 15, 703, 512, 1024), 64),   # leg 6b's decode: 152 CTAs at one tile
    ((2, 3, 1, 300, 16, 15, 300, 100, 2048), 32),   # 96 CTAs at one tile: the card not full
    ((8, 3, 1, 831, 32, 31, 831, None, 1024), 224),  # phase 2's: several tiles already
    ((2, 3, 1, 703, 16, 15, 703, 512, 512), 32),    # at 512 and below, no floor
    ((2, 3, 1, 300, 16, 15, 300, None, 2304), 64),  # 130 CTAs in clusters of 5: 120 a wave
    ((2, 3, 1, 150, 16, 15, 150, None, 2304), 32),  # 80 CTAs: inside a wave
    ((2, 3, 1, 300, 16, 15, 300, 100, 4096), 32),   # 96 CTAs in clusters of 8: 128 a wave
    ((2, 3, 1, 300, 16, 15, 300, None, 4096), 64),  # 208 CTAs at one tile
])
def test_decode_cluster_split_floor(case, chunk):
    """On the cluster route a split holds at least ``CLUSTER_MIN_TILES`` tiles where
    splits of one tile would put more CTAs on the card than one wave holds
    (``cluster_wave``); elsewhere the plan is the one it was."""
    *args, d = case
    plan = DA.decode_plan(*args, 132, n_rep=4, d=d)
    assert plan["chunk"] == chunk
    live_p = args[3] - plan["p_begin"]
    assert plan["p_splits"] == -(-live_p // chunk)


@pytest.mark.parametrize("cluster,wave", [(1, 128), (3, 120), (4, 128), (5, 120), (8, 128)])
def test_decode_cluster_wave(cluster, wave):
    """A wave of K3's clusters at a CTA an SM: whole clusters inside each of the 8 GPCs of
    16 SMs that 132 SMs give, never more CTAs than SMs."""
    assert DA.cluster_wave(cluster, 132) == wave <= 132
