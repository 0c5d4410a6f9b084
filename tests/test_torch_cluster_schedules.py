"""The thread-block cluster schedules of K3 above head dim 512 and of K8 above 19,368
columns (``csrc/decode_attention.cu`` route "cluster", ``csrc/layernorm_bwd.cu``
``layernorm_bwd_cluster_kernel``), emulated in torch fp32 on the CPU as the kernels cut
the work, and held against the JAX package.

K3: the plan's (``ops/decode_attention.py:decode_plan``) row groups and splits; each 32-key
tile's scores as the C slices' partial products over their 256 columns, summed in slice
order; one online softmax for all slices; each slice's P V; each split's partial (m, l,
O slice) combined in split order. Against ``decode_attention`` of the JAX package (its XLA
path, which it takes above 512) at D = 768 and 1024, with a window, ragged prefix padding
and 96 query rows a KV head (row groups).

K8: the plan's (``ops/fused_layernorm.py:bwd_plan``) bands a cluster and slices a CTA; a
row's sum, then its centred squares, sum(g) and sum(g * (x - mean)), each as the slices'
partials summed in slice order; dx a slice at a time; the column sums in row order over a
band, then over the bands in band order. Against ``jax.vjp`` of the JAX package's
``layernorm`` at 20480 and 24577 on a few rows (its XLA path there).

Numpy inputs from a seed, fp32; tolerance: K3 1e-5 absolute and relative, K8 max |error|
within 1e-5 of max |reference| (fp32 sums in another order). Then the plans' cluster
edges: every column in exactly one slice, slices that differ by at most one 16-byte
vector (K8) or are all 256 wide (K3), the cluster size at the reach's edges, shared
memory within the 227 KB a block may use, and the cluster route's least tiles a split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu.ops import decode_attention as JDA
from projectiontrainer_tpu.ops import fused_layernorm as JFLN
from projectiontrainer_tpu_torch.ops import decode_attention as DA
from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN
from projectiontrainer_tpu_torch.ops.attention import NEG_INF

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
REL = 1e-5


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
    cuts = np.cumsum([0] + plan["slices"])
    slices = [slice(lo, hi) for lo, hi in zip(cuts[:-1], cuts[1:])]
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
                    o = [torch.zeros(len(mine), s.stop - s.start) for s in slices]
                    for j0 in range(lo, hi, 32):  # a tile: 32 keys
                        j1 = min(hi, j0 + 32)
                        s = sum(xs[:, sl] @ keys[j0:j1, sl].T for sl in slices) * scale
                        s = s.masked_fill(~live[j0:j1], NEG_INF)
                        m_new = torch.maximum(m, s.max(-1).values)
                        pr = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m_new[:, None]), 0.0)
                        corr = torch.exp(m - m_new)
                        l = l * corr + pr.sum(-1)
                        o = [oc * corr[:, None] + pr @ vals[j0:j1, sl] for oc, sl in zip(o, slices)]
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


# b, nb, hq, hkv, d, p, g, t, window: 768 and 1024 on the cluster route
DECODE_CASES = [
    (2, 3, 4, 2, 768, 70, 12, 7, 40),      # a window, ragged prefix padding
    (2, 3, 4, 1, 1024, 70, 12, 11, None),
    (2, 24, 4, 1, 1024, 40, 8, 5, None),   # 96 query rows a KV head: row groups
    (1, 24, 4, 1, 768, 40, 8, 7, 20),      # ... and a window
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
    if nb * hq // hkv > 64:
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


@pytest.mark.parametrize("d,cluster", [(768, 3), (1024, 4), (1536, 6), (2048, 8), (2304, None),
                                       (4096, None)])
def test_decode_cluster_reach(d, cluster):
    """K3's cluster: D / 256 CTAs, each one 256-column slice, up to 2048; past it the
    column blocks; 64 rows a CTA on the cluster, in shared memory."""
    plan = DA.decode_plan(8, 3, 1, 831, 32, 31, 831, None, 132, n_rep=4, d=d)
    assert plan["col_blocks"] == d // 256
    if cluster is None:
        assert plan["route"] == "column blocks" and "cluster" not in plan
        return
    assert plan["route"] == "cluster" and plan["cluster"] == cluster
    assert plan["slices"] == [256] * cluster and sum(plan["slices"]) == d
    assert DA.max_rows(d) == 64
    for rows in (1, 12, 16, 17, 48, 64):
        assert DA.smem_bytes(d, rows) <= DA.SMEM_LIMIT


def test_decode_cluster_rows():
    """q held at a slice's width: 64 rows a CTA at every D of the cluster, so 96 rows a
    KV head (24 beams of 4 query heads) take two row groups of 48 where the card has few
    SMs to fill; the column blocks hold 8 rows at 4096, so twelve groups there."""
    wide = DA.decode_plan(2, 24, 1, 300, 16, 15, 300, None, 4, n_rep=4, d=1024)
    assert (wide["groups"], wide["beams_per_group"], wide["reps_per_group"]) == (2, 12, 4)
    assert DA.group_shape(4, 24, 4, 4096, 4) == (2, 4)  # column blocks: 8 rows, 12 groups


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
])
def test_decode_cluster_split_floor(case, chunk):
    """On the cluster route a split holds at least ``CLUSTER_MIN_TILES`` tiles where
    splits of one tile would put more CTAs than SMs on the card; elsewhere the plan is
    the one it was."""
    *args, d = case
    plan = DA.decode_plan(*args, 132, n_rep=4, d=d)
    assert plan["chunk"] == chunk
    live_p = args[3] - plan["p_begin"]
    assert plan["p_splits"] == -(-live_p // chunk)
