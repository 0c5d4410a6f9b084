"""What the flash-attention launches decide on the host (``ops/flash_attention.py``): the
tiles of each kernel by head dim, the K/V tiles a query tile visits and the query tiles a
key tile visits under the causal mask and the window, and the tensor map of a strided
[B, T, H, D] tensor. The tile ranges are held against the valid mask of the plain
attention (``ops/attention.py:attention_probs``): every live (query, key) pair lies in a
visited tile, and a tile that is skipped holds none. The kernels compute the same bounds
on the card (``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd.cu``). Above head dim 512:
the cluster kernels' plans (``csrc/flash_attn_cluster.cu``: column slices, cluster size,
passes over the output columns, ring tile and stages and shared memory of K1, K4 and K5)
up to their reach, the column blocks past it."""

import pytest
import torch

from projectiontrainer_tpu_torch.ops import flash_attention as FA
from projectiontrainer_tpu_torch.ops.attention import attention_probs

LENGTHS = [1, 63, 64, 150, 576, 831, 1087]
WINDOWS = [None, 37, 512]


def _valid(t, causal, window):
    """Bool [T, T]: may query i see key j (no padding: a padding mask only removes pairs)."""
    x = torch.zeros((1, t, 1, 8))
    return attention_probs(x, x, scale=1.0, causal=causal, window=window)[1][0, 0]


def _tile_has_pair(valid, q0, bq, k0, bk):
    return bool(valid[q0:q0 + bq, k0:k0 + bk].any())


# K1's stages: 64 keys at D = 256 (128 rows a CTA), 32 at 512 (64 rows), else 128
@pytest.mark.parametrize("bk", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("t", LENGTHS)
def test_kv_tile_range_holds_every_live_pair(t, window, causal, bk):
    valid = _valid(t, causal, window)
    d = {128: 64, 64: 256, 32: 512}[bk]
    bq = FA.forward_plan(d)["bq"]
    assert FA.forward_plan(d)["bk"] == bk
    n_kv_tiles = -(-t // bk)
    for q0 in range(0, t, bq):
        begin, end = FA.kv_tile_range(q0, bq, bk, t, causal, window)
        assert 0 <= begin < end <= n_kv_tiles
        for kt in range(n_kv_tiles):
            if not begin <= kt < end:
                assert not _tile_has_pair(valid, q0, bq, kt * bk, bk), (q0, kt)
        # the range is tight at both ends: its first and last tile hold a live pair
        assert _tile_has_pair(valid, q0, bq, begin * bk, bk)
        assert _tile_has_pair(valid, q0, bq, (end - 1) * bk, bk)


# K5's tiles: 128 queries, stages of 64 keys (32 at 256); 64 queries and 32 keys at 512;
# 64 queries and 16 keys on the cluster's two passes above 4096
@pytest.mark.parametrize("d", [64, 256, 512, 8192])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("t", LENGTHS)
def test_kv_tile_range_holds_every_live_pair_at_dq_tiles(t, window, causal, d):
    valid = _valid(t, causal, window)
    bq, bk = FA.dq_plan(d)["bq"], FA.dq_plan(d)["bk"]
    n_kv_tiles = -(-t // bk)
    for q0 in range(0, t, bq):
        begin, end = FA.kv_tile_range(q0, bq, bk, t, causal, window)
        assert 0 <= begin < end <= n_kv_tiles
        for kt in range(n_kv_tiles):
            if not begin <= kt < end:
                assert not _tile_has_pair(valid, q0, bq, kt * bk, bk), (q0, kt)
        assert _tile_has_pair(valid, q0, bq, begin * bk, bk)
        assert _tile_has_pair(valid, q0, bq, (end - 1) * bk, bk)
        # each warpgroup's 64 queries: the tiles it skips inside the range hold no pair
        for wq0 in range(q0, min(t, q0 + bq), 64):
            for kt in range(begin, end):
                k0 = kt * bk
                outside = (causal and k0 > wq0 + 63) or (
                    window is not None and k0 + bk - 1 <= wq0 - window)
                if outside:
                    assert not _tile_has_pair(valid, wq0, 64, k0, bk), (wq0, kt)


# K4's tiles at D <= 72, at D = 128 and at D = 256 (and on the clusters up to 4096), and on
# the cluster's two passes above 4096
@pytest.mark.parametrize("bk,bq", [(128, 64), (128, 32), (64, 32), (64, 16)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("t", LENGTHS)
def test_q_tile_range_holds_every_live_pair(t, window, causal, bk, bq):
    valid = _valid(t, causal, window)
    n_q_tiles = -(-t // bq)
    for k0 in range(0, t, bk):
        begin, end = FA.q_tile_range(k0, bk, bq, t, causal, window)
        assert 0 <= begin < end <= n_q_tiles
        for qt in range(n_q_tiles):
            if not begin <= qt < end:
                assert not _tile_has_pair(valid, qt * bq, bq, k0, bk), (k0, qt)
        assert _tile_has_pair(valid, begin * bq, bq, k0, bk)
        assert _tile_has_pair(valid, (end - 1) * bq, bq, k0, bk)


@pytest.mark.parametrize("d,fwd,dkv,dq", [
    (64, {"bq": 128, "bk": 128}, {"bk": 128, "bq": 64}, {"bq": 128, "bk": 64}),
    (72, {"bq": 128, "bk": 128}, {"bk": 128, "bq": 64}, {"bq": 128, "bk": 64}),
    (128, {"bq": 128, "bk": 128}, {"bk": 128, "bq": 32}, {"bq": 128, "bk": 64}),
    (256, {"bq": 128, "bk": 64}, {"bk": 64, "bq": 32}, {"bq": 128, "bk": 32}),
    (512, {"bq": 64, "bk": 32}, {"bk": 64, "bq": 32}, {"bq": 64, "bk": 32}),
])
def test_kernel_and_tiles_by_head_dim(d, fwd, dkv, dq):
    assert FA.forward_plan(d) == fwd
    assert FA.dkv_plan(d) == dkv
    assert FA.dq_plan(d) == dq


@pytest.mark.parametrize("d", [0, 32, 80, 96, 1024, 1000])  # 512 is a kernel's width
def test_plans_refuse_other_head_dims(d):
    """Head dims no kernel takes raise (the wrappers pad them first); a multiple of 64
    above 512, which used to raise, is the cluster kernels' for K1, K4 and K5 (within
    their reach)."""
    if FA.takes_head_dim(d):
        for plan in (FA.forward_plan(d), FA.dkv_plan(d), FA.dq_plan(d)):
            assert plan["route"] == "cluster" and sum(plan["slices"]) == d
        return
    with pytest.raises(ValueError):
        FA.forward_plan(d)
    with pytest.raises(ValueError):
        FA.dkv_plan(d)
    with pytest.raises(ValueError):
        FA.dq_plan(d)


def _read_through_plan(x, plan):
    """The [B, T, H, D] tensor that the map's dims and strides describe over x's storage."""
    d, t, h, b = plan[:4]
    st, sh, sb = (n // 2 for n in plan[4:7])  # byte strides of bf16 elements
    return torch.as_strided(x, (b, t, h, d), (sb, st, sh, 1), x.storage_offset())


def _layouts():
    base = torch.arange(2 * 150 * 12 * 72, dtype=torch.float32).to(torch.bfloat16)
    dense = base.view(2, 150, 12, 72)
    fused = base.view(2, 150, 12 * 72)
    q, k, v = (x.view(2, 150, -1, 72) for x in fused.split([8 * 72, 2 * 72, 2 * 72], dim=-1))
    return {
        "dense": dense,
        "merged": FA._split_heads(base.view(2, 150, 12 * 72), 12),
        "sliced_q": q, "sliced_k": k, "sliced_v": v,
        "heads_sliced": dense[:, :, 4:8],
        "rows_sliced": dense[:, 10:74],
        "one_row": dense[:, :1],
        "one_head": dense[:, :, 5:6],
        "one_batch": dense[1:],
        "transposed": base.view(2, 12, 150, 72).transpose(1, 2),
    }


@pytest.mark.parametrize("name", sorted(_layouts()))
@pytest.mark.parametrize("box_rows", [32, 64, 128])
def test_tensor_map_plan_describes_the_tensor(name, box_rows):
    x = _layouts()[name]
    plan = FA.tensor_map_plan(x, box_rows)
    b, t, h, d = x.shape
    assert plan[:4] == [d, t, h, b]                       # D innermost, a dimension of its own
    assert plan[7:] == [64, box_rows, 1, 1]               # one 128-byte row of 64 bf16 a box row
    assert all(s > 0 and s % 16 == 0 for s in plan[4:7])  # what the TMA unit demands
    assert torch.equal(_read_through_plan(x, plan), x)


def test_tensor_map_plan_head_dim_64_box():
    x = torch.zeros((2, 5, 3, 64), dtype=torch.bfloat16)
    assert FA.tensor_map_plan(x, 128) == [64, 5, 3, 2, 2 * 192, 2 * 64, 2 * 960, 64, 128, 1, 1]


def _layout_bytes(d, cluster, stages, kind, tile=32, passes=1):
    """csrc/flash_attn_cluster.cu:Layout's request, term by term: the resident operands of
    CTA 0 (the widest: its slices of every pass) of 64 rows, the ring's stages of two
    ``tile``-row operands at its width, the 2C warpgroups' pieces of ceil(chunks / C)
    16-byte chunks and the whole sum (K1 one tensor of 64 x tile fp32, K4 and K5 two), K4's
    per-stage query statistics, 13 barriers and 1 KB to align the base."""
    widest = sum(s[0] + s[1] for s in FA.pass_slices(d, cluster, passes)) // 64
    tensors = 1 if kind == "fwd" else 2
    chunks = tensors * 64 * tile // 4
    return (tensors * widest * 64 * 128 + stages * 2 * widest * tile * 128
            + 16 * (2 * cluster * -(-chunks // cluster) + chunks)
            + (stages * 2 * tile * 4 if kind == "dkv" else 0) + 8 * 13 + 1024)


def _ring(plan, kind):
    return plan["bq" if kind == "dkv" else "bk"]


def _check_cluster_plan(plan, d, kind):
    width = FA.SLICE[kind]
    rows = "bk" if kind == "dkv" else "bq"
    passes = -(-d // FA.PASS_COLUMNS[kind])  # each score formed once a pass
    assert plan["route"] == ("cluster" if passes == 1 else "cluster passes")
    assert plan[rows] == 64 and plan["passes"] == passes <= FA.MAX_PASSES[kind]
    assert 2 <= plan["cluster"] <= FA.MAX_CLUSTER[kind]
    flat, wgs = plan["slices"], 2 * plan["cluster"]
    assert len(flat) == passes * wgs and flat == sum(FA.pass_slices(d, plan["cluster"],
                                                                    passes), [])
    slices = [flat[p * wgs:(p + 1) * wgs] for p in range(passes)]  # pass 0's first
    # whole 64-column TMA boxes, covering d once, at most a warpgroup's width each a pass
    assert sum(flat) == d and all(x % 64 == 0 and 64 <= x <= width for x in flat)
    # the fewest CTAs that hold d in one pass; in two, the widest cluster
    assert plan["cluster"] == (-(-d // (2 * width)) if passes == 1 else FA.MAX_CLUSTER[kind])
    ctas = [sum(s[g] + s[g + 1] for s in slices) for g in range(0, 2 * plan["cluster"], 2)]
    assert max(ctas) - min(ctas) <= 64 and ctas[0] == max(ctas)  # CTA 0 the widest
    # a ring of 32 rows in one pass, of 16 in two; as many stages as fit, at most 4
    tile = _ring(plan, kind)
    assert tile == (32 if passes == 1 else 16)
    assert 2 <= plan["stages"] <= FA.MAX_STAGES and plan["smem"] <= FA.SMEM_LIMIT
    assert plan["smem"] == FA.cluster_smem(d, plan["cluster"], plan["stages"], kind, tile,
                                           passes)
    assert plan["smem"] == _layout_bytes(d, plan["cluster"], plan["stages"], kind, tile, passes)
    assert (plan["stages"] == FA.MAX_STAGES
            or FA.cluster_smem(d, plan["cluster"], plan["stages"] + 1, kind, tile, passes)
            > FA.SMEM_LIMIT)


@pytest.mark.parametrize("d,fwd,dkv,dq", [
    (576, (2, [192, 128, 128, 128], 4), (3, [128, 64, 128, 64, 128, 64], 4),
     (3, [128, 64, 128, 64, 128, 64], 4)),
    (640, (2, [192, 128, 192, 128], 4), (3, [128, 128, 128, 64, 128, 64], 3),
     (3, [128, 128, 128, 64, 128, 64], 3)),
    (768, (2, [192] * 4, 3), (3, [128] * 6, 3), (3, [128] * 6, 3)),
    (1024, (2, [256] * 4, 2), (4, [128] * 8, 3), (4, [128] * 8, 3)),
    (2048, (4, [256] * 8, 2), (8, [128] * 16, 3), (8, [128] * 16, 3)),
    # K4's and K5's non-portable clusters: 9 CTAs at 2112 (the last three slices of 64
    # columns), 12 at 3072, 16 at 4096, each with three stages as at 2048
    (2112, (5, [256, 192] * 3 + [192] * 4, 2), (9, [128] * 13 + [64, 128, 64, 128, 64], 3),
     (9, [128] * 13 + [64, 128, 64, 128, 64], 3)),
    (3072, (6, [256] * 12, 2), (12, [128] * 24, 3), (12, [128] * 24, 3)),
    (4096, (8, [256] * 16, 2), (16, [128] * 32, 3), (16, [128] * 32, 3)),
    # past 4096 K1 takes the column blocks; K4 and K5 two passes in 16 CTAs of 16 rows a
    # ring stage: at 4160 one extra block, warpgroup 0 of CTA 0's first slice (four stages);
    # at 6144 and 8192 passes of 128 | 64 and 128 | 128 columns a warpgroup
    (4160, None, (16, [128] + [64] * 31 + [64] * 32, 4, 16),
     (16, [128] + [64] * 31 + [64] * 32, 4, 16)),
    (6144, None, (16, [128] * 32 + [64] * 32, 4, 16), (16, [128] * 32 + [64] * 32, 4, 16)),
    (8192, None, (16, [128] * 64, 2, 16), (16, [128] * 64, 2, 16)),
    (8256, None, None, None),  # past every reach: the column blocks
])
def test_cluster_plans(d, fwd, dkv, dq):
    """K1, K4 and K5 above 512: the cluster route, its size, the column slices (uneven at
    576, 640 and 2112: the first warpgroup of each CTA takes the extra blocks first; past
    4096 K4's and K5's two passes, pass 0's slices before pass 1's) and the ring's stages (and its
    rows past 4096); the same formulas as csrc/flash_attn_cluster.cu:Layout, which refuses
    another plan. K5 cuts D as K4 does (128 columns a warpgroup) and keeps no query
    statistics in its stages. A CTA's shared memory is the Layout's at every cluster size
    (the exchange's pieces shrink as the cluster grows)."""
    for plan, want, kind in ((FA.forward_plan(d), fwd, "fwd"), (FA.dkv_plan(d), dkv, "dkv"),
                             (FA.dq_plan(d), dq, "dq")):
        if want is None:
            rows, tile = ("bk", "bq") if kind == "dkv" else ("bq", "bk")
            assert plan == {"route": "column blocks", **FA.wide_plan(d, rows, tile)}
            continue
        _check_cluster_plan(plan, d, kind)
        assert (plan["cluster"], plan["slices"], plan["stages"]) == want[:3]
        assert _ring(plan, kind) == (want[3] if len(want) > 3 else 32)


def test_cluster_plans_reach_and_past_it():
    """Every multiple of 64 from 576 up to the reach (4096 for K1, 8192 for K4 and K5)
    takes the cluster kernel: K1 in at most 8 CTAs, K4 and K5 in ceil(d / 256) <= 16 with at
    least two ring stages up to 4096 and in 16 CTAs and two passes past it (stages of 16
    rows); the next width past each reach, 4160 for K1 and 8256 for
    K4 and K5, takes the column blocks; the CTA's shared memory at 1024 is what
    csrc/flash_attn_cluster.cu lays out: Q 64 KB, two stages of K and V (64 KB each), the
    partial pieces and their sum (24 KB), 13 barriers, 1 KB of alignment (K1); K and V 64
    KB, three stages of Q, dO and their statistics, 48 KB of partial pieces and sums (K4); Q
    and dO 64 KB, three stages of K and V, 48 KB of partial pieces and sums (K5); at 8192
    (K4) K and V 128 KB, two stages of 16 queries of Q and dO (32 KB each) and their
    statistics, 24 KB of partial pieces and sums."""
    assert FA.REACH == {"fwd": 4096, "dkv": 8192, "dq": 8192}
    assert FA.MAX_CLUSTER == {"fwd": 8, "dkv": 16, "dq": 16}
    for d in range(576, FA.REACH["fwd"] + 1, 64):
        _check_cluster_plan(FA.forward_plan(d), d, "fwd")
    for d in range(576, FA.REACH["dkv"] + 1, 64):
        for plan, kind in ((FA.dkv_plan(d), "dkv"), (FA.dq_plan(d), "dq")):
            _check_cluster_plan(plan, d, kind)
            assert plan["cluster"] == min(-(-d // 256), 16) and plan["stages"] >= 2
            assert _ring(plan, kind) == (32 if d <= 4096 else 16)
    assert FA.forward_plan(4160) == {"route": "column blocks", **FA.wide_plan(4160, "bq", "bk")}
    assert FA.dkv_plan(8256) == {"route": "column blocks", **FA.wide_plan(8256, "bk", "bq")}
    assert FA.dq_plan(8256) == {"route": "column blocks", **FA.wide_plan(8256, "bq", "bk")}
    assert FA.forward_plan(2112)["route"] == "cluster"
    assert FA.forward_plan(1024)["smem"] == 65536 + 2 * 65536 + 3 * 8192 + 104 + 1024
    assert FA.dkv_plan(1024)["smem"] == 65536 + 3 * (32768 + 256) + 6 * 8192 + 104 + 1024
    assert FA.dq_plan(1024)["smem"] == 65536 + 3 * 32768 + 6 * 8192 + 104 + 1024
    assert FA.dkv_plan(8192)["smem"] == 131072 + 2 * (32768 + 128) + 3 * 8192 + 104 + 1024


@pytest.mark.parametrize("d", [4160, 5120, 5184, 6144, 7232, 8192])
def test_cluster_passes_form_each_score_twice(d):
    """K4 and K5 past 4096: two passes, each warpgroup one slice of each (1 or 2 blocks),
    so each score and dP are formed twice where the column blocks form them d / 128 times
    (33-64); a warpgroup's slices of both passes are one run of its CTA's blocks, over which
    it contracts the scores in each pass, and the runs of the cluster's 32 warpgroups tile
    d once in order: the sum over the cluster is the whole score."""
    for kind, plan in (("dkv", FA.dkv_plan(d)), ("dq", FA.dq_plan(d))):
        assert plan["passes"] == 2 == -(-d // 4096) < FA.wide_plan(d, "bq", "bk")["col_blocks"]
        slices = [plan["slices"][:32], plan["slices"][32:]]  # pass 0's, pass 1's
        runs = [slices[0][g] + slices[1][g] for g in range(32)]
        assert sum(runs) == d and all(128 <= x <= 256 for x in runs)
        for g in range(32):  # widths fall from pass 0 to pass 1: the ranks grow with the pass
            assert 64 <= slices[1][g] <= slices[0][g] <= FA.SLICE[kind]


@pytest.mark.parametrize("d,fits_at_256", [(576, True), (640, True), (768, False),
                                           (1024, False), (1536, False), (2048, False),
                                           (4096, False), (6144, False), (8192, False)])
def test_dq_cluster_shared_memory_edges(d, fits_at_256):
    """K5's plan at the edges of shared memory: its stages are the most that fit 227 KB
    (one more would not, or it is at 4). At 256 columns a warpgroup (K1's width) even two
    stages fit only up to 640 (5 boxes a CTA), not at leg 6b's 1024: why K5 takes K4's
    128 at every width."""
    plan = FA.dq_plan(d)
    tile, passes = plan["bk"], plan["passes"]
    assert plan["smem"] <= FA.SMEM_LIMIT
    assert (plan["stages"] == FA.MAX_STAGES
            or FA.cluster_smem(d, plan["cluster"], plan["stages"] + 1, "dq", tile, passes)
            > FA.SMEM_LIMIT)
    wide = -(-d // (2 * FA.SLICE["fwd"]))  # the CTAs at 256 columns a warpgroup
    assert (FA.cluster_smem(d, wide, 2, "dq") <= FA.SMEM_LIMIT) == fits_at_256
