"""What the flash-attention launches decide on the host (``ops/flash_attention.py``): the
tiles of each kernel by head dim, the K/V tiles a query tile visits and the query tiles a
key tile visits under the causal mask and the window, and the tensor map of a strided
[B, T, H, D] tensor. The tile ranges are held against the valid mask of the plain
attention (``ops/attention.py:attention_probs``): every live (query, key) pair lies in a
visited tile, and a tile that is skipped holds none. The kernels compute the same bounds
on the card (``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd.cu``)."""

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


@pytest.mark.parametrize("bk", [64, 128])  # K1's stages: 64 keys at D = 256, else 128
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("t", LENGTHS)
def test_kv_tile_range_holds_every_live_pair(t, window, causal, bk):
    valid = _valid(t, causal, window)
    bq = FA.forward_plan(64 if bk == 128 else 256)["bq"]
    assert FA.forward_plan(64 if bk == 128 else 256)["bk"] == bk
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


# K4's tiles at D <= 72, at D = 128 and at D = 256
@pytest.mark.parametrize("bk,bq", [(128, 64), (128, 32), (64, 32)])
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


@pytest.mark.parametrize("d,fwd,dkv", [
    (64, {"bq": 128, "bk": 128}, {"bk": 128, "bq": 64}),
    (72, {"bq": 128, "bk": 128}, {"bk": 128, "bq": 64}),
    (128, {"bq": 128, "bk": 128}, {"bk": 128, "bq": 32}),
    (256, {"bq": 128, "bk": 64}, {"bk": 64, "bq": 32}),
])
def test_kernel_and_tiles_by_head_dim(d, fwd, dkv):
    assert FA.forward_plan(d) == fwd
    assert FA.dkv_plan(d) == dkv


@pytest.mark.parametrize("d", [0, 32, 80, 96, 512])
def test_plans_refuse_other_head_dims(d):
    with pytest.raises(ValueError):
        FA.forward_plan(d)
    with pytest.raises(ValueError):
        FA.dkv_plan(d)


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
