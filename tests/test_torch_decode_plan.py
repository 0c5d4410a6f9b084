"""What the split decode attention (K3) decides on the host
(``ops/decode_attention.py:decode_plan``): how the live keys of each (batch, KV head)
are cut over CTAs. Every live key falls in exactly one split, the served batch fills
the card, and no split is without a tile. A plain split-and-combine version of decode
attention in fp32, written here from the plan as ``csrc/decode_attention.cu`` cuts it,
equals the plain version, splits without a live key included; and the JAX package's
decode kernel (interpret mode) agrees with its XLA oracle and with that split version
on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from projectiontrainer_tpu.ops import decode_attention as JDA
from projectiontrainer_tpu_torch.ops import decode_attention as DA
from projectiontrainer_tpu_torch.ops.attention import NEG_INF

torch.set_num_threads(2)

# b, nb, hkv, p, g, t, window
PLAN_CASES = [
    (8, 3, 1, 831, 32, 0, None),       # the served shape
    (8, 3, 1, 831, 32, 31, None),
    (8, 3, 1, 831, 32, 17, 512),       # the window starts inside the prefix
    (8, 3, 1, 831, 32, 31, 512),
    (8, 3, 1, 831, 32, 31, 20),        # the window holds no prefix slot
    (1, 3, 1, 831, 32, 31, None),      # one request
    (1, 3, 1, 831, 32, 5, 512),
    (8, 3, 1, 831, 1024, 1000, None),  # max_new_tokens 1024
    (8, 3, 1, 831, 1024, 1000, 512),
    (2, 3, 2, 77, 41, 40, None),
    (3, 1, 1, 5, 3, 0, None),
    (4, 4, 1, 300, 64, 63, 100),
    (64, 3, 8, 831, 32, 31, None),     # more (batch, KV head) pairs than SMs
    (8, 3, 8, 831, 32, 0, None),       # Llama-3.2-1B served batch: 8 KV heads
    (8, 3, 8, 831, 32, 31, None),
    (1, 3, 8, 575, 128, 0, None),      # one Llama caption, 3 beams
    (1, 3, 8, 575, 128, 127, None),
]


def _splits(plan, nb, p):
    """(beam, or None for the prefix, first slot, end slot) of each split, in the
    kernel's order: the prefix splits, then each beam's generated ones."""
    c = plan["chunk"]
    out = [(None, lo, min(p, lo + c))
           for lo in range(plan["p_begin"], plan["p_begin"] + plan["p_splits"] * c, c)]
    for beam in range(nb):
        out += [(beam, lo, min(plan["g_end"], lo + c))
                for lo in range(plan["g_begin"], plan["g_begin"] + plan["g_splits"] * c, c)]
    assert len(out) == plan["splits"]
    return out


def _in_window(p, g, t, prefix_len, window):
    """Bool masks of the prefix and generated slots a query at step t may see (before
    the padding mask)."""
    prefix = np.ones(p, bool)
    gen = np.arange(g) <= t
    if window is not None:
        prefix &= np.arange(p) > prefix_len + t - window
        gen &= np.arange(g) > t - window
    return prefix, gen


@pytest.mark.parametrize("case", PLAN_CASES)
def test_every_live_key_falls_in_exactly_one_split(case):
    b, nb, hkv, p, g, t, window = case
    plan = DA.decode_plan(b, nb, hkv, p, g, t, p, window)
    splits = _splits(plan, nb, p)
    prefix_live, gen_live = _in_window(p, g, t, p, window)
    prefix_seen = np.zeros(p, int)
    gen_seen = np.zeros((nb, g), int)
    for beam, lo, hi in splits:
        assert lo < hi, "a split without a slot"
        assert plan["chunk"] % DA.TILE_KEYS == 0 and hi - lo <= plan["chunk"]
        if beam is None:
            prefix_seen[lo:hi] += 1
        else:
            gen_seen[beam, lo:hi] += 1
    # each slot inside the window in exactly one split, and no other slot in any: a
    # padded slot is masked inside its split, so a split may hold no live key
    np.testing.assert_array_equal(prefix_seen, prefix_live.astype(int))
    for beam in range(nb):
        np.testing.assert_array_equal(gen_seen[beam], gen_live.astype(int))
    assert plan["ctas"] == b * hkv * plan["splits"] > b * hkv


@pytest.mark.parametrize("g,t", [(32, 0), (32, 17), (32, 31), (1024, 1000)])
@pytest.mark.parametrize("window", [None, 512])
def test_the_served_batch_fills_the_card(g, t, window):
    """B = 8 samples of one KV head (Gemma3-1B), a prefix of 831 slots: at least 100
    CTAs for the H100's 132 SMs (each (batch, KV head) alone was one CTA)."""
    plan = DA.decode_plan(8, 3, 1, 831, g, t, 831, window, sms=132)
    assert 100 <= plan["ctas"] <= 2 * 132
    assert DA.decode_plan(1, 3, 1, 831, g, t, 831, window, sms=132)["ctas"] > 1


def split_and_combine(q, kp, vp, kg, vg, *, prefix_mask, t, prefix_len, scale, window,
                      sms):
    """Decode attention in fp32 as the kernel computes it: each split's partial max,
    sum and unnormalised output over its keys (padding masked, an explicit 0 for a masked
    key), then per row a combine of the prefix splits and its beam's generated ones.
    Returns (out, number of (split, batch, KV head) partials without a live key)."""
    r, hq, d = q.shape
    b, hkv, p, _ = kp.shape
    g, nb, n_rep = kg.shape[2], r // b, hq // hkv
    plan = DA.decode_plan(b, nb, hkv, p, g, t, prefix_len, window, sms)
    out = torch.empty(r, hq, d)
    empty = 0
    for bi in range(b):
        for h in range(hkv):
            rows = q[bi * nb:(bi + 1) * nb, h * n_rep:(h + 1) * n_rep]  # [nb, n_rep, d]
            parts = []
            for beam, lo, hi in _splits(plan, nb, p):
                if beam is None:
                    keys, vals = kp[bi, h, lo:hi], vp[bi, h, lo:hi]
                    live = prefix_mask[bi, lo:hi].bool()
                    x = rows
                else:
                    keys, vals = kg[bi * nb + beam, h, lo:hi], vg[bi * nb + beam, h, lo:hi]
                    live = torch.ones(hi - lo, dtype=torch.bool)
                    x = rows[beam:beam + 1]
                s = torch.einsum("brd,kd->brk", x, keys) * scale
                s = s.masked_fill(~live, NEG_INF)
                m = s.max(-1).values
                prob = torch.where(live, torch.exp(s - m[..., None]), 0.0)
                empty += int(not live.any())
                parts.append((beam, m, prob.sum(-1), prob @ vals))
            for beam in range(nb):
                mine = [(m[0 if bb is not None else beam], l[0 if bb is not None else beam],
                         o[0 if bb is not None else beam])
                        for bb, m, l, o in parts if bb is None or bb == beam]
                mt = torch.stack([m for m, _, _ in mine]).max(0).values
                w = [torch.exp(m - mt) for m, _, _ in mine]
                lt = sum(wi * l for wi, (_, l, _) in zip(w, mine))
                ot = sum(wi[:, None] * o for wi, (_, _, o) in zip(w, mine))
                out[bi * nb + beam, h * n_rep:(h + 1) * n_rep] = ot / lt[:, None]
    return out, empty


def _inputs(seed, b, nb, hq, hkv, p, g, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b * nb, hq, d), dtype=np.float32)
    kp, vp = (rng.standard_normal((b, hkv, p, d), dtype=np.float32) for _ in range(2))
    kg, vg = (rng.standard_normal((b * nb, hkv, g, d), dtype=np.float32) for _ in range(2))
    pm = np.ones((b, p), np.int32)
    pm[1, :70] = 0  # left padding over whole splits of 32 and 64 slots
    return q, kp, vp, kg, vg, pm


@pytest.mark.parametrize("sms", [8, 64])
@pytest.mark.parametrize("t,window", [(40, None), (3, None), (40, 100), (20, 30)])
def test_split_and_combine_equals_the_plain_version(t, window, sms):
    b, nb, hq, hkv, p, g, d = 2, 3, 4, 2, 150, 41, 16
    q, kp, vp, kg, vg, pm = map(torch.tensor, _inputs(5, b, nb, hq, hkv, p, g, d))
    kw = dict(prefix_mask=pm, t=t, prefix_len=p, scale=d ** -0.5, window=window)
    got, empty = split_and_combine(q, kp, vp, kg, vg, sms=sms, **kw)
    ref = DA.decode_attention_reference(q, kp, vp, kg, vg, **kw)
    assert bool(got.isfinite().all())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    if sms == 64 and window is None:  # 32-slot splits: sample 1's first two are all padding
        assert empty >= 2 * hkv


@pytest.mark.parametrize("t,window", [(0, None), (11, None), (11, 20), (11, 30)])
def test_jax_decode_kernel_matches_its_oracle_and_the_split_version(t, window):
    b, nb, hq, hkv, p, g, d = 2, 3, 4, 2, 150, 12, 16
    arrays = _inputs(6, b, nb, hq, hkv, p, g, d)
    args = (t, p, d ** -0.5, window)
    pallas = JDA._pallas_decode_attention(*map(jnp.asarray, arrays), *args, interpret=True)
    xla = JDA._xla_decode_attention(*map(jnp.asarray, arrays), *args)
    np.testing.assert_allclose(np.asarray(pallas), np.asarray(xla), rtol=1e-5, atol=1e-5)
    q, kp, vp, kg, vg, pm = map(torch.tensor, arrays)
    ours, _ = split_and_combine(q, kp, vp, kg, vg, prefix_mask=pm, t=t, prefix_len=p,
                                scale=d ** -0.5, window=window, sms=64)
    np.testing.assert_allclose(ours.numpy(), np.asarray(xla), rtol=1e-5, atol=1e-5)
