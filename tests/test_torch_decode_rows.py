"""More query rows per KV head than one CTA of the split decode attention (K3) holds:
the row groups of ``ops/decode_attention.py:decode_plan``.

The plan at more than ``max_rows(d)`` rows (nb * n_rep: 17 or 24 beams of Gemma3-1B's
4 query heads on one KV head, 17 beams of Llama's 32/8, 96 query heads on one KV head)
puts every row in exactly one group and, inside each group, every live key in exactly
one split; at or below the cap the plan is the one-group plan it was (the formula before
row groups, written out here). A plain split-and-combine in fp32, cut by the plan as
``csrc/decode_attention.cu`` cuts it (a group reads the prefix again, its beams' own
generated slots, its own combine), equals the plain version. The plain decode attention
at 68 and 96 rows equals the JAX package's (its XLA path, which it takes at these
shapes), and greedy 17-beam generation on the tiny decoder with 4 query heads on one KV
head (68 rows) gives the JAX package's tokens. All fp32 on the CPU, numpy inputs from a
seed; tolerance 1e-5 absolute and relative (fp32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.generate import GenerationConfig as JGenerationConfig
from projectiontrainer_tpu.generate import generate as jgenerate
from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu.ops import decode_attention as JDA
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.generate import GenerationConfig, generate
from projectiontrainer_tpu_torch.ops import decode_attention as DA
from projectiontrainer_tpu_torch.ops.attention import NEG_INF

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)

# b, nb, hkv, n_rep, d, p, g, t, window: more rows than one CTA holds
GROUP_CASES = [
    (2, 24, 1, 4, 256, 831, 32, 31, None),   # Gemma3-1B at 24 beams: 96 rows
    (2, 24, 1, 4, 256, 831, 32, 17, 512),
    (8, 17, 8, 4, 64, 831, 32, 31, None),    # Llama-3.2-1B at 17 beams: 68 rows
    (1, 17, 1, 4, 256, 300, 16, 0, None),
    (1, 1, 1, 96, 64, 300, 16, 15, None),    # 96 query heads on one KV head
    (2, 3, 1, 130, 128, 77, 41, 40, 30),     # 130 heads: groups of a beam's rows
    (2, 5, 2, 20, 128, 150, 41, 40, None),   # 100 rows: a beam's 20 rows in two groups
    (8, 3, 1, 8, 512, 831, 32, 31, None),    # head dim 512: at most 16 rows a CTA
    (2, 3, 2, 8, 512, 300, 16, 15, 200),     # 24 rows of 512: groups of 2 and 1 beams
    (2, 65, 1, 1, 64, 50, 8, 7, None),       # one head, 65 beams
]
# at or below the cap: one group, the plan as it was
ONE_GROUP_CASES = [
    (8, 3, 1, 4, 256, 831, 32, 0, None), (8, 3, 1, 4, 256, 831, 32, 31, 512),
    (1, 3, 1, 4, 256, 831, 1024, 1000, None), (8, 3, 8, 4, 64, 831, 32, 31, None),
    (4, 4, 1, 16, 64, 300, 64, 63, 100), (64, 3, 8, 4, 128, 831, 32, 31, None),
    (1, 16, 1, 4, 256, 575, 128, 127, None), (3, 2, 1, 8, 512, 77, 41, 40, None),
    (2, 1, 1, 64, 64, 5, 3, 0, None),
]


def _old_plan(b, nb, hkv, p, g, t, prefix_len, window, sms=132):
    """``decode_plan`` before row groups (one group of all nb * n_rep rows)."""
    q_slot = prefix_len + t
    p_begin = min(p, max(0, q_slot - window + 1)) if window else 0
    g_begin, g_end = (max(0, t - window + 1) if window else 0), min(t + 1, g)
    live_p, live_g = p - p_begin, g_end - g_begin
    keys = b * hkv * (live_p + nb * live_g)
    tiles = max(1, (keys + sms * 16) // (sms * 32))
    chunk = tiles * 32
    p_splits, g_splits = -(-live_p // chunk), -(-live_g // chunk)
    splits = p_splits + nb * g_splits
    return {"p_begin": p_begin, "p_splits": p_splits, "g_begin": g_begin, "g_end": g_end,
            "g_splits": g_splits, "chunk": chunk, "splits": splits, "ctas": b * hkv * splits}


def _groups(plan, nb, n_rep):
    """Each group's (beams, reps) as the kernel derives them from its index."""
    bpg, rpg = plan["beams_per_group"], plan["reps_per_group"]
    n_rg = -(-n_rep // rpg)
    out = []
    for grp in range(plan["groups"]):
        beam0, rep0 = grp // n_rg * bpg, grp % n_rg * rpg
        out.append((range(beam0, min(nb, beam0 + bpg)), range(rep0, min(n_rep, rep0 + rpg))))
    return out


def _splits(plan, beams, p):
    """(beam or None for the prefix, first slot, end slot) of a group's splits, in the
    kernel's order."""
    c = plan["chunk"]
    out = [(None, lo, min(p, lo + c))
           for lo in range(plan["p_begin"], plan["p_begin"] + plan["p_splits"] * c, c)]
    for beam in beams:
        out += [(beam, lo, min(plan["g_end"], lo + c))
                for lo in range(plan["g_begin"], plan["g_begin"] + plan["g_splits"] * c, c)]
    return out


@pytest.mark.parametrize("case", GROUP_CASES)
def test_every_row_in_one_group_and_every_key_in_one_split(case):
    b, nb, hkv, n_rep, d, p, g, t, window = case
    plan = DA.decode_plan(b, nb, hkv, p, g, t, p, window, n_rep=n_rep, d=d)
    assert plan["groups"] > 1
    assert plan["beams_per_group"] * plan["reps_per_group"] <= min(DA.max_rows(d),
                                                                   max(DA.GROUP_SIZES))
    seen = np.zeros((nb, n_rep), int)
    ctas = 0
    for beams, reps in _groups(plan, nb, n_rep):
        assert len(beams) and len(reps)
        seen[np.ix_(list(beams), list(reps))] += 1
        splits = _splits(plan, beams, p)
        assert len(splits) <= plan["splits"]
        ctas += len(splits)
        prefix, gen = np.zeros(p, int), np.zeros((nb, g), int)
        for beam, lo, hi in splits:
            assert lo < hi and hi - lo <= plan["chunk"]
            if beam is None:
                prefix[lo:hi] += 1
            else:
                gen[beam, lo:hi] += 1
        live_p = np.ones(p, bool)
        live_g = np.arange(g) <= t
        if window is not None:
            live_p &= np.arange(p) > p + t - window
            live_g &= np.arange(g) > t - window
        np.testing.assert_array_equal(prefix, live_p.astype(int))
        for beam in beams:
            np.testing.assert_array_equal(gen[beam], live_g.astype(int))
    assert (seen == 1).all(), "a row in no group or in two"
    assert plan["ctas"] == b * hkv * ctas


@pytest.mark.parametrize("case", ONE_GROUP_CASES)
def test_plans_within_the_cap_are_unchanged(case):
    b, nb, hkv, n_rep, d, p, g, t, window = case
    assert nb * n_rep <= DA.max_rows(d)
    plan = DA.decode_plan(b, nb, hkv, p, g, t, p, window, n_rep=n_rep, d=d)
    assert (plan["groups"], plan["beams_per_group"], plan["reps_per_group"]) == (1, nb, n_rep)
    assert {k: plan[k] for k in _old_plan(b, nb, hkv, p, g, t, p, window)} == \
        _old_plan(b, nb, hkv, p, g, t, p, window)
    # the default (n_rep 1, head dim 256) is one group wherever nb alone fits
    assert DA.decode_plan(b, nb, hkv, p, g, t, p, window)["groups"] == 1


def test_group_size_by_pairs():
    """Groups as large as still give the card's 132 SMs as many groups, else the
    smallest (8 rows): a batch of two on one KV head takes small groups, Llama's 64
    (batch, KV head) pairs large ones."""
    assert DA.group_shape(2, 24, 4, 256, 132) == (2, 4)     # 12 groups of 8 rows
    assert DA.group_shape(64, 17, 4, 64, 132) == (6, 4)     # 3 groups of <= 32 rows
    assert DA.group_shape(1, 1, 96, 64, 132) == (1, 8)
    assert DA.group_shape(8, 3, 8, 512, 132) == (1, 8)      # head dim 512: <= 16 rows
    assert DA.group_shape(8, 3, 4, 256, 132) == (3, 4)      # within a CTA: one group
    assert DA.group_shape(300, 17, 4, 64, 132) == (9, 4)    # 2 groups of <= 64 rows suffice


def test_row_groups_even_out():
    assert DA.row_groups(24, 4, 64) == (12, 4)    # 96 rows: 48 + 48, not 64 + 32
    assert DA.row_groups(17, 4, 64) == (9, 4)     # 68: 36 + 32
    assert DA.row_groups(1, 96, 64) == (1, 48)
    assert DA.row_groups(3, 130, 64) == (1, 44)   # 44 + 44 + 42 a beam
    assert DA.row_groups(3, 8, 16) == (2, 8)
    assert DA.row_groups(3, 4, 64) == (3, 4)
    assert DA.max_rows(512) == 16 and DA.max_rows(256) == DA.max_rows(64) == 64


def _inputs(seed, b, nb, hq, hkv, p, g, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b * nb, hq, d), dtype=np.float32)
    kp, vp = (rng.standard_normal((b, hkv, p, d), dtype=np.float32) for _ in range(2))
    kg, vg = (rng.standard_normal((b * nb, hkv, g, d), dtype=np.float32) for _ in range(2))
    pm = np.ones((b, p), np.int32)
    pm[min(1, b - 1), :min(p - 1, 70)] = 0  # left padding over whole splits
    return q, kp, vp, kg, vg, pm


def split_and_combine_groups(q, kp, vp, kg, vg, *, prefix_mask, t, prefix_len, scale,
                             window, sms):
    """Decode attention in fp32 as the kernel computes it with row groups: per (batch,
    KV head, group), each split's partial max, sum and unnormalised output over the
    group's rows, then per row a combine of the prefix splits and its beam's generated
    ones, in split order."""
    r, hq, d = q.shape
    b, hkv, p, _ = kp.shape
    g, nb, n_rep = kg.shape[2], r // b, hq // hkv
    plan = DA.decode_plan(b, nb, hkv, p, g, t, prefix_len, window, sms, n_rep=n_rep, d=d)
    out = torch.full((r, hq, d), float("nan"))
    for bi in range(b):
        for h in range(hkv):
            for beams, reps in _groups(plan, nb, n_rep):
                heads = [h * n_rep + rep for rep in reps]
                parts = []
                for beam, lo, hi in _splits(plan, beams, p):
                    if beam is None:
                        keys, vals = kp[bi, h, lo:hi], vp[bi, h, lo:hi]
                        live = prefix_mask[bi, lo:hi].bool()
                        rows = [(bm, rep) for bm in beams for rep in heads]
                    else:
                        keys, vals = kg[bi * nb + beam, h, lo:hi], vg[bi * nb + beam, h, lo:hi]
                        live = torch.ones(hi - lo, dtype=torch.bool)
                        rows = [(beam, rep) for rep in heads]
                    x = torch.stack([q[bi * nb + bm, hh] for bm, hh in rows])
                    s = (x @ keys.T * scale).masked_fill(~live, NEG_INF)
                    m = s.max(-1).values
                    prob = torch.where(live, torch.exp(s - m[:, None]), 0.0)
                    for i, row in enumerate(rows):
                        parts.append((row, m[i], prob[i].sum(), prob[i] @ vals))
                for bm in beams:
                    for hh in heads:
                        mine = [(m, l, o) for row, m, l, o in parts if row == (bm, hh)]
                        mt = torch.stack([m for m, _, _ in mine]).max()
                        w = [torch.exp(m - mt) for m, _, _ in mine]
                        lt = sum(wi * l for wi, (_, l, _) in zip(w, mine))
                        out[bi * nb + bm, hh] = sum(wi * o for wi, (_, _, o) in zip(w, mine)) / lt
    return out


@pytest.mark.parametrize("b,nb,hq,hkv,d,window", [
    (2, 17, 4, 1, 16, None), (2, 24, 4, 1, 16, 30), (1, 2, 96, 1, 8, None),
    (2, 3, 8, 1, 512, 20),
])
def test_grouped_split_and_combine_equals_the_plain_version(b, nb, hq, hkv, d, window):
    p, g, t = 90, 12, 9
    q, kp, vp, kg, vg, pm = map(torch.tensor, _inputs(7, b, nb, hq, hkv, p, g, d))
    kw = dict(prefix_mask=pm, t=t, prefix_len=p, scale=d ** -0.5, window=window)
    got = split_and_combine_groups(q, kp, vp, kg, vg, sms=16, **kw)
    assert bool(got.isfinite().all()), "a row no group wrote"
    torch.testing.assert_close(got, DA.decode_attention_reference(q, kp, vp, kg, vg, **kw),
                               **TOL)


@pytest.mark.parametrize("nb,hq,hkv,window", [(17, 4, 1, None), (24, 4, 1, 20),
                                              (17, 32, 8, None), (24, 4, 1, None)])
def test_plain_decode_at_many_rows_matches_jax(nb, hq, hkv, window):
    b, p, g, t, d = 2, 40, 10, 6, 16
    assert nb * hq // hkv in (68, 96)
    arrays = _inputs(8 + nb, b, nb, hq, hkv, p, g, d)
    kw = dict(t=t, prefix_len=p, scale=d ** -0.5, window=window)
    ours = DA.decode_attention(*map(torch.tensor, arrays[:5]),
                               prefix_mask=torch.tensor(arrays[5]), **kw)
    theirs = JDA.decode_attention(*map(jnp.asarray, arrays[:5]),
                                  prefix_mask=jnp.asarray(arrays[5]), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_greedy_17_beams_match_jax():
    """17 beams of a decoder with 4 query heads on one KV head: 68 rows a KV head, more
    than one CTA of K3 holds; deterministic beam search with penalties, the prefix's
    sample 0 left-padded."""
    jcfg = T.tiny_llm_cfg(heads=4, kv_heads=1)
    jparams = jax.tree.map(np.asarray, JDEC.init(jax.random.key(5), jcfg))
    cfg, params = from_jax.config_from_jax(jcfg), from_jax.decoder_params(jparams)
    rng = np.random.default_rng(6)
    embeds = rng.standard_normal((2, 12, cfg.hidden_size), dtype=np.float32)
    mask = np.ones((2, 12), np.int32)
    mask[0, :3] = 0
    kw = dict(max_new_tokens=10, num_beams=17, repetition_penalty=1.3, length_penalty=1.2,
              pad_token_id=0)
    theirs = np.asarray(jgenerate(jparams, jcfg, jnp.asarray(embeds), jnp.asarray(mask),
                                  JGenerationConfig(**kw)))
    ours = generate(params, cfg, torch.tensor(embeds), torch.tensor(mask),
                    GenerationConfig(**kw)).numpy()
    np.testing.assert_array_equal(ours, theirs)
    assert len(set(ours[0].tolist())) > 2
