"""Single-token decode attention over a split prefix / generated KV cache: the CUDA
kernel ``csrc/decode_attention.cu`` for CUDA tensors, its plain version for CPU ones.

Counterpart of ``projectiontrainer_tpu/ops/decode_attention.py``. The caches are
head-major like the JAX package's: a prefix cache ``[B, Hkv, P, D]`` shared by every
beam of a sample and never reordered, and a generated cache ``[R, Hkv, G, D]`` with
one row per beam (R = B * beams). Keys are masked by the prefix padding mask, the
generated ones by ``j <= t``, and a sliding window counts cache slots with the query
at ``prefix_len + t``.

Unlike the TPU kernel, the CUDA kernel masks its own edges, so P and G need no
padding to a multiple of 128 (``generate/decode.py:_cache_pad`` is 1). It cuts the
live keys of each (batch, KV head) into splits, one CTA each, so that a served batch
fills the card: ``decode_plan`` decides the cut on the host, and the CPU tests hold it.
Each split leaves a partial softmax in fp32 scratch (from the caching allocator) and
the last split of a (batch, KV head) to finish combines them; a per-stream counter
tells it that it is the last, and it sets the counter back to 0 for the next launch.

A CTA holds its query rows in shared memory, at most ``max_rows(d)`` of them (64; 16 at
head dim 512; 8 at 4096). A (batch, KV head) with more rows (nb * n_rep: 17 beams of
Gemma3-1B's 4 query heads a KV head) is cut into row groups of whole beams (or, where one
beam's n_rep rows are too many, of a beam's rows), each with its own splits and combine,
and each reading the prefix again; ``decode_plan`` picks their size and reports them. The
JAX package sends such shapes to its XLA decode path instead.

The kernel takes head dims 64, 128, 256 and 512, and every multiple of 256 above 512;
any other is zero-padded on the card to the next of them, the query and the four caches
alike, and the output sliced back (``decode_attention_padded``; the scale stays the
caller's). Padding copies the caches at every step: the copy-free version is a kernel
that reads rows of D < width. Above 512 (where the JAX package runs XLA's decode
attention) O's columns are cut into slices of 256 (``col_blocks``: each slice a unit with
its own partials, counter and combine), on one of two routes (``decode_plan``'s
``route``): up to ``CLUSTER_REACH`` a split runs on a thread-block cluster of D / 256
CTAs, which compute each score once, each over its slice, and sum the partial scores over
the cluster ("cluster"); past it each CTA computes its split's scores over the whole D
again ("column blocks").
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.ops.attention import NEG_INF
from projectiontrainer_tpu_torch.ops.flash_attention import pad_head_dim, padded_head_dim

launches = _build.LaunchCounter("decode_attn")
HEAD_DIMS = (64, 128, 256, 512)
MAX_ROWS = 64  # query rows one CTA holds in shared memory (csrc/decode_attention.cu:MAX_M)
MAX_ROWS_512 = 16  # ... at head dim 512
WIDE_COLUMNS = 256  # above 512: O's columns a CTA (csrc/decode_attention.cu:DC)
KEY_STRIDE = WIDE_COLUMNS + 8  # a cluster CTA's K and q rows in shared memory (KS)
CLUSTER_REACH = _build.MAX_CLUSTER * WIDE_COLUMNS  # the widest head dim on the cluster route
GROUP_SIZES = (64, 32, 16, 8)  # rows a row group may hold, largest first
# tiles a split at least on the cluster route where splits of one tile would put more CTAs
# than SMs on the card: a split's fixed cost (the cluster's start, q, the partial and its
# share of the combine) outweighs a tile once the scores are on the tensor cores. Leg 6b's
# decode in chip_smoke.py (2 x 3 beams, 4|1 heads of 1024, P = 703, window 512: 152 CTAs
# in one-tile splits) took 0.0365-0.0372 ms in splits of one tile, 0.0265 in two, 0.0299
# in three (NVIDIA H100 80GB HBM3, 700 W; kernels/check_decode_attn.py --wide --time)
CLUSTER_MIN_TILES = 2
TILE_KEYS = 32  # keys a tile inside a split (csrc/decode_attention.cu:TK)
SMEM_LIMIT = 232_448  # dynamic shared memory a block may opt into on the H100
_counters: dict = {}  # (device index, stream) -> int32 [>= B * Hkv], zero between launches
_counters_lock = threading.Lock()


def takes_head_dim(d: int) -> bool:
    """Whether K3 runs at head dim d as it is: ``HEAD_DIMS``, or a multiple of
    ``WIDE_COLUMNS`` above 512."""
    return d in HEAD_DIMS or (d > max(HEAD_DIMS) and d % WIDE_COLUMNS == 0)


def col_blocks(d: int) -> int:
    """The slices of O's columns that K3's CTAs split at head dim d (1 up to 512)."""
    return d // WIDE_COLUMNS if d > max(HEAD_DIMS) else 1


def route(d: int) -> str:
    """K3's route at head dim d: "splits" (a CTA a split) up to 512, "cluster" up to
    ``CLUSTER_REACH``, "column blocks" past it (csrc/decode_attention.cu:Route)."""
    if d <= max(HEAD_DIMS):
        return "splits"
    return "cluster" if d <= CLUSTER_REACH else "column blocks"


def exchange_bytes(rows: int, cluster: int) -> int:
    """The cluster's exchange of partial scores at ``rows`` rows over ``cluster`` CTAs
    (csrc/decode_attention.cu:exchange_bytes): each CTA's piece of every CTA's
    [rows x 32] fp32 tile and the whole sum, as 16-byte chunks, and four barriers."""
    total = rows * TILE_KEYS // 4
    return 16 * (cluster * -(-total // cluster) + total) + 32


def smem_bytes(d: int, rows: int) -> int:
    """K3's dynamic shared memory at head dim d for ``rows`` query rows
    (csrc/decode_attention.cu:smem_bytes): two K/V tiles of the slice's width, the rows'
    fp32 q (at the whole width on the column blocks) and O at the slice's, their scores and
    statistics; on the cluster route q in bf16 (rows rounded up to 16), K's and q's rows
    ``KEY_STRIDE`` apart, and the exchange."""
    way = route(d)
    block = WIDE_COLUMNS if way != "splits" else d
    rest = rows * block * 4 + rows * TILE_KEYS * 4 + rows * 12
    if way == "cluster":
        return (2 * TILE_KEYS * (KEY_STRIDE + block) * 2 + -(-rows // 16) * 16 * KEY_STRIDE * 2
                + exchange_bytes(rows, col_blocks(d)) + rest)
    q_width = d if way == "column blocks" else block
    return 2 * TILE_KEYS * block * 2 * 2 + rows * q_width * 4 + rest


def max_rows(d: int) -> int:
    """Query rows one CTA of K3 holds at head dim d: its fp32 q and O beside two K/V
    tiles in flight within 227 KB of shared memory: 64 (16 at 512); 64 on the cluster
    route, where q is held at the slice's width; on the column blocks the largest power
    of two whose rows of the whole width fit (8 at 4096)."""
    if d <= max(HEAD_DIMS):
        return MAX_ROWS_512 if d > 256 else MAX_ROWS
    rows = MAX_ROWS
    while rows > 1 and smem_bytes(d, rows) > SMEM_LIMIT:
        rows //= 2
    if smem_bytes(d, rows) > SMEM_LIMIT:
        raise ValueError(f"decode_attention: head_dim {d}: one query row does not fit in "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return rows


def row_groups(nb: int, n_rep: int, cap: int) -> tuple[int, int]:
    """(beams, reps) of a row group: all nb * n_rep rows of a (batch, KV head) while
    they fit in ``cap``; else as few groups of whole beams as fit, their sizes evened
    out; else (n_rep > cap) one beam's rows in as few groups as fit, evened out."""
    if nb * n_rep <= cap:
        return nb, n_rep
    if n_rep <= cap:
        n = -(-nb // (cap // n_rep))
        return -(-nb // n), n_rep
    n = -(-n_rep // cap)
    return 1, -(-n_rep // n)


def group_shape(pairs: int, nb: int, n_rep: int, d: int, sms: int) -> tuple[int, int]:
    """(beams, reps) of K3's row groups for ``pairs`` (batch, KV head) pairs: all
    nb * n_rep rows while a CTA holds them (``max_rows(d)``); else groups of the largest
    of ``GROUP_SIZES`` that still gives ``sms`` groups in all, or of the smallest. A
    group's partials and its one-CTA combine grow with its rows, while the prefix that
    each group reads again is cheap: at 2 x 24 beams of Gemma3-1B's 4|1 heads (2 pairs)
    groups of 8 rows took 0.064 ms, of 16 0.081, of 64 0.217; at 8 x 17 beams of
    Llama-3.2-1B's 32|8 (64 pairs) groups of 32 took 0.268, of 8 0.322, of 64 0.375
    (NVIDIA H100 80GB HBM3, 700 W; ``kernels/check_decode_attn.py --time``)."""
    cap = max_rows(d)
    if nb * n_rep <= cap:
        return nb, n_rep
    for size in [s for s in GROUP_SIZES if s <= cap] or [cap]:
        bpg, rpg = row_groups(nb, n_rep, size)
        if pairs * -(-nb // bpg) * -(-n_rep // rpg) >= sms:
            break
    return bpg, rpg


def decode_plan(b: int, nb: int, hkv: int, p: int, g: int, t: int, prefix_len: int,
                window: Optional[int], sms: int = 132, *, n_rep: int = 1,
                d: int = 256) -> dict:
    """How K3 cuts the live keys of each (batch, KV head) over CTAs at step t.

    The nb * n_rep query rows of a (batch, KV head) are one group while they fit in a
    CTA; more are cut into ``groups`` row groups (``group_shape``: ``beams_per_group``
    beams x ``reps_per_group`` rows of a beam). Live are the prefix slots [p_begin, p) (the padding mask removes more
    inside the kernel) and each beam's generated slots [g_begin, g_end) = j <= t, both
    inside the window (cache slots, the query at prefix_len + t). They are cut into splits of ``chunk`` keys, a
    multiple of the kernel's 32-key tile, sized so that the CTAs come near ``sms``
    (rounded to the nearest tile, at least one; on the cluster route at least
    ``CLUSTER_MIN_TILES`` where one-tile splits would overfill the SMs): for each group
    ``p_splits`` splits of
    the prefix, each for all the group's rows, then ``g_splits`` a beam of its generated
    slots, each for that beam's rows in the group. Above 512 every split runs on
    ``col_blocks`` CTAs, one a 256-column slice of O: on a cluster of them (``route``
    "cluster", ``cluster`` CTAs, ``slices`` their widths) up to ``CLUSTER_REACH``, as
    column blocks past it. ``splits``: a group's of most beams (the grid's x, in
    clusters on the cluster route), ``ctas``: the CTAs that run. No split is empty of
    slots; a split may be empty of live keys (padding)."""
    bpg, rpg = group_shape(b * hkv, nb, n_rep, d, sms)
    rep_groups = -(-n_rep // rpg)
    groups = -(-nb // bpg) * rep_groups
    q_slot = prefix_len + t
    p_begin = min(p, max(0, q_slot - window + 1)) if window else 0
    g_begin, g_end = (max(0, t - window + 1) if window else 0), min(t + 1, g)
    live_p, live_g = p - p_begin, g_end - g_begin
    blocks = col_blocks(d)
    keys = blocks * b * hkv * (groups * live_p + nb * rep_groups * live_g)
    tiles = max(1, (keys + sms * TILE_KEYS // 2) // (sms * TILE_KEYS))

    def cut(tiles):  # (chunk, p_splits, g_splits, ctas)
        chunk = tiles * TILE_KEYS
        p_splits, g_splits = -(-live_p // chunk), -(-live_g // chunk)
        return chunk, p_splits, g_splits, blocks * b * hkv * (groups * p_splits
                                                              + nb * rep_groups * g_splits)

    chunk, p_splits, g_splits, ctas = cut(tiles)
    if route(d) == "cluster" and tiles < CLUSTER_MIN_TILES and ctas > sms:
        chunk, p_splits, g_splits, ctas = cut(CLUSTER_MIN_TILES)
    splits = p_splits + bpg * g_splits
    plan = {"p_begin": p_begin, "p_splits": p_splits, "g_begin": g_begin, "g_end": g_end,
            "g_splits": g_splits, "chunk": chunk, "splits": splits, "ctas": ctas,
            "groups": groups, "beams_per_group": bpg, "reps_per_group": rpg,
            "col_blocks": blocks, "route": route(d)}
    if plan["route"] == "cluster":
        plan.update(cluster=blocks, slices=[WIDE_COLUMNS] * blocks)
    return plan


def _counter(device, stream: int, n: int):
    """The zeroed arrival counters of one stream (launches on one stream run in order,
    so they share them; each launch leaves them 0)."""
    key = (device.index, stream)
    with _counters_lock:
        c = _counters.get(key)
        if c is None or c.numel() < n:
            c = _counters[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        return c


def _shapes(q, kp, kg):
    r, hq, d = q.shape
    b, hkv, p, _ = kp.shape
    g = kg.shape[2]
    if r % b:
        raise ValueError(f"rows {r} not a multiple of batch {b}")
    return r, hq, d, b, p, hkv, g, r // b, hq // hkv


def decode_attention_reference(q, kp, vp, kg, vg, *, prefix_mask, t: int, prefix_len: int,
                               scale: float, window: Optional[int] = None):
    """The plain version (JAX ``_xla_decode_attention``): fp32 scores and softmax over
    [prefix; generated], probabilities cast to q's dtype before the PV products."""
    r, hq, d, b, p, hkv, g, nb, n_rep = _shapes(q, kp, kg)
    q5 = q.float().reshape(b, nb, hkv, n_rep, d)
    kg5 = kg.float().reshape(b, nb, hkv, g, d)
    vg5 = vg.float().reshape(b, nb, hkv, g, d)
    sp = torch.einsum("bnkrd,bkpd->bnkrp", q5, kp.float()) * scale
    sg = torch.einsum("bnkrd,bnkgd->bnkrg", q5, kg5) * scale

    pidx = torch.arange(p, device=q.device)
    gidx = torch.arange(g, device=q.device)
    validp = prefix_mask.bool()[:, None, None, None, :]
    validg = gidx <= t
    if window is not None:
        q_slot = prefix_len + t
        validp = validp & (pidx > q_slot - window)
        validg = validg & (gidx > t - window)
    sp = sp.masked_fill(~validp, NEG_INF)
    sg = sg.masked_fill(~validg, NEG_INF)

    probs = torch.softmax(torch.cat([sp, sg], dim=-1), dim=-1).to(q.dtype).float()
    out = torch.einsum("bnkrp,bkpd->bnkrd", probs[..., :p], vp.float())
    out = out + torch.einsum("bnkrg,bnkgd->bnkrd", probs[..., p:], vg5)
    return out.to(q.dtype).reshape(r, hq, d)


def _launch(q, kp, vp, kg, vg, *, prefix_mask, t, prefix_len, scale, window):
    r, hq, d, b, p, hkv, g, nb, n_rep = _shapes(q, kp, kg)
    q = q.contiguous()
    for name, x in (("q", q), ("kp", kp), ("vp", vp), ("kg", kg), ("vg", vg)):
        if not x.is_cuda or x.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention: {name} must be bf16 on the card")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous and 16-byte aligned")
    if vp.shape != kp.shape or vg.shape != kg.shape or kg.shape != (r, hkv, g, d):
        raise ValueError("decode_attention: cache shapes disagree")
    if not takes_head_dim(d) or hq % hkv:
        raise ValueError(f"decode_attention: head_dim {d} (takes {HEAD_DIMS} and multiples "
                         f"of {WIDE_COLUMNS} above) or GQA {hq}/{hkv} not supported")
    if not 0 <= t < g:
        raise ValueError(f"decode_attention: step {t} outside the generated cache [0, {g})")
    mask = prefix_mask.to(device=q.device, dtype=torch.int32).contiguous()
    if mask.shape != (b, p):
        raise ValueError(f"decode_attention: prefix_mask must be [B, P], got {tuple(mask.shape)}")
    plan = decode_plan(b, nb, hkv, p, g, t, prefix_len, window,
                       torch.cuda.get_device_properties(q.device).multi_processor_count,
                       n_rep=n_rep, d=d)
    # (batch, KV head, row group, column block): a counter each
    units = b * hkv * plan["groups"] * plan["col_blocks"]
    rows = units * plan["splits"] * plan["beams_per_group"] * plan["reps_per_group"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _build.library()
    out = torch.empty_like(q)
    o_part = torch.empty(rows * (d // plan["col_blocks"]), dtype=torch.float32, device=q.device)
    ml_part = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
    err = lib.decode_attn_bf16(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kg.data_ptr(), vg.data_ptr(),
        mask.data_ptr(), out.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(),
        _counter(q.device, stream, units).data_ptr(), b, nb, hkv, n_rep, p, g, d,
        plan["p_begin"], plan["p_splits"], plan["g_begin"], plan["g_end"], plan["g_splits"],
        plan["chunk"], plan["groups"], plan["beams_per_group"], plan["reps_per_group"],
        float(scale), stream,
    )
    _build.check("decode_attn_bf16", err)
    launches.add()
    return out


def decode_attention(q, kp, vp, kg, vg, *, prefix_mask, t: int, prefix_len: int,
                     scale: float, window: Optional[int] = None):
    """q [R, Hq, D] (this step's queries), kp/vp [B, Hkv, P, D], kg/vg [R, Hkv, G, D]
    with slot t already written -> [R, Hq, D] in q's dtype.

    The kernel on CUDA tensors, the plain version on CPU tensors."""
    kw = dict(prefix_mask=prefix_mask, t=t, prefix_len=prefix_len, scale=scale,
              window=window)
    if q.is_cuda:
        if not takes_head_dim(q.shape[-1]):
            return decode_attention_padded(q, kp, vp, kg, vg, **kw)
        return _launch(q, kp, vp, kg, vg, **kw)
    if q.device.type != "cpu":
        raise RuntimeError(f"decode_attention: no kernel for device {q.device}")
    return decode_attention_reference(q, kp, vp, kg, vg, **kw)


def decode_attention_padded(q, kp, vp, kg, vg, **kw):
    """``decode_attention`` at a head dim D the kernel does not take: q and the caches
    zero-padded on D to the next of ``HEAD_DIMS`` (above 512: to a multiple of
    ``WIDE_COLUMNS``), the output sliced back to D; ``kw`` as ``decode_attention``'s, the
    caller's scale included. On CPU tensors the plain version runs at the padded width."""
    d = q.shape[-1]
    width = padded_width(d)
    q, kp, vp, kg, vg = (pad_head_dim(x, width) for x in (q, kp, vp, kg, vg))
    run = _launch if q.is_cuda else decode_attention_reference
    return run(q, kp, vp, kg, vg, **kw)[..., :d]


def padded_width(d: int) -> int:
    """The head dim K3 runs a head dim d at: d itself where it takes it, else the next of
    ``HEAD_DIMS``, or above 512 the next multiple of ``WIDE_COLUMNS``."""
    return padded_head_dim(d, HEAD_DIMS, WIDE_COLUMNS)
