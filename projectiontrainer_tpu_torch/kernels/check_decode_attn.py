"""Build, check and time the split decode attention (K3) on the card, without the rest of
the smoke run.

    python -m projectiontrainer_tpu_torch.kernels.check_decode_attn [--ptxas] [--time] [--wide]

Needs an NVIDIA GPU and ``nvcc``. Prints one JSON line per step:

- ``--ptxas``: what ``nvcc -Xptxas -v`` says of ``csrc/decode_attention.cu`` (registers,
  spills, shared memory of each kernel, warnings);
- always: the kernel against its plain version (``decode_attention_reference``
  evaluated in fp32 on the same bf16 inputs) within atol = rtol = 2e-2 at the served
  shape (batch 8, 3 beams, Gemma3-1B's 4/1 heads of 256, a prefix of 831 slots with
  ragged left padding, 32 generated slots), at batch 1, with left padding that masks
  whole splits, with a window that starts inside a split, at 1024 generated slots with
  t = 1000, at Llama-3.2-1B's 32/8 heads of 64 (the served batch at P = 831 and at the
  generation evaluation's P = 703, and one caption of 3 beams at P = 575, G = 128), and
  at the other head dims and GQA ratios, at more rows a KV head than a CTA holds (24 beams
  of Gemma3-1B's 4/1 heads, 17 of Llama's 32/8, 96 query heads on one KV head), at head
  dim 512 and at 320 (padded to 512), and above 512 (``--wide``: only those, all on the
  cluster route): 768 (and 640, padded to it), 1024 (also at 96 rows a KV head, and leg
  6b's decode) and 2048 (3, 4 and 8 CTAs a split of one 256-column block each), 2304 and
  4096 (5 CTAs of 2, 2, 2, 2 and 1 blocks; 8 of 2: chip_smoke.py phase 2's shapes, with a
  window of 100 and none); a rerun must give the same bits, and the plan
  (``ops/decode_attention.py:decode_plan``, its route in each row) must put more CTAs on
  the card than there are (batch, KV head) pairs. Every case is run before a failure is
  reported; ``--ptxas`` fails the run where a kernel spills;
- ``--time``: device times (``utils/timing.py:device_ms``) of kernel, plain version and
  the library call (``scaled_dot_product_attention`` over the concatenated caches, the
  prefix repeated per beam outside the timed call, with the masks as one explicit bool
  mask: a yardstick the port never calls; and again with k and v repeated to the query
  heads, which the efficient backend takes), in turns, at the served shapes (Gemma3-1B's
  and Llama-3.2-1B's) and one caption's; with ``--wide`` at phase 2's head dim 1024
  (and its window, and 96 rows a KV head), at 2048, 2304, 4096 and at leg 6b's decode, and
  the cluster route's least tiles a split (``time_cluster_tiles``); each beside its bound
  (``bound``: the caches, q and the output moved once over 3.35 TB/s, or the live keys'
  4 D operations a query head over 989 TFLOP/s, whichever is larger).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.kernels.check_flash_attn import ptxas_report, sdpa
from projectiontrainer_tpu_torch.ops import decode_attention as DA
from projectiontrainer_tpu_torch.ops import flash_attention as FA
from projectiontrainer_tpu_torch.utils.timing import device_ms

TOL = 2e-2
# b, nb, hq, hkv, d, p, g, t, window, padding: "ragged" (up to 224 slots a sample, the
# first sample unpadded), "splits" (sample 1 padded over its first 300 slots: whole
# splits without a live key), or None
CASES = [
    (8, 3, 4, 1, 256, 831, 32, 0, None, "ragged"),     # the served shape
    (8, 3, 4, 1, 256, 831, 32, 31, None, "ragged"),
    (8, 3, 4, 1, 256, 831, 32, 17, 512, "ragged"),     # the window starts inside a split
    (8, 3, 4, 1, 256, 831, 32, 31, 512, "ragged"),
    (8, 3, 32, 8, 64, 831, 32, 31, None, "ragged"),    # Llama-3.2-1B served batch
    (8, 3, 32, 8, 64, 831, 32, 0, None, "ragged"),
    (8, 3, 32, 8, 64, 703, 32, 31, None, "ragged"),    # the generation evaluation's prefix
    (1, 3, 32, 8, 64, 575, 128, 127, None, None),      # one Llama caption, 3 beams
    (1, 3, 4, 1, 256, 831, 32, 31, None, "ragged"),    # one request
    (1, 3, 4, 1, 256, 831, 32, 5, 512, None),
    (8, 3, 4, 1, 256, 831, 1024, 1000, None, "ragged"),  # max_new_tokens 1024
    (8, 3, 4, 1, 256, 831, 1024, 1000, 512, "ragged"),  # the prefix wholly out of the window
    (8, 3, 4, 1, 256, 831, 32, 31, None, "splits"),
    (2, 3, 4, 1, 256, 831, 32, 9, 600, "splits"),
    (3, 3, 4, 2, 128, 77, 41, 40, None, "splits"),
    (3, 3, 8, 2, 64, 150, 41, 9, 16, "ragged"),
    (2, 1, 1, 1, 64, 5, 3, 0, None, None),
    (4, 4, 16, 1, 64, 300, 64, 63, 100, "ragged"),      # 64 rows a KV head: MAX_ROWS
    (2, 24, 4, 1, 256, 831, 32, 31, None, "ragged"),    # 96 rows a KV head: 2 row groups
    (2, 24, 4, 1, 256, 831, 32, 17, 512, "ragged"),
    (8, 17, 32, 8, 64, 831, 32, 31, None, "ragged"),    # 68 rows: Llama at 17 beams
    (1, 1, 96, 1, 64, 300, 16, 15, None, "splits"),     # 96 query heads a KV head: rep groups
    (2, 5, 40, 2, 128, 150, 41, 40, 30, "ragged"),      # 100 rows: whole beams of 20
    (8, 3, 8, 1, 512, 831, 32, 31, None, "ragged"),     # head dim 512: 24 rows, 2 groups
    (2, 2, 4, 2, 512, 300, 16, 15, 200, "splits"),
    (2, 3, 4, 1, 320, 300, 16, 15, None, "ragged"),     # 320, padded to 512
    # above 512: a split on a cluster of CTAs holding 256-column blocks
    (8, 3, 4, 1, 1024, 831, 32, 31, None, "ragged"),    # chip_smoke.py phase 2's shape
    (8, 3, 4, 1, 1024, 831, 32, 17, 512, "ragged"),
    (2, 24, 4, 1, 1024, 300, 16, 15, None, "splits"),   # 96 rows: row groups of 16
    (2, 3, 4, 2, 768, 300, 16, 15, 200, "splits"),     # the narrowest cluster: 3 CTAs
    (2, 3, 4, 1, 640, 150, 16, 15, None, "ragged"),     # 640, padded to 768
    (2, 3, 4, 1, 2048, 300, 16, 15, 100, "ragged"),     # 8 CTAs of one block
    (2, 3, 4, 1, 2304, 150, 16, 15, None, "ragged"),    # 5 CTAs of 2, 2, 2, 2, 1 blocks
    (2, 3, 4, 1, 2304, 300, 16, 15, 100, "ragged"),     # chip_smoke.py phase 2's
    (2, 3, 4, 1, 2304, 300, 16, 15, None, "ragged"),
    (2, 3, 4, 1, 4096, 300, 16, 15, 100, "ragged"),     # 8 CTAs of 2 blocks
    (2, 3, 4, 1, 4096, 300, 16, 15, None, "ragged"),
    (1, 12, 4, 1, 4096, 150, 16, 15, None, "splits"),   # 48 rows: row groups of <= 32
    (2, 3, 4, 1, 1024, 703, 16, 15, 512, "ragged"),     # chip_smoke.py leg 6b's decode
]
WIDE = [case for case in CASES if case[4] > 512]
TIMED = CASES[:8] + CASES[18:21] + CASES[23:24]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def inputs(b, nb, hq, hkv, d, p, g, pad, seed=3):
    """q, the caches (bf16) and the prefix mask."""
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device="cuda").to(torch.bfloat16)

    q = bf16((b * nb, hq, d))
    kp, vp = bf16((b, hkv, p, d)), bf16((b, hkv, p, d))
    kg, vg = bf16((b * nb, hkv, g, d)), bf16((b * nb, hkv, g, d))
    mask = np.ones((b, p), np.int32)
    if pad == "ragged":
        for i, n in enumerate(rng.integers(0, min(224, p - 1), size=b)):
            mask[i, :n if i else 0] = 0
    elif pad == "splits":
        mask[min(1, b - 1), :min(300, p - 1)] = 0
    return q, kp, vp, kg, vg, torch.tensor(mask, device="cuda")


def check(b, nb, hq, hkv, d, p, g, t, window, pad) -> bool:
    q, kp, vp, kg, vg, mask = inputs(b, nb, hq, hkv, d, p, g, pad)
    kw = dict(prefix_mask=mask, t=t, prefix_len=p, scale=d ** -0.5, window=window)
    before = DA.launches.value
    got = DA.decode_attention(q, kp, vp, kg, vg, **kw)
    torch.cuda.synchronize()
    ref = DA.decode_attention_reference(*(x.float() for x in (q, kp, vp, kg, vg)), **kw)
    err = (got.float() - ref).abs()
    again = [DA.decode_attention(q, kp, vp, kg, vg, **kw) for _ in range(2)]
    plan = DA.decode_plan(b, nb, hkv, p, g, t, p, window,
                          torch.cuda.get_device_properties(0).multi_processor_count,
                          n_rep=hq // hkv, d=DA.padded_width(d))
    row = {"case": [b, nb, hq, hkv, d, p, g, t, window, pad], "max_abs_err": float(err.max()),
           "within_tol": bool((err <= TOL + TOL * ref.abs()).all() and got.isfinite().all()),
           "bit_equal": all(torch.equal(got, x) for x in again),
           "launched": DA.launches.value == before + 3, "ctas": plan["ctas"],
           "splits": plan["splits"], "chunk": plan["chunk"], "groups": plan["groups"],
           "route": plan["route"]}
    row["ok"] = bool(row["within_tol"] and row["bit_equal"] and row["launched"]
                     and plan["ctas"] > b * hkv)
    emit(row)
    return row["ok"]


def library_call(q, kp, vp, kg, vg, *, prefix_mask, t, prefix_len, scale, window,
                 repeat_kv=False):
    """The one PyTorch call that computes decode attention, a yardstick the port never
    calls: ``scaled_dot_product_attention`` over the caches concatenated (the prefix
    repeated per beam, here and not in the timed call) with the masks as one explicit bool
    mask -> (fn, the backend that ran, the live keys over all rows). ``repeat_kv``: k and
    v repeated to the query heads too (outside the timed call), which SDPA's efficient
    backend takes with an explicit mask where it refuses GQA."""
    r, _, _ = q.shape
    b, _, p, _ = kp.shape
    g, nb = kg.shape[2], r // b
    live = prefix_mask.bool().repeat_interleave(nb, 0)
    gen = torch.arange(g, device=q.device) <= t
    if window is not None:
        live = live & (torch.arange(p, device=q.device) > prefix_len + t - window)
        gen = gen & (torch.arange(g, device=q.device) > t - window)
    live = torch.cat([live, gen[None].expand(r, g)], dim=1)
    k_cat = torch.cat([kp.repeat_interleave(nb, 0), kg], dim=2).transpose(1, 2)
    v_cat = torch.cat([vp.repeat_interleave(nb, 0), vg], dim=2).transpose(1, 2)
    if repeat_kv:
        k_cat, v_cat = (x.repeat_interleave(q.shape[1] // x.shape[2], 2).contiguous()
                        for x in (k_cat, v_cat))
    fn, backend = sdpa(q[:, None], k_cat, v_cat, live[:, None, None, :], scale, False)
    return fn, backend, int(live.sum())


def live_slots(prefix_mask, *, t, prefix_len, window, g) -> tuple:
    """(the live prefix slots over the batch, the prefix slots inside the window a batch
    row, the generated slots inside the window a beam): the cache rows the function needs
    (padding and slots out of the window left out) and the mask's slots it reads."""
    p = prefix_mask.shape[1]
    p_begin = min(p, max(0, prefix_len + t - window + 1)) if window else 0
    g_begin, g_end = (max(0, t - window + 1) if window else 0), min(t + 1, g)
    return int(prefix_mask[:, p_begin:].bool().sum()), p - p_begin, g_end - g_begin


def bound(b, nb, hq, hkv, d, slots, live) -> tuple:
    """(ms, "bytes" or "operations"): the least time an H100 SXM could take: the live
    slots of both caches (``slots``: ``live_slots``' counts), q and the output moved once
    and the prefix mask read inside the window, over 3.35 TB/s, or the scores and P V
    over the ``live`` keys of every row (4 D operations a key and query head) over 989
    TFLOP/s, whichever is larger (chip_smoke.py:bound_decode_attn's count)."""
    prefix, window_prefix, gen = slots
    rows = b * nb
    nbytes = (2 * 2 * hkv * d * (prefix + rows * gen) + 2 * 2 * rows * hq * d
              + 4 * b * window_prefix)
    by_bytes, by_ops = nbytes / 3.35e12 * 1e3, 4 * hq * live * d / 989e12 * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def time_case(b, nb, hq, hkv, d, p, g, t, window, pad) -> None:
    q, kp, vp, kg, vg, mask = inputs(b, nb, hq, hkv, d, p, g, pad)
    kw = dict(prefix_mask=mask, t=t, prefix_len=p, scale=d ** -0.5, window=window)
    lib, backend, live = library_call(q, kp, vp, kg, vg, **kw)
    lib_rep, backend_rep, _ = library_call(q, kp, vp, kg, vg, **kw, repeat_kv=True)
    rows = {}
    for _ in range(2):  # in turns
        for name, fn in (("plain", lambda: DA.decode_attention_reference(q, kp, vp, kg, vg, **kw)),
                         ("kernel", lambda: DA.decode_attention(q, kp, vp, kg, vg, **kw)),
                         ("library", lib), ("library_repeat_kv", lib_rep)):
            rows.setdefault(name, []).append(device_ms(fn))
    bound_ms, bound_by = bound(b, nb, hq, hkv, d,
                               live_slots(mask, t=t, prefix_len=p, window=window, g=g), live)
    emit({"case": [b, nb, hq, hkv, d, p, g, t, window, pad], "library": backend,
          "library_repeat_kv": backend_rep, "ms": rows, "bound_ms": bound_ms,
          "bound_by": bound_by})


def time_group_rows(sizes=(8, 12, 16, 24, 32, 64)) -> None:
    """The row groups' size at more rows a KV head than a CTA holds: the plan's choice
    (None) against each size alone (``DA.GROUP_SIZES`` narrowed to it), each checked
    against the plain version, then timed in turns."""
    default = DA.GROUP_SIZES
    for case in (CASES[18], CASES[19], CASES[20], CASES[21]):
        b, nb, hq, hkv, d, p, g, t, window, pad = case
        q, kp, vp, kg, vg, mask = inputs(b, nb, hq, hkv, d, p, g, pad)
        kw = dict(prefix_mask=mask, t=t, prefix_len=p, scale=d ** -0.5, window=window)
        ref = DA.decode_attention_reference(*(x.float() for x in (q, kp, vp, kg, vg)), **kw)
        rows = {}
        for size in (None, *sizes):
            DA.GROUP_SIZES = default if size is None else (size,)
            err = float((DA.decode_attention(q, kp, vp, kg, vg, **kw).float() - ref).abs().max())
            plan = DA.decode_plan(b, nb, hkv, p, g, t, p, window, n_rep=hq // hkv, d=d,
                                  sms=torch.cuda.get_device_properties(0).multi_processor_count)
            rows[str(size)] = {"err": err, "groups": plan["groups"], "ctas": plan["ctas"],
                               "rows": plan["beams_per_group"] * plan["reps_per_group"],
                               "chunk": plan["chunk"], "ms": []}
        for _ in range(2):  # in turns
            for size in (None, *sizes):
                DA.GROUP_SIZES = default if size is None else (size,)
                rows[str(size)]["ms"].append(
                    device_ms(lambda: DA.decode_attention(q, kp, vp, kg, vg, **kw)))
        DA.GROUP_SIZES = default
        emit({"group_rows": list(case), **rows})


def time_cluster_tiles(floors=(1, 2, 3)) -> None:
    """The cluster route's least tiles a split (``DA.CLUSTER_MIN_TILES``): the plan's
    floor against each of ``floors``, each checked against the plain version, then timed
    in turns, at the timed cases of ``--wide`` (phase 2's head dim 1024 shape, its window,
    96 rows, 2048, 2304, 4096 and leg 6b's decode)."""
    default = DA.CLUSTER_MIN_TILES
    for case in WIDE[:3] + WIDE[5:]:
        b, nb, hq, hkv, d, p, g, t, window, pad = case
        q, kp, vp, kg, vg, mask = inputs(b, nb, hq, hkv, d, p, g, pad)
        kw = dict(prefix_mask=mask, t=t, prefix_len=p, scale=d ** -0.5, window=window)
        ref = DA.decode_attention_reference(*(x.float() for x in (q, kp, vp, kg, vg)), **kw)
        rows = {}
        for floor in floors:
            DA.CLUSTER_MIN_TILES = floor
            err = float((DA.decode_attention(q, kp, vp, kg, vg, **kw).float() - ref).abs().max())
            plan = DA.decode_plan(b, nb, hkv, p, g, t, p, window, n_rep=hq // hkv, d=d,
                                  sms=torch.cuda.get_device_properties(0).multi_processor_count)
            rows[str(floor)] = {"err": err, "chunk": plan["chunk"], "ctas": plan["ctas"], "ms": []}
        for _ in range(2):  # in turns
            for floor in floors:
                DA.CLUSTER_MIN_TILES = floor
                rows[str(floor)]["ms"].append(
                    device_ms(lambda: DA.decode_attention(q, kp, vp, kg, vg, **kw)))
        DA.CLUSTER_MIN_TILES = default
        emit({"cluster_min_tiles": list(case), "plan": default, **rows})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--wide", action="store_true", help="only the head dims above 512")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": smi, "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda})
    ok = [ptxas_report(("decode_attention.cu",))] if args.ptxas else []
    _build.library()
    emit({"build_s": _build.build_seconds})
    ok += [check(*case) for case in (WIDE if args.wide else CASES)]
    if args.time and args.wide:
        for case in WIDE[:3] + WIDE[5:]:  # phase 2's shape, its window, 96 rows; 2048 and past
            time_case(*case)
        time_cluster_tiles()
    elif args.time:
        for case in TIMED:
            time_case(*case)
        time_group_rows()
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
