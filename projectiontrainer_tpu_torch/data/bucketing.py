"""Bucketed static-shape batching (the port's own copy of the JAX package's
``data/bucketing.py``: numpy only, same functions, same results).

The reference pads each Stage-2 batch to its max question/answer lengths at collate time
(``vqa_collate_fn``, Stage2/trainer.py:18-61) — fine on GPU, but dynamic shapes force an
XLA recompile per unique (q_len, a_len). Here sequences land in a small fixed grid of
buckets (default Q ∈ {32,64,128,256}, A ∈ {128,256,512,1024} — SURVEY §5.7), so the
compiler sees at most |Q|x|A| programs, compiled once each.

Padding honors ``padding_side`` like the reference's ``manual_pad`` (left for generation,
right for training — Stage2/trainer.py:32-46,499-505).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

DEFAULT_Q_BUCKETS = (32, 64, 128, 256)
DEFAULT_A_BUCKETS = (128, 256, 512, 1024)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length (clamps to the largest: sequences are pre-truncated)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def buckets_covering(max_len: int, buckets: Sequence[int]) -> tuple[int, ...]:
    """The grid extended (when needed) so its largest bucket covers ``max_len``.

    A configured ``max_q_len``/``max_a_len`` beyond the default grid must WIDEN the
    grid — otherwise ``bucket_for`` clamps to the old top bucket and ``pad_to``
    silently truncates every longer sequence (dropping answer tails including EOS,
    or the prompt tokens adjacent to the answer)."""
    if max_len <= buckets[-1]:
        return tuple(buckets)
    # extend by doubling so over-the-top lengths keep the grid's ~2x padding bound:
    # jumping straight to max_len would pad every sequence just past the old top
    # bucket all the way to max_len (e.g. 257 -> 2048, ~8x wasted attention/CE work)
    out = list(buckets)
    while out[-1] * 2 < max_len:
        out.append(out[-1] * 2)
    out.append(int(max_len))
    return tuple(out)


def pad_to(ids: np.ndarray, size: int, pad_id: int, *, side: str = "right") -> np.ndarray:
    """Pad (or truncate) to ``size`` honoring the padding side. Truncation keeps the
    end that the padding side is protecting: the HEAD for right padding (tokenizer
    ``truncation=True`` semantics) and the TAIL for left padding (left-padded
    generation prompts must keep the tokens immediately before the answer)."""
    ids = np.asarray(ids, np.int32)
    if len(ids) > size:
        ids = ids[:size] if side == "right" else ids[-size:]
    pad = np.full((size - len(ids),), pad_id, np.int32)
    return np.concatenate([ids, pad] if side == "right" else [pad, ids])


@dataclasses.dataclass
class BucketBatcher:
    """Groups Stage-2 samples into (q_bucket, a_bucket) bins and emits full static-shape
    batches; ``flush`` drains stragglers by repeating samples to fill the batch (constant
    shapes beat dropped data). Every batch carries ``sample_weight`` [B] float32 — 1.0
    for real samples, 0.0 for fillers — which the weighted losses and eval metrics use
    to reproduce the reference's smaller-final-DDP-batch semantics exactly."""

    batch_size: int
    pad_id: int
    q_buckets: Sequence[int] = DEFAULT_Q_BUCKETS
    a_buckets: Sequence[int] = DEFAULT_A_BUCKETS
    q_side: str = "right"
    a_side: str = "right"

    def __post_init__(self):
        self._bins: dict[tuple[int, int], list[dict]] = {}

    def _emit(self, key: tuple[int, int], samples: list[dict], n_real: int) -> dict:
        qb, ab = key
        weight = np.zeros((len(samples),), np.float32)
        weight[:n_real] = 1.0
        return {
            "pixel_values": np.stack([s["pixel_values"] for s in samples]),
            "question_ids": np.stack(
                [pad_to(s["question_ids"], qb, self.pad_id, side=self.q_side) for s in samples]
            ),
            "answer_ids": np.stack(
                [pad_to(s["answer_ids"], ab, self.pad_id, side=self.a_side) for s in samples]
            ),
            "sample_weight": weight,
        }

    def add(self, sample: dict) -> Optional[dict]:
        key = (
            bucket_for(len(sample["question_ids"]), self.q_buckets),
            bucket_for(len(sample["answer_ids"]), self.a_buckets),
        )
        bin_ = self._bins.setdefault(key, [])
        bin_.append(sample)
        if len(bin_) == self.batch_size:
            del self._bins[key]
            return self._emit(key, bin_, n_real=self.batch_size)
        return None

    def flush(self) -> Iterator[dict]:
        for key, bin_ in sorted(self._bins.items()):
            if not bin_:
                continue
            orig = len(bin_)
            i = 0
            while len(bin_) < self.batch_size:
                bin_.append(bin_[i % orig])
                i += 1
            yield self._emit(key, bin_[: self.batch_size], n_real=min(orig, self.batch_size))
        self._bins.clear()

    def batches(self, samples: Iterable[dict], *, drain: bool = True) -> Iterator[dict]:
        for s in samples:
            out = self.add(s)
            if out is not None:
                yield out
        if drain:
            yield from self.flush()


@dataclasses.dataclass(frozen=True)
class PlannedBatch:
    """One globally-agreed batch: bucket shape + the GLOBAL sample indices + how many
    of them are real (the rest are cyclic straggler fillers, weight 0)."""

    q_bucket: int
    a_bucket: int
    indices: np.ndarray   # [global_batch] int
    n_real: int


def global_bucket_plan(
    q_lens, a_lens, *, batch_size: int,
    q_buckets: Sequence[int] = DEFAULT_Q_BUCKETS,
    a_buckets: Sequence[int] = DEFAULT_A_BUCKETS,
    epoch: int = 0, seed: int = 0, shuffle: bool = True,
) -> list[PlannedBatch]:
    """Deterministic epoch batch plan from precomputed token lengths.

    The streaming :class:`BucketBatcher` cannot drive a multi-host feed: each host sees
    a different sample shard, so bucket shapes and batch counts would diverge across
    hosts (shape mismatch inside ``make_array_from_process_local_data``, then deadlock).
    Here every host computes the SAME plan from the same (lengths, seed, epoch), then
    fetches only its ``1/process_count`` slice of each planned batch — the bucketed
    analogue of ``DistributedSampler`` (reference: Stage0:508-509).
    """
    q_lens = np.asarray(q_lens)
    a_lens = np.asarray(a_lens)
    n = len(q_lens)
    order = np.random.default_rng(seed + epoch).permutation(n) if shuffle else np.arange(n)
    bins: dict[tuple[int, int], list[int]] = {}
    plan: list[PlannedBatch] = []
    for i in order:
        i = int(i)
        key = (bucket_for(int(q_lens[i]), q_buckets), bucket_for(int(a_lens[i]), a_buckets))
        b = bins.setdefault(key, [])
        b.append(i)
        if len(b) == batch_size:
            plan.append(PlannedBatch(key[0], key[1], np.asarray(b), batch_size))
            bins[key] = []
    for key in sorted(bins):
        b = bins[key]
        if not b:
            continue
        n_real = len(b)
        j = 0
        while len(b) < batch_size:
            b.append(b[j % n_real])
            j += 1
        plan.append(PlannedBatch(key[0], key[1], np.asarray(b), n_real))
    return plan


def fixed_batcher(samples: Iterable[dict], batch_size: int, *, drop_remainder: bool = False,
                  repeat_to_fill: bool = True) -> Iterator[dict]:
    """Simple static batcher for fixed-shape samples (Stage 0/1, classification).
    Emits ``sample_weight`` [B] (1.0 real / 0.0 repeated filler) like BucketBatcher."""

    def emit(buf: list[dict], n_real: int) -> dict:
        out = {k: np.stack([b[k] for b in buf]) for k in buf[0]}
        weight = np.zeros((len(buf),), np.float32)
        weight[:n_real] = 1.0
        out["sample_weight"] = weight
        return out

    buf: list[dict] = []
    for s in samples:
        buf.append(s)
        if len(buf) == batch_size:
            yield emit(buf, batch_size)
            buf = []
    if buf and not drop_remainder:
        orig = len(buf)
        if repeat_to_fill:
            i = 0
            while len(buf) < batch_size:
                buf.append(buf[i % orig])
                i += 1
        yield emit(buf, orig)
