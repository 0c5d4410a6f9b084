"""Host-side input pipeline: thread pool -> fixed batcher -> device prefetch.

Counterpart of ``projectiontrainer_tpu/data/pipeline.py`` (which imports jax):

- ``host_shard_indices``: the per-epoch seeded shuffle and round-robin process shard
  of ``DistributedSampler.set_epoch``, the data rank of ``parallel/distributed.py``
  when the process group is initialised (one process otherwise; the model ranks of one
  replica read the same rows);
- ``map_samples``: ``dataset[i]`` on a thread pool, in order (a dataset with the
  process-feed protocol job by job: ``pixel_job`` drawn in index order here, the
  job's pixels on the pool through ``datasets.sample_from_job``, as ``data/feeder.py``'s
  workers compute them);
- ``epoch_batches``: shard -> decode (threads, or with ``num_procs`` the process
  feeder for datasets with its protocol) -> ``fixed_batcher`` (``data/bucketing.py``: a straggler batch is filled by repeating samples,
  with ``sample_weight`` 0 on the filler rows) -> ``device_prefetch``;
- ``planned_epoch_batches``: stage 2's global bucket plan (``bucketing.global_bucket_plan``)
  -> this process's slice of each planned batch, questions and answers padded to the
  batch's buckets, ``sample_weight`` 0 on the plan's filler rows -> ``device_prefetch``;
- ``device_prefetch`` replaces ``jax.device_put`` double buffering: a feeder thread
  copies each batch into pinned host memory and on to the card on a side CUDA
  stream, ``size`` batches ahead; the consumer's stream waits on the copy's event.
"""

from __future__ import annotations

import collections
import functools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from projectiontrainer_tpu_torch.data import datasets, feeder
from projectiontrainer_tpu_torch.data.bucketing import fixed_batcher, pad_to
from projectiontrainer_tpu_torch.parallel import distributed


def process_index_count() -> tuple[int, int]:
    """(data rank, data ranks): the model ranks of one replica read the same rows."""
    return distributed.data_rank(), distributed.data_size()


def host_shard_indices(n: int, *, epoch: int, seed: int = 0, shuffle: bool = True,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> np.ndarray:
    """Deterministic per-epoch shuffle + round-robin process shard, padded so every
    process sees the same number of samples."""
    pi, pc = process_index_count()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    order = np.arange(n)
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    pad = (-n) % pc
    if pad:
        order = np.concatenate([order, order[:pad]])
    return order[pi::pc]


def map_samples(dataset, indices, *, num_workers: int = 8) -> Iterator[dict]:
    """Fetch dataset[i] for i in indices with a thread pool, preserving order. For a
    dataset with the process-feed protocol, each ``pixel_job`` (which may draw an
    augmentation seed) is drawn here, in index order, so the samples do not depend on
    the threads' timing and equal the process feeder's."""
    if feeder.supports_process_feed(dataset):
        def fetch(i):
            return functools.partial(datasets.sample_from_job, dataset, i, dataset.pixel_job(i))
    else:
        def fetch(i):
            return functools.partial(dataset.__getitem__, i)
    if num_workers <= 1:
        for i in indices:
            yield fetch(int(i))()
        return
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        window = collections.deque()
        it = iter(indices)
        for i in it:
            window.append(pool.submit(fetch(int(i))))
            if len(window) >= num_workers * 2:
                break
        while window:
            yield window.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                window.append(pool.submit(fetch(int(nxt))))


def _to_tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def device_prefetch(batches: Iterable[dict], *, device, size: int = 2) -> Iterator[dict]:
    """Batches of numpy arrays -> batches of tensors on ``device``, prepared ``size``
    steps ahead on a feeder thread. On a CUDA device the copies go through pinned
    memory on a side stream; a failure on the feeder thread is raised to the
    consumer (an epoch must never end early in silence)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()

    def feeder():
        try:
            for b in batches:
                b = _to_tensors(b)
                event = None
                if cuda:
                    with torch.cuda.stream(stream):
                        b = {k: v.pin_memory().to(device, non_blocking=True)
                             for k, v in b.items()}
                        event = torch.cuda.Event()
                        event.record(stream)
                elif device.type != "cpu":
                    b = {k: v.to(device) for k, v in b.items()}
                q.put((b, event))
            q.put(end)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer below
            q.put(e)

    threading.Thread(target=feeder, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        b, event = item
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for v in b.values():
                v.record_stream(current)
        yield b


def epoch_batches(dataset, *, batch_size: int, epoch: int, device, seed: int = 0,
                  shuffle: bool = True, num_workers: int = 8, num_procs: int = 0,
                  prefetch: int = 2) -> Iterator[dict]:
    """The standard per-epoch pipeline: shard -> decode -> batch -> prefetch.

    ``num_procs > 0`` moves decode+augment onto worker PROCESSES with shared-memory
    pixel handoff (``data/feeder.py``) for datasets with the pixel_job/finish_pixels
    protocol; other datasets stay on the thread pool."""
    indices = host_shard_indices(len(dataset), epoch=epoch, seed=seed, shuffle=shuffle)
    if num_procs > 0 and feeder.supports_process_feed(dataset):
        pool = feeder.get_pool(dataset.image_size, num_procs)
        samples = feeder.map_samples_processes(dataset, indices, pool)
    else:
        samples = map_samples(dataset, indices, num_workers=num_workers)
    yield from device_prefetch(fixed_batcher(samples, batch_size), device=device,
                               size=prefetch)


def planned_epoch_batches(dataset, plan, *, pad_id: int, device, num_workers: int = 8,
                          prefetch: int = 2) -> Iterator[dict]:
    """Execute a global bucket plan (a list of ``bucketing.PlannedBatch``, the same in
    every process): this process fetches its contiguous ``1/process_count`` slice of
    each planned batch, right-pads questions and answers to the batch's buckets and
    weights the plan's filler rows 0; the batches go to ``device`` through
    ``device_prefetch``."""
    pi, pc = process_index_count()

    def local_batches():
        slices = []
        for pb in plan:
            if len(pb.indices) % pc:
                raise ValueError(f"planned global batch {len(pb.indices)} not divisible by "
                                 f"process count {pc}")
            lbs = len(pb.indices) // pc
            slices.append((pb, pb.indices[pi * lbs:(pi + 1) * lbs], lbs))
        flat = np.concatenate([idx for _, idx, _ in slices]) if slices else np.zeros(0, int)
        samples = map_samples(dataset, flat, num_workers=num_workers)
        for pb, _, lbs in slices:
            rows = [next(samples) for _ in range(lbs)]
            # global row j is real iff j < n_real; this process holds rows pi*lbs + k
            weight = (pi * lbs + np.arange(lbs) < pb.n_real).astype(np.float32)
            yield {
                "pixel_values": np.stack([r["pixel_values"] for r in rows]),
                "question_ids": np.stack([pad_to(r["question_ids"], pb.q_bucket, pad_id)
                                             for r in rows]),
                "answer_ids": np.stack([pad_to(r["answer_ids"], pb.a_bucket, pad_id)
                                           for r in rows]),
                "sample_weight": weight,
            }

    yield from device_prefetch(local_batches(), device=device, size=prefetch)
