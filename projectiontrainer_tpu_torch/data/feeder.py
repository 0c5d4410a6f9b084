"""Process-pool image feeder with shared-memory handoff (the port's counterpart of the
JAX package's ``data/feeder.py``).

The thread pool of ``data/pipeline.py`` tops out near one core's decode+augment
throughput: PIL's JPEG decoder and the native C++ kernels release the GIL, but the
Python orchestration between them serializes. So the image hot path scales across
PROCESSES:

- N ``spawn``-context workers run decode (PIL) + the sampled augment + fused native
  preprocess (``datasets.job_pixels``); a worker imports neither torch nor cv2 and
  never touches the card;
- pixel tensors come back through a ``multiprocessing.shared_memory`` slot pool
  (float32 [S, S, C] slots): a worker writes its slot in place and sends only
  ``(ticket, slot, ok, error)`` through the result queue — no pickling of megabyte
  arrays through pipes;
- the parent copies a finished slot into the sample dict (one memcpy, ~100x
  cheaper than the decode) and frees it immediately, then finishes the sample
  host-side (tokenization, labels) via the dataset's ``finish_pixels`` hook.

Datasets opt in with two methods (ContrastiveDataset and Stage1PairDataset):

    pixel_job(idx)            -> (path | None, augment_seed | None)
    finish_pixels(idx, pixels | None) -> sample dict  (None = worker IO failure)

Failures: a worker's ``FileNotFoundError``/``OSError`` (a missing or unreadable
image) comes back as ``ok=False`` and the dataset's ``finish_pixels(idx, None)``
decides (stage 0: an invalid placeholder). Any other exception in a worker comes back
with its traceback and is raised in the parent: a broken build or a missing library
must not turn into silently short batches.
"""

from __future__ import annotations

import atexit
import collections
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import threading
import time
import traceback
from multiprocessing import shared_memory
from typing import Iterator, Optional

import numpy as np

_SENTINEL = ("__stop__",)

# Tickets crossing the worker queues are (stream << _TICKET_BITS) | ticket — a
# generation tag per sample stream, so an ABANDONED stream (consumer raised or the
# feed was dropped mid-epoch; its generator may still be running on a detached
# device_prefetch feeder thread) cannot poison the next one: ticket numbering
# restarts at 0 every stream, and only the tag disambiguates the two. poll() takes
# the CALLER's stream id — results for older streams are reclaimed, results for
# newer streams are buffered for their own consumer, and a caller whose stream has
# been superseded gets StaleStreamError instead of stealing the live stream's work.
_TICKET_BITS = 40
_TICKET_MASK = (1 << _TICKET_BITS) - 1
SHM_DIR = "/dev/shm"
_env_lock = threading.Lock()


class StaleStreamError(RuntimeError):
    """Raised by poll() when a newer stream has started: the calling generator was
    abandoned by its consumer and must stop draining the shared result queue."""


class WorkerError(RuntimeError):
    """A feeder worker failed on a sample with an error other than an unreadable
    image; the message carries the worker's traceback."""


def _worker_main(shm_name: str, n_slots: int, size: int, channels: int, task_q, result_q):
    """Worker loop: decode + augment + preprocess into the shared slot."""
    from projectiontrainer_tpu_torch.data.datasets import job_pixels

    shm = shared_memory.SharedMemory(name=shm_name)
    slots = np.ndarray((n_slots, size, size, channels), np.float32, buffer=shm.buf)
    try:
        while True:
            task = task_q.get()
            if task == _SENTINEL:
                break
            ticket, slot, path, aug_seed = task
            try:
                slots[slot] = job_pixels(path, aug_seed, size)
                result_q.put((ticket, slot, True, None))
            except OSError:  # FileNotFoundError too: an IO failure, as the thread path
                result_q.put((ticket, slot, False, None))
            except Exception:  # noqa: BLE001 - raised in the parent with this traceback
                result_q.put((ticket, slot, False, traceback.format_exc()))
    finally:
        del slots
        shm.close()


def shm_free_bytes() -> Optional[int]:
    """Free bytes of the shared-memory mount (None where there is none)."""
    if not os.path.isdir(SHM_DIR):
        return None
    return shutil.disk_usage(SHM_DIR).free


class ProcessPixelPool:
    """A pool of decode+augment worker processes writing into shared-memory slots.

    One pool per (image_size, num_workers, omp_threads) lives for the
    process lifetime (see :func:`get_pool`) — spawn + import cost is paid once, then
    epochs reuse it. ``omp_threads`` sets ``OMP_NUM_THREADS`` in the workers (the C++
    pipeline's loops are OpenMP-parallel); None keeps the OpenMP default, one thread a
    core in every worker.
    """

    def __init__(self, *, image_size: int, num_workers: int, channels: int = 3,
                 slots_per_worker: int = 8, omp_threads: Optional[int] = None):
        self.image_size = image_size
        self.channels = channels
        self.num_workers = num_workers
        self.omp_threads = omp_threads
        self.n_slots = max(2, num_workers * slots_per_worker)
        nbytes = self.n_slots * image_size * image_size * channels * 4
        free = shm_free_bytes()
        if free is not None and free < nbytes:
            # a write past the mount's end kills the worker with SIGBUS, not an error
            raise RuntimeError(
                f"the feeder's slot pool needs {nbytes} bytes of shared memory "
                f"({self.n_slots} slots of {image_size}x{image_size}x{channels} float32 for "
                f"{num_workers} workers) but {SHM_DIR} has {free} bytes free: use fewer "
                "--num_loader_procs or a larger /dev/shm")
        # the native library is built once here, not by N workers at the same time
        from projectiontrainer_tpu_torch.runtime import native

        native.build()
        self._shm = shared_memory.SharedMemory(create=True, size=nbytes)
        self.slots = np.ndarray(
            (self.n_slots, image_size, image_size, channels), np.float32,
            buffer=self._shm.buf,
        )
        ctx = mp.get_context("spawn")
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._procs = [
            ctx.Process(
                target=_worker_main,
                args=(self._shm.name, self.n_slots, image_size, channels,
                      self._task_q, self._result_q),
                daemon=True,
            )
            for _ in range(num_workers)
        ]
        # a spawned child takes os.environ as it is at start(); OpenMP reads it once
        with _env_lock:
            saved = os.environ.get("OMP_NUM_THREADS")
            if omp_threads is not None:
                os.environ["OMP_NUM_THREADS"] = str(omp_threads)
            try:
                for p in self._procs:
                    p.start()
            finally:
                if saved is None:
                    os.environ.pop("OMP_NUM_THREADS", None)
                else:
                    os.environ["OMP_NUM_THREADS"] = saved
        self._free = collections.deque(range(self.n_slots))
        self._closed = False
        self._stream_gen = 0
        # an abandoned stream's generator can poll concurrently with the live one
        # (both on device_prefetch feeder threads) — guard the shared slot/pending
        # bookkeeping; the mp queues are internally thread-safe already
        self._lock = threading.Lock()
        # results read off _result_q by one stream's poll that belong to another
        # (newer) stream: buffered here for that stream's own consumer
        self._pending: dict[int, collections.deque] = {}

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self._procs]

    # -------------------------------------------------------------- submission

    def new_stream(self) -> int:
        """Start a new sample stream and return its id: outstanding tickets from any
        previous stream become stale — their slots are reclaimed as their results
        drain through poll() — and ticket numbering may restart at 0 without
        collisions."""
        with self._lock:
            self._stream_gen += 1
            # a pending buffer for a now-superseded stream will never be polled —
            # reclaim its slots here or the slot pool leaks
            for g in [g for g in self._pending if g < self._stream_gen]:
                for _ticket, slot, _ok, _err in self._pending.pop(g):
                    self._free.append(slot)
            return self._stream_gen

    def try_submit(self, stream: int, ticket: int, path: str,
                   aug_seed: Optional[int]) -> Optional[int]:
        """Atomically claim a free slot and enqueue the task; None when no slot is
        free (check-then-submit as two calls would race between streams)."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.popleft()
        self._task_q.put(((stream << _TICKET_BITS) | ticket, slot, path, aug_seed))
        return slot

    def poll(self, stream: int, timeout: Optional[float] = None):
        """Next finished (ticket, slot, ok, error) for ``stream``, or None on timeout.

        Results for streams OLDER than the caller are consumed internally and their
        slots freed; results for NEWER streams are buffered for that stream's own
        poll. Raises StaleStreamError once the caller's stream has been superseded —
        the abandoned generator must stop draining the shared queue."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                buf = self._pending.get(stream)
                if buf:
                    item = buf.popleft()
                    if not buf:
                        del self._pending[stream]
                    return item
                if stream != self._stream_gen:
                    raise StaleStreamError(
                        f"stream {stream} superseded by {self._stream_gen}"
                    )
            wait = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                tagged, slot, ok, err = self._result_q.get(
                    timeout=min(wait, 0.5) if wait is not None else 0.5)
            except queue_mod.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    return None
                continue  # re-check pending/staleness between short waits
            g, ticket = tagged >> _TICKET_BITS, tagged & _TICKET_MASK
            if g == stream:
                return ticket, slot, ok, err
            with self._lock:
                if g > stream:
                    # a newer stream's result — hand it to that consumer
                    self._pending.setdefault(g, collections.deque()).append(
                        (ticket, slot, ok, err))
                else:
                    self._free.append(slot)  # abandoned-stream slot reclaimed

    def raise_if_dead(self):
        """Raise :class:`WorkerError` when a worker has exited (it cannot report)."""
        dead = [(p.pid, p.exitcode) for p in self._procs if p.exitcode is not None]
        if dead and not self._closed:
            raise WorkerError(f"feeder workers exited (pid, exit code): {dead}")

    def take(self, slot: int) -> np.ndarray:
        """Copy the slot's pixels out and free the slot."""
        out = self.slots[slot].copy()
        with self._lock:
            self._free.append(slot)
        return out

    def release(self, slot: int):
        with self._lock:
            self._free.append(slot)

    # -------------------------------------------------------------- lifecycle

    def close(self):
        """Stop the workers and unlink the shared memory."""
        if self._closed:
            return
        self._closed = True
        for _ in self._procs:
            try:
                self._task_q.put(_SENTINEL)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        del self.slots
        self._shm.close()
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass


_pools: dict = {}
# OMP_NUM_THREADS of the workers get_pool starts, read when it makes a pool (None:
# OpenMP's default, a thread a core in every worker, which N workers oversubscribe
# N-fold while augmenting)
WORKER_OMP_THREADS: Optional[int] = 1


def get_pool(image_size: int, num_workers: int) -> ProcessPixelPool:
    """Process-lifetime pool cache (spawn + PIL/native import cost paid once), its
    workers at ``WORKER_OMP_THREADS``."""
    key = (image_size, num_workers, WORKER_OMP_THREADS)
    pool = _pools.get(key)
    if pool is None or pool._closed:
        pool = ProcessPixelPool(image_size=image_size, num_workers=num_workers,
                                omp_threads=WORKER_OMP_THREADS)
        _pools[key] = pool
    return pool


@atexit.register
def close_pools():
    """Close every cached pool (also run at exit)."""
    for pool in _pools.values():
        pool.close()
    _pools.clear()


def supports_process_feed(dataset) -> bool:
    return hasattr(dataset, "pixel_job") and hasattr(dataset, "finish_pixels")


def map_samples_processes(dataset, indices, pool: ProcessPixelPool,
                          *, max_inflight: Optional[int] = None) -> Iterator[dict]:
    """Order-preserving sample stream with image work on the process pool.

    For each index: ``pixel_job`` describes the image fetch; workers fill shared
    slots out of order; samples are finished (tokenization etc.) and yielded in
    submission order. Indices whose job is ``(None, ...)`` and IO failures in a worker
    go to ``finish_pixels(idx, None)``; any other worker error raises
    :class:`WorkerError`.
    """
    indices = [int(i) for i in indices]
    stream = pool.new_stream()  # invalidate any abandoned prior stream's tickets/slots
    if max_inflight is None:
        max_inflight = pool.n_slots - 1
    inflight: dict[int, int] = {}          # ticket -> slot
    done: dict[int, tuple] = {}            # ticket -> (pixels | None)
    local: dict[int, bool] = {}            # tickets resolved without the pool
    paths: dict[int, str] = {}             # ticket -> path, for a worker's error
    pending_job: Optional[tuple] = None    # job drawn but not yet submitted
    next_submit = 0
    next_yield = 0
    n = len(indices)

    def _submit_more():
        # pixel_job may consume dataset RNG (the per-sample augmentation seed), so it
        # must be called exactly once per ticket: cache the drawn job across failed
        # try_submit attempts or retries would shift the whole downstream seed stream
        # depending on slot-availability timing (nondeterministic training data)
        nonlocal next_submit, pending_job
        while next_submit < n and len(inflight) < max_inflight:
            idx = indices[next_submit]
            if pending_job is None:
                pending_job = dataset.pixel_job(idx)
            path, aug_seed = pending_job
            if path is None:
                local[next_submit] = True
            else:
                slot = pool.try_submit(stream, next_submit, path, aug_seed)
                if slot is None:
                    return  # no free slot right now — retry after the next poll
                inflight[next_submit] = slot
                paths[next_submit] = path
            pending_job = None
            next_submit += 1

    try:
        _submit_more()
        while next_yield < n:
            while next_yield < n and (next_yield in local or next_yield in done):
                idx = indices[next_yield]
                if next_yield in local:
                    local.pop(next_yield)
                    sample = dataset.finish_pixels(idx, None)
                else:
                    sample = dataset.finish_pixels(idx, done.pop(next_yield))
                next_yield += 1
                yield sample
                _submit_more()
            if next_yield >= n:
                break
            # short-poll loop: draining an abandoned stream's stale results inside
            # poll() frees slots, so re-run _submit_more between polls — otherwise a
            # stream starting with zero free slots could wait forever on work it was
            # never able to submit
            deadline = time.monotonic() + 120.0
            while True:
                result = pool.poll(stream, timeout=2.0)
                _submit_more()
                if result is not None:
                    break
                pool.raise_if_dead()
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        "process feeder stalled: no worker result within 120s "
                        f"({len(inflight)} in flight)"
                    )
            ticket, slot, ok, err = result
            inflight.pop(ticket, None)
            path = paths.pop(ticket, None)
            if ok:
                done[ticket] = pool.take(slot)
            else:
                pool.release(slot)
                if err is not None:
                    raise WorkerError(f"feeder worker failed on {path}:\n{err}")
                done[ticket] = None
            _submit_more()
    except StaleStreamError:
        # a newer stream started: this generator's consumer is gone (abandoned
        # mid-epoch on a prefetch thread) — stop quietly instead of competing for
        # the live stream's results
        return
