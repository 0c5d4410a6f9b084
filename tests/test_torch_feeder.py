"""The port's process-pool feeder (``projectiontrainer_tpu_torch/data/feeder.py``): the
cases of ``tests/test_feeder.py`` under the port — the shared-memory handoff in
order, parity with the thread feed (augmentation off and on), IO failures as invalid
samples, reproducible seeds, stream tags against abandoned and still-running
generators, seeds that do not shift under slot pressure — plus what the port adds:
any other worker error raised in the parent, the /dev/shm check, workers that load
neither torch nor cv2, and the shared memory unlinked on close. Pools of at most 2
workers, each closed."""

import json
import os

import numpy as np
import pytest
import torch

from projectiontrainer_tpu_torch.data import datasets, feeder, pipeline
from tests.util import make_word_tokenizer, write_jpeg

torch.set_num_threads(2)


def _manifest(root, n, *, missing=False, corrupt=False):
    samples = []
    for i in range(n):
        write_jpeg(root / f"img{i}.jpg", size=40, seed=i)
        samples.append({"image": f"img{i}.jpg", "normal_caption": f"class{i % 2}"})
    if corrupt:
        (root / "broken.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a jpeg")
        samples.append({"image": "broken.jpg", "normal_caption": "class1"})
    if missing:
        samples.append({"image": "missing.jpg", "normal_caption": "class0"})
    manifest = root / "train.json"
    manifest.write_text(json.dumps(samples))
    return manifest


def _dataset(root, manifest, **kw):
    return datasets.ContrastiveDataset.from_json(
        str(manifest), image_root=str(root), tokenizer=make_word_tokenizer(["class0", "class1"]),
        image_size=24, **kw)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_feed_imgs")
    return root, _manifest(root, 6, missing=True, corrupt=True)


@pytest.fixture(scope="module")
def contrastive_ds(corpus):
    return _dataset(*corpus)


@pytest.fixture(scope="module")
def pool():
    """One worker, as in tests/test_feeder.py: results come back in submission order,
    so a stream's end finds every stale slot of the stream before it reclaimed."""
    p = feeder.ProcessPixelPool(image_size=24, num_workers=1, slots_per_worker=4)
    yield p
    p.close()


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_protocol_detected(contrastive_ds):
    assert feeder.supports_process_feed(contrastive_ds)
    assert not feeder.supports_process_feed(object())


def test_process_feed_matches_sync(contrastive_ds, pool):
    """Order-preserving parity with in-process __getitem__ (no augmentation: the
    worker runs the exact PIL-bicubic preprocess path)."""
    idx = list(range(len(contrastive_ds)))
    got = list(feeder.map_samples_processes(contrastive_ds, idx, pool))
    _assert_same(got, [contrastive_ds[i] for i in idx])


@pytest.mark.parametrize("augment", [False, True])
def test_process_feed_matches_thread_feed(corpus, pool, augment):
    """The same dataset seed through the thread feed (jobs drawn in index order, run on
    2 threads) and through the process feeder gives the same samples, augmented too."""
    idx = [5, 0, 3, 3, 1, 4, 2, 0]
    threads = list(pipeline.map_samples(_dataset(*corpus, augment=augment, seed=9), idx,
                                        num_workers=2))
    procs = list(feeder.map_samples_processes(_dataset(*corpus, augment=augment, seed=9),
                                              idx, pool))
    _assert_same(procs, threads)
    assert all(s["valid"] for s in procs)
    if augment:  # the two draws of index 3 (and of 0) differ: one seed per sample
        assert not np.array_equal(procs[2]["pixel_values"], procs[3]["pixel_values"])


def test_missing_and_unreadable_images_yield_invalid(contrastive_ds, pool):
    """missing.jpg resolves to (None, ...) in the parent; broken.jpg fails to decode in
    the worker (an OSError): both come back as the dataset's invalid placeholder."""
    names = [s["image"] for s in contrastive_ds.samples]
    idx = [names.index("missing.jpg"), names.index("broken.jpg"), 0]
    got = list(feeder.map_samples_processes(contrastive_ds, idx, pool))
    assert [bool(s["valid"]) for s in got] == [False, False, True]
    assert not got[1]["pixel_values"].any()


class _BadSeedDataset:
    """A protocol dataset whose job carries a seed numpy refuses (a TypeError in the
    worker: not an IO failure)."""

    image_size = 24

    def __init__(self, path):
        self.path = path

    def pixel_job(self, idx):
        return self.path, "not a seed"

    def finish_pixels(self, idx, pixels):
        return {"pixels": pixels}


def test_other_worker_errors_raise_in_the_parent(corpus, pool):
    root, _ = corpus
    with pytest.raises(feeder.WorkerError, match="TypeError") as info:
        list(feeder.map_samples_processes(_BadSeedDataset(str(root / "img0.jpg")), [0, 1],
                                          pool))
    assert "img0.jpg" in str(info.value) and "Traceback" in str(info.value)
    # the pool still serves the next stream
    got = list(feeder.map_samples_processes(_dataset(*corpus), [1], pool))
    assert got[0]["valid"]


def test_epoch_batches_with_procs(corpus):
    """epoch_batches(num_procs=2) gives num_procs=0's batches, batch for batch, with
    augmentation on (the pool comes from get_pool and is closed after)."""
    try:
        got = list(pipeline.epoch_batches(_dataset(*corpus, augment=True, seed=4), batch_size=3,
                                          epoch=1, device="cpu", seed=0, num_procs=2,
                                          prefetch=1))
        assert feeder._pools, "the process feeder was not used"
    finally:
        feeder.close_pools()
    ref = list(pipeline.epoch_batches(_dataset(*corpus, augment=True, seed=4), batch_size=3,
                                      epoch=1, device="cpu", seed=0, num_workers=2, prefetch=1))
    assert len(got) == len(ref) == 3
    for b, r in zip(got, ref):
        assert b.keys() == r.keys()
        for k in b:
            torch.testing.assert_close(b[k], r[k], rtol=0, atol=0)


def test_augment_seeds_reproducible(corpus):
    """With augment=True the parent draws per-sample seeds from the dataset rng:
    two datasets with the same seed produce identical jobs."""
    a, b = _dataset(*corpus, augment=True, seed=7), _dataset(*corpus, augment=True, seed=7)
    first = a.pixel_job(0)
    assert first == b.pixel_job(0) and first[1] is not None
    assert a.pixel_job(0) != first  # stream advances


def test_abandoned_stream_does_not_poison_next(contrastive_ds, pool):
    """A generator dropped mid-epoch leaves in-flight tickets/slots behind; the next
    stream must still yield the CORRECT pixels for every index."""
    idx = list(range(6))  # valid images only
    g = feeder.map_samples_processes(contrastive_ds, idx, pool)
    next(g)
    g.close()

    rev = list(reversed(idx))
    got = list(feeder.map_samples_processes(contrastive_ds, rev, pool))
    _assert_same(got, [contrastive_ds[i] for i in rev])
    assert len(pool._free) == pool.n_slots  # no slot leaked across the two streams


def test_live_stale_generator_stops_instead_of_stealing(contrastive_ds, pool):
    """An abandoned generator that is STILL RUNNING (as on a device_prefetch feeder
    thread) terminates quietly once a newer stream starts, without consuming the live
    stream's results."""
    import time

    idx = list(range(6))
    old = feeder.map_samples_processes(contrastive_ds, idx, pool)
    first_old = next(old)
    np.testing.assert_array_equal(first_old["pixel_values"],
                                  contrastive_ds[idx[0]]["pixel_values"])

    rev = list(reversed(idx))
    new = feeder.map_samples_processes(contrastive_ds, rev, pool)
    first_new = next(new)  # supersedes the old stream

    leftovers = list(old)
    assert len(leftovers) < len(idx)
    for offset, sample in enumerate(leftovers, start=1):
        np.testing.assert_array_equal(sample["pixel_values"],
                                      contrastive_ds[idx[offset]]["pixel_values"])

    got = [first_new] + list(new)
    _assert_same(got, [contrastive_ds[i] for i in rev])

    s3 = pool.new_stream()  # drain straggler old-stream results
    deadline = time.monotonic() + 30
    while len(pool._free) < pool.n_slots and time.monotonic() < deadline:
        pool.poll(s3, timeout=0.5)
    assert len(pool._free) == pool.n_slots


def test_slot_pressure_does_not_shift_aug_seeds(tmp_path):
    """One shared slot but max_inflight=3: the submit loop draws a job, fails
    try_submit, and must retry WITHOUT a fresh draw: exactly one draw per index, in
    order, matching a sequential draw from a fresh dataset."""
    manifest = _manifest(tmp_path, 6)
    expected = _dataset(tmp_path, manifest, augment=True, seed=11)
    expected_jobs = [expected.pixel_job(i) for i in range(6)]

    seen = []
    ds = _dataset(tmp_path, manifest, augment=True, seed=11)
    orig = ds.pixel_job

    def spy(idx):
        job = orig(idx)
        seen.append((idx, job))
        return job

    ds.pixel_job = spy
    p = feeder.ProcessPixelPool(image_size=24, num_workers=1, slots_per_worker=1)
    try:
        got = list(feeder.map_samples_processes(ds, range(6), p, max_inflight=3))
    finally:
        p.close()
    assert len(got) == 6
    assert [s[0] for s in seen] == list(range(6))
    assert [s[1] for s in seen] == expected_jobs


def test_pool_that_does_not_fit_in_shared_memory_raises(monkeypatch):
    monkeypatch.setattr(feeder, "shm_free_bytes", lambda: 64 * 2 ** 20)
    with pytest.raises(RuntimeError, match=r"201326592 bytes of shared memory .* 67108864"):
        feeder.ProcessPixelPool(image_size=512, num_workers=8)


def test_workers_load_neither_torch_nor_cv2_and_close_unlinks(corpus):
    """After decoding and augmenting, no worker has torch's or cv2's libraries mapped
    (nor libcuda); close() stops them and unlinks the slot pool."""
    p = feeder.ProcessPixelPool(image_size=24, num_workers=2, slots_per_worker=2,
                                omp_threads=1)
    try:
        ds = _dataset(*corpus, augment=True, seed=1)
        assert len(list(feeder.map_samples_processes(ds, list(range(6)) * 4, p))) == 24
        native_loaded = 0
        for pid in p.pids:
            with open(f"/proc/{pid}/maps") as f:
                maps = f.read()
            native_loaded += "libptt_pipeline" in maps
            for lib in ("libtorch", "cv2", "libcuda"):
                assert lib not in maps, (pid, lib)
            with open(f"/proc/{pid}/environ", "rb") as f:
                assert b"OMP_NUM_THREADS=1" in f.read().split(b"\0")
        assert native_loaded >= 1  # the workers that augmented ran the C++ pipeline
        name = p._shm.name
        assert os.path.exists(os.path.join(feeder.SHM_DIR, name))
    finally:
        p.close()
    assert not os.path.exists(os.path.join(feeder.SHM_DIR, name))
    assert not any(proc.is_alive() for proc in p._procs)
