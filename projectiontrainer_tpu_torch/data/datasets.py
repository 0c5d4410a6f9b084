"""JSON-manifest datasets for every stage, producing numpy samples (the port's own copy
of the JAX package's ``data/datasets.py``).

Stage 0's online augmentation draws one seed per sample from the dataset's generator
in ``pixel_job`` and augments with ``default_rng(seed)`` (:func:`job_pixels`); the
thread feed draws the jobs in index order as the process feeder does, so both give the
same pixels. (The JAX package's thread path shares one generator across its threads.)

Manifest field names match the reference exactly so its data files work unchanged:

- Stage 1 pairs: ``{"image", "normal_caption"}`` (Stage1/train_projection_stage1.py:55-112)
- Stage 2 VQA:   ``{"image", "problem", "normal_caption"}`` (Stage2/dataset.py:60-126)
- Stage 0 contrastive: ``{"image", "normal_caption"}`` with empty-caption filtering and
  sorted-unique class names (Stage0/train_vision_encoder_stage0.py:111-155)
- classification: ``{"image", "normal_caption"}`` single label with the Abnormal remap
  (cls_evaluate/models.py:14-91)

Error handling follows the reference: broken samples skip to the next index (VQA/cls), or
yield an invalid placeholder filtered at batch time (contrastive). Unlike the torch
version, samples are plain numpy dicts consumed by data/pipeline.py, which owns batching,
bucketing, shuffling, host sharding, and device prefetch.
"""

from __future__ import annotations

import json
import threading
from typing import Optional, Sequence

import numpy as np

from projectiontrainer_tpu_torch.data import image as I


class LockedTokenizer:
    """Thread-safe wrapper around an HF fast tokenizer: the underlying Rust object is
    not re-entrant ("Already borrowed" under concurrent encode), and datasets run on
    the pipeline's thread pool. Tokenization is cheap next to image decode, so a lock
    (not per-thread copies) is the right trade."""

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        with self._lock:
            return self._tok(*args, **kwargs)

    def decode(self, *args, **kwargs):
        # decode borrows the same Rust object; the serving path decodes on the device
        # worker while handler threads encode
        with self._lock:
            return self._tok.decode(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._tok, name)


def load_manifest(json_file: str) -> list[dict]:
    with open(json_file, encoding="utf-8") as f:
        return json.load(f)


def train_val_split(samples: Sequence, val_ratio: float, seed: int = 42):
    """sklearn-style shuffled split (reference uses train_test_split at
    Stage1/train_projection_stage1.py:284-288; random_split 95/5 in Stage 0)."""
    idx = np.random.default_rng(seed).permutation(len(samples))
    n_val = int(round(len(samples) * val_ratio))
    val_idx, train_idx = idx[:n_val], idx[n_val:]
    return [samples[i] for i in train_idx], [samples[i] for i in val_idx]


class Stage1PairDataset:
    """Image-caption pairs; captions tokenized to a FIXED ``max_length`` with max-length
    padding (already static-shape in the reference — SURVEY §5.7)."""

    def __init__(self, samples, image_root, tokenizer, image_size, *, max_length=512,
                 image_root_2=None):
        self.samples = list(samples)
        self.image_root = image_root
        self.image_root_2 = image_root_2
        self.tokenizer = LockedTokenizer(tokenizer)
        self.image_size = image_size
        self.max_length = max_length

    @classmethod
    def from_json(cls, json_file, **kw):
        return cls(load_manifest(json_file), **kw)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx) -> dict:
        sample = self.samples[idx]
        pixels = I.load_and_preprocess(
            sample["image"], self.image_size, self.image_root, self.image_root_2
        )
        return self.finish_pixels(idx, pixels)

    # ------------------------------------------------- process-feed protocol

    def pixel_job(self, idx):
        """(path, aug_seed) for the process-pool feeder (data/feeder.py)."""
        try:
            return I.resolve_image_path(
                self.samples[idx]["image"], self.image_root, self.image_root_2
            ), None
        except FileNotFoundError:
            return None, None

    def finish_pixels(self, idx, pixels) -> dict:
        if pixels is None:  # worker IO failure -> same error the sync path raises
            return self[idx]
        sample = self.samples[idx]
        enc = self.tokenizer(
            sample["normal_caption"], max_length=self.max_length,
            padding="max_length", truncation=True,
        )
        return {
            "pixel_values": pixels,
            "caption_ids": np.asarray(enc["input_ids"], np.int32),
        }


class Stage2VQADataset:
    """(image, problem, normal_caption) triplets. Question tokenized WITHOUT special
    tokens, answer WITH (reference: Stage2/dataset.py:102-113); sequences stay unpadded
    here — the bucketed batcher pads to static shapes."""

    def __init__(self, samples, image_root, tokenizer, image_size, *, max_q_len=128,
                 max_a_len=512, image_root_2=None):
        self.samples = list(samples)
        self.image_root = image_root
        self.image_root_2 = image_root_2
        self.tokenizer = LockedTokenizer(tokenizer)
        self.image_size = image_size
        self.max_q_len = max_q_len
        self.max_a_len = max_a_len

    @classmethod
    def from_json(cls, json_file, **kw):
        return cls(load_manifest(json_file), **kw)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx) -> dict:
        for attempt in range(len(self.samples)):
            sample = self.samples[(idx + attempt) % len(self.samples)]
            if not all(sample.get(k) for k in ("image", "problem", "normal_caption")):
                continue
            try:
                pixels = I.load_and_preprocess(
                    sample["image"], self.image_size, self.image_root, self.image_root_2
                )
            except (FileNotFoundError, OSError):
                continue
            q = self.tokenizer(
                sample["problem"], max_length=self.max_q_len, truncation=True,
                add_special_tokens=False,
            )["input_ids"]
            a = self.tokenizer(
                sample["normal_caption"], max_length=self.max_a_len, truncation=True,
            )["input_ids"]
            return {
                "pixel_values": pixels,
                "question_ids": np.asarray(q, np.int32),
                "answer_ids": np.asarray(a, np.int32),
            }
        raise RuntimeError("no valid samples in dataset")

    def token_lengths(self) -> tuple[np.ndarray, np.ndarray]:
        """(q_lens, a_lens) for every index — text tokenization only, no image IO.
        Feeds the deterministic global bucket plan: every host computes the same plan
        from the same lengths, so multi-host bucket shapes and batch counts agree.

        Indices whose sample has missing fields get the lengths of the sample
        ``__getitem__`` would actually substitute (the skip-broken recursion —
        reference: Stage2/dataset.py:67,80), so the plan matches the fetch. Only
        image-IO failures discovered at fetch time can still diverge; those are rare,
        and ``pad_to`` clamps the substitute to the planned bucket."""
        problems = [str(s.get("problem", "")) for s in self.samples]
        answers = [str(s.get("normal_caption", "")) for s in self.samples]
        q = self.tokenizer(
            problems, max_length=self.max_q_len, truncation=True, add_special_tokens=False
        )["input_ids"]
        a = self.tokenizer(answers, max_length=self.max_a_len, truncation=True)["input_ids"]
        q_lens = np.asarray([len(x) for x in q], np.int32)
        a_lens = np.asarray([len(x) for x in a], np.int32)
        valid = np.asarray([
            all(s.get(k) for k in ("image", "problem", "normal_caption"))
            for s in self.samples
        ])
        if not valid.all():
            n = len(self.samples)
            for i in np.nonzero(~valid)[0]:
                for attempt in range(1, n):
                    j = (i + attempt) % n
                    if valid[j]:
                        q_lens[i], a_lens[i] = q_lens[j], a_lens[j]
                        break
        return q_lens, a_lens


def job_pixels(path: str, aug_seed: Optional[int], size: int) -> np.ndarray:
    """The pixels of one ``pixel_job``: decode, then the SigLIP preprocess, or with a
    seed the sampled augmentation from ``default_rng(aug_seed)``. The process feeder's
    workers (``data/feeder.py``) and the thread feed (``pipeline.map_samples``) both run
    this, so the two give the same pixels."""
    from projectiontrainer_tpu_torch.data.augmentation import augment_and_preprocess_fast

    img = I.load_image(path)
    if aug_seed is None:
        return I.preprocess(img, size)
    return augment_and_preprocess_fast(np.asarray(img), size,
                                       rng=np.random.default_rng(aug_seed))


def sample_from_job(dataset, idx: int, job: tuple) -> dict:
    """``dataset``'s sample ``idx`` from its drawn ``pixel_job``, in this process: what a
    feeder worker computes, finished by ``finish_pixels`` (None pixels on an IO
    failure)."""
    path, aug_seed = job
    pixels = None
    if path is not None:
        try:
            pixels = job_pixels(path, aug_seed, dataset.image_size)
        except OSError:
            pixels = None
    return dataset.finish_pixels(idx, pixels)


class ContrastiveDataset:
    """Stage-0 image-caption pairs with class indices for zero-shot validation. Invalid
    samples return ``valid=False`` placeholders, filtered at batch time (the reference's
    zero-tensor + collate-filter pattern, Stage0:163-169,237-257)."""

    def __init__(self, samples, image_root, tokenizer, image_size, *, max_text_len=64,
                 image_root_2=None, augment: bool = False, seed: int = 0):
        samples = [
            s for s in samples if str(s.get("normal_caption", "")).strip()
        ]
        self.samples = samples
        self.image_root = image_root
        self.image_root_2 = image_root_2
        self.tokenizer = LockedTokenizer(tokenizer)
        self.image_size = image_size
        self.max_text_len = max_text_len
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        self.class_names = sorted({str(s["normal_caption"]) for s in samples})
        self._class_to_idx = {c: i for i, c in enumerate(self.class_names)}

    @classmethod
    def from_json(cls, json_file, **kw):
        return cls(load_manifest(json_file), **kw)

    def __len__(self):
        return len(self.samples)

    def _invalid(self):
        return {
            "pixel_values": np.zeros((self.image_size, self.image_size, 3), np.float32),
            "input_ids": np.zeros((self.max_text_len,), np.int32),
            "class_idx": np.int32(0),
            "valid": np.bool_(False),
        }

    def __getitem__(self, idx) -> dict:
        """The sample, augmented with a seed drawn here when ``augment`` is on; an
        unreadable image gives the invalid placeholder."""
        return sample_from_job(self, idx, self.pixel_job(idx))

    # ------------------------------------------------- process-feed protocol

    def pixel_job(self, idx):
        """(path, aug_seed) for the process-pool feeder; augmentation randomness is
        drawn from the dataset rng here so the parent keeps the single stream."""
        try:
            path = I.resolve_image_path(
                self.samples[idx]["image"], self.image_root, self.image_root_2
            )
        except FileNotFoundError:
            return None, None
        seed = int(self.rng.integers(0, 2 ** 31 - 1)) if self.augment else None
        return path, seed

    def finish_pixels(self, idx, pixels) -> dict:
        if pixels is None:  # IO failure in the worker -> invalid placeholder
            return self._invalid()
        caption = str(self.samples[idx]["normal_caption"])
        enc = self.tokenizer(
            caption, padding="max_length", truncation=True, max_length=self.max_text_len,
        )
        return {
            "pixel_values": pixels,
            "input_ids": np.asarray(enc["input_ids"], np.int32),
            "class_idx": np.int32(self._class_to_idx[caption]),
            "valid": np.bool_(True),
        }


ABNORMAL = "Abnormal"


class ClassificationDataset:
    """Single-label classification samples for the cls_evaluate probe, with the
    ``handle_abnormal`` source-class remap (cls_evaluate/models.py:40-50)."""

    def __init__(self, samples, image_root, class_names, image_size, *, image_root_2=None,
                 handle_abnormal=False, abnormal_source_classes=()):
        self.samples = list(samples)
        self.image_root = image_root
        self.image_root_2 = image_root_2
        self.class_names = list(class_names)
        self.image_size = image_size
        self.handle_abnormal = handle_abnormal
        self.abnormal_source_classes = set(abnormal_source_classes)
        self._class_to_idx = {c: i for i, c in enumerate(self.class_names)}

    def __len__(self):
        return len(self.samples)

    def target_index(self, label: str) -> int:
        if self.handle_abnormal and label in self.abnormal_source_classes:
            return self._class_to_idx.get(ABNORMAL, -1)
        return self._class_to_idx.get(label, -1)

    def __getitem__(self, idx) -> dict:
        for attempt in range(len(self.samples)):
            sample = self.samples[(idx + attempt) % len(self.samples)]
            label = str(sample.get("normal_caption", "")).strip()
            target = self.target_index(label)
            if target == -1 or not sample.get("image"):
                continue
            try:
                pixels = I.load_and_preprocess(
                    sample["image"], self.image_size, self.image_root, self.image_root_2
                )
            except (FileNotFoundError, OSError):
                continue
            return {"pixel_values": pixels, "target_indices": np.int32(target)}
        raise RuntimeError("no valid samples in dataset")


class MultiLabelClassificationDataset:
    """Multi-hot targets for the two-way-loss trainer: ``normal_caption`` may contain
    comma-separated labels; each recognized label sets its class bit (reference:
    cls_evaluate/train_twoway_loss.py:41-112 — unrecognized labels leave zeros)."""

    def __init__(self, samples, image_root, class_names, image_size, *, image_root_2=None):
        self.samples = list(samples)
        self.image_root = image_root
        self.image_root_2 = image_root_2
        self.class_names = list(class_names)
        self.image_size = image_size
        self._class_to_idx = {c: i for i, c in enumerate(self.class_names)}

    def __len__(self):
        return len(self.samples)

    def multi_hot(self, caption: str) -> np.ndarray:
        vec = np.zeros((len(self.class_names),), np.float32)
        for label in str(caption).split(","):
            idx = self._class_to_idx.get(label.strip())
            if idx is not None:
                vec[idx] = 1.0
        return vec

    def __getitem__(self, idx) -> dict:
        for attempt in range(len(self.samples)):
            sample = self.samples[(idx + attempt) % len(self.samples)]
            if not sample.get("image"):
                continue
            try:
                pixels = I.load_and_preprocess(
                    sample["image"], self.image_size, self.image_root, self.image_root_2
                )
            except (FileNotFoundError, OSError):
                continue
            return {
                "pixel_values": pixels,
                "targets": self.multi_hot(sample.get("normal_caption", "")),
            }
        raise RuntimeError("no valid samples in dataset")


def stratified_split(samples, *, val_ratio: float = 0.1, seed: int = 42,
                     label_key: str = "normal_caption"):
    """Per-class proportional split (reference: cls_evaluate/train_utils.py:180-190)."""
    rng = np.random.default_rng(seed)
    by_label: dict[str, list[int]] = {}
    for i, s in enumerate(samples):
        by_label.setdefault(str(s.get(label_key, "")), []).append(i)
    train_idx, val_idx = [], []
    for idxs in by_label.values():
        idxs = list(rng.permutation(idxs))
        n_val = max(1, int(round(len(idxs) * val_ratio))) if len(idxs) > 1 else 0
        val_idx.extend(idxs[:n_val])
        train_idx.extend(idxs[n_val:])
    return [samples[i] for i in train_idx], [samples[i] for i in val_idx]


def balanced_sample(samples, *, candidate_labels, per_label: int, seed: int = 42,
                    label_key: str = "normal_caption"):
    """Exact-label filter + per-label sample + shuffle — the reference's
    balanced_random_sample.py:16-73 as a library function."""
    rng = np.random.default_rng(seed)
    out = []
    for label in candidate_labels:
        matching = [s for s in samples if str(s.get(label_key, "")).strip() == label]
        take = min(per_label, len(matching))
        sel = rng.choice(len(matching), size=take, replace=False) if matching else []
        out.extend(matching[i] for i in sel)
    perm = rng.permutation(len(out))
    return [out[i] for i in perm]
