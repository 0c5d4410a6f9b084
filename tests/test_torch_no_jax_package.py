"""The port imports neither jax nor any module of the JAX package, and its own copies
of the JAX package's numpy-only modules (data/bucketing, data/image, data/datasets,
eval/metrics) give the same results as the originals on seeded inputs (exact equality:
the copies repeat the same numpy arithmetic), and its copies of the quantization
constants (NF4_CODE, NF4_BLOCK, QUANT_TARGETS, QUANT_KEYS), the LoRA targets and the
PEFT key scheme equal the originals, as do its copies of the zero-shot prompt templates
and the diagnostic prompt of the generation evaluation."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.data import augmentation as jax_augmentation
from projectiontrainer_tpu.data import bucketing as jax_bucketing
from projectiontrainer_tpu.data import datasets as jax_datasets
from projectiontrainer_tpu.data import image as jax_image
from projectiontrainer_tpu.eval import metrics as jax_metrics
from projectiontrainer_tpu_torch.data import augmentation, bucketing, datasets, image
from projectiontrainer_tpu_torch.eval import metrics

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "projectiontrainer_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "projectiontrainer_tpu")


def _forbidden(name: str) -> bool:
    return any(name == root or name.startswith(root + ".") for root in FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_the_jax_package(path):
    """Every import statement of the file, at any depth (inside functions too)."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                found.append((node.lineno, node.module))
    assert not found, f"{path.relative_to(REPO)} imports {found}"


def test_entry_points_load_nothing_of_the_jax_package():
    code = (
        "import sys\n"
        "from projectiontrainer_tpu_torch.cli import (infer_vqa_stage2, serve, train_stage0,\n"
        "                                             train_stage1, train_stage2)\n"
        "from projectiontrainer_tpu_torch.cli import (balanced_sample, cls_evaluate_experiment,\n"
        "                                             cls_test, cls_train, run_experiments)\n"
        "from projectiontrainer_tpu_torch.cli import (_scripts, infer_generation, infer_stage1,\n"
        "                                             tsne_analysis, zero_shot_classify)\n"
        "from projectiontrainer_tpu_torch.eval import tsne, zero_shot\n"
        "from projectiontrainer_tpu_torch.train import (trainer_cls, trainer_stage0,\n"
        "                                               trainer_stage1, trainer_stage2)\n"
        "from projectiontrainer_tpu_torch.eval import sweep\n"
        "from projectiontrainer_tpu_torch.models import classifier\n"
        "from projectiontrainer_tpu_torch.data import augmentation, feeder, pipeline\n"
        "from projectiontrainer_tpu_torch.runtime import native\n"
        "from projectiontrainer_tpu_torch.cli import launch\n"
        "from projectiontrainer_tpu_torch.core import mesh\n"
        "from projectiontrainer_tpu_torch.parallel import distributed\n"
        "from projectiontrainer_tpu_torch.parallel import budget\n"
        "from projectiontrainer_tpu_torch.cli import budget as budget_cli\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'projectiontrainer_tpu' or m.startswith('projectiontrainer_tpu.')]\n"
        "assert not bad, bad\n"
        "lazy = [m for m in ('PIL', 'sklearn', 'cv2', 'scipy') if m in sys.modules]\n"
        "assert not lazy, lazy\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


# ------------------------------------------------------- the copies against the originals


def _samples(rng, n):
    return [{"pixel_values": rng.standard_normal((4, 4, 3)).astype(np.float32),
             "input_ids": rng.integers(0, 50, size=6).astype(np.int32)} for _ in range(n)]


@pytest.mark.parametrize("n,batch,drop,fill", [(7, 2, False, True), (7, 4, True, True),
                                               (5, 4, False, False), (8, 4, False, True)])
def test_fixed_batcher_copy(n, batch, drop, fill):
    samples = _samples(np.random.default_rng(0), n)
    kw = dict(drop_remainder=drop, repeat_to_fill=fill)
    got = list(bucketing.fixed_batcher(samples, batch, **kw))
    ref = list(jax_bucketing.fixed_batcher(samples, batch, **kw))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("case", ["bucket_for", "buckets_covering", "defaults", "pad_to"])
def test_bucketing_copy(case):
    rng = np.random.default_rng(1)
    if case == "defaults":
        assert bucketing.DEFAULT_Q_BUCKETS == jax_bucketing.DEFAULT_Q_BUCKETS
        assert bucketing.DEFAULT_A_BUCKETS == jax_bucketing.DEFAULT_A_BUCKETS
    elif case == "bucket_for":
        for length in rng.integers(1, 256, size=64):
            assert (bucketing.bucket_for(int(length), bucketing.DEFAULT_Q_BUCKETS)
                    == jax_bucketing.bucket_for(int(length), jax_bucketing.DEFAULT_Q_BUCKETS))
    elif case == "buckets_covering":
        for max_len in (1, 16, 32, 33, 100, 256):
            assert (bucketing.buckets_covering(max_len, bucketing.DEFAULT_Q_BUCKETS)
                    == jax_bucketing.buckets_covering(max_len, jax_bucketing.DEFAULT_Q_BUCKETS))
    else:
        ids = rng.integers(1, 90, size=11).astype(np.int32)
        for side in ("left", "right"):
            np.testing.assert_array_equal(bucketing.pad_to(ids, 16, 0, side=side),
                                          jax_bucketing.pad_to(ids, 16, 0, side=side))


@pytest.mark.parametrize("source,size", [(48, 32), (32, 32), (20, 32)])
def test_image_preprocess_copy(source, size):
    arr = np.random.default_rng(2).integers(0, 256, size=(source, source, 3), dtype=np.uint8)
    got, ref = image.preprocess(arr, size), jax_image.preprocess(arr, size)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["stage1", "contrastive", "split"])
def test_datasets_copy(tmp_path, kind):
    root, manifest = T.synthetic_corpus(str(tmp_path), n=6, image_size=24)
    tok = T.word_tokenizer()
    assert datasets.load_manifest(manifest) == jax_datasets.load_manifest(manifest)
    samples = datasets.load_manifest(manifest)
    if kind == "split":
        assert (datasets.train_val_split(samples, 0.34, seed=3)
                == jax_datasets.train_val_split(samples, 0.34, seed=3))
        assert image.resolve_image_path("cxr_0.jpg", root) == jax_image.resolve_image_path(
            "cxr_0.jpg", root)
        return
    if kind == "stage1":
        kw = dict(image_root=root, tokenizer=tok, image_size=16, max_length=8)
        got, ref = datasets.Stage1PairDataset(samples, **kw), jax_datasets.Stage1PairDataset(
            samples, **kw)
    else:
        kw = dict(image_root=root, tokenizer=tok, image_size=16, max_text_len=8)
        got, ref = datasets.ContrastiveDataset(samples, **kw), jax_datasets.ContrastiveDataset(
            samples, **kw)
        assert got.class_names == ref.class_names
        # online augmentation: the seed pixel_job draws, through the JAX package's
        # augment_and_preprocess_fast, gives the port's augmented sample
        aug = datasets.ContrastiveDataset(samples, augment=True, seed=5, **kw)
        seeds = jax_datasets.ContrastiveDataset(samples, augment=True, seed=5, **kw)
        for i in (0, 5, 5):
            path, seed = seeds.pixel_job(i)
            assert seed is not None
            want = jax_augmentation.augment_and_preprocess_fast(
                np.asarray(jax_image.load_image(path)), 16, rng=np.random.default_rng(seed))
            np.testing.assert_array_equal(aug[i]["pixel_values"], want)
    assert len(got) == len(ref) == 6
    for i in (0, 5):
        a, b = got[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["last_word_accuracy", "substring_accuracy",
                                  "per_label_substring_accuracy", "accuracy",
                                  "confusion_and_stats", "macro_ovr_auroc", "zero_shot_prf"])
def test_metrics_copy(name):
    rng = np.random.default_rng(4)
    words = ["Pneumonia", "Edema", "Cardiomegaly", "No Finding"]
    generated = [f"the image shows {words[i]}" for i in rng.integers(0, 4, size=40)]
    targets = [words[i] for i in rng.integers(0, 4, size=40)]
    pred, target = rng.integers(0, 4, size=200), rng.integers(0, 4, size=200)
    if name in ("last_word_accuracy", "substring_accuracy", "per_label_substring_accuracy"):
        assert getattr(metrics, name)(generated, targets) == getattr(jax_metrics, name)(
            generated, targets)
    elif name == "accuracy":
        assert metrics.accuracy(pred, target) == jax_metrics.accuracy(pred, target)
    elif name == "confusion_and_stats":
        cm = metrics.confusion_matrix(pred, target, 4)
        np.testing.assert_array_equal(cm, jax_metrics.confusion_matrix(pred, target, 4))
        got, ref = metrics.per_class_stats(cm), jax_metrics.per_class_stats(cm)
        assert got.keys() == ref.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k])
    elif name == "macro_ovr_auroc":
        pytest.importorskip("sklearn")
        probs = rng.random((200, 4))
        probs /= probs.sum(-1, keepdims=True)
        assert metrics.macro_ovr_auroc(probs, target) == jax_metrics.macro_ovr_auroc(
            probs, target)
    else:
        pytest.importorskip("sklearn")
        assert metrics.zero_shot_prf(pred, target) == jax_metrics.zero_shot_prf(pred, target)


@pytest.mark.parametrize("name", ["NF4_CODE", "NF4_BLOCK", "QUANT_TARGETS", "QUANT_KEYS",
                                  "LORA_TARGETS", "PEFT_KEYS"])
def test_quant_and_lora_copies(name):
    """The port's copies of the JAX package's quantization constants, LoRA targets and
    PEFT key scheme."""
    from projectiontrainer_tpu.checkpoint import export as jax_export
    from projectiontrainer_tpu.ops import quant as jax_quant
    from projectiontrainer_tpu.train import lora as jax_lora
    from projectiontrainer_tpu_torch.checkpoint import export
    from projectiontrainer_tpu_torch.ops import quant
    from projectiontrainer_tpu_torch.train import lora

    if name == "NF4_CODE":
        assert quant.NF4_CODE.dtype == jax_quant.NF4_CODE.dtype
        np.testing.assert_array_equal(quant.NF4_CODE, jax_quant.NF4_CODE)
    elif name == "LORA_TARGETS":
        assert lora.TARGETS == jax_lora.TARGETS
    elif name == "PEFT_KEYS":
        for layer in (0, 35):
            for target in lora.TARGETS:
                for ab in ("A", "B"):
                    assert export.peft_key(layer, target, ab) == jax_export._peft_key(
                        layer, target, ab)
    else:
        assert getattr(quant, name) == getattr(jax_quant, name)


def test_augmentation_constants_copy():
    for name in ("SHIFT_MIN", "SHIFT_MAX", "SCALE_MIN", "SCALE_MAX", "CONTRAST_MIN",
                 "CONTRAST_MAX", "ELASTIC_ALPHA", "ELASTIC_SIGMA", "DEFAULT_PIPELINE"):
        assert getattr(augmentation, name) == getattr(jax_augmentation, name), name


def test_native_source_copy():
    """The port's pipeline.cpp is the original's code with one function added (the
    Gaussian blur of the elastic fields); only the header comment differs."""
    def code(path, drop_blur):
        text = path.read_text()
        text = text[text.index("#include <algorithm>"):]
        if drop_blur:
            start = text.index("// ---------------------------------------------------------"
                               "------------- blur")
            text = text[:start] + text[text.index("// Batch: each image has its own"):]
        return text

    csrc = "runtime/csrc/pipeline.cpp"
    assert (code(REPO / "projectiontrainer_tpu_torch" / csrc, True)
            == code(REPO / "projectiontrainer_tpu" / csrc, False))


@pytest.mark.parametrize("name", ["PROMPT_TEMPLATES", "DIAGNOSTIC_PROMPT"])
def test_prompt_copies(name):
    """The port's copies of the zero-shot prompt templates and the generation
    evaluation's diagnostic prompt."""
    if name == "PROMPT_TEMPLATES":
        from projectiontrainer_tpu.eval import zero_shot as jax_zero_shot
        from projectiontrainer_tpu_torch.eval import zero_shot

        assert zero_shot.PROMPT_TEMPLATES == jax_zero_shot.PROMPT_TEMPLATES
    else:
        from projectiontrainer_tpu.cli import infer_generation as jax_infer_generation
        from projectiontrainer_tpu_torch.cli import infer_generation

        assert infer_generation.DIAGNOSTIC_PROMPT == jax_infer_generation.DIAGNOSTIC_PROMPT


@pytest.mark.parametrize("name", ["FSDP_MIN_SIZE", "gemma3_4b", "full_joint_4b"])
def test_fsdp_and_gemma3_4b_copies(name):
    """The port's copies of the JAX package's ``--fsdp`` size threshold
    (``parallel/sharding.py``) and of Gemma3-4B's dims and BASELINE config #4's VLM
    (``parallel/budget.py``), field by field (the kernel choice is each package's own)."""
    import dataclasses

    from projectiontrainer_tpu.parallel import budget as jax_budget
    from projectiontrainer_tpu.parallel import sharding as jax_sharding
    from projectiontrainer_tpu_torch.checkpoint import from_jax
    from projectiontrainer_tpu_torch.models import decoder, vlm
    from projectiontrainer_tpu_torch.parallel import sharding

    if name == "FSDP_MIN_SIZE":
        assert sharding.FSDP_MIN_SIZE == jax_sharding.FSDP_MIN_SIZE
        return
    if name == "gemma3_4b":
        got, ref = decoder.gemma3_4b_config(), jax_budget.gemma3_4b_text_config()
        assert got.num_layers == 34 and got.hidden_size == 2560
    else:
        got, ref = vlm.full_joint_4b_config(), jax_budget.full_joint_4b_vlm_cfg()
        assert got.projector.intermediate_dim == 10_240
    assert dataclasses.asdict(got) == dataclasses.asdict(from_jax.config_from_jax(ref))
