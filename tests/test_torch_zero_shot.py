"""Zero-shot SigLIP classification in the port against the JAX package, fp32 on the CPU:
``ZeroShotClassifier.predict`` probabilities within 1e-4 (weights carried by
``from_jax``, and read from one HF snapshot by each package's ``load_siglip``), the
prompts, ``multi_label_accuracy``, and ``zero_shot_classify.main`` end to end on a tiny
snapshot. The port encodes the class prompts once; the probabilities are those of
JAX's per-call text forward."""

import json

import jax
import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.checkpoint import hf_import as jhf_import
from projectiontrainer_tpu.eval import zero_shot as jzero_shot
from projectiontrainer_tpu.models import siglip as JSIGLIP
from projectiontrainer_tpu_torch.checkpoint import from_jax, hf_import
from projectiontrainer_tpu_torch.cli import zero_shot_classify
from projectiontrainer_tpu_torch.eval import zero_shot

torch.set_num_threads(2)
CLASSES = ["Pneumonia", "Edema", "Cardiomegaly", "No Finding"]


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    from transformers import SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("torch_zero_shot")
    tok = T.word_tokenizer()
    torch.manual_seed(0)
    vis = str(base / "siglip-tiny")
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4, vocab_size=len(tok.get_vocab()),
                                     max_position_embeddings=16).to_dict(),
    )).save_pretrained(vis)
    tok.save_pretrained(vis)
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=10, image_size=32)
    return dict(vis=vis, tok=tok, root=root, manifest=manifest)


def _pixels(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, size=(n, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("template", ["xray", "photo", "plain", "A film with {label} in it"])
def test_predict_matches_jax(template):
    jcfg = T.tiny_siglip_cfg()
    jparams = jax.tree.map(np.asarray, JSIGLIP.init(jax.random.key(0), jcfg))
    tok = T.word_tokenizer()
    theirs = jzero_shot.ZeroShotClassifier(jcfg, jparams, tok, CLASSES, template=template,
                                           max_text_len=16)
    ours = zero_shot.ZeroShotClassifier(from_jax.config_from_jax(jcfg),
                                        from_jax.siglip_params(jparams), tok, CLASSES,
                                        template=template, max_text_len=16)
    pixels = _pixels(6)
    p_ours, i_ours = ours.predict(pixels)
    p_theirs, i_theirs = theirs.predict(pixels)
    np.testing.assert_allclose(p_ours, p_theirs, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(i_ours, i_theirs)
    # the cached prompt embeddings give what a text forward per call gives
    from projectiontrainer_tpu_torch.models import siglip

    with torch.no_grad():
        again = siglip.logits_per_image(ours.params, ours.cfg, torch.tensor(pixels),
                                        ours.class_ids)
    np.testing.assert_allclose(torch.softmax(again, -1).numpy(), p_ours, atol=1e-6, rtol=0)


def test_predict_from_one_snapshot_matches_jax(snapshot):
    """Each package's ``load_siglip`` over the same HF snapshot, fp32."""
    tok = snapshot["tok"]
    jcfg, jparams = jhf_import.load_siglip(snapshot["vis"])
    cfg, params = hf_import.load_siglip(snapshot["vis"], vision_dtype=torch.float32,
                                        text_dtype=torch.float32)
    theirs = jzero_shot.ZeroShotClassifier(jcfg, jparams, tok, CLASSES, max_text_len=16)
    ours = zero_shot.ZeroShotClassifier(cfg, params, tok, CLASSES, max_text_len=16)
    pixels = _pixels(5, seed=1)
    np.testing.assert_allclose(ours.predict(pixels)[0], theirs.predict(pixels)[0],
                               atol=1e-4, rtol=0)
    batches = [{"pixel_values": pixels, "class_idx": np.array([0, 1, 2, 3, 0])}]
    assert ours.evaluate(batches) == theirs.evaluate(batches)


@pytest.mark.parametrize("template", ["xray", "photo", "plain", "custom {label}!"])
def test_build_prompts_equal(template):
    assert zero_shot.build_prompts(CLASSES, template) == jzero_shot.build_prompts(
        CLASSES, template)


def test_multi_label_accuracy_equal():
    rng = np.random.default_rng(2)
    preds = [CLASSES[i] for i in rng.integers(0, 4, size=50)]
    gts = [", ".join(CLASSES[j] for j in rng.choice(4, size=int(rng.integers(1, 3)),
                                                     replace=False)).upper()
           for _ in range(50)]
    assert zero_shot.multi_label_accuracy(preds, gts) == jzero_shot.multi_label_accuracy(
        preds, gts)
    assert zero_shot.multi_label_accuracy([], []) == 0.0


def test_cli_end_to_end(snapshot, tmp_path):
    out = str(tmp_path / "zs.json")
    acc = zero_shot_classify.main([
        "--model_name", snapshot["vis"], "--data_json", snapshot["manifest"],
        "--image_root", snapshot["root"], "--class_names", ",".join(CLASSES),
        "--img_size", "32", "--batch_size", "4", "--max_text_len", "16",
        "--output_json", out, "--device", "cpu",
    ])
    with open(out) as f:
        report = json.load(f)
    assert report["accuracy"] == acc and 0.0 <= acc <= 1.0
    preds = report["predictions"]
    assert len(preds) == 10 and all(r["predicted"] in CLASSES for r in preds)
    assert acc == zero_shot.multi_label_accuracy([r["predicted"] for r in preds],
                                                 [r["normal_caption"] for r in preds])


def test_cli_custom_template_and_device_default():
    args = zero_shot_classify.build_parser().parse_args([
        "--model_name", "m", "--data_json", "d", "--image_root", "r", "--class_names", "a",
        "--template", "custom", "--custom_template", "{label}"])
    assert args.device == "cuda" and args.template == "custom"
