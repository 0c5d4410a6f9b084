"""The t-SNE analysis in the port against the JAX package on the CPU: ``balance_classes``
picks the same samples (the same ``default_rng`` draws), ``compute_image_embeddings``
(pooled MAP output, and the projector over patches 1:) agrees within 1e-4 in fp32,
``tsne_2d`` + ``plot_tsne`` write a PNG, and ``tsne_analysis.main`` plots every
snapshot of an ``--epochs_root`` (and one snapshot through a stage-1 projector)."""

import os

import jax
import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.eval import tsne as jtsne
from projectiontrainer_tpu.models import projector as JPROJ
from projectiontrainer_tpu.models import siglip as JSIGLIP
from projectiontrainer_tpu_torch.checkpoint import export, from_jax
from projectiontrainer_tpu_torch.cli import tsne_analysis
from projectiontrainer_tpu_torch.eval import tsne
from projectiontrainer_tpu_torch.models import projector as proj

torch.set_num_threads(2)
CLASSES = ["No Finding", "Edema", "Cardiomegaly", "Pneumonia"]


def _manifest(seed, n=40):
    rng = np.random.default_rng(seed)
    labels = CLASSES + ["Other"]
    return [{"image": f"img_{i}.jpg", "normal_caption": labels[int(k)] + " " * int(k % 2)}
            for i, k in enumerate(rng.choice(5, size=n, p=[0.4, 0.1, 0.2, 0.2, 0.1]))]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("classes", [CLASSES, CLASSES[:2], ["No Finding", "Absent"]])
def test_balance_classes_selects_the_same_samples(seed, classes):
    samples = _manifest(seed)
    ours = tsne.balance_classes(samples, classes, seed=seed)
    assert ours == jtsne.balance_classes(samples, classes, seed=seed)
    assert ours or "Absent" in classes


@pytest.mark.parametrize("through_projector", [False, True])
def test_embeddings_match_jax(through_projector):
    jcfg = T.tiny_siglip_cfg()
    jparams = jax.tree.map(np.asarray, JSIGLIP.init(jax.random.key(0), jcfg))
    pcfg = JPROJ.ProjectorConfig(vision_dim=32, llm_dim=24, expansion_factor=2)
    jproj = jax.tree.map(np.asarray, JPROJ.init(jax.random.key(1), pcfg))
    rng = np.random.default_rng(2)
    batches = [rng.uniform(-1, 1, size=(n, 32, 32, 3)).astype(np.float32) for n in (4, 3)]
    theirs = jtsne.compute_image_embeddings(
        jparams["vision"], jcfg.vision, batches,
        projector_params=jproj if through_projector else None)
    ours = tsne.compute_image_embeddings(
        from_jax.vision_params(jparams["vision"], head=True),
        from_jax.config_from_jax(jcfg.vision), batches,
        projector_params=from_jax.projector_params(jproj) if through_projector else None)
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    assert ours.shape == (7, 24 if through_projector else 32)
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)


def test_tsne_2d_and_plot_write_a_png(tmp_path):
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((12, 16)).astype(np.float32)
    pts = tsne.tsne_2d(emb, seed=4)
    np.testing.assert_allclose(pts, jtsne.tsne_2d(emb, seed=4), atol=1e-4)
    out = str(tmp_path / "t.png")
    tsne.plot_tsne(pts, [CLASSES[i % 4] for i in range(12)], out)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module")
def stage0_dir(tmp_path_factory):
    """A stage-0 output directory: two exported epochs, a file that is not a snapshot,
    and a corpus of 12 images."""
    from transformers import SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("torch_tsne")
    root = base / "s0out"
    for i, tag in enumerate(("epoch_1", "epoch_0", "checkpoints")):
        torch.manual_seed(i)
        model = SiglipModel(SiglipConfig(
            vision_config=SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                             num_hidden_layers=2, num_attention_heads=4,
                                             image_size=32, patch_size=8).to_dict(),
            text_config=SiglipTextConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         vocab_size=64, max_position_embeddings=16).to_dict()))
        if tag == "checkpoints":
            os.makedirs(root / tag)
        else:
            model.save_pretrained(str(root / tag))
    images, manifest = T.synthetic_corpus(str(base / "corpus"), n=12, image_size=32)
    return dict(root=str(root), images=images, manifest=manifest, base=base)


def _argv(d, *extra):
    return ["--data_json", d["manifest"], "--image_root", d["images"], "--img_size", "32",
            "--batch_size", "5", "--classes", ",".join(CLASSES), "--device", "cpu", *extra]


def test_cli_epochs_root_plots_every_snapshot(stage0_dir, tmp_path):
    assert [t for t, _ in tsne_analysis._epoch_snapshot_dirs(stage0_dir["root"])] == [
        "epoch_0", "epoch_1"]
    out = str(tmp_path / "plots")
    written = tsne_analysis.main(_argv(stage0_dir, "--epochs_root", stage0_dir["root"],
                                       "--output", out))
    assert written == [os.path.join(out, "tsne_epoch_0.png"),
                       os.path.join(out, "tsne_epoch_1.png")]
    assert all(os.path.getsize(p) > 0 for p in written)


def test_cli_one_snapshot_through_a_projector(stage0_dir, tmp_path):
    pdir = str(tmp_path / "s1")
    pcfg = proj.ProjectorConfig(vision_dim=32, llm_dim=16, expansion_factor=2)
    export.save_projector(proj.init(torch.Generator().manual_seed(0), pcfg), pcfg, pdir)
    out = str(tmp_path / "one.png")
    assert tsne_analysis.main(_argv(stage0_dir, "--model_name",
                                    os.path.join(stage0_dir["root"], "epoch_0"),
                                    "--projector_path", pdir, "--output", out)) == out
    assert os.path.getsize(out) > 0


def test_cli_needs_exactly_one_source(stage0_dir):
    with pytest.raises(SystemExit):
        tsne_analysis.main(_argv(stage0_dir))
    with pytest.raises(SystemExit):
        tsne_analysis.main(_argv(stage0_dir, "--model_name", "a", "--epochs_root", "b"))
