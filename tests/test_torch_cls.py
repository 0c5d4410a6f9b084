"""The port's cls probe modules against the JAX package's, fp32 on the CPU.

Weights come from the JAX ``classifier.init`` on a tiny tower (2 layers, hidden 32, 4
heads, 16 px, patch 8; 5 classes) and cross through ``from_jax.classifier_params``;
inputs are numpy draws from a seed. Tolerances, stated per check:

- ``classifier.forward`` logits within 1e-5 x max |reference| (with and without the
  tower's MAP head, which the classifier never runs);
- ``params_from_torch_state_dict``: the same tree as JAX's, leaf for leaf exactly;
- ``softmax_ce_loss`` / ``two_way_multilabel_loss`` within 1e-6 relative, over seeds,
  with filler rows and with columns that lack positives;
- ``classifier_labels`` equal to JAX's, leaf for leaf;
- ``discriminative_optimizer``: 5 updates within 1e-6 of optax's (absolute, on
  parameters of magnitude ~1);
- ``classifier_loss``: loss within 1e-6 relative, each gradient within 1e-4 x max
  |reference|; the unused MAP head after 3 ``Unfreeze`` steps within 1e-6 of JAX's
  (zero gradients, decayed by AdamW);
- the port's dropout by its own statistics (keep rate, scale, one seed one mask);
- ``eval/metrics.binary_auroc`` bit-equal to sklearn's ``roc_auc_score``;
- ``ClsConfig`` fields, defaults and class-name mapping equal to JAX's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.core import config as jconfig
from projectiontrainer_tpu.models import classifier as JC
from projectiontrainer_tpu.train import losses as JL
from projectiontrainer_tpu.train import masks as JM
from projectiontrainer_tpu.train import optim as JO
from projectiontrainer_tpu.train import steps as JS
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.core import config
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
from projectiontrainer_tpu_torch.eval import metrics
from projectiontrainer_tpu_torch.models import classifier
from projectiontrainer_tpu_torch.train import losses, masks, optim, steps

torch.set_num_threads(2)
NUM_CLASSES = 5
# biases that shift every class's logit by the same amount
CLASS_SHARED = ("vision/post_layernorm/bias", "mha/v_proj/bias", "mha/out_proj/bias",
                "head/bias")


def rel_close(ours, theirs, tol):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    err = np.abs(ours - theirs).max()
    assert err <= tol * max(np.abs(theirs).max(), 1e-30), f"max err {err} vs {np.abs(theirs).max()}"


@functools.cache
def _jax_model(use_head: bool):
    vcfg = T.tiny_vision_cfg(image_size=16, patch=8, hidden=32, layers=2, heads=4,
                             use_head=use_head)
    jcfg = JC.ClassifierConfig(vision=vcfg, num_classes=NUM_CLASSES, num_heads=4,
                               dropout_rate=0.0)
    return jcfg, jax.tree.map(np.asarray, JC.init(jax.random.key(0), jcfg))


def _models(use_head: bool = False):
    jcfg, jp = _jax_model(use_head)
    cfg = classifier.ClassifierConfig(vision=from_jax.config_from_jax(jcfg.vision),
                                      num_classes=NUM_CLASSES, num_heads=4, dropout_rate=0.0)
    return jcfg, jp, cfg, from_jax.classifier_params(jp)


def _pixels(rng, b=4):
    return rng.standard_normal((b, 16, 16, 3), dtype=np.float32)


@pytest.mark.parametrize("use_head", [False, True])
def test_forward_matches_jax(use_head):
    jcfg, jp, cfg, p = _models(use_head)
    assert ("head" in p["vision"]) == use_head
    x = _pixels(np.random.default_rng(1))
    theirs = JC.forward(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x))
    ours = classifier.forward(p, cfg, torch.tensor(x))
    assert ours.shape == (4, NUM_CLASSES)
    rel_close(ours, theirs, 1e-5)


def _reference_state_dict(seed=3):
    """A reference ``.pth`` model_state_dict: an HF SiglipVisionModel under
    ``vision_model.`` (with its MAP head) and torch's MultiheadAttention + Linear head."""
    from transformers import SiglipVisionConfig
    from transformers.models.siglip.modeling_siglip import SiglipVisionModel

    torch.manual_seed(seed)
    tower = SiglipVisionModel(SiglipVisionConfig(hidden_size=32, intermediate_size=128,
                                                 num_hidden_layers=2, num_attention_heads=4,
                                                 image_size=16, patch_size=8))
    mha = torch.nn.MultiheadAttention(32, 4, batch_first=True)
    head = torch.nn.Linear(32, 1)
    sd = {"vision_model." + k.removeprefix("vision_model."): v.detach().numpy().copy()
          for k, v in tower.state_dict().items()}
    sd["abnormality_queries"] = torch.randn(1, NUM_CLASSES, 32).numpy()
    for k, v in mha.state_dict().items():
        sd["mha." + k] = v.detach().numpy().copy()
    for k, v in head.state_dict().items():
        sd["classification_head." + k] = v.detach().numpy().copy()
    return sd


def test_params_from_torch_state_dict_matches_jax():
    jcfg, _, cfg, _ = _models(use_head=True)
    sd = _reference_state_dict()
    theirs = from_jax.classifier_params(jax.tree.map(
        np.asarray, JC.params_from_torch_state_dict(jcfg, sd)))
    ours = classifier.params_from_torch_state_dict(cfg, sd)
    a, b = dict(leaves_with_paths(ours)), dict(leaves_with_paths(theirs))
    assert a.keys() == b.keys() and "vision/head/probe" in a
    for path in a:
        torch.testing.assert_close(a[path], b[path], rtol=0, atol=0, msg=path)
    x = _pixels(np.random.default_rng(2))
    rel_close(classifier.forward(ours, cfg, torch.tensor(x)),
              JC.forward(JC.params_from_torch_state_dict(jcfg, sd), jcfg, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_ce_loss_matches_jax(seed, weighted):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((6, NUM_CLASSES)).astype(np.float32) * 3
    targets = rng.integers(0, NUM_CLASSES, 6).astype(np.int32)
    w = np.array([1, 1, 1, 1, 0, 0], np.float32) if weighted else None  # two filler rows
    theirs = JL.softmax_ce_loss(jnp.asarray(logits), jnp.asarray(targets),
                                None if w is None else jnp.asarray(w))
    ours = losses.softmax_ce_loss(torch.tensor(logits), torch.tensor(targets),
                                  None if w is None else torch.tensor(w))
    rel_close(ours, theirs, 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["plain", "filler", "column_without_positives", "both"])
def test_two_way_multilabel_loss_matches_jax(seed, case):
    rng = np.random.default_rng(10 + seed)
    logits = rng.standard_normal((6, NUM_CLASSES)).astype(np.float32) * 2
    targets = (rng.random((6, NUM_CLASSES)) < 0.4).astype(np.float32)
    targets[0] = 1.0  # a row without negatives (its sample term is 0)
    w = None
    if case in ("column_without_positives", "both"):
        targets[:, 2] = 0.0
    if case in ("filler", "both"):
        w = np.array([1, 1, 1, 1, 0, 0], np.float32)
        targets[4:] = 1.0  # fillers would make every column look positive
    kw = dict(t_p=4.0, t_n=1.0)
    theirs = JL.two_way_multilabel_loss(jnp.asarray(logits), jnp.asarray(targets),
                                        sample_weights=None if w is None else jnp.asarray(w),
                                        **kw)
    ours = losses.two_way_multilabel_loss(torch.tensor(logits), torch.tensor(targets),
                                          sample_weights=None if w is None else torch.tensor(w),
                                          **kw)
    assert np.isfinite(float(ours))
    rel_close(ours, theirs, 1e-6)


def _port_labels_of(jlabels, jp):
    """A JAX label tree as the port's {path: label}: each label becomes an array of its
    code shaped like its leaf, carried across by ``from_jax.classifier_params``."""
    names = sorted({l for l in jax.tree.leaves(jlabels)})
    codes = jax.tree.map(lambda l, x: np.full(np.shape(x), names.index(l), np.float32),
                         jlabels, jp)
    return {p: names[int(x.flatten()[0])]
            for p, x in leaves_with_paths(from_jax.classifier_params(codes))}


@pytest.mark.parametrize("freeze", [False, True])
def test_classifier_labels_match_jax(freeze):
    _, jp, _, p = _models(use_head=True)
    theirs = _port_labels_of(JM.classifier_labels(jp, freeze_vision=freeze), jp)
    ours = dict(leaves_with_paths(masks.classifier_labels(p, freeze_vision=freeze)))
    assert ours == theirs
    assert set(ours.values()) == ({"head", "frozen"} if freeze else {"head", "backbone"})


@pytest.mark.parametrize("freeze", [False, True])
def test_discriminative_optimizer_matches_optax(freeze):
    """5 updates from the same seeded gradients; the head at 1e-2 and the tower at 1e-3
    (constant), weight decay 0.05."""
    _, jp, _, p = _models(use_head=True)
    jlabels = JM.classifier_labels(jp, freeze_vision=freeze)
    kw = dict(head_lr=1e-2, backbone_lr=1e-3, weight_decay=0.05)
    jtx, jsched = JO.discriminative_optimizer(jlabels, total_steps=5, **kw)
    tx, sched = optim.discriminative_optimizer(masks.classifier_labels(p, freeze_vision=freeze),
                                               **kw)
    assert sched(3) == pytest.approx(float(jsched(3)))
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jtx.init(jparams)
    state = tx.init(p)
    rng = np.random.default_rng(5)
    for _ in range(5):
        grads = jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), jp)
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port_grads = dict(leaves_with_paths(from_jax.classifier_params(grads)))
        tx.update(port_grads, state, p)
    theirs = dict(leaves_with_paths(from_jax.classifier_params(jax.tree.map(np.asarray,
                                                                            jparams))))
    start = dict(leaves_with_paths(_models(use_head=True)[3]))
    for path, x in leaves_with_paths(p):
        np.testing.assert_allclose(x.numpy(), theirs[path].numpy(), rtol=0, atol=1e-6,
                                   err_msg=path)
        moved = not torch.equal(x, start[path])
        assert moved == (not (freeze and path.startswith("vision/"))), path


def test_classifier_loss_and_grads_match_jax():
    jcfg, jp, cfg, p = _models(use_head=True)
    rng = np.random.default_rng(6)
    batch = {"pixel_values": _pixels(rng),
             "target_indices": rng.integers(0, NUM_CLASSES, 4).astype(np.int32),
             "sample_weight": np.array([1, 1, 1, 0], np.float32)}
    jloss_fn = JS.classifier_loss(jcfg)
    jloss, jgrads = jax.value_and_grad(lambda pr: jloss_fn(pr, jax.tree.map(jnp.asarray, batch),
                                                           None)[0])(jax.tree.map(jnp.asarray, jp))
    train = [(path, x) for path, x in leaves_with_paths(p)]
    for _, x in train:
        x.requires_grad_(True)
    loss, aux = steps.classifier_loss(cfg)(p, {k: torch.tensor(v) for k, v in batch.items()})
    assert aux["logits"].shape == (4, NUM_CLASSES)
    grads = torch.autograd.grad(loss, [x for _, x in train], allow_unused=True)
    rel_close(loss, jloss, 1e-6)
    theirs = dict(leaves_with_paths(from_jax.classifier_params(jax.tree.map(np.asarray, jgrads))))
    for (path, _), g in zip(train, grads):
        if path.startswith("vision/head/"):  # never run: no gradient, zero in JAX
            assert g is None and not np.asarray(theirs[path]).any(), path
        elif path.endswith("k_proj/bias") or path in CLASS_SHARED:
            # zero in exact arithmetic: a key bias adds one constant to a softmax row; the
            # class-shared biases move every class's logit alike (the CE's gradient over
            # the classes sums to 0): both sides hold rounding noise
            assert max(float(g.abs().max()), float(np.abs(np.asarray(theirs[path])).max())) < 1e-6
        else:
            rel_close(g, theirs[path], 1e-4)


def test_unused_map_head_decays_like_jax():
    """Unfreeze: the MAP head gets zero gradients in both packages and AdamW's
    decoupled decay shrinks it; after 3 steps its leaves equal JAX's."""
    jcfg, jp, cfg, p = _models(use_head=True)
    rng = np.random.default_rng(7)
    batches = [{"pixel_values": _pixels(rng),
                "target_indices": rng.integers(0, NUM_CLASSES, 4).astype(np.int32)}
               for _ in range(3)]
    kw = dict(head_lr=1e-2, backbone_lr=1e-2, weight_decay=0.1)
    jlabels = JM.classifier_labels(jp, freeze_vision=False)
    jtx, _ = JO.discriminative_optimizer(jlabels, total_steps=3, **kw)
    jstep = JS.make_train_step(JS.classifier_loss(jcfg), jtx, donate=False,
                               trainable_mask=JM.bool_mask(jlabels))
    jstate = JS.init_state(jax.tree.map(jnp.asarray, jp), jtx)
    labels = masks.classifier_labels(p, freeze_vision=False)
    tx, _ = optim.discriminative_optimizer(labels, **kw)
    step = steps.make_train_step(steps.classifier_loss(cfg), tx,
                                 trainable_mask=masks.bool_mask(labels))
    state = steps.init_state(p, tx)
    probe0 = p["vision"]["head"]["probe"].clone()
    for i, b in enumerate(batches):
        jstate, jloss, _ = jstep(jstate, jax.tree.map(jnp.asarray, b), jax.random.key(i))
        state, loss, _ = step(state, {k: torch.tensor(v) for k, v in b.items()}, i)
        rel_close(loss, jloss, 1e-5)
    theirs = dict(leaves_with_paths(from_jax.classifier_params(
        jax.tree.map(np.asarray, jstate["params"]))))
    head = [(path, x) for path, x in leaves_with_paths(state["params"])
            if path.startswith("vision/head/")]
    assert len(head) == 15  # probe, 4 projections, LayerNorm, MLP
    for path, x in head:
        np.testing.assert_allclose(x.detach().numpy(), theirs[path].numpy(), rtol=0, atol=1e-6,
                                   err_msg=path)
    # decay alone: probe * (1 - lr * wd)^3
    torch.testing.assert_close(state["params"]["vision"]["head"]["probe"],
                               probe0 * (1 - 1e-2 * 0.1) ** 3, rtol=1e-6, atol=0)


def test_dropout_statistics():
    """The head's dropout: keep rate 1 - p, kept values scaled by 1 / (1 - p), one seed
    giving one mask, another seed another; off without a generator."""
    h = torch.ones((1000, 1000))
    p = 0.1
    a = classifier.dropout(h, p, torch.Generator().manual_seed(3))
    b = classifier.dropout(h, p, torch.Generator().manual_seed(3))
    c = classifier.dropout(h, p, torch.Generator().manual_seed(4))
    keep = a != 0
    assert abs(float(keep.float().mean()) - (1 - p)) < 2e-3  # ~6 standard deviations
    assert torch.equal(a[keep], torch.full_like(a[keep], 1 / (1 - p)))
    assert torch.equal(a, b) and not torch.equal(a, c)
    _, _, cfg, params = _models()
    cfg = dataclasses.replace(cfg, dropout_rate=0.5)
    x = torch.tensor(_pixels(np.random.default_rng(8)))
    plain = classifier.forward(params, cfg, x)
    on = [classifier.forward(params, cfg, x, dropout_gen=torch.Generator().manual_seed(s))
          for s in (1, 1, 2)]
    assert torch.equal(on[0], on[1]) and not torch.equal(on[0], on[2])
    assert not torch.equal(on[0], plain)


@pytest.mark.parametrize("scores", ["continuous", "ties", "float32", "integers"])
def test_binary_auroc_equals_sklearn_bits(scores):
    """The card's machine has no sklearn: the AUROC repeats roc_auc_score in numpy."""
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(9)
    for _ in range(200):
        n = int(rng.integers(2, 200))
        y = rng.integers(0, 2, n)
        if y.min() == y.max():
            continue
        s = {"continuous": lambda: rng.random(n), "ties": lambda: np.round(rng.random(n), 1),
             "float32": lambda: rng.random(n).astype(np.float32),
             "integers": lambda: rng.integers(0, 5, n).astype(np.float64)}[scores]()
        assert metrics.binary_auroc(y, s) == roc_auc_score(y, s)


def test_cls_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(config.ClsConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jconfig.ClsConfig)}
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    for kw in ({"class_names": "No Finding,Atelectasis,Cardiomegaly,Effusion"},
               {"class_names": "No Finding,Atelectasis,Effusion", "handle_abnormal": True},
               {"class_names": "No Finding,Atelectasis", "filter_no_finding": True},
               {"class_names": " Edema , No Finding,", "handle_abnormal": True,
                "filter_no_finding": True}):
        a, b = config.ClsConfig(**kw), jconfig.ClsConfig(**kw)
        assert a.effective_class_names() == b.effective_class_names()
        assert a.abnormal_source_classes == b.abnormal_source_classes


def test_checkpoint_restore_params_and_metadata(tmp_path):
    """An evaluator's restore: params only, every leaf required; metadata without
    reading tensors."""
    _, _, _, p = _models(use_head=True)
    state = {"params": p, "opt_state": {"count": 3, "mu": {}, "nu": {}}, "step": 3}
    mgr = CheckpointManager(str(tmp_path),
                            save_paths=[path for path, _ in leaves_with_paths(p)])
    mgr.save_best(0.5, state, {"epoch": 1, "model_config": {"num_classes": NUM_CLASSES}})
    assert mgr.metadata("best") == {"epoch": 1, "model_config": {"num_classes": NUM_CLASSES},
                                    "best_metric": 0.5}
    fresh = _models(use_head=True)[3]
    for _, x in leaves_with_paths(fresh):
        x.zero_()
    mgr.restore_params("best", fresh)
    for (path, a), (_, b) in zip(leaves_with_paths(fresh), leaves_with_paths(p)):
        assert torch.equal(a, b), path
    fresh["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="lacks 1 leaves"):
        mgr.restore_params("best", fresh)
