"""The port's stage-1 train step against the JAX package's, fp32 on the CPU.

Weights come from ``vlm.init(jax.random.key(0), testing.tiny_vlm_cfg())`` and cross
through ``checkpoint/from_jax.py``; batches are numpy draws from a seed (captions
right-padded with the pad id 0, one straggler batch with a filler row of weight 0).

- ``stage1_loss``: loss and projector gradients against JAX ``steps.stage1_loss``,
  through the full-logits, chunked and fused CE paths, with full and partial remat.
  Tolerance 1e-4 relative (to the largest magnitude of each reference leaf).
- A 24-step loss curve through ``make_train_step`` + ``single_group_optimizer``
  (cosine warmup, clip, accumulation 2) against JAX's ``make_train_step`` with
  optax: every step's loss within 1e-4 relative, the final projector within 1e-4.
- A JAX train state carried across mid-run (``from_jax.stage1_train_state``)
  continues with the same losses.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu.train import masks as JM
from projectiontrainer_tpu.train import optim as JO
from projectiontrainer_tpu.train import steps as JS
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths
from projectiontrainer_tpu_torch.train import masks, optim, steps

torch.set_num_threads(2)
PAD = 0


def rel_close(ours, theirs, tol=1e-4):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    err = np.abs(ours - theirs).max()
    assert err <= tol * max(np.abs(theirs).max(), 1e-30), f"max err {err} vs {np.abs(theirs).max()}"


@functools.cache
def _jax_models(kw: tuple):
    jcfg = T.tiny_vlm_cfg(**dict(kw))
    init = jax.jit(JVLM.init, static_argnums=1)
    return jcfg, jax.tree.map(np.asarray, init(jax.random.key(0), jcfg))


def _models(**kw):
    jcfg, jparams = _jax_models(tuple(sorted(kw.items())))
    return jcfg, jparams, from_jax.config_from_jax(jcfg)


def _batch(rng, b=2, image=32, tc=12, vocab=128, filler=False):
    lengths = rng.integers(3, tc + 1, size=b)
    caps = np.full((b, tc), PAD, np.int64)
    for i, n in enumerate(lengths):
        caps[i, :n] = rng.integers(2, vocab, size=n)
    batch = {"pixel_values": rng.standard_normal((b, image, image, 3), dtype=np.float32),
             "caption_ids": caps.astype(np.int32)}
    if filler:
        batch["sample_weight"] = np.array([1.0] + [0.0] * (b - 1), np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


LOSS_CASES = {
    "full_logits": dict(kw={}, logits_chunk=None, ce="auto", remat=True),
    "chunked": dict(kw={}, logits_chunk=5, ce="chunked", remat=1),
    "fused_vs_chunked": dict(kw={"llm_hidden": 128}, logits_chunk=5, ce="fused", remat=True),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_stage1_loss_and_projector_grads_match_jax(case):
    c = LOSS_CASES[case]
    jcfg, jparams, cfg = _models(**c["kw"])
    batch = _batch(np.random.default_rng(0), filler=True)

    # JAX's remat does not change its numbers: it runs without, the port with
    jloss_fn = JS.stage1_loss(jcfg, PAD, remat=False, logits_chunk=c["logits_chunk"],
                              ce_impl="chunked" if c["ce"] == "fused" else c["ce"])
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, batch), None)

    params = from_jax.vlm_params(jparams)
    for _, x in leaves_with_paths(params["projector"]):
        x.requires_grad_(True)
    loss_fn = steps.stage1_loss(cfg, PAD, remat=c["remat"], logits_chunk=c["logits_chunk"],
                                ce_impl=c["ce"])
    loss, aux = loss_fn(params, _torch_batch(batch))
    loss.backward()
    rel_close(loss, jloss)
    assert int(aux["tokens"]) == int(jaux["tokens"])
    theirs = from_jax.projector_params(jax.tree.map(np.asarray, jgrads["projector"]))
    for (path, g), (_, jg) in zip(leaves_with_paths(params["projector"]),
                                  leaves_with_paths(theirs)):
        rel_close(g.grad, jg)


def _jax_run(jcfg, jparams, batches, *, lr, clip, accum, warmup, total):
    labels = JM.stage1_labels(jparams)
    tx, _ = JO.single_group_optimizer(labels, lr, total_steps=total, warmup_ratio=warmup,
                                      weight_decay=0.01, clip_norm=clip, accum_steps=accum)
    step = JS.make_train_step(JS.stage1_loss(jcfg, PAD, remat=False), tx,
                              trainable_mask=JM.bool_mask(labels), donate=False)
    state = JS.init_state(jax.tree.map(jnp.asarray, jparams), tx)
    out = []
    states = []
    for i, b in enumerate(batches):
        state, loss, _ = step(state, jax.tree.map(jnp.asarray, b), jax.random.key(i))
        out.append(float(loss))
        states.append(state)
    return out, states


def _port_run(cfg, state_or_params, batches, *, lr, clip, accum, warmup, total):
    params = state_or_params["params"] if "opt_state" in state_or_params else state_or_params
    labels = masks.stage1_labels(params)
    tx, _ = optim.single_group_optimizer(labels, lr, total_steps=total, warmup_ratio=warmup,
                                         weight_decay=0.01, clip_norm=clip, accum_steps=accum)
    step = steps.make_train_step(steps.stage1_loss(cfg, PAD, remat=True), tx,
                                 trainable_mask=masks.bool_mask(labels))
    state = (state_or_params if "opt_state" in state_or_params
             else steps.init_state(params, tx))
    out = []
    for b in batches:
        state, loss, aux = step(state, _torch_batch(b))
        out.append(float(loss))
    return out, state


@pytest.mark.parametrize("clip", [5.0, 0.05])
def test_loss_curve_matches_jax_train_step(clip):
    """24 micro-steps at accumulation 2 = 12 updates, warmup ceil(0.25 * 12) = 3.
    clip 5.0 is the stage-1 setting; 0.05 makes the clip fire on every update."""
    jcfg, jparams, cfg = _models()
    rng = np.random.default_rng(1)
    batches = [_batch(rng, filler=(i == 3)) for i in range(4)] * 6  # four batches, cycled
    kw = dict(lr=3e-3, clip=clip, accum=2, warmup=0.25, total=12)
    jlosses, jstates = _jax_run(jcfg, jparams, batches, **kw)
    losses, state = _port_run(cfg, from_jax.vlm_params(jparams), batches, **kw)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[20] < losses[0]  # the same batch, 10 updates later
    assert state["opt_state"]["count"] == 12
    theirs = from_jax.projector_params(jax.tree.map(np.asarray,
                                                    jstates[-1]["params"]["projector"]))
    for (_, x), (_, y) in zip(leaves_with_paths(state["params"]["projector"]),
                              leaves_with_paths(theirs)):
        rel_close(x, y)


def test_jax_train_state_carries_across_mid_accumulation():
    """Five JAX micro-steps (an accumulation half done), then the state crosses and
    both packages take three more steps on the same batches."""
    jcfg, jparams, cfg = _models()
    rng = np.random.default_rng(2)
    batches = [_batch(rng) for _ in range(8)]
    kw = dict(lr=3e-3, clip=5.0, accum=2, warmup=0.25, total=4)
    jlosses, jstates = _jax_run(jcfg, jparams, batches, **kw)
    state = from_jax.stage1_train_state(jax.tree.map(np.asarray, jstates[4]))
    assert state["opt_state"]["mini_step"] == 1 and state["opt_state"]["count"] == 2
    losses, _ = _port_run(cfg, state, batches[5:], **kw)
    np.testing.assert_allclose(losses, jlosses[5:], rtol=1e-4)


def test_cosine_schedule_matches_optax_schedule():
    for warm, total in ((0.0, 10), (0.25, 12), (0.1, 7)):
        ours = optim.cosine_schedule_with_warmup(1e-3, warmup_ratio=warm, total_steps=total)
        theirs = JO.cosine_schedule_with_warmup(1e-3, warmup_ratio=warm, total_steps=total)
        for s in range(total + 2):
            assert abs(ours(s) - float(theirs(s))) <= 1e-9 + 1e-6 * abs(float(theirs(s)))


def test_decoder_remat_dots_raises():
    """'dots' is ported (tests/test_torch_remat_dots.py): the decoder runs under it as
    under full remat; a value that names no policy raises."""
    from projectiontrainer_tpu_torch.models import decoder as dec

    jcfg, jparams, cfg = _models()
    params = from_jax.vlm_params(jparams)
    ids = torch.arange(4)[None]
    dots, _ = dec.forward(params["llm"], cfg.llm, input_ids=ids, remat="dots")
    full, _ = dec.forward(params["llm"], cfg.llm, input_ids=ids, remat=True)
    assert torch.equal(dots, full)
    with pytest.raises(ValueError, match="remat"):
        dec.forward(params["llm"], cfg.llm, input_ids=ids, remat="everything")


def test_stage1_mask_trains_the_projector_only():
    jcfg, jparams, cfg = _models()
    params = from_jax.vlm_params(jparams)
    mask = dict(leaves_with_paths(masks.bool_mask(masks.stage1_labels(params))))
    assert {p for p, on in mask.items() if on} == {
        "projector/fc1/weight", "projector/fc1/bias", "projector/fc2/weight",
        "projector/fc2/bias"}
    labels = masks.stage1_labels(params)
    tx, _ = optim.single_group_optimizer(labels, 1e-3, total_steps=2)
    step = steps.make_train_step(steps.stage1_loss(cfg, PAD), tx,
                                 trainable_mask=masks.bool_mask(labels))
    state = steps.init_state(params, tx)
    before = {p: x.clone() for p, x in leaves_with_paths(params)}
    step(state, _torch_batch(_batch(np.random.default_rng(3))))
    for p, x in leaves_with_paths(params):
        assert x.requires_grad == mask[p]
        assert torch.equal(x, before[p]) != mask[p], p
