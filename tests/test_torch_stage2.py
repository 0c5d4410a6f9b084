"""The port's stage-2 train step against the JAX package's, fp32 on the CPU.

Weights come from ``vlm.init(jax.random.key(0), testing.tiny_vlm_cfg())`` (a Gemma3
decoder with a tied embedding table) and cross through ``checkpoint/from_jax.py``;
batches are numpy draws from a seed: questions and answers right-padded with the pad
id 0, one filler row of weight 0.

- ``stage2_loss``: loss and the gradient of every trainable leaf against JAX
  ``steps.stage2_loss``, through the full-logits and chunked CE, with and without the
  tower training, and with a frozen LLM through the fused CE's plain versions.
  Tolerance 1e-4 relative (to the largest magnitude of each reference leaf).
- The tied table (LM head = embedding) is one tensor through the master cast, a
  step, a checkpoint save and restore, has one Adam state and moves as JAX's does.
- A 24-micro-step full-joint curve (accumulation 2, per-module clipping, the tower
  frozen by ``swap_optimizer`` after micro-step 7, inside an accumulation) against
  JAX's: losses and final params within 1e-4; bf16 masters at 2e-2.
- ``swap_optimizer``, per-module clipping, ``stage2_labels`` and a JAX train state
  carried across mid-run (``from_jax.stage2_train_state``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.core import dtypes as JD
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu.train import masks as JM
from projectiontrainer_tpu.train import optim as JO
from projectiontrainer_tpu.train import steps as JS
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.core import dtypes
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths, unique_leaves_with_paths
from projectiontrainer_tpu_torch.train import masks, optim, steps

torch.set_num_threads(2)
PAD = 0
EMBED, HEAD = "llm/embed_tokens/embedding", "llm/lm_head/weight"
FULL_JOINT = dict(train_llm=True, train_projector=True, train_vision=True)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def rel_close(ours, theirs, tol=1e-4):
    ours, theirs = _np(ours), _np(theirs)
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


def _batch(rng, b=2, image=32, tq=5, ta=8, vocab=128, filler=False):
    def ids(t, lo):
        out = np.full((b, t), PAD, np.int32)
        for i, n in enumerate(rng.integers(lo, t + 1, size=b)):
            out[i, :n] = rng.integers(2, vocab, size=n)
        return out

    batch = {"pixel_values": rng.standard_normal((b, image, image, 3), dtype=np.float32),
             "question_ids": ids(tq, 2), "answer_ids": ids(ta, 3)}
    if filler:
        batch["sample_weight"] = np.array([1.0] + [0.0] * (b - 1), np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _port_grads_as_paths(tree) -> dict:
    """A JAX gradient tree (numpy) -> {port path: array}."""
    return {p: x.numpy() for p, x in unique_leaves_with_paths(from_jax.vlm_params(tree))}


def _set_trainable(params, labels) -> list:
    mask = dict(leaves_with_paths(masks.bool_mask(labels)))
    train = []
    for p, x in unique_leaves_with_paths(params):
        x.requires_grad_(bool(mask[p]))
        if mask[p]:
            train.append((p, x))
    return train


# ------------------------------------------------------------------ loss and gradients

LOSS_CASES = {
    "full_joint_full_logits": dict(kw={}, policy=FULL_JOINT, chunk=None, ce="auto", remat=True),
    "full_joint_chunked": dict(kw={}, policy=FULL_JOINT, chunk=5, ce="chunked", remat=1),
    "llm_projector_chunked": dict(kw={}, policy=dict(FULL_JOINT, train_vision=False), chunk=5,
                                  ce="auto", remat=True),
    "frozen_llm_fused": dict(kw={"llm_hidden": 128},
                             policy=dict(train_llm=False, train_projector=True,
                                         train_vision=True), chunk=5, ce="fused", remat=False),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_stage2_loss_and_trainable_grads_match_jax(case):
    c = LOSS_CASES[case]
    jcfg, jparams, cfg = _models(**c["kw"])
    batch = _batch(np.random.default_rng(0), filler=True)
    frozen_table = not c["policy"]["train_llm"]

    # JAX's remat does not change its numbers: it runs without, the port with
    jloss_fn = JS.stage2_loss(jcfg, PAD, remat=False, logits_chunk=c["chunk"],
                              ce_impl="chunked" if c["ce"] == "fused" else c["ce"],
                              table_frozen=frozen_table)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, batch), None)
    theirs = _port_grads_as_paths(jax.tree.map(np.asarray, jgrads))

    params = from_jax.vlm_params(jparams)
    train = _set_trainable(params, masks.stage2_labels(params, masks.Stage2Freeze(**c["policy"])))
    loss_fn = steps.stage2_loss(cfg, PAD, remat=c["remat"], logits_chunk=c["chunk"],
                                ce_impl=c["ce"], table_frozen=frozen_table)
    loss, aux = loss_fn(params, _torch_batch(batch))
    loss.backward()
    rel_close(loss, jloss)
    assert int(aux["tokens"]) == int(jaux["tokens"])
    groups = {p.split("/")[0] for p, _ in train}
    assert groups == {g for g, on in (("vision", c["policy"]["train_vision"]),
                                      ("projector", True), ("llm", c["policy"]["train_llm"]))
                      if on}
    for path, x in train:
        assert x.grad is not None, path
        if path.endswith("k_proj/bias"):
            # zero in exact arithmetic (softmax ignores a per-query constant): both
            # sides are rounding noise, held at the scale of the layer's weight gradient
            scale = np.abs(theirs[path[:-len("bias")] + "weight"]).max()
            assert np.abs(x.grad.numpy() - theirs[path]).max() <= 1e-4 * scale, path
        else:
            rel_close(x.grad, theirs[path])


def test_forward_logits_matches_jax():
    from projectiontrainer_tpu_torch.models import vlm

    jcfg, jparams, cfg = _models()
    rng = np.random.default_rng(6)
    embeds = rng.standard_normal((2, 7, jcfg.llm.hidden_size)).astype(np.float32)
    mask = np.array([[1] * 7, [1] * 5 + [0] * 2], np.int32)
    theirs = JVLM.forward_logits(jax.tree.map(jnp.asarray, jparams), jcfg, jnp.asarray(embeds),
                                 jnp.asarray(mask))
    ours = vlm.forward_logits(from_jax.vlm_params(jparams), cfg, torch.tensor(embeds),
                              torch.tensor(mask), remat=True)
    rel_close(ours, theirs)


def test_fused_ce_refused_when_the_table_trains():
    _, _, cfg = _models()
    with pytest.raises(ValueError, match="frozen vocab table"):
        steps.stage2_loss(cfg, PAD, logits_chunk=5, ce_impl="fused", table_frozen=False)


# ------------------------------------------------------------------ the tied table (F1)


def test_cast_keeps_the_tied_table_one_tensor():
    _, jparams, _ = _models()
    params = from_jax.vlm_params(jparams, tower_dtype=torch.bfloat16)
    assert [p for p, _ in leaves_with_paths(params) if p not in
            dict(unique_leaves_with_paths(params))] == [HEAD]
    for target in (torch.float32, torch.bfloat16, torch.float32):
        params = {**params, "llm": dtypes.cast_compute_params(params["llm"], target)}
        assert params["llm"]["lm_head"]["weight"] is params["llm"]["embed_tokens"]["embedding"]
        assert params["llm"]["lm_head"]["weight"].dtype == target
    assert [p for p, _ in unique_leaves_with_paths(params)].count(EMBED) == 1
    assert HEAD not in dict(unique_leaves_with_paths(params))


def test_full_llm_step_updates_the_tied_table_once(tmp_path):
    """One full-LLM update after the trainer's bf16 -> fp32 master cast: the table
    keeps one tensor and one Adam state, moves as JAX's (whose tree has no lm_head),
    and a checkpoint saves it once and restores it into a fresh state still tied."""
    jcfg, jparams, cfg = _models()
    batch = _batch(np.random.default_rng(4))
    # both start from a bf16-stored LLM (a snapshot's), cast to fp32 masters
    jllm = JD.cast_compute_params(JD.cast_compute_params(jparams["llm"], jnp.bfloat16),
                                  jnp.float32)
    jstart = {**jparams, "llm": jax.tree.map(np.asarray, jllm)}
    jlabels = JM.stage2_labels(jstart, JM.Stage2Freeze(train_llm=True, train_projector=True))
    jtx, _ = JO.single_group_optimizer(jlabels, 1e-2, total_steps=1, clip_norm=1.0,
                                       clip_per_module=True)
    jstep = JS.make_train_step(JS.stage2_loss(jcfg, PAD, remat=False, logits_chunk=5,
                                              table_frozen=False),
                               jtx, trainable_mask=JM.bool_mask(jlabels), donate=False)
    jstate, jloss, _ = jstep(JS.init_state(jax.tree.map(jnp.asarray, jstart), jtx),
                             jax.tree.map(jnp.asarray, batch), jax.random.key(0))
    jstate = jax.tree.map(np.asarray, jstate)

    def start():
        params = from_jax.vlm_params(jparams)
        params["llm"] = dtypes.cast_compute_params(params["llm"], torch.bfloat16)
        params["llm"] = dtypes.cast_compute_params(params["llm"], torch.float32)
        return params

    params = start()
    table = params["llm"]["embed_tokens"]["embedding"]
    assert params["llm"]["lm_head"]["weight"] is table and table.dtype == torch.float32
    labels = masks.stage2_labels(params, masks.Stage2Freeze(train_llm=True, train_projector=True))
    tx, _ = optim.single_group_optimizer(labels, 1e-2, total_steps=1, clip_norm=1.0,
                                         clip_per_module=True)
    step = steps.make_train_step(steps.stage2_loss(cfg, PAD, logits_chunk=5, table_frozen=False),
                                 tx, trainable_mask=masks.bool_mask(labels))
    state = steps.init_state(params, tx)
    before = table.detach().clone()
    state, loss, _ = step(state, _torch_batch(batch))
    rel_close(loss, jloss)
    assert EMBED in state["opt_state"]["mu"] and HEAD not in state["opt_state"]["mu"]
    assert params["llm"]["lm_head"]["weight"] is table and not torch.equal(table, before)
    theirs = dict(unique_leaves_with_paths(from_jax.vlm_params(jstate["params"])))
    rel_close(table, theirs[EMBED])
    jopt = from_jax.opt_state(jstate["opt_state"])
    assert set(jopt["mu"]) == set(state["opt_state"]["mu"])
    for key in ("mu", "nu"):
        rel_close(state["opt_state"][key][EMBED], jopt[key][EMBED])

    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_step(1, state)
    saved = torch.load(tmp_path / "step_1.pt", weights_only=True)
    assert EMBED in saved["params"] and HEAD not in saved["params"]
    restored = ckpt.restore("step_1", steps.init_state(start(), tx))
    got = restored["params"]["llm"]
    assert got["lm_head"]["weight"] is got["embed_tokens"]["embedding"]
    assert torch.equal(got["embed_tokens"]["embedding"], table)


# ------------------------------------------------------------------ curves


def _jax_stage2_run(jcfg, jparams, batches, *, swap_at, lr=3e-3, clip=1.0, accum=2,
                    warmup=0.1, total=12, compute_dtype=None):
    variants = {}
    for ve in (True, False):
        labels = JM.stage2_labels(jparams, JM.Stage2Freeze(**dict(FULL_JOINT, train_vision=ve)))
        tx, _ = JO.single_group_optimizer(labels, lr, total_steps=total, warmup_ratio=warmup,
                                          weight_decay=0.01, clip_norm=clip,
                                          clip_per_module=True, accum_steps=accum)
        loss = JS.stage2_loss(jcfg, PAD, remat=False, logits_chunk=5, table_frozen=False,
                              compute_dtype=compute_dtype)
        variants[ve] = (JS.make_train_step(loss, tx, trainable_mask=JM.bool_mask(labels),
                                           donate=False), tx)
    state = JS.init_state(jax.tree.map(jnp.asarray, jparams), variants[True][1])
    losses, states = [], []
    for i, b in enumerate(batches):
        if i == swap_at:
            state = JS.swap_optimizer(state, variants[False][1])
        state, loss, _ = variants[i < swap_at][0](state, jax.tree.map(jnp.asarray, b),
                                                  jax.random.key(i))
        losses.append(float(loss))
        states.append(jax.tree.map(np.asarray, state))
    return losses, states


def _port_variants(cfg, params, *, lr=3e-3, clip=1.0, accum=2, warmup=0.1, total=12,
                   compute_dtype=None):
    loss = steps.stage2_loss(cfg, PAD, logits_chunk=5, table_frozen=False,
                             compute_dtype=compute_dtype)
    variants = {}
    for ve in (True, False):
        labels = masks.stage2_labels(params, masks.Stage2Freeze(**dict(FULL_JOINT,
                                                                       train_vision=ve)))
        tx, _ = optim.single_group_optimizer(labels, lr, total_steps=total, warmup_ratio=warmup,
                                             weight_decay=0.01, clip_norm=clip,
                                             clip_per_module=True, accum_steps=accum)
        variants[ve] = (steps.make_train_step(loss, tx, trainable_mask=masks.bool_mask(labels)),
                        tx)
    return variants


def _port_stage2_run(variants, state, batches, *, swap_at, start=0):
    losses = []
    for i, b in enumerate(batches, start=start):
        if i == swap_at:
            state = steps.swap_optimizer(state, variants[False][1])
        state, loss, _ = variants[i < swap_at][0](state, _torch_batch(b))
        losses.append(float(loss))
    return losses, state


def _params_close(params, jparams, tol=1e-4):
    """Every leaf within ``tol`` relative, but the tower's key-projection biases: their
    gradient is zero in exact arithmetic, so Adam's normalised steps follow the sign of
    rounding noise on both sides; they are held to the same size (at most 3x)."""
    theirs = dict(unique_leaves_with_paths(from_jax.vlm_params(jparams)))
    for p, x in unique_leaves_with_paths(params):
        if p.endswith("k_proj/bias"):
            assert np.abs(_np(x)).max() <= 3 * np.abs(_np(theirs[p])).max(), p
        else:
            rel_close(x, theirs[p], tol)


SWAP_AT = 7  # the tower freezes after micro-step 7: inside an accumulation of 2


@functools.cache
def _curve_batches():
    rng = np.random.default_rng(1)
    return [_batch(rng, filler=(i == 3)) for i in range(4)] * 6  # four batches, cycled


@functools.cache
def _jax_curve():
    jcfg, jparams, _ = _models()
    return _jax_stage2_run(jcfg, jparams, _curve_batches(), swap_at=SWAP_AT)


def test_full_joint_curve_with_the_tower_swap_matches_jax():
    """24 micro-steps at accumulation 2 = 12 updates, warmup ceil(0.1 * 12) = 2; the
    tower trains in micro-steps 0-6 and freezes with half an accumulation held."""
    _, jparams, cfg = _models()
    jlosses, jstates = _jax_curve()
    params = from_jax.vlm_params(jparams)
    variants = _port_variants(cfg, params)
    tower_before = {p: x.clone() for p, x in leaves_with_paths(params["vision"])}
    state = steps.init_state(params, variants[True][1])
    batches = _curve_batches()
    losses, state = _port_stage2_run(variants, state, batches[:SWAP_AT], swap_at=SWAP_AT)
    tower_at_swap = {p: x.clone() for p, x in leaves_with_paths(params["vision"])}
    more, state = _port_stage2_run(variants, state, batches[SWAP_AT:], swap_at=SWAP_AT,
                                   start=SWAP_AT)
    losses += more
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[20] < losses[0]  # the same batch, 10 updates later
    opt = state["opt_state"]
    assert opt["count"] == 12 and opt["mini_step"] == 0
    assert not any(p.startswith("vision/") for p in opt["mu"]) and HEAD not in opt["mu"]
    # the tower moved in the updates before the swap (micro-steps 1, 3, 5) and not
    # after it (micro-step 6's half accumulation is dropped with its state)
    for p, x in leaves_with_paths(params["vision"]):
        assert torch.equal(x, tower_at_swap[p]), p
    assert all(not torch.equal(x, tower_before[p]) for p, x in tower_at_swap.items())
    _params_close(params, jstates[-1]["params"])
    assert params["llm"]["lm_head"]["weight"] is params["llm"]["embed_tokens"]["embedding"]


@pytest.mark.parametrize("at", [5, 9])
def test_jax_train_state_carries_across_mid_run(at):
    """A JAX state after micro-step ``at`` (both inside an accumulation; 9 after the
    swap) crosses through ``from_jax.stage2_train_state`` and the port continues with
    JAX's losses."""
    _, jparams, cfg = _models()
    jlosses, jstates = _jax_curve()
    state = from_jax.stage2_train_state(jstates[at - 1])
    opt = state["opt_state"]
    assert opt["mini_step"] == 1 and opt["count"] == at // 2 and state["step"] == at
    assert any(p.startswith("vision/") for p in opt["mu"]) == (at < SWAP_AT)
    assert HEAD not in opt["mu"] and EMBED in opt["acc"]
    params = state["params"]
    assert params["llm"]["lm_head"]["weight"] is params["llm"]["embed_tokens"]["embedding"]
    variants = _port_variants(cfg, params)
    losses, _ = _port_stage2_run(variants, state, _curve_batches()[at:at + 6],
                                 swap_at=SWAP_AT, start=at)
    np.testing.assert_allclose(losses, jlosses[at:at + 6], rtol=1e-4)


def test_bf16_masters_curve_matches_jax_within_2e2():
    """--master_dtype bf16: the LLM and the tower stored bf16, so are their Adam
    moments and accumulator (optax's zeros_like), and each Adam operation rounds to
    bf16. 8 micro-steps, the swap after 3. The loss casts to fp32 in both packages
    (with bf16 compute the two backends' roundings of a gradient element differ by
    percents where its terms cancel), so what is held is what bf16 storage does: losses
    within 1e-3, params within 2e-2 of each leaf's largest value (a bf16 step there is
    0.8%)."""
    jcfg, jparams, cfg = _models()
    jstart = {**jparams, **{k: jax.tree.map(np.asarray, JD.cast_compute_params(
        jparams[k], jnp.bfloat16)) for k in ("vision", "llm")}}
    batches = _curve_batches()[:8]
    jlosses, jstates = _jax_stage2_run(jcfg, jstart, batches, swap_at=3, total=4,
                                       compute_dtype=jnp.float32)
    params = from_jax.vlm_params(jparams)
    for k in ("vision", "llm"):
        params[k] = dtypes.cast_compute_params(params[k], torch.bfloat16)
    variants = _port_variants(cfg, params, total=4, compute_dtype=torch.float32)
    state = steps.init_state(params, variants[True][1])
    assert state["opt_state"]["mu"][EMBED].dtype == torch.bfloat16
    assert state["opt_state"]["acc"]["projector/fc1/weight"].dtype == torch.float32
    losses, state = _port_stage2_run(variants, state, batches, swap_at=3)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    _params_close(params, jstates[-1]["params"], tol=2e-2)


# ------------------------------------------------------------------ the pieces


def test_swap_optimizer_matches_jax_inside_an_accumulation():
    """Three micro-steps of the full-joint variant at accumulation 2 (one update, half
    an accumulation held), then the swap: the port keeps what JAX keeps."""
    jcfg, jparams, cfg = _models()
    _, jstates = _jax_curve()
    jstate = jstates[2]
    labels = JM.stage2_labels(jparams, JM.Stage2Freeze(**dict(FULL_JOINT, train_vision=False)))
    jtx, _ = JO.single_group_optimizer(labels, 3e-3, total_steps=12, warmup_ratio=0.1,
                                       clip_norm=1.0, clip_per_module=True, accum_steps=2)
    swapped = from_jax.opt_state(jax.tree.map(np.asarray, JS.swap_optimizer(
        jax.tree.map(jnp.asarray, jstate), jtx)["opt_state"]))

    params = from_jax.vlm_params(jparams)
    variants = _port_variants(cfg, params)
    state = steps.init_state(params, variants[True][1])
    _, state = _port_stage2_run(variants, state, _curve_batches()[:3], swap_at=99)
    before = state["opt_state"]
    ours = steps.swap_optimizer(state, variants[False][1])["opt_state"]
    assert (ours["count"], ours["mini_step"]) == (swapped["count"], swapped["mini_step"]) == (1, 1)
    for key in ("mu", "nu", "acc"):
        assert set(ours[key]) == set(swapped[key])
        assert not any(p.startswith("vision/") for p in ours[key])
        for p, x in ours[key].items():
            assert x is before[key][p]  # carried, not copied
            rel_close(x, swapped[key][p])


@pytest.mark.parametrize("max_norm", [1e-3, 0.5, 1e3])
def test_clip_by_module_norm_matches_jax(max_norm):
    """Each first path segment is a group with its own norm; the factor is
    min(1, max_norm / (norm + 1e-6)). Groups of very different norms: at 0.5 one is
    clipped and one is not."""
    rng = np.random.default_rng(5)
    tree = {"vision": {"a": rng.standard_normal((3, 4)).astype(np.float32) * 0.01},
            "projector": {"w": rng.standard_normal((5,)).astype(np.float32),
                          "b": rng.standard_normal((2, 2)).astype(np.float32)},
            "llm": {"layers": [{"k": rng.standard_normal((4,)).astype(np.float32) * 3}]}}
    theirs, _ = JO.clip_by_module_norm(max_norm).update(jax.tree.map(jnp.asarray, tree), None)
    theirs = {p: np.asarray(x) for p, x in leaves_with_paths(jax.tree.map(np.asarray, theirs))}
    labels = jax.tree.map(lambda _: masks.TRAINABLE, tree)
    tx = optim.MaskedAdamW(labels, lambda _: 0.0, clip_norm=max_norm, clip_per_module=True)
    ours = tx._clip({p: torch.tensor(x) for p, x in leaves_with_paths(tree)})
    assert set(ours) == set(theirs)
    for p, x in ours.items():
        np.testing.assert_allclose(x.numpy(), theirs[p], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("policy", [FULL_JOINT, dict(FULL_JOINT, train_vision=False),
                                    dict(train_llm=False, train_projector=True),
                                    dict(train_llm=True, use_lora=True, train_projector=False)])
def test_stage2_labels_match_jax(policy):
    _, jparams, _ = _models()
    jlabels = JM.stage2_labels(jparams, JM.Stage2Freeze(**policy))
    ours = masks.stage2_labels(from_jax.vlm_params(jparams), masks.Stage2Freeze(**policy))

    def by_group(tree):
        out = {}
        for p, label in leaves_with_paths(tree):
            out.setdefault(p.split("/")[0], set()).add(label)
        return out

    assert by_group(ours) == by_group(jlabels)


def test_stage2_config_matches_jax_fields_and_policy():
    from projectiontrainer_tpu.core.config import Stage2Config as JaxStage2Config
    from projectiontrainer_tpu_torch.core.config import Stage2Config

    ours = {f.name: f.default for f in dataclasses.fields(Stage2Config)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxStage2Config)}
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    cfg = Stage2Config(unfreeze_llm=True, unfreeze_projection_layer=True,
                       train_ve_first_epoch=True)
    assert dataclasses.asdict(cfg.freeze_policy()) == dataclasses.asdict(
        JaxStage2Config(unfreeze_llm=True, unfreeze_projection_layer=True,
                        train_ve_first_epoch=True).freeze_policy())
