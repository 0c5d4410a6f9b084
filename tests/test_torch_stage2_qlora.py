"""The port's QLoRA train steps (stage 2 with LoRA over a quantized base, and stage 1
over a quantized frozen base) against the JAX package's, fp32 on the CPU.

The VLM is a tiny Qwen3 (GQA 4/2, untied head) behind the tiny SigLIP tower, from
``vlm.init(jax.random.key(0), ...)``; the JAX package quantizes the decoder and its
adapters are drawn with B nonzero (at PEFT's init B = 0 and every A gradient is 0);
everything crosses through ``checkpoint/from_jax.py``. Batches are numpy draws.

- ``stage2_loss`` with LoRA over each base (dense, int8, nf4, nf4-mirror): the loss
  and the gradient of every LoRA and projector leaf within 1e-4 of JAX's.
- A 24-micro-step QLoRA curve (nf4-mirror, dropout 0, accumulation 2, per-module
  clipping, the tower trained in micro-steps 0-6 and frozen by ``swap_optimizer``):
  losses and the final adapters and projector within 1e-4; a JAX train state carried
  across mid-run continues with JAX's losses.
- The stage-1 ``--enable_qlora`` step: loss and updated projector within 1e-4.
- The masks of every ``--unfreeze_projection_layer`` x ``--train_ve_first_epoch``
  combination; integer leaves never train, hold no optimizer slot and stay bit-equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.core.config import Stage2Config as JaxStage2Config
from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu.models import projector as JPROJ
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu.ops import quant as JQ
from projectiontrainer_tpu.train import lora as JL
from projectiontrainer_tpu.train import masks as JM
from projectiontrainer_tpu.train import optim as JO
from projectiontrainer_tpu.train import steps as JS
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.core.config import Stage2Config
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths, unique_leaves_with_paths
from projectiontrainer_tpu_torch.train import lora, masks, optim, steps

torch.set_num_threads(2)
PAD = 0
R, ALPHA = 4, 8


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def rel_close(ours, theirs, tol=1e-4):
    ours, theirs = _np(ours), _np(theirs)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    err = np.abs(ours - theirs).max()
    assert err <= tol * max(np.abs(theirs).max(), 1e-30), f"max err {err} vs {np.abs(theirs).max()}"


def _jax_cfg():
    llm = JDEC.qwen3_config(vocab_size=128, hidden_size=64, intermediate_size=128,
                            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
    vis = T.tiny_vision_cfg()
    return JVLM.VLMConfig(vision=vis, llm=llm, projector=JPROJ.ProjectorConfig(
        vision_dim=vis.hidden_size, llm_dim=64, expansion_factor=2))


@functools.cache
def _models(base: str = "nf4-mirror"):
    """(JAX config, JAX params with a quantized llm and nonzero-B adapters as numpy,
    the port's config)."""
    jcfg = _jax_cfg()
    jp = JVLM.init(jax.random.key(0), jcfg)
    if base != "dense":
        jp["llm"] = JQ.quantize_decoder(jp["llm"], method=base)
    jp["lora"] = JL.init(jax.random.key(1), jcfg.llm, JL.LoraConfig(r=R, alpha=ALPHA))
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(2)
    for layer in jp["lora"]["layers"]:
        for p in layer.values():
            p["b"] = rng.standard_normal(p["b"].shape, dtype=np.float32) * 0.05
    return jcfg, jp, from_jax.config_from_jax(jcfg)


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


def _jax_lcfg(dropout=0.0):
    return JL.LoraConfig(r=R, alpha=ALPHA, dropout=dropout)


def _lcfg(dropout=0.0):
    return lora.LoraConfig(r=R, alpha=ALPHA, dropout=dropout)


# ------------------------------------------------------------------ loss and gradients


@pytest.mark.parametrize("base", ["dense", "int8", "nf4", "nf4-mirror"])
def test_stage2_lora_loss_and_grads_match_jax(base):
    jcfg, jp, cfg = _models(base)
    batch = _batch(np.random.default_rng(0), filler=True)
    jloss_fn = JS.stage2_loss(jcfg, PAD, lora_cfg=_jax_lcfg(0.05), remat=False, logits_chunk=5)
    jparams = jax.tree.map(jnp.asarray, jp)

    def f(adapters, projector):
        return jloss_fn({**jparams, "lora": adapters, "projector": projector},
                        jax.tree.map(jnp.asarray, batch), None)

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jparams["lora"], jparams["projector"])
    theirs = {**{f"lora/{p}": x for p, x in leaves_with_paths(
        from_jax.lora_params(jax.tree.map(np.asarray, jgrads[0])))},
              **{f"projector/{p}": x for p, x in leaves_with_paths(
                  from_jax.projector_params(jax.tree.map(np.asarray, jgrads[1])))}}

    params = from_jax.vlm_params(jp)
    labels = masks.stage2_labels(params, masks.Stage2Freeze(use_lora=True, train_projector=True))
    mask = dict(leaves_with_paths(masks.bool_mask(labels)))
    train = [(p, x) for p, x in unique_leaves_with_paths(params) if mask[p]]
    assert {p for p, _ in train} == set(theirs)
    for _, x in train:
        x.requires_grad_(True)
    # dropout 0.05 is configured: eval (rng None) runs without it, as JAX's does
    loss_fn = steps.stage2_loss(cfg, PAD, lora_cfg=_lcfg(0.05), remat=True, logits_chunk=5)
    loss, aux = loss_fn(params, _torch_batch(batch))
    grads = torch.autograd.grad(loss, [x for _, x in train])
    rel_close(loss, jloss)
    assert int(aux["tokens"]) == int(jaux["tokens"])
    for (p, _), g in zip(train, grads):
        rel_close(g, theirs[p])
    assert all(bool(g.abs().max() > 0) for (p, _), g in zip(train, grads) if p.endswith("/a"))


def test_lora_table_frozen_by_default_and_fused_ce_allowed():
    _, _, cfg = _models()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, hidden_size=128))
    steps.stage2_loss(cfg, PAD, lora_cfg=_lcfg(), logits_chunk=5, ce_impl="fused")
    with pytest.raises(ValueError, match="frozen vocab table"):
        steps.stage2_loss(cfg, PAD, logits_chunk=5, ce_impl="fused")
    assert steps._resolve_ce_impl("auto", table_frozen=True, hidden_size=4096,
                                  on_card=True) == "fused"


def test_dropout_draws_differ_by_step_and_repeat_within_one():
    """With dropout on, the train step's seed changes the loss; the same seed repeats it
    exactly; no seed (evaluation) is the dropout-free loss."""
    _, jp, cfg = _models()
    params = from_jax.vlm_params(jp)
    batch = _torch_batch(_batch(np.random.default_rng(3)))
    fn = steps.stage2_loss(cfg, PAD, lora_cfg=_lcfg(0.5), remat=True, logits_chunk=5)
    plain = steps.stage2_loss(cfg, PAD, lora_cfg=_lcfg(0.0), logits_chunk=5)
    with torch.no_grad():
        a, b, c = (float(fn(params, batch, s)[0]) for s in (1, 1, 2))
        off, ref = float(fn(params, batch, None)[0]), float(plain(params, batch, 7)[0])
    assert a == b and a != c and off == ref


# ------------------------------------------------------------------ masks and optimizer


@pytest.mark.parametrize("projector", [False, True])
@pytest.mark.parametrize("ve_first", [False, True])
def test_qlora_masks_match_jax(projector, ve_first):
    """The policies of ``--enable_qlora`` with and without --unfreeze_projection_layer
    and --train_ve_first_epoch (both of its step variants): the same trainable groups
    and leaf counts as JAX's; the quantized base and the table never train."""
    _, jp, _ = _models()
    params = from_jax.vlm_params(jp)
    kw = dict(enable_qlora=True, unfreeze_projection_layer=projector,
              train_ve_first_epoch=ve_first, unfreeze_llm=True)
    ours_pol, theirs_pol = Stage2Config(**kw).freeze_policy(), JaxStage2Config(**kw).freeze_policy()
    assert dataclasses.asdict(ours_pol) == dataclasses.asdict(theirs_pol)
    for ve in ((True, False) if ve_first else (False,)):
        ours = masks.stage2_labels(params, dataclasses.replace(ours_pol, train_vision=ve))
        theirs = JM.stage2_labels(jp, dataclasses.replace(theirs_pol, train_vision=ve))

        def count(tree):
            out = {}
            for p, label in leaves_with_paths(tree):
                if label != masks.FROZEN and not p.startswith("vision/head"):
                    out[p.split("/")[0]] = out.get(p.split("/")[0], 0) + 1
            return out

        assert count(ours) == count(theirs)
        assert set(count(ours)) == {"lora"} | ({"projector"} if projector else set()) | (
            {"vision"} if ve else set())
        leaves = dict(leaves_with_paths(params))
        for p, label in leaves_with_paths(ours):
            if p.startswith("llm/"):
                assert label == masks.FROZEN, p
            if not leaves[p].is_floating_point():
                assert label == masks.FROZEN


def test_integer_leaves_never_train_nor_hold_optimizer_slots():
    _, jp, cfg = _models("int8")
    params = from_jax.vlm_params(jp)
    ints = [p for p, x in leaves_with_paths(params) if not x.is_floating_point()]
    assert ints and all(p.startswith("llm/layers/") for p in ints)
    # even a mask that marks every leaf trainable gives an integer leaf no slot
    everything = masks.stage2_labels(params, masks.Stage2Freeze(
        train_llm=True, train_projector=True, train_vision=True))
    assert all(everything_label != masks.FROZEN for p, everything_label in
               leaves_with_paths(everything) if p in ints)
    tx, _ = optim.single_group_optimizer(everything, 1e-3, total_steps=2, accum_steps=2)
    state = tx.init(params)
    for key in ("mu", "nu", "acc"):
        assert not set(ints) & set(state[key])
    before = {p: x.clone() for p, x in leaves_with_paths(params) if p in ints}
    loss = steps.stage2_loss(cfg, PAD, lora_cfg=_lcfg(), logits_chunk=5)
    step = steps.make_train_step(loss, tx, trainable_mask=masks.bool_mask(everything))
    st = steps.init_state(params, tx)
    for i in range(2):
        st, _, _ = step(st, _torch_batch(_batch(np.random.default_rng(i))), i)
    leaves = dict(leaves_with_paths(params))
    for p in ints:
        assert not leaves[p].requires_grad and torch.equal(leaves[p], before[p])


# ------------------------------------------------------------------ curves

SWAP_AT = 7
LR, TOTAL = 3e-3, 12


def _jax_policy(ve):
    return JM.Stage2Freeze(train_llm=False, use_lora=True, train_projector=True, train_vision=ve)


@functools.cache
def _curve_batches():
    rng = np.random.default_rng(1)
    return [_batch(rng, filler=(i == 3)) for i in range(4)] * 6


@functools.cache
def _jax_curve():
    jcfg, jp, _ = _models()
    loss = JS.stage2_loss(jcfg, PAD, lora_cfg=_jax_lcfg(0.0), remat=False, logits_chunk=5)
    variants = {}
    for ve in (True, False):
        labels = JM.stage2_labels(jp, _jax_policy(ve))
        tx, _ = JO.single_group_optimizer(labels, LR, total_steps=TOTAL, warmup_ratio=0.1,
                                          weight_decay=0.01, clip_norm=1.0,
                                          clip_per_module=True, accum_steps=2)
        variants[ve] = (JS.make_train_step(loss, tx, trainable_mask=JM.bool_mask(labels),
                                           donate=False), tx)
    state = JS.init_state(jax.tree.map(jnp.asarray, jp), variants[True][1])
    losses, states = [], []
    for i, b in enumerate(_curve_batches()):
        if i == SWAP_AT:
            state = JS.swap_optimizer(state, variants[False][1])
        state, loss_i, _ = variants[i < SWAP_AT][0](state, jax.tree.map(jnp.asarray, b),
                                                    jax.random.key(i))
        losses.append(float(loss_i))
        states.append(jax.tree.map(np.asarray, state))
    return losses, states


def _port_variants(cfg, params):
    loss = steps.stage2_loss(cfg, PAD, lora_cfg=_lcfg(0.0), logits_chunk=5)
    variants = {}
    for ve in (True, False):
        labels = masks.stage2_labels(params, masks.Stage2Freeze(
            train_llm=False, use_lora=True, train_projector=True, train_vision=ve))
        tx, _ = optim.single_group_optimizer(labels, LR, total_steps=TOTAL, warmup_ratio=0.1,
                                             weight_decay=0.01, clip_norm=1.0,
                                             clip_per_module=True, accum_steps=2)
        variants[ve] = (steps.make_train_step(loss, tx, trainable_mask=masks.bool_mask(labels)),
                        tx)
    return variants


def _port_run(variants, state, batches, start=0):
    losses = []
    for i, b in enumerate(batches, start=start):
        if i == SWAP_AT:
            state = steps.swap_optimizer(state, variants[False][1])
        state, loss, _ = variants[i < SWAP_AT][0](state, _torch_batch(b), i)
        losses.append(float(loss))
    return losses, state


def test_qlora_curve_matches_jax():
    """24 micro-steps = 12 updates at accumulation 2 over an nf4-mirror base: losses
    and the final adapters and projector within 1e-4 of JAX's; the swap keeps the
    adapters' Adam moments; the base does not change."""
    _, jp, cfg = _models()
    jlosses, jstates = _jax_curve()
    params = from_jax.vlm_params(jp)
    base = {p: x.clone() for p, x in leaves_with_paths(params["llm"])}
    variants = _port_variants(cfg, params)
    state = steps.init_state(params, variants[True][1])
    losses, state = _port_run(variants, state, _curve_batches()[:SWAP_AT])
    mu_before = {p: x for p, x in state["opt_state"]["mu"].items() if p.startswith("lora/")}
    more, state = _port_run(variants, state, _curve_batches()[SWAP_AT:], start=SWAP_AT)
    losses += more
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[20] < losses[0]
    opt = state["opt_state"]
    assert opt["count"] == 12 and not any(p.startswith("vision/") for p in opt["mu"])
    assert all(opt["mu"][p] is x for p, x in mu_before.items())  # carried by the swap
    theirs = from_jax.vlm_params(jstates[-1]["params"])
    for group in ("lora", "projector"):
        mine = dict(leaves_with_paths(params[group]))
        for p, x in leaves_with_paths(theirs[group]):
            rel_close(mine[p], x)
    for p, x in leaves_with_paths(params["llm"]):
        assert torch.equal(x, base[p]), p


def test_jax_qlora_train_state_carries_across_mid_run():
    """A JAX QLoRA state after micro-step 9 (inside an accumulation, after the swap):
    its quantized base and adapters cross bit for bit, and the port continues with
    JAX's losses."""
    _, _, cfg = _models()
    jlosses, jstates = _jax_curve()
    state = from_jax.stage2_train_state(jstates[8])
    opt = state["opt_state"]
    assert opt["mini_step"] == 1 and opt["count"] == 4 and state["step"] == 9
    assert set(p.split("/")[0] for p in opt["mu"]) == {"lora", "projector"}
    params = state["params"]
    assert params["llm"]["layers"][0]["attn"]["q_proj"]["qvalues_block"].dtype == torch.int8
    losses, _ = _port_run(_port_variants(cfg, params), state, _curve_batches()[9:15], start=9)
    np.testing.assert_allclose(losses, jlosses[9:15], rtol=1e-4)


# ------------------------------------------------------------------ stage 1 --enable_qlora


@pytest.mark.parametrize("method", ["int8", "nf4-mirror"])
def test_stage1_step_over_a_quantized_base_matches_jax(method):
    jcfg = T.tiny_vlm_cfg(llm_hidden=64)
    jp = JVLM.init(jax.random.key(0), jcfg)
    jp["llm"] = JQ.quantize_decoder(jp["llm"], method=method)
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(5)
    caps = np.zeros((2, 9), np.int32)
    caps[0, :9], caps[1, :5] = rng.integers(2, 128, size=9), rng.integers(2, 128, size=5)
    batch = {"pixel_values": rng.standard_normal((2, 32, 32, 3), dtype=np.float32),
             "caption_ids": caps}
    jlabels = JM.stage1_labels(jp)
    jtx, _ = JO.single_group_optimizer(jlabels, 1e-2, total_steps=2, clip_norm=5.0)
    jstep = JS.make_train_step(JS.stage1_loss(jcfg, PAD, remat=False, logits_chunk=5), jtx,
                               trainable_mask=JM.bool_mask(jlabels), donate=False)
    jstate, jloss, _ = jstep(JS.init_state(jax.tree.map(jnp.asarray, jp), jtx),
                             jax.tree.map(jnp.asarray, batch), jax.random.key(0))

    params = from_jax.vlm_params(jp)
    labels = masks.stage1_labels(params)
    tx, _ = optim.single_group_optimizer(labels, 1e-2, total_steps=2, clip_norm=5.0)
    step = steps.make_train_step(steps.stage1_loss(from_jax.config_from_jax(jcfg), PAD,
                                                   logits_chunk=5), tx,
                                 trainable_mask=masks.bool_mask(labels))
    state, loss, _ = step(steps.init_state(params, tx), _torch_batch(batch))
    rel_close(loss, jloss)
    theirs = from_jax.projector_params(jax.tree.map(np.asarray, jstate["params"]["projector"]))
    for (p, x), (_, y) in zip(leaves_with_paths(params["projector"]), leaves_with_paths(theirs)):
        rel_close(x, y)


# ------------------------------------------------------------------ checkpoint metadata


def test_detect_quant_method_reads_the_newest_checkpoint(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.detect_quant_method() is None
    state = {"params": {"w": torch.ones(2)}, "opt_state": {"mu": {"w": torch.zeros(2)}},
             "step": 1}
    ckpt.save_periodic(0, state, {"epoch": 0, "quant_method": "int8"})
    assert ckpt.detect_quant_method() == "int8"
    ckpt.save_step(5, state, {"epoch": 1, "quant_method": "nf4"})
    assert ckpt.detect_quant_method() == "nf4"  # a step_K checkpoint is read first
    ckpt.save_step(6, state, {"epoch": 1, "quant_method": None})
    assert ckpt.detect_quant_method() is None
