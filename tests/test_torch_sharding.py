"""The port's sharding rules (``parallel/sharding.py``) against the JAX package's
``parallel/sharding.py``.

- The rules are the JAX ``DEFAULT_RULES``, in order, with 'kernel' read as 'weight' and
  each 2-D spec of a linear leaf transposed (the port's ``[out, in]`` layout; the
  embedding tables keep theirs).
- Every leaf of a tiny QLoRA VLM (nf4-mirror, int8 and nf4 bases, LoRA adapters) gets
  the JAX spec of its JAX leaf, transposed where the leaf is; a single KV head is the
  deliberate divergence: its k/v projections stay replicated.
- Each rank's shards put back together are the leaf (``gather_params`` over gloo ranks is
  held by ``tests/test_torch_tp.py``); the tied head is sliced once.
- A model the model axis does not divide gets a plan that leaves each unit it does not
  divide whole; a sharded leaf that does not divide raises.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu.models import projector as JPROJ
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu.ops import quant as JQ
from projectiontrainer_tpu.parallel import sharding as JSHARD
from projectiontrainer_tpu.train import lora as JL
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.core.pytree import leaves_with_paths, unique_leaves_with_paths
from projectiontrainer_tpu_torch.parallel import sharding


def _transposed(spec):
    return tuple(reversed(spec)) if len(spec) == 2 else tuple(spec)


def _embedding(pattern: str) -> bool:
    return pattern.endswith("embedding$")


def test_rules_are_the_jax_rules_transposed():
    assert len(sharding.DEFAULT_RULES) == len(JSHARD.DEFAULT_RULES)
    for (ours, spec), (theirs, jspec) in zip(sharding.DEFAULT_RULES, JSHARD.DEFAULT_RULES):
        assert ours.replace("weight", "kernel") == theirs
        jspec = tuple(jspec)
        assert spec == (jspec if _embedding(theirs) else _transposed(jspec)), ours


@functools.cache
def _qlora_vlm(method):
    llm = JDEC.qwen3_config(vocab_size=128, hidden_size=128, intermediate_size=256,
                            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32)
    vis = T.tiny_vision_cfg()
    jcfg = JVLM.VLMConfig(vision=vis, llm=llm, projector=JPROJ.ProjectorConfig(
        vision_dim=vis.hidden_size, llm_dim=128, expansion_factor=2))
    jp = JVLM.init(jax.random.key(0), jcfg)
    jp["llm"] = JQ.quantize_decoder(jp["llm"], method=method)
    jp["lora"] = JL.init(jax.random.key(1), jcfg.llm, JL.LoraConfig(r=4, alpha=8))
    return jcfg, jax.tree.map(np.asarray, jp)


def _jax_leaves(jp):
    from projectiontrainer_tpu.core.pytree import path_str

    return {path_str(p): x for p, x in jax.tree_util.tree_leaves_with_path(jp)}


@pytest.mark.parametrize("method", ["nf4-mirror", "int8", "nf4"])
def test_every_leaf_of_a_qlora_vlm_gets_the_jax_spec(method):
    jcfg, jp = _qlora_vlm(method)
    theirs = _jax_leaves(jp)
    ours = dict(leaves_with_paths(from_jax.vlm_params(jp)))
    cfg = from_jax.config_from_jax(jcfg)
    rules, _ = sharding.rules_for(cfg)
    checked = 0
    for path, x in ours.items():
        jpath = path[:-len("weight")] + "kernel" if path.endswith("/weight") else path
        jx = theirs[jpath]
        jspec = tuple(JSHARD.spec_for_path(jpath))
        jdim = jspec.index("model") if "model" in jspec else None
        if jdim is not None and x.ndim == 2 and not path.endswith("embedding"):
            assert tuple(x.shape) == tuple(jx.shape)[::-1], path
            jdim = 1 - jdim  # a linear leaf: the port holds the transpose
        assert sharding.sharded_dim(path, rules) == jdim, (path, jspec)
        checked += 1
    assert checked == len(ours)
    plan = sharding.plan_for(from_jax.vlm_params(jp), cfg)
    # the quantized leaves are sharded with their base: codes and scales of q/o/down
    assert plan.dims["llm/layers/0/attn/o_proj/" + (
        "qvalues" if method == "int8" else "block_scales")] == 1
    assert "lora/layers/1/q_proj/a" in plan.partial and "lora/layers/1/o_proj/b" in plan.partial


def test_a_single_kv_head_stays_replicated():
    jcfg = T.tiny_vlm_cfg()
    assert jcfg.llm.num_kv_heads == 1
    cfg = from_jax.config_from_jax(jcfg)
    jp = jax.tree.map(np.asarray, JVLM.init(jax.random.key(0), jcfg))
    plan = sharding.plan_for(from_jax.vlm_params(jp), cfg)
    assert "llm/layers/0/attn/k_proj/weight" not in plan.dims
    assert "llm/layers/0/attn/k_proj/weight" in plan.partial
    assert plan.dims["llm/layers/0/attn/q_proj/weight"] == 0
    # the JAX rules shard it (GSPMD regathers the one head)
    assert tuple(JSHARD.spec_for_path("llm/layers/0/attn/k_proj/kernel")) == (None, "model")


@pytest.mark.parametrize("name", ["qwen_qlora", "gemma"])
def test_the_shards_put_back_together_are_the_leaf(name):
    model = 2
    if name == "gemma":
        jcfg = T.tiny_vlm_cfg()
        jp = jax.tree.map(np.asarray, JVLM.init(jax.random.key(0), jcfg))
    else:
        jcfg, jp = _qlora_vlm("nf4-mirror")
    cfg = from_jax.config_from_jax(jcfg)
    sharding.check_config(cfg, model)
    full = from_jax.vlm_params(jp)
    shards = [sharding.shard_params(full, sharding.plan_for(full, cfg, model=model, rank=r))
              for r in range(model)]
    plan = sharding.plan_for(full, cfg, model=model, rank=0)
    per_rank = [dict(leaves_with_paths(s)) for s in shards]
    for path, x in unique_leaves_with_paths(full):
        parts = [leaves[path] for leaves in per_rank]
        if path in plan.dims:
            assert parts[0].shape[plan.dims[path]] * model == x.shape[plan.dims[path]]
            assert torch.equal(torch.cat(parts, dim=plan.dims[path]), x), path
        else:
            assert all(p is x for p in parts), path


def test_the_tied_head_is_sliced_once():
    jcfg = T.tiny_vlm_cfg()
    cfg = from_jax.config_from_jax(jcfg)
    full = from_jax.vlm_params(jax.tree.map(np.asarray, JVLM.init(jax.random.key(0), jcfg)))
    assert full["llm"]["lm_head"]["weight"] is full["llm"]["embed_tokens"]["embedding"]
    local = sharding.shard_params(full, sharding.plan_for(full, cfg, model=2, rank=1))
    assert local["llm"]["lm_head"]["weight"] is local["llm"]["embed_tokens"]["embedding"]
    assert torch.equal(local["llm"]["lm_head"]["weight"],
                       full["llm"]["embed_tokens"]["embedding"][64:])


# per case: (model axis, the units it leaves whole, leaves of whole units, sharded leaves
# (path -> dim), leaves with partial gradients) for a 1-layer Qwen3 decoder
_L = "llm/layers/0/"
_PLANS = {
    "heads": (2, ["llm attention"],
              [_L + "attn/q_proj/weight", _L + "attn/k_proj/weight", _L + "attn/o_proj/weight",
               _L + "attn/q_norm/scale", _L + "attn/k_norm/scale"],
              {_L + "mlp/gate_proj/weight": 0, _L + "mlp/down_proj/weight": 1,
               "llm/embed_tokens/embedding": 0}, []),
    "kv_heads": (8, ["llm KV heads"], [],
                 {_L + "attn/q_proj/weight": 0, _L + "attn/o_proj/weight": 1,
                  _L + "mlp/up_proj/weight": 0, "llm/lm_head/weight": 0},
                 [_L + "attn/k_proj/weight", _L + "attn/v_proj/weight", _L + "attn/q_norm/scale",
                  _L + "attn/k_norm/scale"]),
    "intermediate": (2, ["llm MLP"],
                     [_L + "mlp/gate_proj/weight", _L + "mlp/up_proj/weight",
                      _L + "mlp/down_proj/weight"],
                     {_L + "attn/q_proj/weight": 0, _L + "attn/k_proj/weight": 0,
                      "llm/embed_tokens/embedding": 0}, [_L + "attn/k_norm/scale"]),
    "vocab": (2, ["llm vocab"], ["llm/embed_tokens/embedding", "llm/lm_head/weight"],
              {_L + "attn/v_proj/weight": 0, _L + "mlp/down_proj/weight": 1}, []),
}


@pytest.mark.parametrize("what", ["heads", "kv_heads", "intermediate", "vocab", "leaf"])
def test_an_indivisible_model_raises(what):
    """A model whose heads, KV heads, intermediate size or vocab the model axis does not
    divide no longer raises: the plan leaves that unit whole on every rank (replicated,
    a complete gradient; replicated KV heads get a partial one) and shards the rest. A
    leaf that a plan shards and that does not divide still raises."""
    if what == "leaf":
        plan = sharding.plan_for({"projector": {"fc1": {"weight": torch.zeros(5, 4)}}},
                                 model=2, rank=0)
        with pytest.raises(ValueError, match="does not divide"):
            sharding.shard_params({"projector": {"fc1": {"weight": torch.zeros(5, 4)}}}, plan)
        return
    kw = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=1,
              num_heads=4, num_kv_heads=2, head_dim=32)
    kw.update({"heads": dict(num_heads=3, num_kv_heads=1), "kv_heads": dict(num_kv_heads=4,
               num_heads=8), "intermediate": dict(intermediate_size=255),
               "vocab": dict(vocab_size=127)}[what])
    cfg = from_jax.config_from_jax(JDEC.qwen3_config(**kw))
    model, whole_units, whole, shards, partial = _PLANS[what]
    if what == "kv_heads":
        assert sharding.check_config(cfg, 2) == []  # 4 KV heads divide over 2 ...
    assert sharding.check_config(cfg, model) == whole_units
    from projectiontrainer_tpu_torch.models import decoder

    params = decoder.init(torch.Generator().manual_seed(0), cfg)
    plan = sharding.plan_for(params, cfg, model=model, rank=model - 1, prefix="llm")
    for p in whole:
        assert p not in plan.dims and p not in plan.partial, p
    assert {p: plan.dims.get(p) for p in shards} == shards
    assert all(p in plan.partial for p in partial)
    local = dict(leaves_with_paths(sharding.shard_params(params, plan, prefix="llm"), "llm"))
    full = dict(leaves_with_paths(params, "llm"))
    for p in whole:
        assert local[p] is full[p], p  # whole on every rank
    for p, dim in shards.items():
        assert local[p].shape[dim] * model == full[p].shape[dim], p
