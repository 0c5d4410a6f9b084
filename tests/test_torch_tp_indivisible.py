"""Tensor parallelism at a model axis that does not divide the model, on the CPU: gloo
ranks against one port process and against the JAX package on its data x model mesh.

The port splits a unit over the model axis only where every dim of it divides and runs
it whole on every model rank otherwise (``parallel/sharding.py:units``); KV heads that
do not divide where the query heads do are replicated and sliced by rank. The JAX
package replicates each leaf that does not divide. The cases:

(a) a tiny Gemma3 VLM at 1 x 2: 3 query heads over 1 KV head (the decoder's attention
    whole), intermediate 145, vocab 131 and a projector of 99 (all whole), a tower of 3
    heads (its attention whole, its MLP split): stage 1, stage-2 full-joint under full
    remat, greedy and 3-beam generation; and a Qwen3 decoder of 6 query heads over 3 KV
    heads, forward and backward: a rank's 3 query heads read KV heads 0, 0, 1 (1, 2, 2),
    no uniform grouping, so each rank expands them to one KV head a query head;
(b) a tiny Qwen3 QLoRA VLM at 1 x 4: 4 query heads over 2 KV heads (each rank's query
    head reads one replicated KV head), LoRA on every target (k/v included), the MLP
    split, vocab 131 and a projector of 90 whole, under ``remat='dots'``; greedy and
    3-beam generation on a dense decoder of its widths (K3's caches hold the KV head
    each rank's query head reads);
(c) a SigLIP dual tower of 3 heads at 1 x 2 (attention whole, the MLPs split, text vocab
    129 whole): stage 0 with global negatives and the text tower trained, and the cls
    probe over a tower of 3 heads;
(d) stage 0 at 2 x 2 under ``--fsdp``: towers of 4 heads (split) with MLPs of 515
    (whole on the model axis, data-sharded on their width);
(e) (b)'s QLoRA VLM with an MLP of 384 at 1 x 4, quantized by nf4 and by nf4-mirror: its
    rows divide over the 4 ranks, its 6 blocks of 64 along down_proj's input do not, so
    the port runs the MLP whole (``sharding.units``: a unit whole) where the JAX package
    replicates the leaves that do not divide (``block_scales``) and shards the rest.

The ranks are ``tests/torch_tp_worker.py`` (a, b) and ``tests/torch_tp_towers_worker.py``
(c, d) processes (no JAX; the four meshes spawned at once, each rank bounded by 120 s).
Each case is held against one port process (losses and grad norms within 1e-6
relative, every trained leaf within 1e-6, the trained leaves the model axis leaves
whole bit-equal across the model ranks after every step; tokens equal) and against the
JAX package (its step under ``jit`` with the params sharded by its rules over the data x
model virtual mesh of ``tests/conftest.py``; its generation): within 1e-4 relative,
tokens equal. Each number also may move by 3x what a 1e-7 relative change of the pixels
moves it in one port process (``_rounding``): after two Adam steps an element whose
gradient nearly vanishes moves by what rounding decides, as the existing tests' noise
leaves do (a SigLIP q_proj element moves by 4e-5 there). Case (d) takes the bound of the
``--fsdp`` tests (``tests/test_torch_fsdp.py``, ``tests/test_torch_tp_towers.py``'s wide
cases): losses and grad norms within 1e-5 of one process, each trained leaf's update at
cosine >= 0.9999 (0.999 against JAX). The model-axis collectives of (a)'s stage 1 and
(b) are the counts read off the code.
"""

import concurrent.futures
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.core import mesh as JMESH
from projectiontrainer_tpu.generate import decode as JGEN
from projectiontrainer_tpu.models import classifier as JC
from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu.models import projector as JPROJ
from projectiontrainer_tpu.models import siglip as JSIG
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu.ops import quant as JQ
from projectiontrainer_tpu.parallel import param_shardings
from projectiontrainer_tpu.parallel import sharding as JSHARD
from projectiontrainer_tpu.train import lora as JL
from projectiontrainer_tpu.train import masks as JM
from projectiontrainer_tpu.train import optim as JO
from projectiontrainer_tpu.train import steps as JS
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
from projectiontrainer_tpu_torch.models import classifier, decoder
from projectiontrainer_tpu_torch.ops.flash_attention import rank_kv_heads
from projectiontrainer_tpu_torch.parallel import sharding

import torch_dp_worker
import torch_tp_towers_worker
import torch_tp_worker

torch.set_num_threads(2)
PAD = 0
HERE = os.path.dirname(os.path.abspath(__file__))
FULL_JOINT = dict(train_llm=True, use_lora=False, train_projector=True, train_vision=True)
QLORA = dict(train_llm=False, use_lora=True, train_projector=True, train_vision=False)
# leaves whose gradient is zero in exact arithmetic: Adam moves them by rounding noise
NOISE = ("k_proj/bias", "vision/post_layernorm/bias", "mha/v_proj/bias", "mha/out_proj/bias")
NOISE_STEP = 1e-2  # the largest learning rate of the cases
# --fsdp (the data axis's reduce-scatters): the bound of the fsdp tests
FSDP_RTOL, FSDP_COS, FSDP_COS_JAX = 1e-5, 0.9999, 0.999

# case -> (mesh, worker): the VLM cases on torch_tp_worker, the towers' on the other
CASES = {"stage1": "1x2", "full_joint": "1x2", "generate": "1x2", "forward_kv": "1x2",
         "qlora": "1x4", "generate_kv": "1x4", "stage0": "1x2", "cls": "1x2",
         "stage0_fsdp": "2x2", "qlora_nf4_blocks": "1x4", "qlora_mirror_blocks": "1x4"}
TOWERS = ("stage0", "cls", "stage0_fsdp")
TRAIN = ("stage1", "full_joint", "qlora", "stage0", "cls", "stage0_fsdp", "qlora_nf4_blocks",
         "qlora_mirror_blocks")
# (e)'s models: an MLP of 384, quantized by each NF4 method
BLOCKS = {"qwen_blocks_nf4": "nf4", "qwen_blocks_mirror": "nf4-mirror"}


def _meshes():
    """(mesh, worker script, the cases it runs) of each launch."""
    out = {}
    for name, mesh in CASES.items():
        script = "torch_tp_towers_worker.py" if name in TOWERS else "torch_tp_worker.py"
        out.setdefault((mesh, script), []).append(name)
    return out


# ------------------------------------------------------------------ models and batches


@functools.cache
def _jcfg(model):
    """The JAX config of ``model``: 'gemma', 'qwen' (NF4 blocks of 64 whole on each of 4
    model ranks where the model axis splits), 'qwen_dense' (its decoder), 'siglip',
    'siglip_wide' or 'classifier'."""
    if model == "qwen_dense":
        return _jcfg("qwen").llm
    if model == "qwen_kv6":
        return JDEC.qwen3_config(vocab_size=64, hidden_size=64, intermediate_size=128,
                                 num_layers=1, num_heads=6, num_kv_heads=3, head_dim=16)
    if model == "gemma":
        vis = T.tiny_vision_cfg(hidden=33, heads=3)
        llm = JDEC.gemma3_config(vocab_size=131, hidden_size=48, intermediate_size=145,
                                 num_layers=2, num_heads=3, num_kv_heads=1, head_dim=16,
                                 sliding_window=16, query_pre_attn_scalar=16)
        return JVLM.VLMConfig(vision=vis, llm=llm, projector=JPROJ.ProjectorConfig(
            vision_dim=33, llm_dim=48, expansion_factor=3))
    if model in ("qwen",) + tuple(BLOCKS):
        vis = T.tiny_vision_cfg(hidden=30, heads=3)
        llm = JDEC.qwen3_config(vocab_size=131, hidden_size=128,
                                intermediate_size=384 if model in BLOCKS else 512,
                                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64)
        return JVLM.VLMConfig(vision=vis, llm=llm, projector=JPROJ.ProjectorConfig(
            vision_dim=30, llm_dim=128, expansion_factor=3))
    if model == "siglip_wide":
        tower = dict(hidden_size=128, intermediate_size=515, num_layers=1, num_heads=4)
        return JSIG.SiglipConfig(
            vision=JSIG.VisionConfig(**tower, image_size=16, patch_size=8, use_head=True),
            text=JSIG.TextConfig(**tower, vocab_size=129, max_position_embeddings=16))
    if model == "siglip":
        return T.tiny_siglip_cfg(image_size=16, hidden=48, heads=3, vocab=129)
    vcfg = T.tiny_vision_cfg(image_size=16, patch=8, hidden=48, heads=3)
    return JC.ClassifierConfig(vision=vcfg, num_classes=4, num_heads=4, dropout_rate=0.0)


MODELS = ("gemma", "qwen", "qwen_dense", "qwen_kv6", "siglip", "siglip_wide", "classifier",
          "qwen_blocks_nf4", "qwen_blocks_mirror")
INIT = {"gemma": JVLM.init, "qwen": JVLM.init, "qwen_dense": JDEC.init, "qwen_kv6": JDEC.init,
        "siglip": JSIG.init, "siglip_wide": JSIG.init, "classifier": JC.init,
        "qwen_blocks_nf4": JVLM.init, "qwen_blocks_mirror": JVLM.init}


@functools.cache
def _jparams(model):
    """The JAX params of ``model`` as numpy (the QLoRA model quantized, its adapters'
    B drawn off zero so that the A gradients are nonzero too)."""
    jcfg = _jcfg(model)
    jp = jax.jit(INIT[model], static_argnums=1)(jax.random.key(0), jcfg)
    if model == "qwen" or model in BLOCKS:
        jp["llm"] = jax.jit(functools.partial(JQ.quantize_decoder,
                                              method=BLOCKS.get(model, "nf4-mirror")))(jp["llm"])
        jp["lora"] = JL.init(jax.random.key(1), jcfg.llm, JL.LoraConfig(r=4, alpha=8))
    jp = jax.tree.map(np.asarray, jp)
    if model == "qwen" or model in BLOCKS:
        rng = np.random.default_rng(2)
        for layer in jp["lora"]["layers"]:
            for p in layer.values():
                p["b"] = rng.standard_normal(p["b"].shape, dtype=np.float32) * 0.05
    return jp


def _ids(rng, rows, t, lengths):
    out = np.full((rows, t), PAD, np.int32)
    for i, n in enumerate(lengths):
        out[i, :n] = rng.integers(2, 131, size=n)
    return out


def _vlm_batches(kind):
    rng = np.random.default_rng(0 if kind == "stage1" else 2)
    out = []
    for i in range(2):
        b = {"pixel_values": rng.standard_normal((4, 32, 32, 3), dtype=np.float32)}
        if kind == "stage1":
            b["caption_ids"] = _ids(rng, 4, 12, rng.integers(3, 13, size=4))
        else:
            b["question_ids"] = _ids(rng, 4, 5, rng.integers(2, 6, size=4))
            b["answer_ids"] = _ids(rng, 4, 8, rng.integers(3, 9, size=4))
        if i == 1:
            b["sample_weight"] = np.array([1, 1, 1, 0], np.float32)
        out.append(b)
    return out


def _tower_batches(kind, image_size):
    rng = np.random.default_rng(1)
    out = []
    for i in range(2):
        b = {"pixel_values": rng.standard_normal((4, image_size, image_size, 3),
                                                 dtype=np.float32)}
        if kind == "stage0":
            b.update(input_ids=rng.integers(1, 129, size=(4, 16)).astype(np.int32),
                     sample_weight=np.ones(4, np.float32), valid=np.ones(4, bool))
        else:
            b["target_indices"] = rng.integers(0, 4, 4).astype(np.int32)
        if i == 1:
            b["sample_weight"] = np.array([1, 1, 1, 0], np.float32)
        out.append(b)
    return out


MODEL_OF = {"stage1": "gemma", "full_joint": "gemma", "generate": "gemma", "qlora": "qwen",
            "generate_kv": "qwen_dense", "forward_kv": "qwen_kv6", "stage0": "siglip",
            "cls": "classifier", "stage0_fsdp": "siglip_wide",
            "qlora_nf4_blocks": "qwen_blocks_nf4", "qlora_mirror_blocks": "qwen_blocks_mirror"}
GENERATE = ("generate", "generate_kv")


def _case_cfg(name):
    """The JAX config of case ``name`` (the decoder's for generation)."""
    jcfg = _jcfg(MODEL_OF[name])
    return jcfg.llm if name == "generate" else jcfg


@functools.cache
def _case(name):
    """(the port's case without its params and config, the JAX config, the JAX params)"""
    jcfg, jp = _case_cfg(name), _jparams(MODEL_OF[name])
    if name == "stage1":
        return dict(kind="stage1", batches=_vlm_batches("stage1")), jcfg, jp
    if name in ("full_joint", "qlora", "qlora_nf4_blocks", "qlora_mirror_blocks"):
        case = (dict(policy=FULL_JOINT, remat=True) if name == "full_joint" else
                dict(policy=QLORA, lora_r=4, remat="dots"))
        return dict(kind="stage2", batches=_vlm_batches("stage2"), **case), jcfg, jp
    if name in GENERATE + ("forward_kv",):
        rng = np.random.default_rng(7)
        mask = np.ones((2, 9), np.int32)
        mask[1, :3] = 0  # left padding
        case = dict(kind="generate", prefix="llm", mask=mask, embeds=rng.standard_normal(
            (2, 9, jcfg.hidden_size), dtype=np.float32))
        if name == "forward_kv":
            case.update(kind="forward", remat=True, probe=rng.standard_normal(
                (2, 9, jcfg.hidden_size), dtype=np.float32))
        return case, jcfg, jp["llm"] if name == "generate" else jp
    if name == "cls":
        return (dict(kind="cls", multilabel=False, freeze_mode="Unfreeze", swap_at=1,
                     batches=_tower_batches("cls", 16)), jcfg, jp)
    return (dict(kind="stage0", shards=1, freeze_text=False, fsdp=name == "stage0_fsdp",
                 batches=_tower_batches("stage0", 16)), jcfg, jp)


def _port_cfg(jcfg, quant_method=None):
    """The port's config of ``jcfg``; its decoder quantized by ``quant_method`` where one
    is given (``decoder.QuantizedDecoderConfig``, as ``setup.build_vlm`` makes it)."""
    if isinstance(jcfg, JC.ClassifierConfig):
        return classifier.ClassifierConfig(vision=from_jax.config_from_jax(jcfg.vision),
                                           num_classes=jcfg.num_classes,
                                           num_heads=jcfg.num_heads,
                                           dropout_rate=jcfg.dropout_rate)
    cfg = from_jax.config_from_jax(jcfg)
    if quant_method is not None:
        cfg = dataclasses.replace(cfg, llm=decoder.quantized_config(cfg.llm, quant_method))
    return cfg


def _port_params(name):
    case, jcfg, jp = _case(name)
    if case["kind"] in ("generate", "forward"):
        return from_jax.decoder_params(jp)
    if case["kind"] == "cls":
        return from_jax.classifier_params(jp)
    if case["kind"] == "stage0":
        return from_jax.siglip_params(jp)
    return from_jax.vlm_params(jp)


def _port_case(name):
    case, jcfg, _ = _case(name)
    return {**case, "cfg": _port_cfg(jcfg, BLOCKS.get(MODEL_OF[name])),
            "params": _port_params(name)}


# ------------------------------------------------------------------ the ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{case: result dicts by rank}: every mesh's ranks spawned at once, the JAX
    references (``_jax_train``, ``_jax_generate``) computed meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(_jparams, MODELS))
        for name in CASES:
            _case(name)
        launches = []
        for (mesh, script), names in _meshes().items():
            d = str(tmp_path_factory.mktemp(f"tp_indivisible_{mesh}_{script[:-3]}"))
            torch.save({n: _port_case(n) for n in names}, os.path.join(d, "payload.pt"))
            launches.append((mesh, script, names, d))

        def spawn(launch):
            mesh, script, _, d = launch
            data, model = (int(v) for v in mesh.split("x"))
            torch_dp_worker.spawn_ranks(mesh, d, data * model, timeout=120,
                                        script=os.path.join(HERE, script))

        jobs = [pool.submit(spawn, launch) for launch in launches]
        jobs += [pool.submit(_jax_train, name) for name in TRAIN]
        jobs += [pool.submit(_jax_generate, name) for name in GENERATE]
        jobs.append(pool.submit(_jax_forward, "forward_kv"))
        for job in jobs:
            job.result()
    out = {}
    for mesh, _, names, d in launches:
        data, model = (int(v) for v in mesh.split("x"))
        got = [torch.load(os.path.join(d, f"result{r}.pt"), weights_only=False)
               for r in range(data * model)]
        for n in names:
            out[n] = [{**g[n], "_counts": g["_counts_by_case"].get(n)} for g in got]
    return out


@functools.cache
def _one_process(name, perturbed=False):
    """The case in one port process; ``perturbed``: its pixels scaled by 1 + 1e-7, which
    shows what rounding alone moves (:func:`_rounding`)."""
    case = _port_case(name)
    if case["kind"] == "generate":
        return torch_tp_worker.generate_case(case, case["params"])
    if case["kind"] == "forward":
        return torch_tp_worker.forward_case(case, case["params"])
    batches = case["batches"]
    if perturbed:
        batches = [{**b, "pixel_values": (b["pixel_values"] * np.float32(1 + 1e-7))}
                   for b in batches]
    if name in TOWERS:
        return torch_tp_towers_worker.run_case(case, case["params"], batches)
    return torch_tp_worker.run_case(case, case["params"], batches)


def _rounding(name, key, path=None):
    """3x how far a 1e-7 relative change of the inputs moves the one-process run's
    ``key`` (the losses or the grad norms, or the leaf at ``path``): an element whose
    gradient nearly vanishes, or whose two Adam steps nearly cancel, moves by what
    rounding decides there, on every side of the comparison."""
    a, b = _one_process(name), _one_process(name, perturbed=True)
    if path is None:
        return 3 * np.abs(np.asarray(a[key]) - np.asarray(b[key]))
    return 3 * np.abs((a[key][path].float() - b[key][path].float()).numpy())


def _close(name, key, got, want, rtol):
    """``got`` (the losses or grad norms) within ``rtol`` of ``want``, plus rounding."""
    got, want = np.asarray(got), np.asarray(want)
    assert (np.abs(got - want) <= rtol * np.abs(want) + _rounding(name, key)).all(), (
        key, got, want)


def _trained_close(name, ours: dict, theirs: dict, tol, *, relative: bool, cos_min=None):
    """Each trained leaf's update within ``tol`` (x the larger of the reference leaf's
    largest magnitude and the most Adam moves it when ``relative``), each element plus
    what rounding moves it by (:func:`_rounding`), or with ``cos_min`` at cosine >=
    ``cos_min``; a noise leaf's update at most 3x the reference's plus ``NOISE_STEP`` a
    step."""
    x0 = dict(unique_leaves_with_paths(_port_params(name)))
    n_steps = len(_case(name)[0]["batches"])
    assert ours.keys() <= theirs.keys() and ours
    for p, x in ours.items():
        mine = (x.float() - x0[p].float()).numpy()
        ref = (theirs[p].float() - x0[p].float()).numpy()
        if p.endswith(NOISE) or (name == "cls" and p == "head/bias"):
            assert np.abs(mine).max() <= 3 * np.abs(ref).max() + NOISE_STEP * n_steps, p
            continue
        assert np.abs(ref).max() > 0, p  # the leaf trained
        if cos_min is not None:
            a, b = mine.ravel().astype(np.float64), ref.ravel().astype(np.float64)
            cos = a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300)
            assert cos >= cos_min, f"{name} {p}: cosine {cos}"
            continue
        scale = (max(np.abs(theirs[p].float().numpy()).max(), NOISE_STEP * n_steps)
                 if relative else 1.0)
        err = np.abs(mine - ref) - _rounding(name, "params", p)
        assert err.max() <= tol * scale, f"{name} {p}: err {err.max()} vs {scale}"


def test_the_plans_leave_the_indivisible_units_whole():
    """What each case's model axis splits and leaves whole (``sharding.check_config``),
    and the configs of the repo that used to raise."""
    from projectiontrainer_tpu_torch.models import decoder, projector, siglip, vlm

    want = {"stage1": ["llm attention", "llm MLP", "llm vocab", "projector MLP",
                       "vision attention"],
            "qlora": ["llm KV heads", "llm vocab", "projector MLP", "vision attention"],
            "stage0": ["vision attention", "text attention", "text vocab"],
            "cls": ["vision attention"],
            "stage0_fsdp": ["vision MLP", "text MLP", "text vocab"]}
    blocks = ["llm KV heads", "llm MLP", "llm vocab", "projector MLP", "vision attention"]
    want.update(qlora_nf4_blocks=blocks, qlora_mirror_blocks=blocks)
    for name, whole in want.items():
        model = int(CASES[name].split("x")[1])
        cfg = _port_cfg(_case_cfg(name), BLOCKS.get(MODEL_OF[name]))
        assert sharding.check_config(cfg, model) == whole, name
    assert sharding.check_config(vlm.full_joint_4b_config(), 8) == ["llm KV heads"]
    stage1_1b = vlm.VLMConfig(vision=siglip.vit_l_16_384(),
                              projector=projector.ProjectorConfig(1024, 1152),
                              llm=decoder.gemma3_config(num_layers=6))
    assert sharding.check_config(stage1_1b, 3) == [
        "llm attention", "llm vocab", "projector MLP", "vision attention", "vision MLP"]


@pytest.mark.parametrize("name", ["qlora_nf4_blocks", "qlora_mirror_blocks"])
def test_nf4_blocks_keep_the_mlp_whole(name):
    """(e)'s plan at 1 x 4: the MLP's rows divide, its NF4 blocks do not, so every leaf
    of the MLP (codes, block scales, LoRA) stays whole on each rank, while the attention
    and the same decoder unquantized split; the JAX package shards the codes and
    replicates the block scales alone."""
    cfg = _port_cfg(_case_cfg(name), BLOCKS[MODEL_OF[name]])
    assert sharding.nf4_blocks(cfg.llm, cfg.llm.intermediate_size) == 6
    dense = _port_cfg(_case_cfg(name))
    assert sharding.units(dense.llm, 4).mlp and not sharding.units(cfg.llm, 4).mlp
    assert sharding.units(cfg.llm, 4).attn
    params = _port_params(name)
    plan = sharding.plan_for(params, cfg, model=4, rank=3)
    mlp = [p for p, _ in unique_leaves_with_paths(params)
           if p.startswith("llm/") and "/mlp/" in p
           or p.startswith("lora/") and any(t in p for t in ("gate_proj", "up_proj", "down_proj"))]
    assert mlp and not any(p in plan.dims for p in mlp)
    key = "packed_nf4" if BLOCKS[MODEL_OF[name]] == "nf4" else "qvalues_block"
    assert plan.dims["llm/layers/0/attn/o_proj/" + key] == 1
    assert plan.dims["llm/layers/0/attn/q_proj/block_scales"] == 0
    local = sharding.shard_params(params, plan)
    down = params["llm"]["layers"][0]["mlp"]["down_proj"]
    assert local["llm"]["layers"][0]["mlp"]["down_proj"]["block_scales"] is down["block_scales"]
    jspecs = param_shardings(_jparams(MODEL_OF[name]), _jax_mesh(CASES[name]))
    jdown = jspecs["llm"]["layers"][0]["mlp"]["down_proj"]
    assert jdown["block_scales"].spec == P() and jdown[key].spec != P()


@pytest.mark.parametrize("name", TRAIN)
def test_train_matches_one_process_and_whole_leaves_stay_equal(ranks, name):
    got, ref = ranks[name], _one_process(name)
    fsdp = _case(name)[0].get("fsdp", False)
    for r in got:
        _close(name, "losses", r["losses"], ref["losses"], FSDP_RTOL if fsdp else 1e-6)
        _close(name, "grad_norms", r["grad_norms"], ref["grad_norms"],
               FSDP_RTOL if fsdp else 1e-6)
        _trained_close(name, r["params"], ref["params"], 1e-6, relative=False,
                       cos_min=FSDP_COS if fsdp else None)
    model = int(CASES[name].split("x")[1])
    key = "model_whole_bytes_by_step" if name in TOWERS else "replicated_bytes_by_step"
    for i, r in enumerate(got):  # the model ranks of a replica: whole leaves bit-equal
        first = got[i - i % model][key]
        assert len(first) == len(_case(name)[0]["batches"]) and first[0]
        assert r[key] == first, i


@pytest.mark.parametrize("name", GENERATE)
def test_generation_tokens_match_one_process(ranks, name):
    ref = _one_process(name)
    for r in ranks[name]:
        for k in ("beams1", "beams3"):
            assert torch.equal(r[k], ref[k]), k


def test_decoder_with_expanded_kv_heads_matches_one_process(ranks):
    """6 query heads over 3 KV heads at 1 x 2: hidden states and the gradients of a fixed
    projection of them (the embeddings', q_proj's gathered) within 1e-6 of the largest
    magnitude."""
    assert rank_kv_heads(6, 3, 2, 0) == [0, 0, 1] and rank_kv_heads(6, 3, 2, 1) == [1, 2, 2]
    ref = _one_process("forward_kv")
    for r in ranks["forward_kv"]:
        for k in ("hidden", "d_embeds", "d_q"):
            want = ref[k].numpy()
            np.testing.assert_allclose(r[k].numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(), err_msg=k)


def test_model_axis_collectives_are_the_counts_read_off_the_code(ranks):
    """Per train step. (a) stage 1 at 1 x 2: the frozen tower's 2 split MLPs all-reduce
    in the forward; the decoder, its vocab and the projector are whole; the clip and the
    step's grad norm sum the sharded leaves' squares (2). (b) QLoRA at 1 x 4: the
    decoder's 2 attention blocks and 2 MLPs reduce in the forward and in the backward
    (``copy_to_model``), the frozen tower's 2 MLPs in the forward; ``remat='dots'`` saves
    the reductions (no recompute); the partial gradients (the replicated k/v LoRA and
    norms) are summed once, and the 2 norms."""
    per_step = {"stage1": {"forward": 2, "backward": 0, "recompute": 0, "grads": 2},
                "qlora": {"forward": 6, "backward": 4, "recompute": 0, "grads": 3}}
    for name, counts in per_step.items():
        steps = len(_case(name)[0]["batches"])
        for r in ranks[name]:
            assert r["_counts"] == {k: v * steps for k, v in counts.items()}, name


# ------------------------------------------------------------------ against JAX


def _jax_mesh(mesh):
    data, model = (int(v) for v in mesh.split("x"))
    return JMESH.build_mesh(JMESH.MeshConfig(data=data, model=model))


@functools.cache
def _jax_train(name):
    case, jcfg, jp = _case(name)
    total = len(case["batches"])
    if case["kind"] == "stage1":
        labels = JM.stage1_labels(jp)
        tx, _ = JO.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.1,
                                          weight_decay=0.01, clip_norm=5.0)
        loss = JS.stage1_loss(jcfg, PAD, remat=False, logits_chunk=5, ce_impl="chunked")
    elif case["kind"] == "stage2":
        labels = JM.stage2_labels(jp, JM.Stage2Freeze(**case["policy"]))
        tx, _ = JO.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.1,
                                          weight_decay=0.01, clip_norm=1.0,
                                          clip_per_module=True)
        lcfg = JL.LoraConfig(r=4, alpha=8, dropout=0.0) if "lora_r" in case else None
        # remat moves no number: the port's case runs it, the reference compiles without
        loss = JS.stage2_loss(jcfg, PAD, lora_cfg=lcfg, remat=False, logits_chunk=5,
                              ce_impl="chunked", table_frozen=lcfg is not None)
    elif case["kind"] == "stage0":
        labels = JM.stage0_labels(jp, freeze_text=case["freeze_text"])
        tx, _ = JO.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.3,
                                          weight_decay=0.01, warmup_rounding="floor")
        loss = JS.stage0_loss(jcfg, remat=False, local_negatives_shards=case["shards"])
    else:
        labels = JM.classifier_labels(jp, freeze_vision=False)
        tx = JO.discriminative_optimizer(labels, head_lr=1e-2, backbone_lr=1e-3,
                                         weight_decay=0.01, total_steps=total)[0]
        loss = JS.classifier_loss(jcfg, multilabel=case["multilabel"])
    step = JS.make_train_step(loss, tx, trainable_mask=JM.bool_mask(labels), donate=False)
    jmesh = _jax_mesh(CASES[name])
    params = jax.device_put(jax.tree.map(jnp.asarray, jp),
                            param_shardings(jp, jmesh, fsdp=case.get("fsdp", False)))
    state = JS.init_state(params, tx)
    losses = []
    for i, b in enumerate(case["batches"]):
        batch = jax.device_put(jax.tree.map(jnp.asarray, b), NamedSharding(jmesh, P("data")))
        state, value, _ = step(state, batch, jax.random.key(i))
        losses.append(float(value))
    final = jax.tree.map(np.asarray, state["params"])
    convert = {"cls": from_jax.classifier_params, "stage0": from_jax.siglip_params}.get(
        case["kind"], from_jax.vlm_params)
    return losses, dict(unique_leaves_with_paths(convert(final)))


@pytest.mark.parametrize("name", TRAIN)
def test_train_matches_the_jax_data_model_mesh(ranks, name):
    jlosses, jparams = _jax_train(name)
    got = ranks[name][0]
    _close(name, "losses", got["losses"], jlosses, 1e-4)
    _trained_close(name, got["params"], jparams, 1e-4, relative=True,
                   cos_min=FSDP_COS_JAX if _case(name)[0].get("fsdp") else None)


@functools.cache
def _jax_forward(name):
    case, jcfg, jllm = _case(name)
    params = JSHARD.shard_params(jax.tree.map(jnp.asarray, jllm), _jax_mesh(CASES[name]))
    hidden, _ = jax.jit(lambda p, e, m: JDEC.forward(p, jcfg, inputs_embeds=e,
                                                     attention_mask=m))(
        params, jnp.asarray(case["embeds"]), jnp.asarray(case["mask"]))
    return np.asarray(hidden)


def test_decoder_with_expanded_kv_heads_matches_jax(ranks):
    want = _jax_forward("forward_kv")
    np.testing.assert_allclose(ranks["forward_kv"][0]["hidden"].numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@functools.cache
def _jax_generate(name):
    case, jcfg, jllm = _case(name)
    out = {}
    for beams in (1, 3):
        cfg = JGEN.GenerationConfig(max_new_tokens=6, num_beams=beams, eos_token_id=1,
                                    pad_token_id=PAD)
        out[beams] = np.asarray(JGEN.generate(
            jax.tree.map(jnp.asarray, jllm), jcfg, jnp.asarray(case["embeds"]),
            jnp.asarray(case["mask"]), cfg, jax.random.key(0)))
    return out


@pytest.mark.parametrize("name", GENERATE)
def test_generation_tokens_match_jax(ranks, name):
    for beams, ids in _jax_generate(name).items():
        np.testing.assert_array_equal(ranks[name][0][f"beams{beams}"].numpy(), ids)
