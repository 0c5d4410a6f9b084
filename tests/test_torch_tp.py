"""Tensor parallelism of the port on the CPU: gloo ranks on a 1 x 2 and a 2 x 2 data x
model mesh against one port process on the whole batch and against the JAX package on
its data x model mesh.

The ranks are ``tests/torch_tp_worker.py`` processes (no JAX; each bounded by 120 s and
its collectives by 60 s); each slices the full params the test built (from the JAX
package's models, through ``checkpoint/from_jax.py``) to its model rank's shards
(``parallel/sharding.py``) and runs every case on its data rank's rows. Two models: a
tiny Gemma3 VLM (2 query heads, ONE KV head: the k/v projections replicated, the
vocab-parallel table tied to the head) and a tiny Qwen3 QLoRA VLM (4 query heads over 2
KV heads, an nf4-mirror base with LoRA adapters).

The cases: stage 1 (projector; the frozen tower and decoder sharded), stage-2
full-joint at accumulation 2 under full remat (every leaf trains, the tied table
through the vocab-parallel chunked CE), QLoRA under ``remat='dots'`` (and, on the 1 x 2
mesh, with LoRA dropout on: the row targets' masks sliced from the full draw), the
decoder forward and backward, the vocab-parallel fused and chunked CE on labels outside
the rank's slice, greedy and 3-beam generation, and a checkpoint saved under TP and read
in one process. Each is held against

- one port process: losses and grad norms within 1e-6 relative, every trained leaf
  within 1e-6 absolute, and every replicated leaf bit-equal across the ranks after every
  step;
- the JAX package (its step under ``jit`` with the params and batch sharded over the
  data x model virtual mesh of ``tests/conftest.py``; its decoder, CE and generation
  functions): within 1e-4 relative.
"""

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
from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu.models import projector as JPROJ
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu.ops import quant as JQ
from projectiontrainer_tpu.parallel import sharding as JSHARD
from projectiontrainer_tpu.train import lora as JL
from projectiontrainer_tpu.train import masks as JM
from projectiontrainer_tpu.train import optim as JO
from projectiontrainer_tpu.train import steps as JS
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths

import torch_dp_worker
import torch_tp_worker

torch.set_num_threads(2)
PAD = 0
MESHES = ("1x2", "2x2")
FULL_JOINT = dict(train_llm=True, use_lora=False, train_projector=True, train_vision=True)
QLORA = dict(train_llm=False, use_lora=True, train_projector=True, train_vision=False)
# leaves whose gradient is zero in exact arithmetic: they move by Adam-scaled rounding
NOISE = ("k_proj/bias", "vision/post_layernorm/bias")
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tp_worker.py")


# ------------------------------------------------------------------ models and batches


@functools.cache
def _gemma():
    jcfg = T.tiny_vlm_cfg()
    jp = jax.jit(JVLM.init, static_argnums=1)(jax.random.key(0), jcfg)
    return jcfg, jax.tree.map(np.asarray, jp)


@functools.cache
def _qwen():
    """Widths whose NF4 blocks of 64 stay whole on each of 2 model ranks."""
    llm = JDEC.qwen3_config(vocab_size=128, hidden_size=128, intermediate_size=256,
                            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32)
    vis = T.tiny_vision_cfg()
    jcfg = JVLM.VLMConfig(vision=vis, llm=llm, projector=JPROJ.ProjectorConfig(
        vision_dim=vis.hidden_size, llm_dim=128, expansion_factor=2))
    jp = JVLM.init(jax.random.key(0), jcfg)
    jp["llm"] = JQ.quantize_decoder(jp["llm"], method="nf4-mirror")
    jp["lora"] = JL.init(jax.random.key(1), jcfg.llm, JL.LoraConfig(r=4, alpha=8))
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(2)
    for layer in jp["lora"]["layers"]:
        for p in layer.values():  # B off zero: the A gradients are nonzero too
            p["b"] = rng.standard_normal(p["b"].shape, dtype=np.float32) * 0.05
    return jcfg, jp


def _ids(rng, rows, t, lengths):
    out = np.full((rows, t), PAD, np.int32)
    for i, n in enumerate(lengths):
        out[i, :n] = rng.integers(2, 128, size=n)
    return out


def _stage1_batches():
    rng = np.random.default_rng(0)
    return [{"pixel_values": rng.standard_normal((4, 32, 32, 3), dtype=np.float32),
             "caption_ids": _ids(rng, 4, 12, rng.integers(3, 13, size=4))}
            for _ in range(2)]


def _stage2_batches(n):
    rng = np.random.default_rng(2)
    out = []
    for i in range(n):
        b = {"pixel_values": rng.standard_normal((4, 32, 32, 3), dtype=np.float32),
             "question_ids": _ids(rng, 4, 5, rng.integers(2, 6, size=4)),
             "answer_ids": _ids(rng, 4, 8, rng.integers(3, 9, size=4))}
        if i == 1:
            b["sample_weight"] = np.array([1, 1, 1, 0], np.float32)
        out.append(b)
    return out


TRAIN = ("stage1", "full_joint", "qlora", "qlora_dropout")


@functools.cache
def _case(name):
    """(the port's case without its params, the JAX config, the JAX params as numpy)"""
    if name == "stage1":
        jcfg, jp = _gemma()
        return dict(kind="stage1", batches=_stage1_batches()), jcfg, jp
    if name == "full_joint":
        jcfg, jp = _gemma()
        return (dict(kind="stage2", policy=FULL_JOINT, accum=2, remat=True,
                     batches=_stage2_batches(4)), jcfg, jp)
    if name in ("qlora", "qlora_dropout"):
        jcfg, jp = _qwen()
        drop = 0.1 if name == "qlora_dropout" else 0.0
        return (dict(kind="stage2", policy=QLORA, lora_r=4, dropout=drop, remat="dots",
                     batches=_stage2_batches(2)), jcfg, jp)
    rng = np.random.default_rng(7)
    if name.startswith(("forward", "generate")):
        jcfg, jp = _gemma() if name.endswith("gemma") else _qwen()
        llm = (jp["llm"] if name.endswith("gemma")  # a dense Qwen3 of the same widths
               else JDEC.init(jax.random.key(3), jcfg.llm))
        b, t = 2, 9
        mask = np.ones((b, t), np.int32)
        mask[1, :3] = 0  # left padding
        case = dict(kind=name.split("_")[0], prefix="llm",
                    embeds=rng.standard_normal((b, t, jcfg.llm.hidden_size),
                                               dtype=np.float32), mask=mask)
        if case["kind"] == "forward":
            case.update(remat="dots", probe=rng.standard_normal(
                (b, t, jcfg.llm.hidden_size), dtype=np.float32))
        return case, jcfg.llm, jax.tree.map(np.asarray, llm)
    if name == "ce":
        jcfg, jp = _qwen()
        n = 12
        labels = rng.integers(0, 128, size=n).astype(np.int32)
        labels[:4] = [1, 2, 126, 127]  # both ends of both slices
        return (dict(kind="ce", hidden=rng.standard_normal((n, 128), dtype=np.float32),
                     labels=labels, g=rng.random(n, dtype=np.float32)), jcfg,
                {"llm": {"embed_tokens": jp["llm"]["embed_tokens"]}})
    if name == "roundtrip":
        jcfg, jp = _qwen()
        return dict(kind="roundtrip"), jcfg, jp
    assert name == "checkpoint"
    jcfg, jp = _qwen()
    return dict(kind="checkpoint", policy=QLORA, lora_r=4,
                batch=_stage2_batches(1)[0]), jcfg, jp


CASES = TRAIN + ("forward_gemma", "forward_qwen", "ce", "generate_gemma", "generate_qwen",
                 "checkpoint", "roundtrip")


def _port_params(name):
    case, jcfg, jp = _case(name)
    if case["kind"] in ("forward", "generate"):
        return from_jax.decoder_params(jp)
    if case["kind"] == "ce":
        return {"llm": {"embed_tokens": {"embedding": torch.tensor(
            jp["llm"]["embed_tokens"]["embedding"])}}}
    return from_jax.vlm_params(jp)


def _port_case(name):
    case, jcfg, _ = _case(name)
    return {**case, "cfg": from_jax.config_from_jax(jcfg), "params": _port_params(name)}


def _cases_for(mesh):
    # with dropout on, the masks follow the data rank: only a 1-wide data axis draws the
    # one-process masks
    return [n for n in CASES if not (n == "qlora_dropout" and mesh != "1x2")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on every mesh: {mesh: (result dicts by rank, directory)}."""
    out = {}
    for mesh in MESHES:
        d = str(tmp_path_factory.mktemp(f"tp{mesh}"))
        torch.save({n: _port_case(n) for n in _cases_for(mesh)},
                   os.path.join(d, "payload.pt"))
        data, model = (int(v) for v in mesh.split("x"))
        torch_dp_worker.spawn_ranks(mesh, d, data * model, script=WORKER)
        out[mesh] = ([torch.load(os.path.join(d, f"result{r}.pt"), weights_only=False)
                      for r in range(data * model)], d)
    return out


@functools.cache
def _one_process(name):
    case = _port_case(name)
    kind = case["kind"]
    if kind in ("stage1", "stage2"):
        return torch_tp_worker.run_case(case, case["params"], case["batches"])
    if kind == "forward":
        return torch_tp_worker.forward_case(case, case["params"])
    if kind == "ce":
        return torch_tp_worker.ce_case(case, case["params"]["llm"]["embed_tokens"]["embedding"])
    if kind == "generate":
        return torch_tp_worker.generate_case(case, case["params"])
    raise ValueError(kind)


def _initial(name):
    return dict(unique_leaves_with_paths(_port_params(name)))


def _trained_close(name, ours: dict, theirs: dict, tol, *, relative: bool):
    """Each trained leaf's update within ``tol`` (x the reference leaf's largest magnitude
    when ``relative``); a noise leaf's update at most 3x the reference's."""
    x0 = _initial(name)
    assert ours.keys() <= theirs.keys() and ours
    for p, x in ours.items():
        mine = (x.float() - x0[p].float()).numpy()
        ref = (theirs[p].float() - x0[p].float()).numpy()
        if p.endswith(NOISE):
            assert np.abs(mine).max() <= 3 * np.abs(ref).max() + 1e-12, p
            continue
        assert np.abs(ref).max() > 0, p  # the leaf trained
        scale = np.abs(theirs[p].float().numpy()).max() if relative else 1.0
        err = np.abs(mine - ref).max()
        assert err <= tol * scale, f"{name} {p}: err {err} vs {scale}"


def _cases(kind_names):
    return [pytest.param(m, n, id=f"{m}-{n}") for m in MESHES for n in kind_names
            if n in _cases_for(m)]


# ------------------------------------------------------------------ against one process


@pytest.mark.parametrize("mesh,name", _cases(TRAIN))
def test_train_matches_one_process_and_replicas_stay_equal(ranks, mesh, name):
    got, _ = ranks[mesh]
    ref = _one_process(name)
    for r in got:
        np.testing.assert_allclose(r[name]["losses"], ref["losses"], rtol=1e-6)
        np.testing.assert_allclose(r[name]["grad_norms"], ref["grad_norms"], rtol=1e-6)
        _trained_close(name, r[name]["params"], ref["params"], 1e-6, relative=False)
    for r in got[1:]:  # every replicated leaf bit-equal on every rank, after every step
        rep = r[name]["replicated"]
        assert rep.keys() == got[0][name]["replicated"].keys() and rep
        for p, x in rep.items():
            assert torch.equal(x, got[0][name]["replicated"][p]), p
        steps = r[name]["replicated_bytes_by_step"]
        assert len(steps) == len(_case(name)[0]["batches"])
        assert steps == got[0][name]["replicated_bytes_by_step"]


@pytest.mark.parametrize("mesh,name", _cases(("forward_gemma", "forward_qwen")))
def test_decoder_forward_backward_matches_one_process(ranks, mesh, name):
    got, _ = ranks[mesh]
    ref = _one_process(name)
    for r in got:
        for k in ("hidden", "d_embeds", "d_q"):  # within 1e-6 of the largest magnitude
            want = ref[k].numpy()
            np.testing.assert_allclose(r[name][k].numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
def test_vocab_parallel_ce_matches_one_process(ranks, mesh):
    got, _ = ranks[mesh]
    ref = _one_process("ce")
    case = _port_case("ce")
    v_local = 128 // 2
    assert any(int(l) < v_local for l in case["labels"])
    assert any(int(l) >= v_local for l in case["labels"])  # out of rank 0's slice
    for r in got:
        for impl in ("fused", "chunked"):
            for k in ("nll", "dh", "dw"):
                if impl == "fused" and k == "dw":
                    assert not r["ce"][impl][k].any()  # zero by contract
                    continue
                want = ref[impl][k].numpy()
                np.testing.assert_allclose(r["ce"][impl][k].numpy(), want, rtol=0,
                                           atol=1e-6 * np.abs(want).max(),
                                           err_msg=f"{impl} {k}")


@pytest.mark.parametrize("mesh,name", _cases(("generate_gemma", "generate_qwen")))
def test_generation_tokens_match_one_process(ranks, mesh, name):
    got, _ = ranks[mesh]
    ref = _one_process(name)
    for r in got:
        for k in ("beams1", "beams3"):
            assert torch.equal(r[name][k], ref[k]), k


@pytest.mark.parametrize("mesh", MESHES)
def test_checkpoint_saved_under_tp_loads_in_one_process(ranks, mesh):
    got, d = ranks[mesh]
    ckpt = CheckpointManager(os.path.join(d, "ckpt"))
    case = _port_case("checkpoint")
    params = case["params"]
    state = {"params": params, "step": 0, "opt_state": {
        "count": 0, "mini_step": 0,
        "mu": {p: torch.zeros_like(x) for p, x in got[0]["checkpoint"]["mu"].items()},
        "nu": {p: torch.zeros_like(x) for p, x in got[0]["checkpoint"]["mu"].items()}}}
    ckpt.restore("epoch_0", state)
    assert state["step"] == 1 and state["opt_state"]["count"] == 1
    for p, x in got[0]["checkpoint"]["mu"].items():
        assert torch.equal(state["opt_state"]["mu"][p], x), p
    saved = torch.load(os.path.join(d, "ckpt", "epoch_0.pt"), weights_only=True)["params"]
    full = dict(unique_leaves_with_paths(params))
    assert saved.keys() == got[0]["checkpoint"]["mu"].keys()
    for p, x in saved.items():
        assert x.shape == full[p].shape, p  # whole leaves, not a rank's shard


@pytest.mark.parametrize("mesh", MESHES)
def test_gather_of_the_shards_is_the_full_tree(ranks, mesh):
    full = dict(unique_leaves_with_paths(_port_params("roundtrip")))
    for r in ranks[mesh][0]:
        got = r["roundtrip"]
        assert got.keys() == full.keys()
        for p, x in full.items():
            assert torch.equal(got[p], x), p


def test_model_axis_collectives_are_counted(ranks):
    got, _ = ranks["1x2"]
    counts = got[0]["_counts"]
    assert counts["forward"] > 0 and counts["backward"] > 0 and counts["grads"] > 0
    assert counts["recompute"] > 0  # the full-joint case's full remat repeats them


# ------------------------------------------------------------------ against JAX


def _jax_mesh(mesh):
    data, model = (int(v) for v in mesh.split("x"))
    return JMESH.build_mesh(JMESH.MeshConfig(data=data, model=model))


def _jax_train(name, mesh):
    case, jcfg, jp = _case(name)
    accum = case.get("accum", 1)
    total = -(-len(case["batches"]) // accum)
    if case["kind"] == "stage1":
        labels = JM.stage1_labels(jp)
        tx, _ = JO.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.1,
                                          weight_decay=0.01, clip_norm=5.0)
        loss = JS.stage1_loss(jcfg, PAD, remat=False, logits_chunk=5, ce_impl="chunked")
    else:
        labels = JM.stage2_labels(jp, JM.Stage2Freeze(**case["policy"]))
        tx, _ = JO.single_group_optimizer(labels, 3e-3, total_steps=total, warmup_ratio=0.1,
                                          weight_decay=0.01, clip_norm=1.0,
                                          clip_per_module=True, accum_steps=accum)
        lcfg = JL.LoraConfig(r=4, alpha=8, dropout=0.0) if "lora_r" in case else None
        loss = JS.stage2_loss(jcfg, PAD, lora_cfg=lcfg, remat=case.get("remat", False),
                              logits_chunk=5, ce_impl="chunked",
                              table_frozen=lcfg is not None)
    step = JS.make_train_step(loss, tx, trainable_mask=JM.bool_mask(labels), donate=False)
    jmesh = _jax_mesh(mesh)
    params = JSHARD.shard_params(jax.tree.map(jnp.asarray, jp), jmesh)
    state = JS.init_state(params, tx)
    losses = []
    for i, b in enumerate(case["batches"]):
        batch = jax.device_put(jax.tree.map(jnp.asarray, b), NamedSharding(jmesh, P("data")))
        state, value, _ = step(state, batch, jax.random.key(i))
        losses.append(float(value))
    trained = dict(unique_leaves_with_paths(from_jax.vlm_params(
        jax.tree.map(np.asarray, state["params"]))))
    return losses, trained


@pytest.mark.parametrize("mesh,name", _cases(("stage1", "full_joint", "qlora")))
def test_train_matches_the_jax_data_model_mesh(ranks, mesh, name):
    jlosses, jparams = _jax_train(name, mesh)
    got = ranks[mesh][0][0][name]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    _trained_close(name, got["params"], jparams, 1e-4, relative=True)


@pytest.mark.parametrize("mesh,name", _cases(("forward_gemma", "forward_qwen")))
def test_decoder_forward_matches_jax(ranks, mesh, name):
    case, jcfg, jllm = _case(name)
    jmesh = _jax_mesh(mesh)
    params = JSHARD.shard_params(jax.tree.map(jnp.asarray, jllm), jmesh)
    hidden, _ = jax.jit(lambda p, e, m: JDEC.forward(p, jcfg, inputs_embeds=e,
                                                     attention_mask=m, remat="dots"))(
        params, jnp.asarray(case["embeds"]), jnp.asarray(case["mask"]))
    got = ranks[mesh][0][0][name]["hidden"].numpy()
    np.testing.assert_allclose(got, np.asarray(hidden), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(hidden)).max())


@pytest.mark.parametrize("mesh,name", _cases(("generate_gemma", "generate_qwen")))
def test_generation_tokens_match_jax(ranks, mesh, name):
    case, jcfg, jllm = _case(name)
    for beams in (1, 3):
        cfg = JGEN.GenerationConfig(max_new_tokens=6, num_beams=beams, eos_token_id=1,
                                    pad_token_id=PAD)
        ids = JGEN.generate(jax.tree.map(jnp.asarray, jllm), jcfg,
                            jnp.asarray(case["embeds"]), jnp.asarray(case["mask"]), cfg,
                            jax.random.key(0))
        got = ranks[mesh][0][0][name][f"beams{beams}"].numpy()
        np.testing.assert_array_equal(got, np.asarray(ids))


@pytest.mark.parametrize("mesh", MESHES)
def test_vocab_parallel_ce_matches_jax(ranks, mesh):
    case, _, tree = _case("ce")
    table = jnp.asarray(tree["llm"]["embed_tokens"]["embedding"])
    h = jnp.asarray(case["hidden"])
    labels, g = jnp.asarray(case["labels"]), jnp.asarray(case["g"])

    def nll(h, w):
        logits = (h @ w.T) * 0.5
        picked = jnp.take_along_axis(logits, labels[:, None].astype(jnp.int32), 1)[:, 0]
        return jax.nn.logsumexp(logits, axis=-1) - picked

    ref, vjp = jax.vjp(nll, h, table)
    dh, dw = vjp(g)
    got = ranks[mesh][0][0]["ce"]
    for impl in ("fused", "chunked"):
        np.testing.assert_allclose(got[impl]["nll"].numpy(), np.asarray(ref), rtol=1e-4)
        np.testing.assert_allclose(got[impl]["dh"].numpy(), np.asarray(dh), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(got["chunked"]["dw"].numpy(), np.asarray(dw), rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------------------------ the CLI over the launcher


@pytest.fixture(scope="module")
def qwen_snapshots(tmp_path_factory):
    """Tiny local snapshots: a SigLIP tower and a Qwen3 decoder whose widths shard over
    2 model ranks (NF4 blocks of 64 whole), with a corpus of 8 samples."""
    from transformers import Qwen3Config, SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.qwen3.modeling_qwen3 import Qwen3ForCausalLM
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("torch_tp_snapshots")
    torch.manual_seed(0)
    vis_dir, llm_dir = str(base / "siglip-tiny"), str(base / "qwen3-tiny")
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4, vocab_size=64,
                                     max_position_embeddings=16).to_dict(),
    )).save_pretrained(vis_dir)
    tok = T.word_tokenizer()
    Qwen3ForCausalLM(Qwen3Config(
        vocab_size=len(tok.get_vocab()), hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=32,
        max_position_embeddings=256)).save_pretrained(llm_dir)
    tok.save_pretrained(llm_dir)
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=8, image_size=32)
    return vis_dir, llm_dir, root, manifest


def _qlora_argv(snapshots, out):
    vis, llm, root, manifest = snapshots
    return ["--image_root", root, "--train_json", manifest, "--val_json", manifest,
            "--output_dir", out, "--vision_model_name", vis, "--llm_name", llm,
            "--img_size", "32", "--batch_size", "2", "--gradient_accumulation_steps", "2",
            "--num_epochs", "1", "--learning_rate", "2e-3", "--max_q_len", "16",
            "--max_a_len", "16", "--enable_qlora", "--quant_method", "nf4-mirror",
            "--lora_r", "16", "--lora_alpha", "32", "--lora_dropout", "0.05",
            "--mixed_precision", "no", "--eval_max_new_tokens", "4", "--eval_num_beams", "3",
            "--eval_example_batches", "1", "--logging_steps", "1", "--num_workers", "1",
            "--disable_wandb", "--seed", "0", "--remat", "dots"]


def _launch(argv, timeout=110):
    """The launcher in a process group of its own (its ranks with it), killed whole at
    the timeout; returns (exit code, output)."""
    import signal
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-m", "projectiontrainer_tpu_torch.cli.launch",
                             *argv], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"the launch hung:\n{out[-4000:]}")
    return proc.returncode, out


def test_launch_trains_the_stage2_qlora_recipe_over_the_model_axis(qwen_snapshots, tmp_path):
    """``launch --simulate 2 stage2 -- ... --mesh_model 2`` (the recipe of
    ``launchers/run_stage2_h100.sh``, LoRA dropout on, ``--remat dots``; fp32) against
    the same CLI in one process: the same losses (within the bf16 base's rounding), one
    adapter written whole in PEFT format, the same adapter (A within 1e-5; B, which starts
    at zero, at cosine >= 0.999), and validation examples generated on the sharded
    model."""
    import json

    from safetensors.torch import load_file

    from projectiontrainer_tpu_torch.cli import train_stage2

    one = str(tmp_path / "one")
    train_stage2.main(_qlora_argv(qwen_snapshots, one) + ["--device", "cpu"])
    tp = str(tmp_path / "tp")
    rc, logs = _launch(["--simulate", "2", "--timeout", "60", "--feeder_procs", "0",
                        "stage2", "--", *_qlora_argv(qwen_snapshots, tp), "--mesh_data", "1",
                        "--mesh_model", "2"])
    assert rc == 0, logs[-4000:]

    def losses(out):
        with open(os.path.join(out, "metrics.jsonl")) as f:
            return [r["train/step_loss"] for r in map(json.loads, f) if "train/step_loss" in r]

    assert len(losses(tp)) == 4
    # the snapshot's frozen base is bf16: a row-parallel partial product rounds to bf16
    # before its sum over the model axis, where one process rounds the whole product once
    np.testing.assert_allclose(losses(tp), losses(one), rtol=2e-3)
    adapter = "checkpoint-epoch_0/language_model/adapter_model.safetensors"
    ours, ref = load_file(os.path.join(tp, adapter)), load_file(os.path.join(one, adapter))
    assert ours.keys() == ref.keys()
    for k, x in ref.items():
        assert ours[k].shape == x.shape, k  # whole, not a rank's shard
    # B starts at zero and Adam's first updates are about lr x sign(gradient): compare
    # the trained B's (the updates themselves) by their cosine, the A's by their gap
    def flat(d, part):
        return torch.cat([d[k].flatten().double() for k in sorted(d) if part in k])

    cos = torch.nn.functional.cosine_similarity(flat(ours, "lora_B"), flat(ref, "lora_B"),
                                                dim=0)
    assert float(cos) >= 0.999
    gap = (flat(ours, "lora_A") - flat(ref, "lora_A")).abs().max()
    assert float(gap) <= 1e-5 * float(flat(ref, "lora_A").abs().max())
    with open(os.path.join(tp, "validation_examples", "epoch_0_examples.txt")) as f:
        assert f.read().count("GENERATED:") == 2
