"""``remat='dots'`` of the port (``core/remat.py``): the JAX policy
``dots_with_no_batch_dims_saveable`` as a selective checkpoint that saves the outputs of
``aten.mm`` / ``aten.addmm`` and recomputes the rest.

- The decoder (Gemma3 with its sliding window; Qwen3 with LoRA adapters and their
  dropout over an nf4-mirror base), the vision tower and the stage-2 loss under
  'dots' equal ``remat=True`` within 1e-6 (loss, outputs and every gradient), and the
  JAX package's 'dots' within 1e-4 (fp32, shared weights through
  ``checkpoint/from_jax.py``).
- What the backward computes is counted with a dispatch mode: under 'dots' it runs
  exactly the products of the backward without remat (no forward product recomputed;
  the saved ones are returned by the checkpoint's cache), under True those plus every
  product of the forward.
- ``train_stage2 --remat dots`` trains (the CLI on tiny snapshots).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu.models import projector as JPROJ
from projectiontrainer_tpu.models import siglip as JSIG
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu.ops import quant as JQ
from projectiontrainer_tpu.train import lora as JL
from projectiontrainer_tpu.train import steps as JS
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.cli import train_stage2
from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
from projectiontrainer_tpu_torch.models import decoder, siglip
from projectiontrainer_tpu_torch.train import lora, steps

torch.set_num_threads(2)
PAD = 0
aten = torch.ops.aten


@functools.cache
def _gemma():
    jcfg = T.tiny_vlm_cfg(llm_layers=3)
    jp = jax.tree.map(np.asarray, jax.jit(JVLM.init, static_argnums=1)(jax.random.key(0), jcfg))
    return jcfg, jp


@functools.cache
def _qwen():
    llm = JDEC.qwen3_config(vocab_size=128, hidden_size=64, intermediate_size=128,
                            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
    vis = T.tiny_vision_cfg()
    jcfg = JVLM.VLMConfig(vision=vis, llm=llm, projector=JPROJ.ProjectorConfig(
        vision_dim=vis.hidden_size, llm_dim=64, expansion_factor=2))
    jp = JVLM.init(jax.random.key(0), jcfg)
    jp["llm"] = JQ.quantize_decoder(jp["llm"], method="nf4-mirror")
    jp["lora"] = JL.init(jax.random.key(1), jcfg.llm, JL.LoraConfig(r=4, alpha=8))
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(2)
    for layer in jp["lora"]["layers"]:
        for p in layer.values():
            p["b"] = rng.standard_normal(p["b"].shape, dtype=np.float32) * 0.05
    return jcfg, jp


def _inputs(d, b=2, t=24, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, t), np.int32)
    mask[1, :5] = 0
    return (rng.standard_normal((b, t, d), dtype=np.float32), mask,
            rng.standard_normal((b, t, d), dtype=np.float32))


class _Count(TorchDispatchMode):
    """Counts the products dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (aten.mm.default, aten.addmm.default):
            self.n["mm"] += 1
        elif func is aten.bmm.default:
            self.n["bmm"] += 1
        return func(*args, **(kwargs or {}))


def _decoder_run(name, remat, count_backward=False):
    """(hidden, {grad name: grad}, products counted in the backward) of the decoder
    on fixed embeddings; Qwen3 with its LoRA adapters and their dropout."""
    jcfg, jp = _gemma() if name == "gemma" else _qwen()
    params = from_jax.vlm_params(jp)
    cfg = from_jax.config_from_jax(jcfg)
    embeds, mask, probe = _inputs(cfg.llm.hidden_size)
    x = torch.tensor(embeds, requires_grad=True)
    leaves = {"embeds": x}
    kw = {}
    if name == "qwen":
        kw = dict(lora=params["lora"], lora_cfg=lora.LoraConfig(r=4, alpha=8, dropout=0.1),
                  lora_seed=3)
        for p, a in unique_leaves_with_paths(params["lora"]):
            leaves["lora/" + p] = a.requires_grad_(True)
    else:
        for p, w in unique_leaves_with_paths(params["llm"]):
            if w.is_floating_point() and not p.startswith("embed_tokens"):  # read by ids
                leaves["llm/" + p] = w.requires_grad_(True)
    hidden, _ = decoder.forward(params["llm"], cfg.llm, inputs_embeds=x,
                                attention_mask=torch.tensor(mask), remat=remat, **kw)
    loss = (hidden * torch.tensor(probe)).sum()
    counter = _Count()
    if count_backward:
        with counter:
            grads = torch.autograd.grad(loss, list(leaves.values()))
    else:
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return hidden.detach(), dict(zip(leaves, grads)), counter.n


def _close(a, b, tol):
    a, b = a.detach().float().numpy(), b.detach().float().numpy()
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", ["gemma", "qwen"])
def test_decoder_dots_equals_full_remat(name):
    h_dots, g_dots, _ = _decoder_run(name, "dots")
    h_full, g_full, _ = _decoder_run(name, True)
    _close(h_dots, h_full, 1e-6)
    assert g_dots.keys() == g_full.keys()
    for k in g_dots:
        _close(g_dots[k], g_full[k], 1e-6)


def test_decoder_dots_matches_jax_dots():
    jcfg, jp = _gemma()
    embeds, mask, probe = _inputs(jcfg.llm.hidden_size)
    h_ours, g_ours, _ = _decoder_run("gemma", "dots")

    def f(x):
        h, _ = JDEC.forward(jax.tree.map(jnp.asarray, jp["llm"]), jcfg.llm, inputs_embeds=x,
                            attention_mask=jnp.asarray(mask), remat="dots")
        return (h * probe).sum(), h

    (_, h_jax), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(embeds))
    _close(h_ours, torch.tensor(np.asarray(h_jax)), 1e-4)
    _close(g_ours["embeds"], torch.tensor(np.asarray(g)), 1e-4)


@pytest.mark.parametrize("name", ["gemma", "qwen"])
def test_dots_recomputes_no_product_and_full_remat_recomputes_them_all(name):
    _, _, none = _decoder_run(name, False, count_backward=True)
    _, _, dots = _decoder_run(name, "dots", count_backward=True)
    _, _, full = _decoder_run(name, True, count_backward=True)
    # the forward's products, counted on their own (recorded by autograd, as the
    # recompute runs them)
    counter = _Count()
    with counter:
        _decoder_run_forward(name)
    fwd = counter.n
    assert fwd["mm"] > 0 and fwd["bmm"] > 0
    layers = len(from_jax.vlm_params((_gemma() if name == "gemma" else _qwen())[1])
                 ["llm"]["layers"])
    assert dots["mm"] == none["mm"]                     # no product recomputed
    # every product recomputed, but for the one a layer whose output no backward reads
    # (a layer's last LoRA product): the checkpoint stops its recompute early
    assert none["mm"] + fwd["mm"] - layers <= full["mm"] <= none["mm"] + fwd["mm"]
    assert dots["bmm"] == none["bmm"] + fwd["bmm"]       # batched products recomputed


def _decoder_run_forward(name):
    jcfg, jp = _gemma() if name == "gemma" else _qwen()
    params = from_jax.vlm_params(jp)
    cfg = from_jax.config_from_jax(jcfg)
    embeds, mask, _ = _inputs(cfg.llm.hidden_size)
    kw = {}
    if name == "qwen":
        kw = dict(lora=params["lora"], lora_cfg=lora.LoraConfig(r=4, alpha=8, dropout=0.1),
                  lora_seed=3)
    decoder.forward(params["llm"], cfg.llm, inputs_embeds=torch.tensor(embeds),
                    attention_mask=torch.tensor(mask), **kw)


def _tower_run(remat):
    jcfg, jp = _gemma()
    params = from_jax.vlm_params(jp)
    cfg = from_jax.config_from_jax(jcfg)
    px = torch.tensor(np.random.default_rng(1).standard_normal((2, 32, 32, 3),
                                                               dtype=np.float32))
    leaves = dict(unique_leaves_with_paths(params["vision"]))
    for w in leaves.values():
        w.requires_grad_(True)
    hidden, _ = siglip.vision_forward(params["vision"], cfg.vision, px, remat=remat)
    grads = torch.autograd.grad(hidden.square().sum(), list(leaves.values()))
    return hidden.detach(), dict(zip(leaves, grads)), px


def test_tower_dots_equals_full_remat_and_jax():
    h_dots, g_dots, px = _tower_run("dots")
    h_full, g_full, _ = _tower_run(True)
    _close(h_dots, h_full, 1e-6)
    for k in g_dots:
        _close(g_dots[k], g_full[k], 1e-6)
    jcfg, jp = _gemma()
    h_jax, _ = JSIG.vision_forward(jax.tree.map(jnp.asarray, jp["vision"]), jcfg.vision,
                                   jnp.asarray(px.numpy()), remat="dots")
    _close(h_dots, torch.tensor(np.asarray(h_jax)), 1e-4)


def _stage2_batch():
    rng = np.random.default_rng(4)
    ids = lambda t, n: np.stack([np.r_[rng.integers(2, 128, size=k), np.zeros(t - k)]  # noqa
                                 for k in n]).astype(np.int32)
    return {"pixel_values": rng.standard_normal((2, 32, 32, 3), dtype=np.float32),
            "question_ids": ids(5, [3, 5]), "answer_ids": ids(8, [8, 4])}


def _stage2_loss_grads(remat):
    jcfg, jp = _qwen()
    params = from_jax.vlm_params(jp)
    cfg = from_jax.config_from_jax(jcfg)
    lcfg = lora.LoraConfig(r=4, alpha=8, dropout=0.0)
    loss_fn = steps.stage2_loss(cfg, PAD, lora_cfg=lcfg, remat=remat, logits_chunk=5,
                                ce_impl="chunked", table_frozen=True)
    leaves = dict(unique_leaves_with_paths({"lora": params["lora"],
                                            "projector": params["projector"]}))
    for w in leaves.values():
        w.requires_grad_(True)
    loss, _ = loss_fn(params, {k: torch.tensor(v) for k, v in _stage2_batch().items()}, 0)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def test_stage2_loss_dots_equals_full_remat_and_jax():
    loss_dots, g_dots = _stage2_loss_grads("dots")
    loss_full, g_full = _stage2_loss_grads(True)
    _close(loss_dots, loss_full, 1e-6)
    for k in g_dots:
        _close(g_dots[k], g_full[k], 1e-6)
    jcfg, jp = _qwen()
    jloss = JS.stage2_loss(jcfg, PAD, lora_cfg=JL.LoraConfig(r=4, alpha=8, dropout=0.0),
                           remat="dots", logits_chunk=5, ce_impl="chunked", table_frozen=True)
    value, _ = jloss(jax.tree.map(jnp.asarray, jp),
                     jax.tree.map(jnp.asarray, _stage2_batch()), jax.random.key(0))
    np.testing.assert_allclose(float(loss_dots), float(value), rtol=1e-4)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    from transformers import Gemma3TextConfig, SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.gemma3.modeling_gemma3 import Gemma3ForCausalLM
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("torch_remat_snapshots")
    torch.manual_seed(0)
    vis_dir, llm_dir = str(base / "siglip-tiny"), str(base / "gemma3-tiny")
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4, vocab_size=64,
                                     max_position_embeddings=16).to_dict(),
    )).save_pretrained(vis_dir)
    tok = T.word_tokenizer()
    Gemma3ForCausalLM(Gemma3TextConfig(
        vocab_size=len(tok.get_vocab()), hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1, head_dim=16,
        sliding_window=64, query_pre_attn_scalar=16, max_position_embeddings=256,
    )).save_pretrained(llm_dir)
    tok.save_pretrained(llm_dir)
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=4, image_size=32)
    return vis_dir, llm_dir, root, manifest


def test_cli_train_stage2_remat_dots_runs(snapshots, tmp_path):
    """Full-joint, the tower trained in epoch 0: 'dots' repeats the losses of 'full'."""
    vis, llm, root, manifest = snapshots
    losses = {}
    for mode in ("dots", "full"):
        out = str(tmp_path / mode)
        train_stage2.main([
            "--image_root", root, "--train_json", manifest, "--output_dir", out,
            "--vision_model_name", vis, "--llm_name", llm, "--img_size", "32",
            "--batch_size", "2", "--gradient_accumulation_steps", "1", "--num_epochs", "1",
            "--max_q_len", "16", "--max_a_len", "16", "--unfreeze_llm",
            "--unfreeze_projection_layer", "--train_ve_first_epoch", "--mixed_precision", "no",
            "--logging_steps", "1", "--num_workers", "1", "--disable_wandb", "--device", "cpu",
            "--remat", mode])
        with open(os.path.join(out, "metrics.jsonl")) as f:
            losses[mode] = [r["train/step_loss"] for r in map(json.loads, f)
                            if "train/step_loss" in r]
    assert len(losses["dots"]) == 2 and np.isfinite(losses["dots"]).all()
    np.testing.assert_allclose(losses["dots"], losses["full"], rtol=1e-6)
