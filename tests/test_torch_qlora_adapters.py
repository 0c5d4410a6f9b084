"""LoRA adapters across the port, the JAX package and PEFT, on the CPU.

An adapter trained by the port's ``train_stage2 --enable_qlora`` (tiny Qwen3 and
SigLIP snapshots, ``testing.synthetic_corpus``) is merged by the port's
``infer_vqa_stage2 --adapter_path`` and by the JAX package's: the same greedy and
3-beam answers. Adapters written by the JAX package (PEFT and its legacy flat format)
load into the port, and the port's into the JAX package's ``load_adapter``, tensor for
tensor. ``peft.PeftModel.from_pretrained`` reads the port's adapter over the HF
snapshot to the port's merged logits within 1e-4 (fp32). ``VQAService`` with
``--adapter_path`` answers as the batch path over the merged model does.
"""

import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.checkpoint import export as jexport
from projectiontrainer_tpu.cli import infer_vqa_stage2 as jvqa
from projectiontrainer_tpu.models import decoder as JDEC
from projectiontrainer_tpu.models import projector as JPROJ
from projectiontrainer_tpu.train import lora as JL
from projectiontrainer_tpu_torch.checkpoint import export, from_jax, hf_import
from projectiontrainer_tpu_torch.cli import infer_vqa_stage2 as vqa
from projectiontrainer_tpu_torch.cli import serve, train_stage2
from projectiontrainer_tpu_torch.models import decoder as dec
from projectiontrainer_tpu_torch.train import lora, setup

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Snapshots and one epoch of the port's QLoRA training (lr 2e-4: the answers stay
    words; a stronger adapter makes the greedy answer end at once)."""
    from transformers import Qwen3Config, SiglipConfig, SiglipTextConfig, SiglipVisionConfig
    from transformers.models.qwen3.modeling_qwen3 import Qwen3ForCausalLM
    from transformers.models.siglip.modeling_siglip import SiglipModel

    base = tmp_path_factory.mktemp("torch_qlora_adapters")
    torch.manual_seed(0)
    vis, llm = str(base / "siglip-tiny"), str(base / "qwen3-tiny")
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4, vocab_size=64,
                                     max_position_embeddings=16).to_dict(),
    )).save_pretrained(vis)
    tok = T.word_tokenizer()
    Qwen3ForCausalLM(Qwen3Config(
        vocab_size=len(tok.get_vocab()), hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=256)).save_pretrained(llm)
    tok.save_pretrained(llm)
    root, manifest = T.synthetic_corpus(str(base / "corpus"), n=7, image_size=32)
    out = str(base / "run")
    train_stage2.main([
        "--image_root", root, "--train_json", manifest, "--output_dir", out,
        "--vision_model_name", vis, "--llm_name", llm, "--img_size", "32", "--batch_size", "2",
        "--gradient_accumulation_steps", "1", "--num_epochs", "1", "--learning_rate", "2e-4",
        "--warmup_ratio", "0", "--max_q_len", "16", "--max_a_len", "16", "--enable_qlora",
        "--unfreeze_projection_layer", "--num_workers", "2", "--disable_wandb",
        "--device", "cpu", "--seed", "0"])
    ckpt = os.path.join(out, "checkpoint-epoch_0")
    return dict(vis=vis, llm=llm, root=root, manifest=manifest, tok=tok,
                adapter=os.path.join(ckpt, "language_model"),
                projector=os.path.join(ckpt, "projection_layer"), base=base)


def _infer_argv(t, out, nb, adapter=True):
    return ["--input_json", t["manifest"], "--image_root", t["root"], "--output_json", out,
            "--vision_model_name", t["vis"], "--llm_name", t["llm"],
            "--projector_path", t["projector"], "--img_size", "32", "--batch_size", "4",
            "--max_q_len", "16", "--max_new_tokens", "10", "--num_beams", str(nb),
            *(["--adapter_path", t["adapter"]] if adapter else [])]


@pytest.mark.parametrize("nb", [1, 3])
def test_infer_with_the_port_adapter_matches_jax(trained, nb, tmp_path):
    """The port's CLI answers every sample with the adapter merged, and not as without
    it. Token identity with the JAX package is held in fp32, through each package's
    ``answer_batch`` over the snapshot merged as each ``main`` merges it: the CLIs
    store the towers in bf16, where the port runs its tower in bf16 and the JAX
    package promotes it to fp32 (a deliberate divergence since PR 1)."""
    import jax.numpy as jnp

    from projectiontrainer_tpu.generate import GenerationConfig as JGenerationConfig
    from projectiontrainer_tpu.train import setup as jsetup

    ours = vqa.main(_infer_argv(trained, str(tmp_path / "ours.json"), nb) + ["--device", "cpu"])
    answers = [r["generated_answer"] for r in ours]
    assert len(answers) == 7 and sum(bool(a.strip()) for a in answers) >= 5
    plain = vqa.main(_infer_argv(trained, str(tmp_path / "plain.json"), nb, adapter=False)
                     + ["--device", "cpu"])
    assert answers != [r["generated_answer"] for r in plain]  # the adapter matters

    args = vqa.build_parser().parse_args(_infer_argv(trained, "unused", nb))
    tok, log = trained["tok"], logging.getLogger("infer-test")
    with open(trained["manifest"]) as f:
        samples = json.load(f)
    kw = dict(image_root=trained["root"], image_root_2=None, img_size=32, max_q_len=16)
    cfg, params = setup.build_vlm(trained["vis"], trained["llm"], device=torch.device("cpu"),
                                  stage1_projector_path=trained["projector"],
                                  frozen_dtype=torch.float32)
    vqa.merge_adapter(args, params, log)
    ours = vqa.answer_batch(samples, cfg, params, tok, gen_cfg=vqa.generation_config(args, tok),
                            **kw)
    jcfg, jparams, _ = jsetup.build_vlm(trained["vis"], trained["llm"],
                                        stage1_projector_path=trained["projector"],
                                        frozen_dtype=jnp.float32)
    adapters, lcfg = jexport.load_adapter(trained["adapter"])
    jparams["llm"] = JL.merge_into_decoder(jparams["llm"], adapters, lcfg)
    jgen = JGenerationConfig(max_new_tokens=10, num_beams=nb, repetition_penalty=1.8,
                             length_penalty=1.2, temperature=0.3, top_p=0.9, top_k=50,
                             eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id or 0)
    theirs = jvqa.answer_batch(samples, jcfg, jparams, tok, gen_cfg=jgen, **kw)
    assert ours == theirs and sum(bool(a.strip()) for a in ours) >= 5


def _jax_adapters(seed=0):
    jcfg = JDEC.qwen3_config(vocab_size=32, hidden_size=64, intermediate_size=128,
                             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
    lcfg = JL.LoraConfig(r=4, alpha=8, dropout=0.05)
    tree = jax.tree.map(np.asarray, JL.init(jax.random.key(seed), jcfg, lcfg))
    rng = np.random.default_rng(seed)
    for layer in tree["layers"]:
        for p in layer.values():
            p["b"] = rng.standard_normal(p["b"].shape, dtype=np.float32)
    return tree, lcfg


@pytest.mark.parametrize("fmt", ["peft", "legacy_flat"])
def test_a_jax_adapter_loads_into_the_port(fmt, tmp_path):
    tree, lcfg = _jax_adapters()
    out = str(tmp_path / "ad")
    if fmt == "peft":
        jexport.save_peft_adapter(tree, lcfg, out)
    else:  # the JAX package's stage-2 checkpoint without a LoRA config: flat pytree keys
        pcfg = JPROJ.ProjectorConfig(vision_dim=8, llm_dim=8, expansion_factor=2)
        ckpt = jexport.save_stage2_checkpoint(
            str(tmp_path), 0, projector_params=JPROJ.init(jax.random.key(0), pcfg),
            projector_cfg=pcfg, lora_params=tree)
        out = os.path.join(ckpt, "language_model")
        assert not os.path.exists(os.path.join(out, "adapter_config.json"))
    ours, cfg = export.load_adapter(out)
    want = from_jax.lora_params(tree)
    for i, layer in enumerate(want["layers"]):
        assert set(ours["layers"][i]) == set(layer)
        for t, p in layer.items():
            for k in ("a", "b"):
                assert torch.equal(ours["layers"][i][t][k], p[k]), (i, t, k)
    if fmt == "peft":
        assert (cfg.r, cfg.alpha, cfg.dropout) == (4, 8, 0.05)
        assert cfg.targets == tuple(sorted(lora.TARGETS))
    else:
        assert cfg is None


def test_the_port_adapter_loads_into_jax(trained):
    ours, cfg = export.load_adapter(trained["adapter"])
    theirs, jcfg = jexport.load_adapter(trained["adapter"])
    assert (jcfg.r, jcfg.alpha, jcfg.dropout) == (cfg.r, cfg.alpha, cfg.dropout) == (16, 32, 0.05)
    back = from_jax.lora_params_to_jax(ours)
    assert len(theirs["layers"]) == len(back["layers"]) == 2
    for i, layer in enumerate(back["layers"]):
        for t, p in layer.items():
            for k in ("a", "b"):
                np.testing.assert_array_equal(np.asarray(theirs["layers"][i][t][k]),
                                              p[k].numpy())


def test_peft_reads_the_port_adapter_to_the_merged_logits(trained):
    from peft import PeftModel
    from transformers import AutoModelForCausalLM

    hf = AutoModelForCausalLM.from_pretrained(trained["llm"], torch_dtype=torch.float32).eval()
    peft_model = PeftModel.from_pretrained(hf, trained["adapter"]).eval()
    cfg, params = hf_import.load_decoder(trained["llm"], dtype=torch.float32)
    adapters, lcfg = export.load_adapter(trained["adapter"])
    merged = lora.merge_into_decoder(params, adapters, lcfg)
    ids = torch.tensor(np.random.default_rng(0).integers(3, 20, size=(2, 9)))
    with torch.no_grad():
        theirs = peft_model(input_ids=ids).logits.numpy()
        h, _ = dec.forward(merged, cfg, input_ids=ids)
        ours = dec.logits(merged, cfg, h).numpy()
        unmerged, _ = dec.forward(params, cfg, input_ids=ids, lora=adapters, lora_cfg=lcfg)
        base = dec.logits(params, cfg, dec.forward(params, cfg, input_ids=ids)[0]).numpy()
    scale = np.abs(theirs).max()
    assert np.abs(ours - theirs).max() <= 1e-4 * scale
    assert np.abs(dec.logits(params, cfg, unmerged).numpy() - theirs).max() <= 1e-4 * scale
    assert np.abs(base - theirs).max() > 1e-3 * scale  # the adapter is not a no-op


def test_service_with_the_adapter_answers_as_the_merged_batch_path(trained):
    tok = trained["tok"]
    vlm_cfg, params = setup.build_vlm(trained["vis"], trained["llm"], device=torch.device("cpu"),
                                      stage1_projector_path=trained["projector"])
    args = serve.build_parser().parse_args([
        "--vision_model_name", "in-memory", "--llm_name", "in-memory", "--projector_path", "",
        "--img_size", "32", "--batch_size", "4", "--max_q_len", "16", "--max_new_tokens", "6",
        "--num_beams", "3", "--max_wait_ms", "50", "--device", "cpu",
        "--adapter_path", trained["adapter"]])
    service = serve.VQAService(args, logging.getLogger("serve-test"),
                               model=(vlm_cfg, params, tok))
    try:
        assert params["llm"] is not service.params["llm"]  # the caller's tree is untouched
        merged = dict(params)
        vqa.merge_adapter(args, merged, logging.getLogger("serve-test"))
        gen_cfg = vqa.generation_config(args, tok)
        rng = np.random.default_rng(1)
        for _ in range(3):
            pixels = rng.uniform(-1, 1, size=(32, 32, 3)).astype(np.float32)
            q = tok("What disease is shown ?", add_special_tokens=False)["input_ids"]
            got = service.submit(serve.Request(pixels, q), timeout_s=300)
            want = vqa.generate_answers(pixels[None], [q], vlm_cfg, merged, tok, max_q_len=16,
                                        gen_cfg=gen_cfg)[0]
            assert got == want
    finally:
        service.shutdown()
