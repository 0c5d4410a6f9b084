"""The port's VQA service on the CPU with a tiny in-memory model: concurrent submit()s
are answered, and each answer equals the batch CLI's ``generate_answers`` on the same
inputs; the HTTP front end reports the torch device and takes base64 images."""

import base64
import concurrent.futures
import io
import json
import logging
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.cli import infer_vqa_stage2 as vqa
from projectiontrainer_tpu_torch.cli import serve

torch.set_num_threads(2)
ARGS = ["--vision_model_name", "in-memory", "--llm_name", "in-memory", "--projector_path", "",
        "--img_size", "32", "--batch_size", "4", "--max_q_len", "16", "--max_new_tokens", "6",
        "--num_beams", "3", "--repetition_penalty", "1.8", "--length_penalty", "1.2",
        "--max_wait_ms", "100", "--device", "cpu"]


@pytest.fixture(scope="module")
def model():
    tok = T.word_tokenizer()
    jcfg = T.tiny_vlm_cfg(llm_vocab=len(tok.get_vocab()))
    jparams = jax.tree.map(np.asarray, JVLM.init(jax.random.key(0), jcfg))
    return from_jax.config_from_jax(jcfg), from_jax.vlm_params(jparams), tok


@pytest.fixture(scope="module")
def service(model):
    args = serve.build_parser().parse_args(ARGS)
    svc = serve.VQAService(args, logging.getLogger("serve-test"), model=model)
    yield svc
    svc.shutdown()
    assert not svc.prefix_worker.is_alive() and not svc.decode_worker.is_alive()


def _requests(n, tok, seed=0):
    rng = np.random.default_rng(seed)
    words = ["What", "disease", "is", "shown", "in", "this", "chest", "x-ray", "?"]
    out = []
    for _ in range(n):
        q = " ".join(rng.choice(words, size=int(rng.integers(3, 10))))
        pixels = rng.uniform(-1, 1, size=(32, 32, 3)).astype(np.float32)
        out.append((pixels, tok(q, add_special_tokens=False)["input_ids"]))
    return out


def test_concurrent_submits_match_generate_answers(service, model):
    cfg, params, tok = model
    reqs = _requests(7, tok)
    before = service.stats()["batches"]
    with concurrent.futures.ThreadPoolExecutor(7) as ex:
        answers = list(ex.map(lambda r: service.submit(serve.Request(*r), timeout_s=300),
                              reqs))
    gen_cfg = vqa.generation_config(service.args, tok)
    for (pixels, q_ids), answer in zip(reqs, answers):
        expected = vqa.generate_answers(pixels[None], [q_ids], cfg, params, tok,
                                        max_q_len=16, gen_cfg=gen_cfg)[0]
        assert answer == expected
    stats = service.stats()
    assert stats["requests"] >= 7 and stats["p50_latency_s"] > 0
    assert stats["batches"] - before < 7  # requests were batched together
    assert stats["mean_batch_size"] > 1


def test_http_health_and_base64_image(service):
    from PIL import Image

    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health == {"ok": True, "device": "cpu", "device_name": "cpu"}
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(1).integers(0, 255, (40, 40, 3), np.uint8)
                        ).save(buf, format="PNG")
        body = json.dumps({"image": base64.b64encode(buf.getvalue()).decode(),
                           "question": "Is Edema shown ?"}).encode()
        req = urllib.request.Request(url + "/v1/vqa", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            out = json.loads(resp.read())
        assert isinstance(out["answer"], str) and out["latency_ms"] > 0
        bad = urllib.request.Request(url + "/v1/vqa", data=b'{"question": "no image"}')
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)


def test_adapter_path_raises(model):
    """--adapter_path merges an adapter since the QLoRA port
    (tests/test_torch_qlora_adapters.py); one that names no directory raises before
    any model is built, in the service and in the batch CLI."""
    args = serve.build_parser().parse_args(ARGS + ["--adapter_path", "some/adapter"])
    with pytest.raises(FileNotFoundError, match="some/adapter"):
        serve.VQAService(args, logging.getLogger("serve-test"), model=model)
    with pytest.raises(FileNotFoundError, match="some/adapter"):
        vqa.main(["--vision_model_name", "x", "--llm_name", "y", "--projector_path", "",
                  "--adapter_path", "some/adapter"])


def test_batch_cli_from_hf_snapshots(tmp_path):
    """The batch CLI end to end on the CPU: HF snapshots in, a predictions JSON out."""
    from transformers import (
        Gemma3TextConfig, SiglipConfig, SiglipTextConfig, SiglipVisionConfig,
    )
    from transformers.models.gemma3.modeling_gemma3 import Gemma3ForCausalLM
    from transformers.models.siglip.modeling_siglip import SiglipModel

    torch.manual_seed(0)
    tok = T.word_tokenizer()
    SiglipModel(SiglipConfig(
        vision_config=SiglipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=32, patch_size=8).to_dict(),
        text_config=SiglipTextConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, vocab_size=len(tok.get_vocab()),
            max_position_embeddings=16).to_dict(),
    )).save_pretrained(tmp_path / "vis")
    Gemma3ForCausalLM(Gemma3TextConfig(
        vocab_size=len(tok.get_vocab()), hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1, head_dim=16,
        sliding_window=8, query_pre_attn_scalar=16, max_position_embeddings=256,
    )).save_pretrained(tmp_path / "llm")
    tok.save_pretrained(tmp_path / "llm")
    root, manifest = T.synthetic_corpus(str(tmp_path / "corpus"), n=5, image_size=32)
    out = tmp_path / "preds.json"
    results = vqa.main([
        "--input_json", manifest, "--image_root", root, "--output_json", str(out),
        "--vision_model_name", str(tmp_path / "vis"), "--llm_name", str(tmp_path / "llm"),
        "--projector_path", "", "--img_size", "32", "--batch_size", "2", "--max_q_len", "16",
        "--max_new_tokens", "5", "--num_beams", "3", "--device", "cpu",
    ])
    saved = json.loads(out.read_text())
    assert saved == results and len(saved) == 5
    assert all(isinstance(r["generated_answer"], str) for r in saved)
