"""Stage 2 VQA inference: batch generation over a JSON of (image, problem) samples.

Counterpart of ``projectiontrainer_tpu/cli/infer_vqa_stage2.py``, with the same flags
plus ``--device``. Per batch: bucket and left-pad the questions, run the
[visual; question] prefix (tower -> projector -> embeds), beam decode, detokenize.
``--adapter_path`` merges a LoRA adapter (PEFT, or the legacy flat format with the
``--lora_r``/``--lora_alpha`` flags) into the dense base before the first batch.

``--approx_topk`` asks the JAX package for the TPU's approximate top-k in the sampled
beam search's candidate scan; here, as in XLA off the TPU, that top-k is exact.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from projectiontrainer_tpu_torch.checkpoint import export
from projectiontrainer_tpu_torch.data.bucketing import DEFAULT_Q_BUCKETS, bucket_for, buckets_covering
from projectiontrainer_tpu_torch.generate import GenerationConfig, generate
from projectiontrainer_tpu_torch.models import vlm
from projectiontrainer_tpu_torch.train import lora as lora_mod, setup
from projectiontrainer_tpu_torch.utils.logging import setup_logging


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_json", type=str, default=None,
                   help="Batch mode: JSON of {image, problem} samples")
    p.add_argument("--image_path", type=str, default=None, help="Single-image mode")
    p.add_argument("--question", type=str, default=None,
                   help="Question for single-image mode")
    p.add_argument("--output_json", type=str, default="vqa_predictions.json")
    p.add_argument("--image_root", type=str, default=None)
    p.add_argument("--image_root_2", type=str, default=None)
    p.add_argument("--vision_model_name", type=str, required=True)
    p.add_argument("--llm_name", "--base_llm_name", dest="llm_name", type=str,
                   required=True)
    p.add_argument("--adapter_path", type=str, default=None,
                   help="Directory containing adapter_model.safetensors (LoRA)")
    p.add_argument("--projector_path", type=str, required=True)
    p.add_argument("--img_size", type=int, default=384)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_q_len", type=int, default=256)
    p.add_argument("--max_new_tokens", type=int, default=1024)
    p.add_argument("--num_beams", type=int, default=3)
    p.add_argument("--do_sample", action="store_true")
    p.add_argument("--temperature", type=float, default=0.3)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--top_k", type=int, default=50)
    p.add_argument("--repetition_penalty", type=float, default=1.8)
    p.add_argument("--length_penalty", type=float, default=1.2)
    p.add_argument("--approx_topk", action="store_true",
                   help="Approximate top-k in the sampled beam search's candidate scan "
                   "(the TPU's approx_max_k; exact here, as XLA computes it off the TPU)")
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda")
    return p


def check_adapter(args) -> None:
    """Fail before any model is built when ``--adapter_path`` names no directory."""
    if args.adapter_path and not os.path.isdir(args.adapter_path):
        raise FileNotFoundError(f"--adapter_path {args.adapter_path!r} is not a directory")


def merge_adapter(args, params, logger) -> None:
    """``--adapter_path``: merge the adapter into ``params['llm']`` (in place of the
    tree's decoder; the JAX package's ``infer_vqa_stage2.py:139-147``). A legacy flat
    adapter carries no config: ``--lora_r``/``--lora_alpha`` give its scaling."""
    if not args.adapter_path:
        return
    device = params["llm"]["embed_tokens"]["embedding"].device
    lora, lcfg = export.load_adapter(args.adapter_path, device=device)
    if lcfg is None:
        lcfg = lora_mod.LoraConfig(r=args.lora_r, alpha=args.lora_alpha)
    params["llm"] = lora_mod.merge_into_decoder(params["llm"], lora, lcfg)
    logger.info("merged LoRA adapters from %s", args.adapter_path)


def generation_config(args, tokenizer) -> GenerationConfig:
    return GenerationConfig(
        max_new_tokens=args.max_new_tokens, num_beams=args.num_beams,
        do_sample=args.do_sample, temperature=args.temperature, top_p=args.top_p,
        top_k=args.top_k, repetition_penalty=args.repetition_penalty,
        length_penalty=args.length_penalty, eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id or 0, approx_top_k=args.approx_topk,
    )


def build_prefix(pixels, q_tok, vlm_cfg, params, tokenizer, *, max_q_len):
    """Stage A: bucket + LEFT-pad the questions, then build the [visual; question]
    prefix on the parameters' device. The work is enqueued on the current CUDA stream
    and not waited for.

    Questions pad to a BUCKET, not the batch maximum, so the prefix shapes (and the
    kernels' launch shapes) stay in a small set, as in the JAX package."""
    pad = tokenizer.pad_token_id or 0
    grid = buckets_covering(max_q_len, DEFAULT_Q_BUCKETS)
    q_len = min(bucket_for(max(len(q) for q in q_tok), grid), max_q_len)
    q_ids = np.full((len(q_tok), q_len), pad, np.int64)
    for i, q in enumerate(q_tok):  # left padding: the last slot is the last question token
        q = q[-q_len:]  # over-bucket truncation keeps the tokens nearest the answer
        q_ids[i, q_len - len(q):] = q
    device = params["llm"]["embed_tokens"]["embedding"].device
    pixels = torch.as_tensor(np.asarray(pixels)).to(device)
    return vlm.question_prefix(params, vlm_cfg, pixels, torch.as_tensor(q_ids).to(device),
                               pad_token_id=pad)


def decode_prefix(embeds, mask, vlm_cfg, params, tokenizer, *, gen_cfg):
    """Stage B: beam decode from a prebuilt prefix, then detokenization on the host
    (where the device is waited for)."""
    pad = tokenizer.pad_token_id or 0
    ids = generate(params["llm"], vlm_cfg.llm, embeds, mask, gen_cfg).cpu().numpy()
    return [tokenizer.decode([t for t in row if t != pad], skip_special_tokens=True)
            for row in ids]


def generate_answers(pixels, q_tok, vlm_cfg, params, tokenizer, *, max_q_len, gen_cfg):
    """Prefix build (stage A) and decode (stage B) back to back: the core shared by
    the batch CLI and the serving endpoint."""
    embeds, mask = build_prefix(pixels, q_tok, vlm_cfg, params, tokenizer,
                                max_q_len=max_q_len)
    return decode_prefix(embeds, mask, vlm_cfg, params, tokenizer, gen_cfg=gen_cfg)


def answer_batch(samples, vlm_cfg, params, tokenizer, *, image_root, image_root_2,
                 img_size, max_q_len, gen_cfg):
    """samples: list of {'image', 'problem'} -> generated answer strings."""
    from projectiontrainer_tpu_torch.data import image as I  # PIL: image intake only

    pixels = np.stack([
        I.preprocess(I.load_image(I.resolve_image_path(s["image"], image_root,
                                                       image_root_2)), img_size)
        for s in samples
    ])
    q_tok = [tokenizer(s["problem"], max_length=max_q_len, truncation=True,
                       add_special_tokens=False)["input_ids"] for s in samples]
    return generate_answers(pixels, q_tok, vlm_cfg, params, tokenizer,
                            max_q_len=max_q_len, gen_cfg=gen_cfg)


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_adapter(args)
    logger = setup_logging()
    vlm_cfg, params = setup.build_vlm(args.vision_model_name, args.llm_name,
                                      device=torch.device(args.device),
                                      stage1_projector_path=args.projector_path)
    tokenizer = setup.load_tokenizer(args.llm_name)
    merge_adapter(args, params, logger)
    gen_cfg = generation_config(args, tokenizer)

    if args.image_path:
        samples = [{"image": os.path.basename(args.image_path),
                    "problem": args.question or "Describe the findings."}]
        args.image_root = os.path.dirname(os.path.abspath(args.image_path))
    else:
        if not args.input_json:
            raise SystemExit("--input_json or --image_path required")
        with open(args.input_json, encoding="utf-8") as f:
            samples = json.load(f)
    results, latencies = [], []
    for i in range(0, len(samples), args.batch_size):
        chunk = samples[i:i + args.batch_size]
        n_real = len(chunk)
        if n_real < args.batch_size and len(samples) > args.batch_size:
            chunk = chunk + [chunk[-1]] * (args.batch_size - n_real)  # keep the batch shape
        t0 = time.perf_counter()
        answers = answer_batch(chunk, vlm_cfg, params, tokenizer, image_root=args.image_root,
                               image_root_2=args.image_root_2, img_size=args.img_size,
                               max_q_len=args.max_q_len, gen_cfg=gen_cfg)[:n_real]
        latencies.append((time.perf_counter() - t0) / n_real)
        results.extend({**s, "generated_answer": a} for s, a in zip(chunk[:n_real], answers))
        logger.info("processed %d/%d", min(i + args.batch_size, len(samples)), len(samples))

    with open(args.output_json, "w") as f:
        json.dump(results, f, indent=2)
    if latencies:
        logger.info("p50 per-sample latency: %.3fs", float(np.median(latencies)))
    return results


if __name__ == "__main__":
    main()
