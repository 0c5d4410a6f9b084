"""Generation evaluation: the fixed diagnostic prompt, substring accuracy per label.

Counterpart of ``projectiontrainer_tpu/cli/infer_generation.py``, with the same flags
plus ``--device``: every sample gets the prompt "Identify the diseases ... single word
or phrase"; a generation is right when the ground-truth label occurs in it
(case-insensitive substring); the summary gives the accuracy per label and, with
``--candidate_labels``, how often each candidate label occurs in the generations.
Batches go through ``infer_vqa_stage2.answer_batch`` (``generate_results``).
``--adapter_path`` merges a LoRA
adapter as ``infer_vqa_stage2`` does.

    python -m projectiontrainer_tpu_torch.cli.infer_generation --input_json data.json \\
        --image_root images --vision_model_name SIGLIP_DIR --llm_name LLM_DIR \\
        --projector_path s2out/checkpoint-epoch_0/projection_layer
"""

from __future__ import annotations

import collections
import json
import sys

import torch

from projectiontrainer_tpu_torch.cli.infer_vqa_stage2 import (
    answer_batch, build_parser as _vqa_parser, check_adapter, generation_config, merge_adapter,
)
from projectiontrainer_tpu_torch.data import datasets
from projectiontrainer_tpu_torch.eval import metrics as M
from projectiontrainer_tpu_torch.train import setup
from projectiontrainer_tpu_torch.utils.logging import setup_logging

DIAGNOSTIC_PROMPT = (
    "Identify the diseases shown in the chest X-ray image. "
    "Answer with a single word or phrase."
)


def build_parser():
    p = _vqa_parser()
    p.description = __doc__
    p.add_argument("--prompt", type=str, default=DIAGNOSTIC_PROMPT)
    p.add_argument("--max_length", type=int, default=None,
                   help="Alias for --max_new_tokens (reference flag name)")
    p.add_argument("--candidate_labels", type=str, default=None,
                   help="Comma-separated labels for the prediction-distribution summary")
    p.add_argument("--verbose", action="store_true")
    return p


def generate_results(samples, args, vlm_cfg, params, tokenizer, gen_cfg, logger) -> list:
    """Every sample asked ``args.prompt`` in batches of ``args.batch_size`` -> the
    samples with their ``generated_answer``. A short last batch runs as it is (eager
    PyTorch has no compiled shape to keep)."""
    results = []
    for i in range(0, len(samples), args.batch_size):
        chunk = samples[i:i + args.batch_size]
        answers = answer_batch(
            [dict(s, problem=args.prompt) for s in chunk], vlm_cfg, params, tokenizer,
            image_root=args.image_root, image_root_2=args.image_root_2,
            img_size=args.img_size, max_q_len=args.max_q_len, gen_cfg=gen_cfg,
        )
        for s, a in zip(chunk, answers):
            results.append({**s, "generated_answer": a})
            if args.verbose:
                logger.info("[%d] gt=%r gen=%r", len(results), s.get("normal_caption", ""), a)
    return results


def display_summary(results, logger, candidate_labels=()):
    """Log the overall and per-label substring accuracy (labels in order of their
    ground-truth frequency), the candidate labels' counts in the generations, and the
    commonest answers -> the overall accuracy."""
    per_label = M.per_label_substring_accuracy(
        [r["generated_answer"] for r in results],
        [r.get("normal_caption", "") for r in results],
    )
    total_hits = sum(h for h, _ in per_label.values())
    total = sum(n for _, n in per_label.values())
    logger.info("overall substring accuracy: %.4f (%d/%d)",
                total_hits / max(1, total), total_hits, total)
    for label, (hits, n) in sorted(per_label.items(), key=lambda kv: -kv[1][1]):
        logger.info("  %-30s %3d/%3d  (%.3f)  [%.2f%% of GT]",
                    label, hits, n, hits / max(1, n), 100.0 * n / max(1, total))
    if candidate_labels:
        pred_counts = collections.Counter()
        for r in results:
            gen = r["generated_answer"].lower()
            for label in candidate_labels:
                if label.lower() in gen:
                    pred_counts[label] += 1
        logger.info("prediction distribution (candidate label found in generation):")
        for label, n in pred_counts.most_common():
            logger.info("  %-30s %3d (%.2f%%)", label, n, 100.0 * n / max(1, total))
    gen_counter = collections.Counter(r["generated_answer"].strip() for r in results)
    logger.info("top generated answers: %s", gen_counter.most_common(10))
    return total_hits / max(1, total)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.max_length is not None:
        if any(str(a).startswith("--max_new_tokens") for a in (argv or sys.argv[1:])):
            parser.error("--max_length is an alias for --max_new_tokens; pass one, "
                         "not both")
        args.max_new_tokens = args.max_length
    candidate_labels = [
        c.strip() for c in (args.candidate_labels or "").split(",") if c.strip()
    ]
    check_adapter(args)
    logger = setup_logging()
    vlm_cfg, params = setup.build_vlm(args.vision_model_name, args.llm_name,
                                      device=torch.device(args.device),
                                      stage1_projector_path=args.projector_path)
    tokenizer = setup.load_tokenizer(args.llm_name)
    merge_adapter(args, params, logger)
    gen_cfg = generation_config(args, tokenizer)

    results = generate_results(datasets.load_manifest(args.input_json), args, vlm_cfg, params,
                               tokenizer, gen_cfg, logger)
    acc = display_summary(results, logger, candidate_labels)
    with open(args.output_json, "w") as f:
        json.dump({"accuracy": acc, "results": results}, f, indent=2)
    return acc


if __name__ == "__main__":
    main()
