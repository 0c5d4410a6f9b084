"""Stage 1 inference: a caption (report) of one X-ray image from the visual embeddings
alone, with no text prompt.

Counterpart of ``projectiontrainer_tpu/cli/infer_stage1.py``, with the same flags plus
``--device``: the vision tower -> the stage-1 projector -> the decoder's ``generate``
from the visual prefix.

    python -m projectiontrainer_tpu_torch.cli.infer_stage1 --image_path cxr.jpg \\
        --vision_model_name SIGLIP_DIR --llm_name LLM_DIR --projection_path s1out
"""

from __future__ import annotations

import argparse
import os

import torch

from projectiontrainer_tpu_torch.generate import GenerationConfig, generate
from projectiontrainer_tpu_torch.models import vlm
from projectiontrainer_tpu_torch.train import setup
from projectiontrainer_tpu_torch.utils.logging import setup_logging


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image_path", type=str, required=True)
    p.add_argument("--vision_model_name", type=str, required=True)
    p.add_argument("--llm_name", type=str, required=True)
    p.add_argument("--projection_path", type=str, required=True,
                   help="Directory with projector weights + projector_config.json")
    p.add_argument("--img_size", type=int, default=384)
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--do_sample", action="store_true")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--repetition_penalty", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def caption_image(image, vlm_cfg, params, tokenizer, *, img_size, gen_cfg) -> str:
    """``image``: a file path, or an image already in memory (PIL, or a uint8 [H, W, 3]
    array) -> the decoded caption. The prefix is built and decoded on the parameters'
    device."""
    from projectiontrainer_tpu_torch.data import image as I  # PIL: image intake only

    source = I.load_image(image) if isinstance(image, (str, os.PathLike)) else image
    device = params["llm"]["embed_tokens"]["embedding"].device
    pixels = torch.as_tensor(I.preprocess(source, img_size)[None]).to(device)
    visual, mask = vlm.visual_prefix(params, vlm_cfg, pixels)
    ids = generate(params["llm"], vlm_cfg.llm, visual, mask, gen_cfg).cpu().numpy()
    pad = tokenizer.pad_token_id or 0
    return tokenizer.decode([t for t in ids[0] if t != pad], skip_special_tokens=True)


def main(argv=None):
    args = build_parser().parse_args(argv)
    logger = setup_logging()
    vlm_cfg, params = setup.build_vlm(args.vision_model_name, args.llm_name,
                                      device=torch.device(args.device),
                                      stage1_projector_path=args.projection_path)
    tokenizer = setup.load_tokenizer(args.llm_name)
    gen_cfg = GenerationConfig(
        max_new_tokens=args.max_new_tokens, num_beams=args.num_beams,
        do_sample=args.do_sample, temperature=args.temperature, top_p=args.top_p,
        top_k=args.top_k, repetition_penalty=args.repetition_penalty,
        eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id or 0,
    )
    text = caption_image(args.image_path, vlm_cfg, params, tokenizer, img_size=args.img_size,
                         gen_cfg=gen_cfg)
    logger.info("generated caption: %s", text)
    print(text)
    return text


if __name__ == "__main__":
    main()
