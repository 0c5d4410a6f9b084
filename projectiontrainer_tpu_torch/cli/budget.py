"""Memory and collective budget of the full-joint ``--fsdp`` stage-2 step on H100s,
without the cards: ``projectiontrainer-torch-budget``.

Counterpart of the JAX package's ``projectiontrainer-budget``, with its flags but
``--logits_chunk``: the chunk is the trainer's (128 rows where the vocabulary holds
32768 tokens or more), as every other option of the program traced. Traces
the port's own train step (``parallel/budget.py``) for rank 0 of ``--n_devices`` ranks
laid out as a data x ``--model_axis`` mesh, on tensors that hold no data, and prints one
JSON object: the per-device peak and its split (params, grads, optimizer, activations,
temporaries), whether it fits an H100's usable memory, the sharded state's bytes and
the collectives of a micro-step by kind and phase. ``--preset gemma3-4b`` is BASELINE
config #4 (Gemma3-4B + ViT-L/384 full joint, fp32 masters and moments); ``small-test``
the same recipe at small widths, in seconds. ``--device cpu`` traces the CPU program
instead of the card's. Runs on any host: no card is needed or used.
"""

from __future__ import annotations

import argparse
import json


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n_devices", type=int, default=8)
    p.add_argument("--model_axis", type=int, default=1,
                   help="tensor-parallel ranks; the data axis is n_devices / model_axis")
    p.add_argument("--batch_per_device", type=int, default=2)
    p.add_argument("--q_len", type=int, default=256)
    p.add_argument("--a_len", type=int, default=1024)
    p.add_argument("--accum_steps", type=int, default=16)
    p.add_argument("--master_dtype", choices=["fp32", "bf16"], default="fp32")
    p.add_argument("--remat", type=str, default="full")
    p.add_argument("--preset", choices=["gemma3-4b", "small-test"], default="gemma3-4b",
                   help="small-test traces a small-width model through the same program")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the card's program (kernels, 512-byte allocations) or the CPU's")
    p.add_argument("--limit_bytes", type=int, default=None,
                   help="the memory a device offers (default: an H100's usable bytes)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from projectiontrainer_tpu_torch.parallel import budget as B

    out = B.full_joint_budget(
        B.small_test_config() if args.preset == "small-test" else None,
        n_devices=args.n_devices, model_axis=args.model_axis,
        batch_per_device=args.batch_per_device, q_len=args.q_len, a_len=args.a_len,
        accum_steps=args.accum_steps, master_dtype=args.master_dtype, remat=args.remat,
        limit_bytes=args.limit_bytes, device=args.device, model=args.preset)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
