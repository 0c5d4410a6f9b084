"""Layer rematerialisation: recompute a layer's activations in the backward.

Counterpart of the JAX package's ``jax.checkpoint`` around each decoder and tower layer
(``models/decoder.py:439-446``, ``models/siglip.py:228-233`` there). ``remat`` is

- ``True``: recompute everything (``torch.utils.checkpoint``, non-reentrant): the
  backward runs each layer's forward again, its tensor-parallel all-reduces and its
  ``--fsdp`` gathers included, as the JAX package's remat repeats the psum;
- ``'dots'``: the JAX policy ``dots_with_no_batch_dims_saveable``: the outputs of the
  products without batch dimensions are saved and everything else is recomputed.
  In torch these are ``aten.mm`` and ``aten.addmm``, which ``F.linear``, the
  dequantized base's product and the LoRA thin products reach; ``aten.bmm`` and the
  flash kernels' autograd Functions are recomputed, as on the TPU. Under tensor
  parallelism the output of each row-parallel product's all-reduce
  (``parallel/tensor_parallel.py``) is saved too, and under ``--fsdp`` each gathered
  weight (``parallel/fsdp.py``), so the recompute launches no collective;
- ``False``: keep every activation.

The numbers are the same under every policy; only what is stored differs.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from projectiontrainer_tpu_torch.parallel import fsdp, tensor_parallel

aten = torch.ops.aten
DOTS_SAVED = frozenset({aten.mm.default, aten.addmm.default, tensor_parallel.ALL_REDUCE_OP,
                        fsdp.ALL_GATHER_OP})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def check(remat) -> None:
    """Raise for a value that names no policy (an int N is the first N layers)."""
    if not isinstance(remat, (bool, int)) and remat != "dots":
        raise ValueError(f"remat must be True, False, 'dots' or an int, got {remat!r}")


def layer_remat(remat, i: int):
    """Layer ``i``'s policy under ``remat``: True, 'dots' or False (an int N: True for
    the first N layers)."""
    # True == 1 in Python: test for bool before the int (partial remat) branch
    if isinstance(remat, bool) or remat == "dots":
        return remat
    return i < int(remat)


def run(fn, policy, *args):
    """``fn(*args)`` under ``policy`` (True, 'dots' or False), when autograd records."""
    if not policy or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)
