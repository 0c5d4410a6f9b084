"""Dtype policy: bf16 compute over fp32 masters.

Counterpart of ``projectiontrainer_tpu/core/dtypes.py:cast_compute_params``.
"""

from __future__ import annotations

import torch

from projectiontrainer_tpu_torch.core.pytree import map_with_path

# quantized-linear scale tensors stay fp32 (as in the JAX package)
_KEEP_F32_KEYS = frozenset({"scales", "block_scales"})


def cast_compute_params(tree, compute_dtype):
    """Cast the floating leaves of a params tree to ``compute_dtype``, leaving
    quantized scale tensors and integer storage as they are. The cast is
    differentiable: gradients flow back through it into the fp32 master leaves. A
    leaf already of ``compute_dtype`` is returned as is (no copy).

    Ties survive: a tensor held under two paths (the tied LM head) is cast once and
    the copy is held under both, so its two uses add their gradients into the one
    master and the tree stays tied (``core/pytree.py``)."""
    done = {}

    def cast(path, x):
        if path.rsplit("/", 1)[-1] in _KEEP_F32_KEYS:
            return x
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            if id(x) not in done:
                done[id(x)] = (x, x.to(compute_dtype))  # x kept: its id stays unique
            return done[id(x)][1]
        return x

    return map_with_path(cast, tree)


def compute_dtype(mixed_precision: str):
    """``--mixed_precision {bf16,fp16,no}`` -> the compute dtype, or None to compute
    in the params' own types. fp16 maps to bf16, as in the JAX package."""
    return torch.bfloat16 if mixed_precision in ("bf16", "fp16") else None
