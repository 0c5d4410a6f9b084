"""projectiontrainer_tpu_torch — the PyTorch/CUDA port of ``projectiontrainer_tpu``.

The JAX package beside this one is the reference every module here is held against.
Module names mirror it (``models/siglip.py`` <-> ``models/siglip.py``) so each
counterpart is easy to find; inside, the code is PyTorch: plain functions over
dictionaries of tensors, an explicit ``device``, explicit ``torch.Generator``s.

Every kernel the JAX package wrote in Pallas for the TPU is a kernel written by hand
for Hopper (``csrc/*.cu`` built by ``kernels/_build.py``, or Triton). Each kernel's
wrapper sends a CPU tensor to the kernel's plain PyTorch version in the same module
and a CUDA tensor to the kernel; there is no fallback between the two.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
