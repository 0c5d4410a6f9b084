"""Carry weights across from the JAX package.

Takes a JAX parameter tree whose leaves are numpy arrays (for example
``jax.tree.map(np.asarray, vlm.init(key, cfg))``) and returns the port's tree:

- linear kernels ``[in, out]`` become torch weights ``[out, in]``;
- the patch conv's HWIO kernel ``[p, p, C, D]`` becomes the space-to-depth matrix
  ``[D, p*p*C]`` (rows ordered patch row, patch column, channel, as ``conv_patchify``
  flattens them);
- the tied embedding table becomes the LM head;
- quantized linears (``ops/quant.py``) keep their bytes, transposed to ``[out, ...]``:
  ``qvalues`` / ``qvalues_block`` ``[in, out]`` -> ``[out, in]``, ``packed_nf4``
  ``[in/2, out]`` -> ``[out, in/2]``, ``block_scales`` ``[in/64, out]`` -> ``[out,
  in/64]``; codes stay integer and scales fp32 whatever ``dtype`` asks;
- LoRA adapters (``params['lora']``) become ``a`` ``[r, in]`` and ``b`` ``[out, r]``
  (``lora_params``; ``lora_params_to_jax`` is the inverse);
- the SigLIP dual tower (``siglip_params``) keeps the MAP head, whose probe is a plain
  tensor, and the logit scale and bias as fp32 [1] tensors;
- the cls probe's classifier (``classifier_params``) keeps its tower's MAP head and its
  per-class queries as they are;
- a stage-1 or stage-2 train state (``steps.init_state`` plus the optax state of
  ``optim.single_group_optimizer``: ``MultiSteps(multi_transform(clip, adamw))``)
  becomes the port's: the params in their own types (fp32 masters stay fp32) and the
  ``MaskedAdamW`` state (Adam count and moments, ``MultiSteps`` mini-step and
  accumulator) of the groups that train, keyed by parameter path
  (``stage1_train_state``, ``stage2_train_state``);
- ``decoder_params_to_jax`` is the inverse of ``decoder_params``, for exports that the
  JAX package reads.

The trees are whole: under tensor parallelism ``parallel/sharding.shard_params`` then
slices one to a model rank's shards (``tests/test_torch_tp.py`` builds its ranks' params
this way).

Configs carry across by field name (``config_from_jax``). This module takes numpy
arrays (optax's named tuples survive ``jax.tree.map(np.asarray, ...)``) and imports
nothing of JAX or optax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
from projectiontrainer_tpu_torch.models import decoder as dec
from projectiontrainer_tpu_torch.models import projector as proj
from projectiontrainer_tpu_torch.models import siglip, vlm


def _t(x, device, dtype):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":  # ml_dtypes' type: torch reads it through fp32
        return torch.tensor(x.astype(np.float32)).to(device=device, dtype=dtype or torch.bfloat16)
    return torch.tensor(x).to(device=device, dtype=dtype)


_QUANT_KEYS = ("qvalues", "packed_nf4", "qvalues_block")


def _quantized(tree: dict, device, dtype) -> dict:
    """A JAX quantized linear -> the port's: 2-D leaves transposed, the same bytes;
    only a bias takes ``dtype``."""
    out = {}
    for k, v in tree.items():
        v = np.asarray(v)
        if k == "bias":
            out[k] = _t(v, device, dtype)
        else:
            out[k] = torch.tensor(np.ascontiguousarray(v.T if v.ndim == 2 else v)).to(device)
    return out


def _convert(tree, device, dtype):
    """Linear ``{'kernel' [in, out], 'bias'?}`` -> ``{'weight' [out, in], 'bias'?}``;
    a quantized linear as ``_quantized``; dicts and lists recursively; any other leaf
    as a tensor."""
    if isinstance(tree, dict):
        if any(k in tree for k in _QUANT_KEYS):
            return _quantized(tree, device, dtype)
        if "kernel" in tree and np.ndim(tree["kernel"]) == 2:
            out = {"weight": _t(np.asarray(tree["kernel"]).T, device, dtype)}
            if "bias" in tree:
                out["bias"] = _t(tree["bias"], device, dtype)
            return out
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    return _t(tree, device, dtype)


def vision_params(tree: dict, *, device=None, dtype=None, head: bool = False) -> dict:
    """JAX SigLIP vision params -> the port's. The MAP head is dropped unless ``head``
    (the VLM path does not run it)."""
    drop = ("patch_embedding",) if head else ("head", "patch_embedding")
    rest = {k: v for k, v in tree.items() if k not in drop}
    out = _convert(rest, device, dtype)
    kernel = np.asarray(tree["patch_embedding"]["kernel"])  # HWIO
    out["patch_embedding"] = {
        "weight": _t(kernel.reshape(-1, kernel.shape[-1]).T, device, dtype),
        "bias": _t(tree["patch_embedding"]["bias"], device, dtype),
    }
    return out


def siglip_params(tree: dict, *, device=None, vision_dtype=None, text_dtype=None) -> dict:
    """JAX SigLIP dual-tower params (``siglip.init``) -> the port's: the vision tower
    with its MAP head, the text tower, fp32 logit scale and bias."""
    return {
        "vision": vision_params(tree["vision"], device=device, dtype=vision_dtype, head=True),
        "text": _convert(tree["text"], device, text_dtype),
        "logit_scale": _t(tree["logit_scale"], device, torch.float32).reshape(1),
        "logit_bias": _t(tree["logit_bias"], device, torch.float32).reshape(1),
    }


def classifier_params(tree: dict, *, device=None, dtype=None) -> dict:
    """JAX classifier params (``models/classifier.init``) -> the port's: the tower with
    its MAP head when it has one, the [1, C, D] queries, the MHA's four linears and
    the ``Linear(d, 1)`` head."""
    rest = _convert({k: v for k, v in tree.items() if k != "vision"}, device, dtype)
    return {"vision": vision_params(tree["vision"], device=device, dtype=dtype, head=True),
            **rest}


def projector_params(tree: dict, *, device=None, dtype=None) -> dict:
    return _convert(tree, device, dtype)


def decoder_params(tree: dict, *, device=None, dtype=None) -> dict:
    out = _convert(tree, device, dtype)
    if "lm_head" not in out:  # tied head: the embedding table itself
        out["lm_head"] = {"weight": out["embed_tokens"]["embedding"]}
    return out


def decoder_params_to_jax(params: dict) -> dict:
    """The port's decoder params -> the JAX package's layout, as contiguous CPU tensors
    in their own types: linear weights ``[out, in]`` become kernels ``[in, out]``, and a
    tied head is left out (the JAX tree holds the table once, as
    ``embed_tokens/embedding``)."""
    tied = params["lm_head"]["weight"] is params["embed_tokens"]["embedding"]

    def conv(tree):
        if isinstance(tree, dict):
            if "weight" in tree and tree["weight"].dim() == 2:
                out = {"kernel": tree["weight"].detach().t()}
                if "bias" in tree:
                    out["bias"] = tree["bias"].detach()
                return {k: v.cpu().contiguous() for k, v in out.items()}
            return {k: conv(v) for k, v in tree.items() if not (tied and k == "lm_head")}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return tree.detach().cpu().contiguous()

    return conv(params)


def lora_params(tree: dict, *, device=None, dtype=None) -> dict:
    """JAX LoRA adapters ``{'layers': [{target: {'a' [in, r], 'b' [r, out]}}]}`` -> the
    port's ``a`` [r, in], ``b`` [out, r]."""
    return {"layers": [{t: {k: _t(np.asarray(x).T, device, dtype) for k, x in p.items()}
                        for t, p in layer.items()} for layer in tree["layers"]]}


def lora_params_to_jax(params: dict) -> dict:
    """The port's LoRA adapters -> the JAX package's layout, contiguous CPU tensors."""
    return {"layers": [{t: {k: x.detach().t().cpu().contiguous() for k, x in p.items()}
                        for t, p in layer.items()} for layer in params["layers"]]}


def vlm_params(tree: dict, *, device=None, tower_dtype=None, projector_dtype=None) -> dict:
    """A JAX VLM tree -> the port's; its ``lora`` subtree, when present, in the adapters'
    own type."""
    out = {
        "vision": vision_params(tree["vision"], device=device, dtype=tower_dtype),
        "projector": projector_params(tree["projector"], device=device,
                                      dtype=projector_dtype),
        "llm": decoder_params(tree["llm"], device=device, dtype=tower_dtype),
    }
    if "lora" in tree:
        out["lora"] = lora_params(tree["lora"], device=device)
    return out


def _same_fields(cls, cfg):
    names = {f.name for f in dataclasses.fields(cls)} - {"attn_impl", "norm_impl"}
    return cls(**{n: getattr(cfg, n) for n in names if hasattr(cfg, n)})


def config_from_jax(cfg):
    """A JAX ``VLMConfig`` or ``SiglipConfig`` (or one of their parts) -> the port's
    config of the same fields. Kernel choices are the port's own
    (``attn_impl``/``norm_impl`` default to 'kernel')."""
    if hasattr(cfg, "vision") and hasattr(cfg, "text"):
        return siglip.SiglipConfig(vision=_same_fields(siglip.VisionConfig, cfg.vision),
                                   text=_same_fields(siglip.TextConfig, cfg.text))
    if hasattr(cfg, "projection_size"):
        return _same_fields(siglip.TextConfig, cfg)
    if hasattr(cfg, "vision") and hasattr(cfg, "llm"):
        return vlm.VLMConfig(
            vision=_same_fields(siglip.VisionConfig, cfg.vision),
            projector=_same_fields(proj.ProjectorConfig, cfg.projector),
            llm=_same_fields(dec.DecoderConfig, cfg.llm),
            drop_first_patch=cfg.drop_first_patch,
        )
    if hasattr(cfg, "vocab_size"):
        return _same_fields(dec.DecoderConfig, cfg)
    if hasattr(cfg, "patch_size"):
        return _same_fields(siglip.VisionConfig, cfg)
    return _same_fields(proj.ProjectorConfig, cfg)


def _find(node, fields):
    """The first node (depth first) carrying every attribute in ``fields``."""
    if all(hasattr(node, f) for f in fields):
        return node
    children = node.values() if isinstance(node, dict) else (
        node if isinstance(node, (list, tuple)) else ())
    for child in children:
        found = _find(child, fields)
        if found is not None:
            return found
    return None


def _has_array(node) -> bool:
    """Whether an optax state subtree holds an array (optax's ``MaskedNode``, an empty
    tuple, stands where a leaf does not train)."""
    if isinstance(node, dict):
        return any(_has_array(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return any(_has_array(v) for v in node)
    return node is not None


_GROUPS = {"vision": vision_params, "projector": projector_params, "llm": decoder_params,
           "lora": lora_params}


def _per_leaf(tree, device) -> dict:
    """A per-leaf optax state tree over a VLM's params -> {port path: tensor} for the
    groups that hold arrays (each of vision, projector, llm, lora trains whole or not at all;
    the tower's MAP head, which the VLM path does not run, is left out)."""
    out = {}
    for group, sub in tree.items():
        if group in _GROUPS and _has_array(sub):
            port = _GROUPS[group](sub, device=device, dtype=None)
            out.update({f"{group}/{p}": x for p, x in unique_leaves_with_paths(port)})
    return out


def opt_state(state, *, device=None) -> dict:
    """The optax state of a JAX ``single_group_optimizer`` (numpy leaves) -> the port's
    ``MaskedAdamW`` state: the Adam count, mu and nu of the trainable leaves, and the
    ``MultiSteps`` mini-step and accumulator (the JAX accumulator also holds zeros for
    the frozen leaves; the port's holds the trainable ones)."""
    adam = _find(state, ("count", "mu", "nu"))
    multi = _find(state, ("mini_step", "acc_grads"))
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the given optax state")
    mu = _per_leaf(adam.mu, device)
    out = {"count": int(np.asarray(adam.count)),
           "mini_step": 0 if multi is None else int(np.asarray(multi.mini_step)),
           "mu": mu, "nu": _per_leaf(adam.nu, device)}
    if multi is not None:
        acc = _per_leaf(multi.acc_grads, device)
        out["acc"] = {p: acc[p] for p in mu}
    return out


def stage1_train_state(state: dict, *, device=None, tower_dtype=None) -> dict:
    """A JAX stage-1 train state ``{'params', 'opt_state', 'step'}`` (numpy leaves)
    -> the port's, with fp32 projector masters and towers in ``tower_dtype``."""
    return {"params": vlm_params(state["params"], device=device, tower_dtype=tower_dtype,
                                 projector_dtype=torch.float32),
            "opt_state": opt_state(state["opt_state"], device=device),
            "step": int(np.asarray(state["step"]))}


def stage2_train_state(state: dict, *, device=None) -> dict:
    """A JAX stage-2 train state (numpy leaves), also one saved in the middle of an
    accumulation or after ``--train_ve_first_epoch``'s swap -> the port's, every leaf
    in its own type (fp32 masters stay fp32; the tied table stays one tensor)."""
    return {"params": vlm_params(state["params"], device=device),
            "opt_state": opt_state(state["opt_state"], device=device),
            "step": int(np.asarray(state["step"]))}
