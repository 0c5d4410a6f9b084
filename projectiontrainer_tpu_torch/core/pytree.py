"""Parameter trees: nested dicts and lists of tensors, addressed by '/'-joined paths.

Counterpart of ``projectiontrainer_tpu/core/pytree.py:path_str`` for the port's trees
(``projector/fc1/weight``, ``llm/layers/3/attn/q_proj/weight``): the freezing masks,
the optimizer state and the checkpoints key their leaves by these paths.

A tree may hold one tensor under two paths: a decoder with a tied head carries
``llm/lm_head/weight`` as the very tensor of ``llm/embed_tokens/embedding`` (the JAX
tree has no ``lm_head`` then). ``unique_leaves_with_paths`` yields such a tensor once,
under its first path (the embedding's, which is also its JAX path), so it gets one
gradient, one optimizer state and one share of every norm.
"""

from __future__ import annotations

from typing import Callable, Iterator


def leaves_with_paths(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(path, leaf) pairs in insertion order; dicts and lists are nodes."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, child in items:
        yield from leaves_with_paths(child, f"{prefix}/{key}" if prefix else str(key))


def map_with_path(fn: Callable[[str, object], object], tree, prefix: str = ""):
    """A tree of the same structure with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def unique_leaves_with_paths(tree) -> Iterator[tuple[str, object]]:
    """``leaves_with_paths`` with each object once, under the first path holding it."""
    seen = set()
    for path, leaf in leaves_with_paths(tree):
        if id(leaf) not in seen:
            seen.add(id(leaf))
            yield path, leaf

