"""Nested containers of tensors: the port's stand-in for JAX pytrees.

Carried block state, tapped outputs and messages are tuples, NamedTuples
(``planar.PC``, ``XEngineState``), lists and dicts whose leaves are
tensors or plain Python values; ``tree_map`` rebuilds the same structure
around new leaves.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the matching leaves of
    ``rest`` (same structure)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def structure(tree: Any) -> Any:
    """``tree`` with every leaf replaced by None: equal for two trees of
    the same containers."""
    return tree_map(lambda _: None, tree)
