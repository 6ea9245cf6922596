"""Parameter and optimizer trees: nested dicts of tensors.

The port keeps parameters, gradients and optimizer moments as plain
nested dicts whose leaves are tensors; a ``GaussianVariational`` (the
BNN's probabilistic block) is a node with the two leaves ``mu`` and
``rho``.  These helpers walk such trees in one fixed order (dict keys
sorted, as ``jax.tree_util`` orders them) and name every leaf by its
path joined with ``/`` (``blocks/attn/wq``), the names a checkpoint
stores.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import torch

from repro_torch.core.bayesian import GaussianVariational


def items(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs of ``tree`` in sorted-key order."""
    if isinstance(tree, GaussianVariational):
        tree = {"mu": tree.mu, "rho": tree.rho}
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{prefix}{k}/")
        return
    yield prefix[:-1], tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in items(tree)]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), as a new tree of that
    structure."""
    if isinstance(tree, GaussianVariational):
        return GaussianVariational(
            mu=fn(tree.mu, *(r.mu for r in rest)),
            rho=fn(tree.rho, *(r.rho for r in rest)))
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def zeros_like(tree: Any, dtype: torch.dtype | None = None) -> Any:
    return map_tree(lambda t: torch.zeros_like(t, dtype=dtype), tree)


def unflatten(tree: Any, values: list) -> Any:
    """A tree of ``tree``'s structure whose leaves are ``values`` in
    ``items`` order."""
    it = iter(values)

    def build(node):
        if isinstance(node, GaussianVariational):
            mu = next(it)
            return GaussianVariational(mu=mu, rho=next(it))
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out
