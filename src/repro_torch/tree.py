"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Parameters, gradients and optimizer moments are plain nested dicts with
string keys; these helpers walk them in sorted key order, the order in which
``jax.tree_util`` flattens a dict, so a leaf's key path names the same
leaf in both packages.
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """fn applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def leaves_with_path(tree, prefix=()):
    """[(key path tuple, leaf)] in sorted key order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves_with_path(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def tree_leaves(tree):
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_from_leaves(items):
    """The nested dict of [(key path tuple, leaf)]."""
    tree = {}
    for path, leaf in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree
