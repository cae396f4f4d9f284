"""Nested dicts of tensors (the port's pytrees): flattening in the
reference's order, with ``/``-joined key paths.

``jax.tree_util`` flattens a dict in sorted key order and a registered
node (the optimizer's ``QTensor``) into its children, keyed by their
index; ``flatten`` does the same, so key strings and leaf order match the
reference's checkpoints and its sums over leaves."""
from __future__ import annotations


def flatten(tree, is_leaf=lambda x: False):
    """[(path, leaf), ...] in sorted key order.  A node with
    ``tree_children()`` (a ``QTensor``) is expanded into children keyed
    "0", "1", ... unless ``is_leaf`` says it is a leaf."""
    out = []

    def walk(node, path):
        if not is_leaf(node) and isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (str(key),))
        elif not is_leaf(node) and hasattr(node, "tree_children"):
            for i, child in enumerate(node.tree_children()):
                walk(child, path + (str(i),))
        else:
            out.append(("/".join(path), node))

    walk(tree, ())
    return out


def leaves(tree, is_leaf=lambda x: False):
    return [leaf for _, leaf in flatten(tree, is_leaf)]


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), in a tree of ``tree``'s structure; dicts only."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
