"""Parameter trees carried between the JAX package and the port.

Port-only module.  The JAX package keeps parameters as nested dicts of
arrays; the port keeps the same keys and the same ``[in, out]`` kernel
layout (``deepspeed_tpu/models/layers.py:42``), with torch tensors as
leaves, so weights move in either direction with no transposes.  A
``PipelineModule``'s tree is ``{"layers": (layer dict, ...), "tied":
{key: ...}}`` (JAX ``runtime/pipe/module.py:157``): a tuple is a node
too, its items in index order, and a path names an item by its index,
as ``jax.tree_util`` does.
"""

import numpy as np
import torch


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a param tree of dicts and tuples
    (lists stay lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """``(paths, leaves)`` of a tree of dicts and tuples, dict keys
    sorted at every level and tuple items in index order: the order of
    ``jax.tree_util.tree_leaves``, which fixes where each tensor sits in
    the flat parameter buffer.  An empty dict or tuple has no leaves."""
    if isinstance(tree, dict):
        items = [(key, tree[key]) for key in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return [()], [tree]
    paths, leaves = [], []
    for key, sub in items:
        sub_paths, sub_leaves = tree_leaves(sub)
        paths += [(key,) + sp for sp in sub_paths]
        leaves += sub_leaves
    return paths, leaves


def tree_from_leaves(paths, leaves):
    """Inverse of :func:`tree_leaves`, in dicts (a tuple's items come
    back keyed by their index)."""
    tree = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _to_tensor(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: reinterpret the 16-bit words
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.uint16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_numpy(tree, device, dtype=None):
    """Same-keyed dict of torch tensors on ``device`` from a param tree
    whose leaves are numpy arrays (or anything ``np.asarray`` takes, or
    tensors).  ``dtype`` casts the floating-point leaves only; integer
    leaves pass through, as ``cast_weights`` does."""
    def convert(leaf):
        t = _to_tensor(leaf)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(convert, tree)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: numpy leaves on the host.
    Bit-exact for every dtype numpy has; bfloat16 leaves widen to
    float32, which holds every bfloat16 value exactly."""
    def convert(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(convert, tree)
