"""Parameter trees carried between the JAX package and the port.

Port-only module.  The JAX package keeps parameters as nested dicts of
arrays; the port keeps the same keys and the same ``[in, out]`` kernel
layout (``deepspeed_tpu/models/layers.py:42``), with torch tensors as
leaves, so weights move in either direction with no transposes.  A
``PipelineModule``'s tree is ``{"layers": (layer dict, ...), "tied":
{key: ...}}`` (JAX ``runtime/pipe/module.py:157``): a tuple is a node
too, its items in index order, and a path names an item by its index,
as ``jax.tree_util`` does.

Tensor and expert parallelism keep each rank's slices of the leaves
(Megatron's layout): :func:`tp_slice` cuts a rank's tree from the whole
one and :func:`tp_gather` joins the ranks' trees back, by a spec per
leaf (a model's ``partition_specs()``): a tuple with one entry per dim,
``None`` (whole), ``MODEL`` or ``EXPERT`` (an even contiguous cut over
that axis) or ``QKV`` (the fused ``[.., 3·hidden]`` projection cut by
HEADS over ``model``: rank r of m takes columns ``[r·n/m, (r+1)·n/m)``
of each of the Q, K and V blocks of width n, so its ``[b, s, 3, h/m,
d]`` reshape holds its own heads of all three; a contiguous cut of the
3·hidden columns would give rank 0 all of Q and half of K).  A spec of
``None`` (or a leaf without one) is replicated.  The weight carry-over,
the engine's flat master and the checkpoint share these two functions.
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


MODEL = "model"
EXPERT = "expert"
QKV = "model:qkv"


def _axis_of(entry):
    return MODEL if entry == QKV else entry


def spec_axes(spec):
    """The mesh axes a leaf's spec cuts it over (a set)."""
    return {_axis_of(e) for e in (spec or ()) if e is not None}


def _qkv_index(n, rank, size):
    block = n // 3
    if n % 3 or block % size:
        raise ValueError(f"a fused QKV dim of {n} does not cut into 3 "
                         f"blocks of {size} equal head ranges")
    part = block // size
    return np.concatenate([np.arange(j * block + rank * part,
                                     j * block + (rank + 1) * part)
                           for j in range(3)])


def _cut(leaf, dim, entry, coords, sizes):
    size = sizes.get(_axis_of(entry), 1)
    if size == 1:
        return leaf
    rank = coords[_axis_of(entry)]
    n = leaf.shape[dim]
    if entry == QKV:
        idx = _qkv_index(n, rank, size)
        if isinstance(leaf, torch.Tensor):
            return leaf.index_select(dim, torch.from_numpy(idx).to(
                leaf.device))
        return np.take(leaf, idx, axis=dim)
    if n % size:
        raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not cut "
                         f"evenly over {size} members of {entry!r}")
    part = n // size
    sl = [slice(None)] * leaf.ndim
    sl[dim] = slice(rank * part, (rank + 1) * part)
    return leaf[tuple(sl)]


def _spec_tree_map(fn, tree, specs):
    if isinstance(tree, dict):
        specs = specs if isinstance(specs, dict) else {}
        return {k: _spec_tree_map(fn, v, specs.get(k)) for k, v in
                tree.items()}
    if isinstance(tree, (tuple, list)):
        specs = specs if isinstance(specs, (tuple, list)) and len(specs) \
            == len(tree) and not _is_spec(specs) else [None] * len(tree)
        return type(tree)(_spec_tree_map(fn, v, sp)
                          for v, sp in zip(tree, specs))
    return fn(tree, specs if _is_spec(specs) else None)


class _Spec:
    def __init__(self, spec):
        self.spec = spec


def leaf_specs(tree, specs):
    """The spec of every leaf of ``tree``, in :func:`tree_leaves` order
    (None for a replicated leaf)."""
    boxed = _spec_tree_map(lambda leaf, spec: _Spec(spec), tree, specs)
    return [b.spec for b in tree_leaves(boxed)[1]]


def _is_spec(x):
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def tp_slice(tree, specs, coords, sizes):
    """The leaves of a whole ``tree`` cut to the rank at ``coords``
    (``{"model": i, "expert": j}``) of a mesh with ``sizes`` (``{"model":
    m, "expert": e}``), by ``specs`` (numpy or tensor leaves; a slice of
    a numpy leaf is a copy only under QKV)."""
    return _spec_tree_map(
        lambda leaf, spec: tp_slice_leaf(leaf, spec, coords, sizes), tree,
        specs)


def _join(pieces, dim, entry):
    """The inverse of ``_cut`` over one axis: ``pieces`` in rank order."""
    size = len(pieces)
    if size == 1:
        return pieces[0]
    if isinstance(pieces[0], torch.Tensor):
        whole = torch.cat(pieces, dim=dim)
    else:
        whole = np.concatenate(pieces, axis=dim)
    if entry != QKV:
        return whole
    # the ranks' [q_r | k_r | v_r] pieces back into [Q | K | V]
    n = whole.shape[dim]
    order = np.concatenate([_qkv_index(n, r, size) for r in range(size)])
    inv = np.argsort(order)
    if isinstance(whole, torch.Tensor):
        return whole.index_select(dim, torch.from_numpy(inv).to(
            whole.device))
    return np.take(whole, inv, axis=dim)


def tp_slice_leaf(leaf, spec, coords, sizes):
    """One leaf cut to the rank at ``coords`` by its ``spec``."""
    if not spec:
        return leaf
    if len(spec) != np.ndim(leaf):
        raise ValueError(f"spec {spec} for a leaf of shape "
                         f"{tuple(np.shape(leaf))}")
    for dim, entry in enumerate(spec):
        if entry is not None:
            leaf = _cut(leaf, dim, entry, coords, sizes)
    return leaf


def tp_gather_leaf(pieces, spec, sizes):
    """One leaf whole from ``pieces[(i, j)]``, its slice at model
    coordinate i and expert coordinate j; a replicated leaf is piece
    (0, 0)."""
    m, e = sizes.get(MODEL, 1), sizes.get(EXPERT, 1)
    cut = {_axis_of(en): (d, en) for d, en in enumerate(spec or ())
           if en is not None}
    rows = []
    for i in range(m):
        row = [pieces[(i, j)] for j in range(e)]
        rows.append(_join(row, *cut[EXPERT]) if EXPERT in cut and e > 1
                    else row[0])
    return _join(rows, *cut[MODEL]) if MODEL in cut and m > 1 else rows[0]


def tp_gather(trees, specs, sizes):
    """The whole tree from every rank's: ``trees[(i, j)]`` is the tree of
    model coordinate i and expert coordinate j (each as :func:`tp_slice`
    cut it), for i < ``sizes["model"]``, j < ``sizes["expert"]``.  A
    replicated leaf comes from coordinate (0, 0)."""
    base = trees[(0, 0)]
    paths, _ = tree_leaves(base)
    leaves_at = {c: tree_leaves(t)[1] for c, t in trees.items()}
    out = [tp_gather_leaf({c: leaves[k] for c, leaves in leaves_at.items()},
                          spec, sizes)
           for k, spec in enumerate(leaf_specs(base, specs))]
    return tree_from_leaves(paths, out)
