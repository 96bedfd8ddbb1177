"""The bucketed gradient exchange of ``overlap_comm`` and ZeRO-3's
just-in-time parameter gathers (port of the JAX engine's
``bucketed_loss_and_flat_grads``, ``_gather_cast_leaves`` and
``zero3_loss_and_flat_grads``, ``deepspeed_tpu/runtime/engine.py:2890-3112``).

The JAX package issues one ``psum_scatter`` per bucket in a ``shard_map``
region and lets XLA's scheduler overlap them with the backward.  Here
the backward itself drives them:

- :class:`BucketedExchange` reduce-scatters a bucket of the canonical
  gradient into the rank's piece of it (``comm.reduce_scatter`` with
  ``async_op``) as soon as the bucket is complete, and waits for every
  handle at the end of the backward.  Buckets go out in reversed bucket
  index, the backward's order, and a bucket that completes early waits
  until every bucket above it has gone, so every rank issues the same
  collectives in the same order whatever order its hooks fire in.
- :class:`Zero3Params` holds no parameters between the steps: the
  model's param tree is a lazy mapping, and the first use of a leaf
  gathers its ``ag_group`` (one all-gather of the group's master pieces,
  cast to the compute dtype) through :class:`_GatherGroup`, whose
  backward is the reduce-scatter of the group's gradient.  Saved
  tensors that are views of a gathered group are packed as handles
  (``torch.autograd.graph.saved_tensors_hooks``), so a group is freed
  once the forward has passed its last use and is gathered again, once,
  when the backward first needs it.  A leaf that the model holds on to
  (a closure of a checkpointed chunk) keeps its group alive instead:
  nothing reads freed memory.  Peak parameter residency is one to two
  groups, not the model.

The 1/dp of the JAX exchange is in the loss here: the engine's backward
divides by the accumulation steps times the data-parallel degree, as the
fused exchange does, so the bucketed and the fused gradients are the same
numbers summed in the same order.
"""

import collections
import contextlib
import weakref

import torch

from ... import comm
from ...ops.op_common import LANES
from ...parallel.mesh import DATA_AXIS
from ...utils.params import tree_from_leaves


class BucketedExchange:
    """Reduce-scatters of a :class:`~deepspeed_tpu_torch.runtime.zero.buckets.BucketPlan`'s
    buckets into ``gshard`` (the rank's rows of the reduced gradient, in
    the plan's shard-major order), issued while the backward runs.
    ``max_inflight`` bounds the collectives in flight (their fp32 blocks
    stay alive until they complete); None leaves it unbounded."""

    def __init__(self, plan, mesh, gshard, max_inflight=None):
        self.plan = plan
        self.mesh = mesh
        self.gshard = gshard
        self.max_inflight = max_inflight
        self._pending = collections.deque()
        self._ready = [False] * plan.n_buckets
        self._next = -1
        self._accumulate = False
        self.active = False

    def start(self, accumulate, ordered=True):
        """Arm for one backward; ``accumulate`` adds the reduced pieces
        to ``gshard`` (a later micro-batch) instead of writing them.
        ``ordered``: the buckets report through :meth:`ready` and every
        bucket goes out once; otherwise the caller issues them
        (:meth:`issue`) and ``gshard`` starts from zero, so a bucket that
        no backward reaches reduces to zero."""
        self._ready = [False] * self.plan.n_buckets
        self._next = self.plan.n_buckets - 1 if ordered else -1
        self._accumulate = accumulate
        if not ordered and not accumulate:
            self.gshard.zero_()
            self._accumulate = True
        self.active = True

    def ready(self, b, block_fn):
        """Bucket ``b`` is complete; ``block_fn(b)`` gives its canonical
        ``(rows, LANES)`` fp32 block.  Issues every complete bucket that
        is next in reversed order."""
        self._ready[b] = block_fn
        while self._next >= 0 and self._ready[self._next]:
            self._issue(self._next, self._ready[self._next])
            self._next -= 1

    def issue(self, b, block):
        """Issue bucket ``b``'s reduce-scatter of ``block`` now (the
        caller keeps the order the same on every rank)."""
        self._issue(b, lambda _: block)

    def _issue(self, b, block_fn):
        bk = self.plan.buckets[b]
        block = block_fn(b)
        piece = self.gshard[bk.piece_start:bk.piece_start + bk.piece_rows]
        out = torch.empty_like(piece) if self._accumulate else piece
        out, handle = comm.reduce_scatter(block, DATA_AXIS, mesh=self.mesh,
                                          out=out, async_op=True)
        self._pending.append((handle, out, piece, block))
        if self.max_inflight is not None:
            while len(self._pending) > self.max_inflight:
                self._complete(self._pending.popleft())

    def _complete(self, item):
        handle, out, piece, _ = item
        handle.wait()
        if out is not piece:
            piece.add_(out)

    def finish(self, block_fn=None):
        """After the backward: issue what is left, in order (``block_fn``
        gives the blocks of buckets no hook reported), then wait for
        every collective."""
        while self._next >= 0:
            self._issue(self._next, self._ready[self._next] or block_fn)
            self._next -= 1
        while self._pending:
            self._complete(self._pending.popleft())
        self.active = False


class _GatherGroup(torch.autograd.Function):
    """Forward: all-gather ``ag_group`` ``g``'s master pieces, cast to
    the compute dtype, and return its leaves.  Backward: the group's
    gradient, assembled from its leaves' in fp32, reduce-scattered bucket
    by bucket onto the ranks that own it."""

    @staticmethod
    def forward(ctx, anchor, z3, g):
        ctx.z3, ctx.g = z3, g
        return tuple(z3.carve(g, z3.gather(g)))

    @staticmethod
    def backward(ctx, *grads):
        ctx.z3.reduce_group(ctx.g, grads)
        return None, None, None


class _LazyTree(collections.abc.Mapping):
    """A read-only view of the param tree whose leaves are gathered on
    first use."""

    def __init__(self, z3, node):
        self._z3, self._node = z3, node

    def __getitem__(self, key):
        v = self._node[key]
        if isinstance(v, dict):
            return _LazyTree(self._z3, v)
        return self._z3.leaf(v)

    def __iter__(self):
        return iter(self._node)

    def __len__(self):
        return len(self._node)


class Zero3Params:
    """ZeRO-3's parameters under ``overlap_comm``: gathered per
    ``ag_group`` when the model first reads them, released after the
    forward's last use, gathered again in the backward (see the module
    docstring).  ``master`` is the rank's shard of the fp32 master (the
    plan's shard-major rows); ``exchange`` takes the backward's
    reduce-scatters."""

    def __init__(self, flat, master, compute_dtype, exchange):
        self.flat, self.plan, self.mesh = flat, flat.plan, flat.mesh
        self.master = master
        self.dtype = compute_dtype
        self.exchange = exchange
        plan, seg = self.plan, flat.segments
        self.group_rows = [plan.group_rows(g)
                           for g in range(len(plan.ag_groups))]
        self.group_of_leaf = []
        for g, (b_lo, b_hi) in enumerate(plan.ag_groups):
            n = plan.buckets[b_hi - 1].leaf_hi - plan.buckets[b_lo].leaf_lo
            self.group_of_leaf += [g] * n
        self._leaf_spans = [(ro, n) for ro, n in zip(seg.row_offsets,
                                                     seg.sizes)]
        self.params = _LazyTree(self, tree_from_leaves(
            flat.paths, list(range(len(flat.paths)))))
        self.anchor = torch.zeros((), requires_grad=True)
        self._outs = {}        # group -> weakrefs of its leaf tensors
        self._ptr = {}         # data_ptr of a live group buffer -> group
        self._held = collections.OrderedDict()   # forward's strong refs
        self._cache = collections.OrderedDict()  # backward's re-gathers
        self._trace, self._last_use = [], None
        self._pos = 0
        self.phase = None
        self.live_bytes = self.peak_bytes = 0
        self.gathers = collections.Counter()

    def group_bytes(self, g):
        return self.group_rows[g][1] * LANES * \
            torch.empty((), dtype=self.dtype).element_size()

    # ---------------------------------------------------------- gathers
    def gather(self, g):
        """Group ``g`` in the canonical layout, ``(rows, LANES)`` in the
        compute dtype: one all-gather of the rank's pieces of its
        buckets (a collective)."""
        p0, prows = self.group_rows[g][2:]
        piece = self.master[p0:p0 + prows].to(self.dtype)
        # a buffer of its own (not a view of the gathered pieces): its
        # lifetime is the group's
        buf = self.plan.canonical_group(
            comm.all_gather(piece, DATA_AXIS, mesh=self.mesh), g)
        self.gathers[self.phase or "eval"] += 1
        nbytes = buf.numel() * buf.element_size()
        ptr = buf.untyped_storage().data_ptr()
        self._ptr[ptr] = g
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(buf, self._freed, ptr, nbytes)
        return buf

    def _freed(self, ptr, nbytes):
        self._ptr.pop(ptr, None)
        self.live_bytes -= nbytes

    def carve(self, g, buf):
        """Group ``g``'s leaves as views of its gathered ``buf``."""
        c0 = self.group_rows[g][0]
        flat = buf.view(-1)
        out = []
        for i in self.leaves_of(g):
            ro, n = self._leaf_spans[i]
            start = (ro - c0) * LANES
            out.append(flat[start:start + n].view(self.flat.shapes[i]))
        return out

    def leaves_of(self, g):
        b_lo, b_hi = self.plan.ag_groups[g]
        return range(self.plan.buckets[b_lo].leaf_lo,
                     self.plan.buckets[b_hi - 1].leaf_hi)

    def _live(self, g):
        """Group ``g``'s leaf tensors from its last gather, None where
        one of them is gone."""
        outs = [r() for r in self._outs.get(g, ())]
        return outs if outs and all(t is not None for t in outs) else None

    def _any_live(self, g):
        return next((t for t in (r() for r in self._outs.get(g, ()))
                     if t is not None), None)

    def leaf(self, i):
        """Leaf ``i``, its group gathered unless its tensors are alive."""
        g = self.group_of_leaf[i]
        if self.phase == "forward":
            self._advance(g)
        outs = self._live(g)
        if outs is None:
            if self.phase == "backward":
                # a recompute (activation checkpointing) reads the
                # params again: data only, as leaves that require grad,
                # so that it saves what the forward saved
                outs = [t.detach().requires_grad_(True)
                        for t in self.carve(g, self._cached(g))]
            elif self.phase == "forward" and torch.is_grad_enabled():
                outs = list(_GatherGroup.apply(self.anchor, self, g))
            else:
                outs = self.carve(g, self.gather(g))
            self._outs[g] = [weakref.ref(t) for t in outs]
        if self.phase == "forward":
            self._held[g] = outs
            self._held.move_to_end(g)
        return outs[i - self.leaves_of(g).start]

    def _advance(self, g):
        """A forward use of group ``g``, before it is gathered: release
        the groups whose last use (in the first forward's trace of group
        uses) has passed; before a trace exists, or off it, all but the
        most recent one."""
        if self._trace and self._trace[-1] == g:
            return
        self._trace.append(g)
        pos = len(self._trace) - 1
        known = self._last_use
        on_trace = (known is not None and pos < len(known[0])
                    and known[0][pos] == g)
        for h in list(self._held):
            if h == g:
                continue
            if on_trace:
                if known[1].get(h, -1) < pos:
                    del self._held[h]
            elif len(self._held) > 1:
                del self._held[h]

    def _cached(self, g):
        """Group ``g``'s buffer for the backward: gathered again, and kept
        among the two most recent."""
        if g in self._cache:
            self._cache.move_to_end(g)
            return self._cache[g]
        while len(self._cache) > 1:
            self._cache.popitem(last=False)
        buf = self._cache[g] = self.gather(g)
        return buf

    # ----------------------------------------------- saved-tensor hooks
    def _pack(self, t):
        g = self._ptr.get(t.untyped_storage().data_ptr())
        if g is None:
            return t
        return g, t.shape, t.stride(), t.storage_offset()

    def _unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        g, shape, stride, offset = packed
        src = self._any_live(g)
        if src is None:
            src = self._cached(g)
        # the offset is the storage's, and every gather of a group lays
        # it out alike
        return torch.as_strided(src.detach(), shape, stride, offset)

    # ------------------------------------------------------------ scopes
    @contextlib.contextmanager
    def scope(self, phase):
        """``"forward"`` (a training forward, with the saved-tensor hooks),
        ``"backward"`` or ``"eval"``; each tidies up after it."""
        self.phase = phase
        if phase != "backward":
            self._outs = {}
            self._trace = []
        hooks = (torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack)
                 if phase == "forward" else contextlib.nullcontext())
        try:
            with hooks:
                yield self
        finally:
            if phase == "forward":
                if self._last_use is None:
                    self._last_use = (tuple(self._trace), {
                        g: k for k, g in enumerate(self._trace)})
                self._held.clear()
            else:
                self._cache.clear()
                self._outs = {}
            self.phase = None

    # --------------------------------------------------------- backward
    def reduce_group(self, g, grads):
        """The backward of :class:`_GatherGroup`: group ``g``'s gradient
        as a canonical fp32 block, reduce-scattered bucket by bucket
        (reversed, as the backward produces them)."""
        c0, rows = self.group_rows[g][:2]
        block = torch.zeros((rows * LANES,), dtype=torch.float32,
                            device=self.master.device)
        for i, gr in zip(self.leaves_of(g), grads):
            if gr is not None:
                ro, n = self._leaf_spans[i]
                block[(ro - c0) * LANES:(ro - c0) * LANES + n] = \
                    gr.reshape(-1)
        block = block.view(rows, LANES)
        b_lo, b_hi = self.plan.ag_groups[g]
        for b in reversed(range(b_lo, b_hi)):
            bk = self.plan.buckets[b]
            self.exchange.issue(b, block[bk.start_row - c0:
                                         bk.start_row - c0 + bk.rows])
