"""The overlap model: which wire seconds a step pays as latency, and
the roofline compute that could hide them (port of
``deepspeed_tpu/profiling/overlap.py``).

The JAX module reads each compiled program's scheduled HLO: a roofline
cost per instruction, a wire node per collective, host transfer and
point-to-point transfer, and the compute that the scheduler placed
between an async pair's ``-start`` and ``-done``.  Eager PyTorch
compiles no program and prints no HLO, so the HLO parser is not ported.
The model is kept and its input changes: the node list comes from what
the step DISPATCHES, in dispatch order, where the JAX module reads the
text order of a scheduled module.

- **Compute.** While the comm ledger records a phase (the training
  engine's first ``fwd_bwd`` micro-batch and first ``apply_update``, the
  serving engine's first decode), :class:`DispatchPricer`, a
  ``TorchDispatchMode``, prices each aten op as the JAX
  ``_compute_cost`` prices an instruction: ``max(flops / peak, io_bytes
  / hbm)``.  The flops are the flops profiler's rules
  (:func:`~.flops_profiler.profiler.aten_flops`); the io bytes are the
  op's distinct input and output tensors, so an in-place op's buffer
  counts once.  Views, factories and metadata ops are free (the JAX
  ``_FREE_OPS``), and so is an op on another device than the engine's
  (the host's work, and the offload stream's copies, which the engine
  declares).  A hand-written kernel, invisible to the mode, is priced
  at its launch (:func:`~.flops_profiler.profiler.kernel_launch`): its
  plain version's flops, counted on ``meta`` copies of its inputs, and
  its own inputs and outputs as bytes, not the plain version's
  intermediates.  The rates are the card's row of
  :func:`~.utilization.chip_specs` (``link_gbps`` where the JAX table
  has ``ici_gbps``); the CPU gets the SXM card's row.
- **Wire.** :class:`~deepspeed_tpu_torch.comm.CommCounter` hands every
  collective to the pricer's tracker with its verb, bytes, group and
  whether it was asynchronous; an asynchronous call's handle reports its
  ``wait()``.  A blocking call is ``serialized`` (NCCL runs it on the
  compute stream's order: nothing hides it).  An asynchronous pair's
  window is the roofline compute dispatched between its issue and its
  wait, as NCCL's stream runs beside the compute stream: the async
  ``-start``/``-done`` rule of the JAX module.  ``send`` and ``recv``
  are point-to-point nodes (``KIND_P2P``), one per tensor as the JAX
  module has one per HLO ``send`` and ``recv``.  A serialized node's
  ``window_seconds`` is None (unknown): the JAX module fills it from the
  program's dependency graph, which a dispatch stream does not carry
  (as the JAX module reports None past ``MAX_WINDOW_INSTRUCTIONS``).
- **Declared schedules.** The engine's host stream
  (:func:`_declared_stream_nodes`) and bucketed exchange
  (:func:`_apply_collective_schedule`) are applied on top by copies of
  the JAX functions, unchanged, and so is :func:`_classify`.  A node read
  off the step keeps the schema's source name ``"hlo"`` (``"hlo+declared"``
  once a declared schedule re-priced it), so the JAX package's readers of
  the summary (the DSO7xx rules, the doctor) take it as they take
  theirs.

:func:`analyze_dispatch` returns the JAX summary with the same keys and
:data:`OVERLAP_SCHEMA_VERSION`; ``scheduled`` is true (the dispatch
order is the order the card runs the compute stream in) and
``instructions`` counts the dispatched ops.  It adds ``op_bytes``, the
io bytes by op (aten name, or the kernel's name), the per-op roofline
byte count that ranks which passes move a step's bytes.
"""

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from .. import comm
from . import comm as comm_prof
from .flops_profiler import profiler as flops_prof
from .utilization import chip_specs

OVERLAP_SCHEMA_VERSION = 1

# programs whose run performs the offloaded optimizer update: the
# engine's DECLARED host-state stream attaches to these and only these
UPDATE_PROGRAMS = ("train_step", "train_step_compressed", "apply_update")

# programs that carry (part of) the ZeRO-2 data-parallel gradient
# exchange: the engine's DECLARED collective schedule attaches to these
EXCHANGE_PROGRAMS = ("train_step", "fwd_bwd", "apply_update",
                     "cast_params")

# the bucketed-exchange collective ops a declared schedule re-prices
_SCHEDULE_OPS = ("reduce-scatter", "all-gather")

# overlap classifications (per comm/transfer node)
OVERLAPPED = "overlapped"
PARTIAL = "partially_exposed"
SERIALIZED = "serialized"

# a node counts as fully overlapped when >= 95% of its wire seconds are
# hidden
OVERLAP_SLACK = 0.05

# instruction kinds carrying wire cost
KIND_COLLECTIVE = "collective"
KIND_HOST = "host_transfer"
KIND_P2P = "p2p_transfer"

# the schema's source of a node read off the step itself (the JAX
# module's HLO; here the dispatch stream)
SOURCE_PROGRAM = "hlo"

# aten ops that allocate, alias or describe and move no bytes (the JAX
# ``_FREE_OPS``); view ops are free too (``OpOverload.is_view``)
FREE_OPS = frozenset((
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "_unsafe_view", "lift_fresh", "detach", "alias",
    "_local_scalar_dense", "set_", "resize_", "record_stream",
    "is_same_size", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "_has_compatible_shallow_copy_type",
    "is_pinned", "_pin_memory", "_version",
))


# ---------------------------------------------------------------------------
# the model (copies of the JAX functions)
# ---------------------------------------------------------------------------

def _classify(ins_op, kind, wire_bytes, seconds, hidden, window, index,
              name, source="hlo"):
    hidden = min(max(hidden, 0.0), seconds)
    if seconds <= 0:
        cls = OVERLAPPED
    elif hidden >= seconds * (1.0 - OVERLAP_SLACK):
        cls = OVERLAPPED
    elif hidden > 0:
        cls = PARTIAL
    else:
        cls = SERIALIZED
    base_op = ins_op[:-6] if ins_op.endswith("-start") else ins_op
    return {"index": index, "name": name, "op": base_op, "kind": kind,
            "wire_bytes": wire_bytes, "seconds": seconds,
            "hidden_seconds": hidden, "window_seconds": window,
            "classification": cls, "source": source}


def _bucket(nodes, kind):
    sel = [n for n in nodes if n["kind"] == kind]
    return {"total": len(sel),
            "overlapped": sum(1 for n in sel
                              if n["classification"] == OVERLAPPED),
            "partially_exposed": sum(1 for n in sel
                                     if n["classification"] == PARTIAL),
            "serialized": sum(1 for n in sel
                              if n["classification"] == SERIALIZED)}


def _declared_stream_nodes(declared_residual, schedule, compute_total,
                           specs, hlo_excess_bytes=0):
    """Model the engine-declared between-dispatch host stream as wire
    nodes, honoring the declared issue schedule (JAX
    ``overlap.py:578``).

    Serialized (no schedule, ``overlap: false``, or a single chunk):
    one fully exposed host transfer.  Pipelined (``overlap: true,
    chunks: n``): the steady-state wire hides behind compute, and the
    pipeline fill and drain (one chunk's round trip, ``wire/n``) plus
    whatever steady-state wire exceeds the available compute stay
    exposed.  Components share one compute budget, so the model never
    claims more hiding than the program holds; ``hlo_excess_bytes``
    (host wire the program itself shows beyond the declaration) reduces
    the declared gradient component."""
    schedule = schedule or {}
    chunks = int(schedule.get("chunks") or 0)
    pipelined = bool(schedule.get("overlap")) and chunks > 1
    components = []
    if declared_residual > 0:
        components.append(("<declared-host-stream>", "host-stream",
                           declared_residual,
                           int(schedule.get("redundant_prefetch_chunks")
                               or 0)))
    grad_bytes = max(int(schedule.get("grad_wire_bytes") or 0)
                     - max(int(hlo_excess_bytes or 0), 0), 0)
    if grad_bytes > 0:
        components.append(("<declared-grad-stream>", "grad-stream",
                           grad_bytes, 0))
    nodes = []
    budget = max(float(compute_total), 0.0)
    bw = specs["host_gbps"] * 1e9
    for i, (name, op, nbytes, redundant) in enumerate(components):
        secs = nbytes / bw
        extra = (redundant * (nbytes / (2 * chunks)) / bw
                 if pipelined and chunks else 0.0)
        if not pipelined:
            hidden = 0.0
        else:
            fill_drain = secs / chunks
            hidden = min(max(secs - fill_drain, 0.0), budget)
            budget -= hidden
        nodes.append(_classify(
            ins_op=op, kind=KIND_HOST, wire_bytes=nbytes + int(
                extra * bw), seconds=secs + extra, hidden=hidden,
            window=compute_total, index=-(i + 1), name=name,
            source="declared"))
    return nodes


def _apply_collective_schedule(nodes, schedule, compute_total):
    """Re-price the bucketed ZeRO-2 gradient exchange per the engine's
    declared collective schedule (``{overlap, rs_buckets, ag_buckets,
    ...}``; JAX ``overlap.py:639``).

    - ``overlap: true``: steady-state buckets hide up to each node's
      window (None: uncapped), all sharing one ``compute_total`` budget,
      and the pipeline fill/drain (one bucket's wire, ``W/B``) stays
      exposed; hiding is granted in issue order.
    - ``overlap: false`` (the serialized control): nothing hides, and
      the matching nodes' windows record the potential window
      ``compute_total * (B-1)/B`` over the declared bucket count.

    Only the program's own reduce-scatter/all-gather collective nodes
    are touched (``source`` becomes ``hlo+declared``)."""
    if not schedule:
        return
    matching = [n for n in nodes
                if n["kind"] == KIND_COLLECTIVE
                and n["op"] in _SCHEDULE_OPS
                and n["source"] == "hlo"]
    if not matching:
        return
    n_declared = (int(schedule.get("rs_buckets") or 0)
                  + int(schedule.get("ag_buckets") or 0))
    if not schedule.get("overlap"):
        if n_declared > 1:
            potential = max(
                float(compute_total) * (n_declared - 1) / n_declared,
                0.0)
            for n in matching:
                n["window_seconds"] = max(
                    float(n.get("window_seconds") or 0.0), potential)
                n["source"] = "hlo+declared"
        return
    B = len(matching)
    if B <= 1:
        return
    total = sum(n["seconds"] for n in matching)
    fill_drain = total / B
    budget = max(float(compute_total), 0.0)
    remaining = min(max(total - fill_drain, 0.0), budget)
    for n in sorted(matching, key=lambda x: x["index"]):
        cap = n.get("window_seconds")
        grant = remaining if cap is None else min(remaining,
                                                 max(float(cap), 0.0))
        hidden = min(n["seconds"], grant)
        remaining -= hidden
        re = _classify(ins_op=n["op"], kind=n["kind"],
                       wire_bytes=n["wire_bytes"], seconds=n["seconds"],
                       hidden=hidden,
                       window=(cap if cap is not None else budget),
                       index=n["index"], name=n["name"],
                       source="hlo+declared")
        n.update(re)


# ---------------------------------------------------------------------------
# the torch front end: pricing what a step dispatches
# ---------------------------------------------------------------------------

def op_seconds(flops, nbytes, specs):
    """Roofline seconds of one op: the larger of its flop time at the
    card's peak and its HBM-traffic time (JAX ``_compute_cost``)."""
    return max(flops / (specs["peak_tflops"] * 1e12),
               nbytes / (specs["hbm_gbps"] * 1e9))


def _tensors(x, out):
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def io_bytes(tensors):
    """Bytes of the distinct tensors of an op (an in-place op's output is
    its input, counted once)."""
    seen, total = set(), 0
    for t in tensors:
        key = (t.data_ptr(), t.numel(), t.dtype)
        if key in seen:
            continue
        seen.add(key)
        total += t.numel() * t.element_size()
    return total


class _MetaFlops(TorchDispatchMode):
    """The flops of a plain version run on ``meta`` tensors, by the flops
    profiler's rules."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.flops += flops_prof.aten_flops(func, args, kwargs, out)[0]
        return out


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("meta")
    if isinstance(x, (tuple, list)):
        return type(x)(_meta(y) for y in x)
    return x


def launch_cost(plain, args, kwargs):
    """``(flops, io_bytes)`` of one hand-written kernel launch: its plain
    version's flops on ``meta`` copies of the inputs, and the launch's
    own inputs plus the plain version's outputs as bytes."""
    counter = _MetaFlops()
    with _disable_current_modes(), counter, torch.no_grad():
        out = plain(*_meta(args), **{k: _meta(v) for k, v in kwargs.items()})
    inputs = [t for t in _tensors(args, []) + _tensors(kwargs, [])
              if t.device.type != "meta"]
    outs = _tensors(out, [])
    return counter.flops, io_bytes(inputs) + sum(
        t.numel() * t.element_size() for t in outs)


class DispatchPricer(TorchDispatchMode):
    """Records what a phase dispatches, in order, for
    :func:`analyze_dispatch`: each priced op's ``(name, flops,
    io_bytes)``, each collective's issue and, for an asynchronous one,
    its wait.  Every op is called as it was called, so the phase's
    numbers are those of a run without the pricer.  ``device_type``
    names the engine's device; an op of another device is the host's
    and free."""

    def __init__(self, device_type="cpu"):
        super().__init__()
        self.device_type = str(device_type)
        self.events = []
        self.dispatched = 0
        self._wires = 0

    # -- recording ------------------------------------------------------
    def start(self):
        self.__enter__()
        comm.counter.trackers.append(self._track)
        flops_prof._LAUNCH_PRICERS.append(self._launch)
        return self

    def stop(self):
        flops_prof._LAUNCH_PRICERS.remove(self._launch)
        comm.counter.trackers.remove(self._track)
        self.__exit__(None, None, None)
        return self

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.dispatched += 1
        name = func.overloadpacket.__name__
        if func.is_view or name in FREE_OPS:
            return out
        tensors = _tensors(args, []) + _tensors(kwargs, [])
        outs = _tensors(out, [])
        every = tensors + outs
        if not every:
            return out
        # the engine's device only, and no transfer to or from another
        # (a 0-d host tensor is a scalar operand, no transfer)
        if any(t.device.type != self.device_type and t.dim() > 0
               for t in every) or all(t.device.type != self.device_type
                                      for t in every):
            return out
        flops = flops_prof.aten_flops(func, args, kwargs, out)[0]
        self.events.append(("op", name, int(flops), io_bytes(every)))
        return out

    def _launch(self, name, plain, args, kwargs):
        flops, nbytes = launch_cost(plain, args, kwargs)
        self.events.append(("op", str(name), int(flops), int(nbytes)))

    def _track(self, verb, nbytes, group, async_op):
        wire = {"id": self._wires, "verb": verb, "nbytes": int(nbytes),
                "group": int(group), "async": bool(async_op)}
        self._wires += 1
        self.events.append(("issue", wire))
        if not async_op:
            return None
        return lambda: self.events.append(("wait", wire["id"]))

    # -- what was recorded ----------------------------------------------
    def records(self):
        return {"events": list(self.events), "dispatched": self.dispatched}

    def op_bytes(self):
        out = {}
        for ev in self.events:
            if ev[0] == "op":
                out[ev[1]] = out.get(ev[1], 0) + ev[3]
        return out


def _wire_node(wire, specs):
    """``(kind, op, wire_bytes, seconds)`` of one recorded call."""
    verb = wire["verb"]
    if verb in ("send", "recv"):
        n = int(wire["nbytes"])
        return KIND_P2P, verb, n, n / (specs["link_gbps"] * 1e9)
    rec = comm_prof.collective_record(verb, wire["nbytes"], wire["group"])
    if rec is None:
        return None
    wbytes = rec["wire_bytes"]
    return (KIND_COLLECTIVE, rec["op"], wbytes,
            wbytes / (specs["link_gbps"] * 1e9))


def analyze_dispatch(records, specs=None, total_devices=1, device_kind="",
                     declared_host_wire_bytes=0, max_nodes=32,
                     declared_host_stream=None,
                     declared_collective_schedule=None):
    """The JAX ``analyze_hlo`` summary of one recorded phase
    (``records`` from :meth:`DispatchPricer.records`): roofline compute
    and critical-path seconds, the classified wire nodes, the declared
    host stream and bucketed-exchange schedules on top, and the wire,
    exposed-wire and per-kind totals.  ``specs`` defaults to
    ``chip_specs(device_kind)``; ``total_devices`` is kept for the JAX
    signature (the recorded calls carry their group sizes).
    ``max_nodes`` caps the emitted node list (None: every node)."""
    del total_devices
    specs = specs if specs is not None else chip_specs(device_kind)
    nodes, costs, op_bytes = [], [], {}
    issued = {}            # wire id -> (node args, issue time, position)
    t = 0.0                # the stream's clock: the critical path
    position = 0           # ops and issues so far (a node's index)
    for ev in records["events"]:
        if ev[0] == "op":
            _, name, flops, nbytes = ev
            cost = op_seconds(flops, nbytes, specs)
            costs.append(cost)
            op_bytes[name] = op_bytes.get(name, 0) + nbytes
            t += cost
            position += 1
            continue
        if ev[0] == "wait":
            wire = issued.pop(ev[1], None)
            if wire is None:
                continue
            (kind, op, wbytes, secs), t_issue, first_op, index, name = wire
            hidden = sum(costs[first_op:])
            nodes.append(_classify(
                ins_op=op, kind=kind, wire_bytes=wbytes, seconds=secs,
                hidden=hidden, window=hidden or None, index=index,
                name=name, source=SOURCE_PROGRAM))
            t = max(t, t_issue + secs)
            continue
        wire = ev[1]
        node = _wire_node(wire, specs)
        if node is None:
            continue
        kind, op, wbytes, secs = node
        name = f"{op}.{wire['id']}"
        if wire["async"]:
            issued[wire["id"]] = (node, t, len(costs), position, name)
        else:
            nodes.append({"index": position, "name": name, "op": op,
                          "kind": kind, "wire_bytes": wbytes,
                          "seconds": secs, "hidden_seconds": 0.0,
                          "window_seconds": None,
                          "classification": SERIALIZED,
                          "source": SOURCE_PROGRAM})
            t += secs
        position += 1
    # an asynchronous call never waited for in the phase: it completes
    # at the phase's end, behind whatever compute followed its issue
    for (kind, op, wbytes, secs), t_issue, first_op, index, name in \
            issued.values():
        hidden = sum(costs[first_op:])
        nodes.append(_classify(
            ins_op=op, kind=kind, wire_bytes=wbytes, seconds=secs,
            hidden=hidden, window=hidden or None, index=index, name=name,
            source=SOURCE_PROGRAM))
        t = max(t, t_issue + secs)
    nodes.sort(key=lambda n: n["index"])
    compute_total = sum(costs)
    program_transfers = {
        "host_transfers": sum(1 for n in nodes if n["kind"] == KIND_HOST),
        "host_transfer_bytes": sum(n["wire_bytes"] for n in nodes
                                   if n["kind"] == KIND_HOST),
        "p2p_transfers": sum(1 for n in nodes if n["kind"] == KIND_P2P),
        "p2p_transfer_bytes": sum(n["wire_bytes"] for n in nodes
                                  if n["kind"] == KIND_P2P),
    }
    host_bytes = program_transfers["host_transfer_bytes"]
    declared_state = int(declared_host_wire_bytes or 0)
    declared_residual = max(declared_state - host_bytes, 0)
    nodes.extend(_declared_stream_nodes(
        declared_residual, declared_host_stream, compute_total, specs,
        hlo_excess_bytes=max(host_bytes - declared_state, 0)))
    _apply_collective_schedule(nodes, declared_collective_schedule,
                               compute_total)
    wire = sum(n["seconds"] for n in nodes)
    exposed = sum(n["seconds"] - n["hidden_seconds"] for n in nodes)
    exposed_by_kind = {KIND_COLLECTIVE: 0.0, KIND_HOST: 0.0,
                       KIND_P2P: 0.0}
    for n in nodes:
        exposed_by_kind[n["kind"]] += n["seconds"] - n["hidden_seconds"]
    # the declared host stream runs between the phase's ops: its exposed
    # seconds add to the stream's clock
    declared_exposed = sum(n["seconds"] - n["hidden_seconds"]
                           for n in nodes if n["source"] == "declared")
    return {
        "overlap_schema_version": OVERLAP_SCHEMA_VERSION,
        "device_kind": specs["device_kind"],
        "scheduled": True,
        "instructions": int(records.get("dispatched", len(costs))),
        "critical_path_seconds": t + declared_exposed,
        "compute_seconds": compute_total,
        "wire_seconds": wire,
        "exposed_wire_seconds": exposed,
        "exposed_by_kind": exposed_by_kind,
        "overlap_fraction": (1.0 - exposed / wire) if wire > 0 else 1.0,
        "collectives": _bucket(nodes, KIND_COLLECTIVE),
        "host_transfers": _bucket(nodes, KIND_HOST),
        "p2p_transfers": _bucket(nodes, KIND_P2P),
        "hlo_transfer_summary": program_transfers,
        "nodes": nodes if max_nodes is None else nodes[:max_nodes],
        "nodes_truncated": (0 if max_nodes is None
                            else max(len(nodes) - max_nodes, 0)),
        "op_bytes": op_bytes,
    }
