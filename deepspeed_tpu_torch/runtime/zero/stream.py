"""The streamed offload update on the card (port of
``deepspeed_tpu/runtime/zero/stream.py`` and of the JAX engine's
unrolled form, ``chunked_offload_update`` and its chunk plan,
``deepspeed_tpu/runtime/engine.py:1951-2150``, ``:2310-2545``).

The master and the optimizer state live in pinned host memory, one
``(rows, LANES)`` buffer per family.  An update walks them in chunks of
``offload_chunk_mb`` (of fp32 rows; 0 is one chunk).  For each chunk it
copies the chunk's rows of every family from the host into a device
slot on a copy stream, makes the compute stream wait on that copy's
event, runs the caller's chunk function there (the optimizer's own
update on the chunk views, which is elementwise, so the result equals
the whole-buffer update bit for bit), and copies the written families
back to the host on a second copy stream once the compute stream's
event says the chunk is done.

XLA needs two forms of this loop, a ``lax.scan`` over uniform chunks
for its compile time and an unrolled one; in PyTorch they are one loop.
``offload_prefetch_depth`` d gives d device slots: the fetch of chunk
k+d-1 is issued before chunk k updates and waits only for the
write-back of the chunk that last held its slot, so it overlaps chunk
k's update and write-back, and the two copy directions overlap each
other.  Depth 1 is the serialized schedule.  Every chunk reads host
rows that no other chunk writes, and its stochastic-rounding tag is its
index ``k``, which is its rank by row (the jobs are in row order: JAX's
``sr_chunk_tags``, ``stream.py:124``), so every depth gives the same
result bit for bit.

Nothing in the loop waits on the host: slots cross streams through
events and ``record_stream``, and the host reads the buffers only after
:meth:`HostStream.sync_host`.  On the CPU (the tests) the same loop
runs in order without streams.
"""

import torch

from ...ops.op_common import LANES

MB = 1 << 20


def split_rows(total_rows, rows_per):
    """Contiguous ``(start, count)`` bounds of at most ``rows_per`` rows
    (JAX ``zero/coordinator.py:141``); the last one may be ragged."""
    if not rows_per or total_rows <= rows_per:
        return ((0, total_rows),)
    out, r = [], 0
    while r < total_rows:
        rc = min(rows_per, total_rows - r)
        out.append((r, rc))
        r += rc
    return tuple(out)


def chunk_rows_for(chunk_mb):
    """Rows of one chunk of ``chunk_mb`` MB of fp32 rows (None for 0:
    one chunk), as the JAX engine sizes them."""
    return max(1, (chunk_mb * MB) // (LANES * 4)) if chunk_mb else None


class HostStream:
    """The chunk loop between pinned host buffers and the card.

    ``rows`` is the row count of the host buffers (the rank's rows of
    the flat layout above one data rank), ``chunk_rows`` the rows of a
    chunk (None: one chunk), ``depth`` the chunks in flight.  With
    ``timing`` set, every copy and every run is timed with CUDA events
    and :meth:`timing_report` reads them (after a sync).  ``transfers``
    and ``transfer_bytes`` count every host<->card copy issued (each
    family's chunk each way, each spilled chunk), for the comm ledger's
    ``host_transfer_bytes``."""

    def __init__(self, rows, chunk_rows, depth, device):
        self.device = torch.device(device)
        self.jobs = split_rows(rows, chunk_rows)
        self.depth = max(1, min(int(depth), len(self.jobs)))
        self.cuda = self.device.type == "cuda"
        self._done = None  # the last host write of the copy streams
        self.transfers = 0
        self.transfer_bytes = 0
        self.timing = False
        self._timed = []
        if self.cuda:
            self.h2d = torch.cuda.Stream(self.device)
            self.d2h = torch.cuda.Stream(self.device)

    @property
    def chunk_rows(self):
        return max(rc for _, rc in self.jobs)

    def schedule(self):
        """The schedule that was built, in the JAX engine's keys
        (``engine.py:2120-2130``): one host group, and one loop form."""
        return {"overlap": self.depth > 1, "prefetch_depth": self.depth,
                "chunks": len(self.jobs), "groups": 1, "form": "loop"}

    def sync_host(self):
        """Block the host until every copy into a host buffer landed:
        before the host reads or writes one (a checkpoint, the host
        optimizer, ``get_master_params``)."""
        if self._done is not None:
            self._done.synchronize()

    def _moved(self, t):
        self.transfers += 1
        self.transfer_bytes += t.nbytes

    def _event(self, stream):
        ev = torch.cuda.Event(enable_timing=self.timing)
        ev.record(stream)
        return ev

    def run(self, host, fn, writes=()):
        """Stream every chunk of the ``host`` buffers (``{name: (rows,
        LANES) tensor}``) through device slots: ``fn(k, r0, rc, views)``
        runs on the compute stream for job ``k`` (rows ``r0:r0+rc``) with
        ``views`` the chunk's device copies, ``{name: (rc, LANES)}``,
        which it may write in place; the families named in ``writes``
        go back to the host afterwards."""
        if not self.cuda:
            for k, (r0, rc) in enumerate(self.jobs):
                views = {n: h[r0:r0 + rc].clone() for n, h in host.items()}
                for v in views.values():
                    self._moved(v)
                fn(k, r0, rc, views)
                for n in writes:
                    host[n][r0:r0 + rc].copy_(views[n])
                    self._moved(views[n])
            return
        cur = torch.cuda.current_stream(self.device)
        slots = [{n: torch.empty((self.chunk_rows, LANES), dtype=h.dtype,
                                 device=self.device)
                  for n, h in host.items()} for _ in range(self.depth)]
        for slot in slots:
            for t in slot.values():
                t.record_stream(self.h2d)
                t.record_stream(self.d2h)
        timed = {"h2d": [], "d2h": [], "bytes_h2d": 0, "bytes_d2h": 0}
        # the slots' memory may be the compute stream's last tensors: the
        # fetches start after what it has queued; and the previous run's
        # write-backs (and a gradient spill) land before any fetch reads
        # the host buffers
        timed["start"] = self._event(cur)
        self.h2d.wait_event(timed["start"])
        if self._done is not None:
            self.h2d.wait_event(self._done)
        n = len(self.jobs)
        # freed[k]: job k's slot may take another chunk (its write-back,
        # or its update when nothing goes back)
        fetched, freed = [None] * n, [None] * n

        def fetch(k):
            r0, rc = self.jobs[k]
            slot = slots[k % self.depth]
            with torch.cuda.stream(self.h2d):
                if k >= self.depth:
                    self.h2d.wait_event(freed[k - self.depth])
                t0 = self._event(self.h2d) if self.timing else None
                for name, h in host.items():
                    slot[name][:rc].copy_(h[r0:r0 + rc], non_blocking=True)
                    timed["bytes_h2d"] += h[r0:r0 + rc].nbytes
                    self._moved(h[r0:r0 + rc])
                fetched[k] = self._event(self.h2d)
                if t0 is not None:
                    timed["h2d"].append((t0, fetched[k]))

        for k in range(self.depth):
            fetch(k)
        for k, (r0, rc) in enumerate(self.jobs):
            slot = slots[k % self.depth]
            cur.wait_event(fetched[k])
            fn(k, r0, rc, {name: t[:rc] for name, t in slot.items()})
            freed[k] = self._event(cur)
            if writes:
                with torch.cuda.stream(self.d2h):
                    self.d2h.wait_event(freed[k])
                    t0 = self._event(self.d2h) if self.timing else None
                    for name in writes:
                        host[name][r0:r0 + rc].copy_(slot[name][:rc],
                                                     non_blocking=True)
                        timed["bytes_d2h"] += slot[name][:rc].nbytes
                        self._moved(slot[name][:rc])
                    freed[k] = self._event(self.d2h)
                    if t0 is not None:
                        timed["d2h"].append((t0, freed[k]))
            if k + self.depth < n:
                fetch(k + self.depth)
        # copy streams run in order, and each fetch waited for the copies
        # before it: the last event covers every copy of the run
        self._done = freed[-1] if writes else fetched[-1]
        if self.timing:
            timed["end"] = self._done
            self._timed.append(timed)

    def spill(self, src, dst):
        """Copy the device buffer ``src`` into the host buffer ``dst``
        (fp32, the same rows) chunk by chunk, each cast on the compute
        stream and copied on the write-back stream: the gradient leg of
        ``offload_gradients``."""
        if not self.cuda:
            dst.copy_(src)
            self._moved(dst)
            return
        cur = torch.cuda.current_stream(self.device)
        for r0, rc in self.jobs:
            part = src[r0:r0 + rc].to(dst.dtype)
            part.record_stream(self.d2h)
            cast = self._event(cur)
            with torch.cuda.stream(self.d2h):
                self.d2h.wait_event(cast)
                dst[r0:r0 + rc].copy_(part, non_blocking=True)
                self._moved(dst[r0:r0 + rc])
                self._done = self._event(self.d2h)

    def timing_report(self):
        """The timed runs since the last call, summed: bytes and event
        time of each copy direction, the achieved rates, the compute
        stream's wall time from a run's start to its last write-back,
        and that wall against the sum of the copies (below 1 means the
        copies overlapped).  Call after a sync."""
        runs, self._timed = self._timed, []
        if not runs:
            return None
        h2d = sum(a.elapsed_time(b) for r in runs for a, b in r["h2d"])
        d2h = sum(a.elapsed_time(b) for r in runs for a, b in r["d2h"])
        wall = sum(r["start"].elapsed_time(r["end"]) for r in runs)
        bh = sum(r["bytes_h2d"] for r in runs)
        bd = sum(r["bytes_d2h"] for r in runs)
        return {"runs": len(runs), "h2d_bytes": bh, "d2h_bytes": bd,
                "h2d_ms": h2d, "d2h_ms": d2h, "wall_ms": wall,
                "h2d_gb_s": bh / h2d / 1e6 if h2d else None,
                "d2h_gb_s": bd / d2h / 1e6 if d2h else None,
                "wall_over_copies": wall / (h2d + d2h) if h2d + d2h
                else None}
