"""Paged KV cache: preallocated device buffers + a host-side block
allocator (port of ``deepspeed_tpu/inference/kv_cache.py``).

The cache is two device tensors of fixed shape

    ``[layers, kv_blocks, kv_block_size, heads, head_dim]``

allocated once at engine construction.  Sequences never own contiguous
cache memory: each holds a *block table* (host list of block ids) and
the prefill and decode steps scatter and gather through it.  Both steps
write the cache tensors in place.

Block 0 is reserved as the *null block*: inactive decode slots point
their whole table at it and park their write offset there, so the
fixed-width decode needs no masking on the write path — dead slots
harmlessly overwrite scratch.
"""

import torch

# block id every table slot starts at (and dead slots stay at): the
# reserved scratch block the allocator never hands out
NULL_BLOCK = 0


class BlockAllocator:
    """Host-side free list over the preallocated KV blocks.

    Pure Python bookkeeping — nothing here touches the device.  The
    scheduler allocates a sequence's whole worst-case block budget at
    admission (prompt bucket plus the generation cap), which makes
    admission the ONLY place an out-of-blocks condition can surface;
    mid-decode the table is already paid for.
    """

    def __init__(self, num_blocks):
        assert num_blocks > 1, "need at least one block beyond the null block"
        self.num_blocks = int(num_blocks)
        # LIFO free list, block 0 excluded (the null block)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        # pool-occupancy high-water mark (allocatable blocks in use at
        # once, across the run) — the capacity-planning receipt
        self.used_peak = 0

    @property
    def capacity(self):
        """Allocatable blocks (the null block is not allocatable)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def used_blocks(self):
        return self.capacity - len(self._free)

    def allocate(self, n):
        """``n`` block ids, or None when the pool cannot cover them (the
        caller defers admission; never a partial grant)."""
        if n > len(self._free):
            return None
        taken = [self._free.pop() for _ in range(n)]
        if self.used_blocks > self.used_peak:
            self.used_peak = self.used_blocks
        return taken

    def release(self, blocks):
        for b in blocks:
            assert b != NULL_BLOCK, "the null block is never released"
            self._free.append(int(b))


def init_kv_cache(num_layers, num_blocks, block_size, heads, head_dim,
                  dtype=torch.float32, device=None):
    """The (k, v) cache tensors on ``device``, zero-initialized."""
    shape = (num_layers, num_blocks, block_size, heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def kv_cache_bytes(num_layers, num_blocks, block_size, heads, head_dim,
                   dtype=torch.float32):
    """Footprint of one engine's K+V buffers (capacity-planning aid)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * num_layers * num_blocks * block_size * heads * head_dim \
        * itemsize
