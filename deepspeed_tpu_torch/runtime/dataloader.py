"""Data pipeline (port of ``deepspeed_tpu/runtime/dataloader.py``).

``RepeatingLoader`` restarts an iterator on ``StopIteration``;
``DeepSpeedDataLoader`` batches a map-style or iterable dataset into
micro-batches of host (numpy) arrays, with the sampler cursor
``(epoch, samples_yielded)`` that a resumed run re-enters.  Under data
parallelism every process iterates the dataset in the same seeded order
and keeps its contiguous slice of each global micro-batch (JAX
``dataloader.py:61-205``, the reference's ``DistributedSampler`` made
batch-wise); the cursor counts global samples, so a run resumes at
another data-parallel degree.  Given the data-parallel process group,
the loader checks on an epoch's first batch that every rank iterates
the same order (``DS_VERIFY_DATA_ORDER``, JAX ``dataloader.py:143-195``).
"""

import logging
import os
import zlib

import numpy as np

logger = logging.getLogger(__name__)

_END = object()


class RepeatingLoader:
    """Wrap an iterator to restart on StopIteration."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


def _stack_samples(samples):
    """Default collate: stack leaves of identically-structured samples."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_samples([s[i] for s in samples])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack_samples([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Batches a dataset (a sequence, a torch ``Dataset`` or an iterable
    of samples) into global micro-batches of ``batch_size`` (the
    micro-batch per rank × ``data_parallel_world_size``), of which this
    process yields its ``data_parallel_rank``-th slice; a seeded shuffle
    makes an epoch's order a pure function of ``(seed, epoch)``.
    ``group`` is the data-parallel process group the order check
    gathers over (None: no check)."""

    def __init__(self, dataset, batch_size, collate_fn=None, shuffle=False,
                 seed=0, drop_last=True, data_parallel_world_size=1,
                 data_parallel_rank=0, group=None):
        world = max(int(data_parallel_world_size), 1)
        if not 0 <= data_parallel_rank < world:
            raise ValueError(f"data_parallel_rank {data_parallel_rank} is "
                             f"outside a world of {world}")
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} does not split over "
                             f"{world} data-parallel processes")
        self.world = world
        self.rank = data_parallel_rank
        self.group = group
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _stack_samples
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.samples_yielded = 0
        self._pending_state = None
        try:
            n = len(dataset)
            self.len = n // batch_size if drop_last else -(-n // batch_size)
        except TypeError:
            self.len = None

    def __len__(self):
        if self.len is None:
            raise TypeError("underlying dataset has no length")
        return self.len

    def state_dict(self):
        """The cursor in the seeded sample stream: live epoch and the
        samples it has yielded."""
        return {"epoch": int(self.epoch),
                "samples_yielded": int(self.samples_yielded)}

    def load_state_dict(self, state):
        """Arm a resume: the next ``__iter__`` re-enters ``state``'s epoch
        (same seeded order) and skips the samples already consumed."""
        if not state:
            return
        self._pending_state = {
            "epoch": int(state.get("epoch", 0)),
            "samples_yielded": int(state.get("samples_yielded", 0))}

    def _sample_iter(self):
        try:
            n = len(self.dataset)
        except TypeError:
            yield from iter(self.dataset)
            return
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self._verify_shared_order(order)
        for i in order:
            yield self.dataset[int(i)]

    @staticmethod
    def order_fingerprint(order):
        """Deterministic 32-bit fingerprint of an iteration order (CRC-32
        over the int64 index bytes, the JAX package's); identical across
        processes iff the orders are identical."""
        return zlib.crc32(np.ascontiguousarray(
            np.asarray(order, np.int64)).tobytes()) & 0xFFFFFFFF

    def _verify_shared_order(self, order):
        """Every data-parallel rank must iterate the dataset in the SAME
        order — each keeps its slice of every global batch, so a rank
        seeded differently trains on duplicated or missing shards with
        no error.  One all-gather of the order's fingerprint over the
        data group turns that into a loud failure on the epoch's first
        batch.  ``DS_VERIFY_DATA_ORDER``: ``epoch0`` (the default)
        checks the first epoch only, ``always`` every epoch, ``never``
        disables.  A world of one never gathers."""
        if self.world <= 1 or self.group is None:
            return
        mode = os.environ.get("DS_VERIFY_DATA_ORDER", "epoch0")
        if mode not in ("epoch0", "always", "never"):
            logger.warning(
                f"DS_VERIFY_DATA_ORDER={mode!r} is not one of "
                "epoch0/always/never; treating as 'epoch0'")
            mode = "epoch0"
        if mode == "never" or (mode == "epoch0" and self.epoch > 1):
            return
        import torch
        import torch.distributed as dist

        # one uint32 in an int64 word (gloo has no uint32); on the card
        # under NCCL
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(self.group) == "nccl"
                  else torch.device("cpu"))
        fp = torch.tensor([self.order_fingerprint(order)],
                          dtype=torch.int64, device=device)
        gathered = [torch.empty_like(fp)
                    for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(gathered, fp, group=self.group)
        fps = torch.cat(gathered).tolist()
        if len(set(fps)) > 1:
            raise RuntimeError(
                f"data-parallel dataloader order drift: per-rank order "
                f"fingerprints differ ({fps}); every rank must construct "
                f"the loader with the same dataset, seed, and shuffle flag")

    def __iter__(self):
        resume = self._pending_state
        self._pending_state = None
        skip = 0
        if resume is not None and resume["epoch"] >= 1:
            self.epoch = resume["epoch"]
            skip = resume["samples_yielded"]
        else:
            self.epoch += 1
        self.samples_yielded = skip
        it = self._sample_iter()
        for _ in range(skip):
            if next(it, _END) is _END:
                break
        samples = []
        for sample in it:
            samples.append(sample)
            if len(samples) == self.batch_size:
                self.samples_yielded += self.batch_size
                yield self.collate_fn(self._process_slice(samples))
                samples = []
        if samples and not self.drop_last:
            # a ragged tail splits only in whole rows a process
            keep = len(samples) // self.world * self.world
            if keep:
                self.samples_yielded += keep
                yield self.collate_fn(self._process_slice(samples[:keep]))

    def _process_slice(self, samples):
        """This process's contiguous slice of one global batch's
        samples."""
        per = len(samples) // self.world
        return samples[self.rank * per:(self.rank + 1) * per]
