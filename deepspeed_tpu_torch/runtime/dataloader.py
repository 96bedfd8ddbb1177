"""Data pipeline (port of ``deepspeed_tpu/runtime/dataloader.py``).

``RepeatingLoader`` restarts an iterator on ``StopIteration``;
``DeepSpeedDataLoader`` batches a map-style or iterable dataset into
micro-batches of host (numpy) arrays, with the sampler cursor
``(epoch, samples_yielded)`` that a resumed run re-enters.  One process
feeds the one card here; splitting batches over data-parallel processes
is ROADMAP A5.
"""

import numpy as np

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
    of samples) into micro-batches of ``batch_size``; a seeded shuffle
    makes an epoch's order a pure function of ``(seed, epoch)``."""

    def __init__(self, dataset, batch_size, collate_fn=None, shuffle=False,
                 seed=0, drop_last=True, data_parallel_world_size=1):
        if data_parallel_world_size != 1:
            raise NotImplementedError(
                "splitting batches over data-parallel processes is not "
                "ported yet (ROADMAP A5)")
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
        for i in order:
            yield self.dataset[int(i)]

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
                yield self.collate_fn(samples)
                samples = []
        if samples and not self.drop_last:
            self.samples_yielded += len(samples)
            yield self.collate_fn(samples)
