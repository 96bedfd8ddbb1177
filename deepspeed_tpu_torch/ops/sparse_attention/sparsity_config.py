"""Block-sparse attention layout configurations.

Port of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, class
for class and line for line (it is numpy and ``random`` only), kept as
the port's own copy so that the port imports nothing of the JAX package:
``SparsityConfig``, ``DenseSparsityConfig``, ``FixedSparsityConfig``,
``VariableSparsityConfig``, ``BigBirdSparsityConfig``,
``BSLongformerSparsityConfig`` and ``build_sparsity_config``.  A layout
is an int array ``[num_heads, num_blocks, num_blocks]`` where
``layout[h, i, j] == 1`` means query block ``i`` of head ``h`` attends to
key block ``j``.  Layouts are static host-side numpy arrays: the gather
path (``block_sparse.py``) turns them into index tensors and the Hopper
kernels (``flash_block_sparse.py``) into look-up tables on the device.
The random blocks of the Variable and BigBird patterns come from
Python's ``random.sample``, so with ``random.seed(n)`` set before
``make_layout`` both packages give the same layout.
"""

import random

import numpy as np


class SparsityConfig:
    """Base class: head count, block size, shared-vs-per-head layouts
    (reference ``sparsity_config.py:9-61``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        """Zeroed ``[num_heads, num_blocks, num_blocks]`` layout."""
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence Length, {seq_len}, needs to be dividable by "
                f"Block size {self.block}!")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        """Copy head 0's layout to every head when layouts are shared."""
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout


class DenseSparsityConfig(SparsityConfig):
    """All blocks active — dense attention expressed in the block-sparse
    framework, for comparison (reference ``:63-91``)."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed pattern from `Generative Modeling with Sparse Transformers`
    (arXiv:1904.10509), as customized by the reference (``:94-240``): local
    windows of ``num_local_blocks`` plus per-window global representative
    blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"Number of blocks in a local window, {num_local_blocks}, "
                f"must be dividable by number of global blocks, "
                f"{num_global_blocks}!")
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                'only "uni/bi-directional" attentions are supported for now!')
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                'only "bi-directional" attentions can support horizontal '
                "global attention!")
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "Number of different layouts cannot be more than one when "
                "you have set a single layout for all heads! Set "
                "different_layout_per_head to True.")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"Number of layout versions (num_different_global_patterns), "
                f"{num_different_global_patterns}, cannot be larger than "
                f"number of local window blocks divided by number of global "
                f"blocks, {num_local_blocks // num_global_blocks}!")
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h, layout):
        """Dense (or lower-triangular, if unidirectional) blocks within each
        ``num_local_blocks`` window."""
        num_blocks = layout.shape[1]
        uni = self.attention == "unidirectional"
        for start in range(0, num_blocks, self.num_local_blocks):
            end = min(start + self.num_local_blocks, num_blocks)
            w = end - start
            win = np.tril(np.ones((w, w), np.int64)) if uni else np.ones((w, w), np.int64)
            layout[h, start:end, start:end] |= win
        return layout

    def set_global_layout(self, h, layout):
        """Per-window global representative block columns (and rows when
        ``horizontal_global_attention``); heads rotate which block of the
        window is global when layouts differ per head."""
        num_blocks = layout.shape[1]
        first = self.num_local_blocks - (
            1 + h % self.num_different_global_patterns) * self.num_global_blocks
        end = num_blocks - (num_blocks % self.num_local_blocks)
        for i in range(first, end, self.num_local_blocks):
            first_row = 0 if self.attention == "bidirectional" else i
            layout[h, first_row:, i:i + self.num_global_blocks] = 1
            if self.horizontal_global_attention:
                layout[h, i:i + self.num_global_blocks, :] = 1
        if end < num_blocks:  # short last window
            start = min(end + first, num_blocks - self.num_global_blocks)
            stop = start + self.num_global_blocks
            first_row = 0 if self.attention == "bidirectional" else start
            layout[h, first_row:, start:stop] = 1
            if self.horizontal_global_attention:
                layout[h, start:stop, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Fixed pattern generalized with random blocks, variable-size local
    windows, and explicit global block indices (reference ``:243-418``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None else [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    f"Global block start indices length, "
                    f"{len(self.global_block_indices)}, must be same as global "
                    f"block end indices length, {len(global_block_end_indices)}!")
            for start_idx, end_idx in zip(self.global_block_indices,
                                          global_block_end_indices):
                if start_idx >= end_idx:
                    raise ValueError(
                        f"Global block start index, {start_idx}, must be "
                        f"smaller than global block end index, {end_idx}!")
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                'only "uni/bi-directional" attentions are supported for now!')
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                'only "bi-directional" attentions can support horizontal '
                "global attention!")
        self.horizontal_global_attention = horizontal_global_attention

    def set_random_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_random_blocks:
            raise ValueError(
                f"Number of random blocks, {self.num_random_blocks}, must be "
                f"smaller than overal number of blocks in a row, {num_blocks}!")
        for row in range(num_blocks):
            cols = random.sample(range(num_blocks), self.num_random_blocks)
            layout[h, row, cols] = 1
        return layout

    def set_local_layout(self, h, layout):
        num_blocks = layout.shape[1]
        uni = self.attention == "unidirectional"

        def fill(start, end):
            w = end - start
            if w <= 0:
                return
            win = np.tril(np.ones((w, w), np.int64)) if uni else np.ones((w, w), np.int64)
            layout[h, start:end, start:end] |= win

        start = 0
        size = self.local_window_blocks[-1]
        for size in self.local_window_blocks:
            fill(start, min(start + size, num_blocks))
            start += size
        for i in range(start, num_blocks, size):  # remaining windows reuse last size
            fill(i, min(i + size, num_blocks))
        return layout

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for start_idx, end_idx in spans:
            if start_idx >= num_blocks:
                continue
            end_idx = min(end_idx, num_blocks)
            if self.horizontal_global_attention:
                layout[h, start_idx:end_idx, :] = 1
            first_row = 0 if self.attention == "bidirectional" else start_idx
            layout[h, first_row:, start_idx:end_idx] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout)
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird pattern (arXiv:2007.14062): random + sliding window + ITC
    global blocks at the start of the sequence (reference ``:421-541``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks

    def set_random_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_random_blocks:
            raise ValueError(
                f"Number of random blocks, {self.num_random_blocks}, must be "
                f"smaller than overal number of blocks in a row, {num_blocks}!")
        for row in range(num_blocks):
            cols = random.sample(range(num_blocks), self.num_random_blocks)
            layout[h, row, cols] = 1
        return layout

    def set_sliding_window_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_sliding_window_blocks:
            raise ValueError(
                f"Number of sliding window blocks, "
                f"{self.num_sliding_window_blocks}, must be smaller than "
                f"overal number of blocks in a row, {num_blocks}!")
        w = self.num_sliding_window_blocks // 2
        rows = np.arange(num_blocks)[:, None]
        cols = np.arange(num_blocks)[None, :]
        layout[h] |= (np.abs(rows - cols) <= w).astype(np.int64)
        return layout

    def set_global_layout_itc(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_global_blocks:
            raise ValueError(
                f"Number of global blocks, {self.num_global_blocks}, must be "
                f"smaller than overal number of blocks in a row, {num_blocks}!")
        layout[h, :self.num_global_blocks, :] = 1
        layout[h, :, :self.num_global_blocks] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout)
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout_itc(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer (arXiv:2004.05150): sliding window + explicit
    symmetric global blocks (reference ``:544-663``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None else [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    f"Global block start indices length, "
                    f"{len(self.global_block_indices)}, must be same as global "
                    f"block end indices length, {len(global_block_end_indices)}!")
            for start_idx, end_idx in zip(self.global_block_indices,
                                          global_block_end_indices):
                if start_idx >= end_idx:
                    raise ValueError(
                        f"Global block start index, {start_idx}, must be "
                        f"smaller than global block end index, {end_idx}!")
        self.global_block_end_indices = global_block_end_indices

    def set_sliding_window_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_sliding_window_blocks:
            raise ValueError(
                f"Number of sliding window blocks, "
                f"{self.num_sliding_window_blocks}, must be smaller than "
                f"overal number of blocks in a row, {num_blocks}!")
        w = self.num_sliding_window_blocks // 2
        rows = np.arange(num_blocks)[:, None]
        cols = np.arange(num_blocks)[None, :]
        layout[h] |= (np.abs(rows - cols) <= w).astype(np.int64)
        return layout

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for start_idx, end_idx in spans:
            if start_idx >= num_blocks:
                continue
            end_idx = min(end_idx, num_blocks)
            layout[h, start_idx:end_idx, :] = 1
            layout[h, :, start_idx:end_idx] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


def build_sparsity_config(sparse_attention_dict, num_heads):
    """Parsed ``sparse_attention`` config section → SparsityConfig instance.

    This is how the json config's sparse-attention subsection (reference
    ``config.py:192-360``; the bing_bert flow hands it to
    ``SparseSelfAttention``) becomes a live layout object: the ``mode`` key
    selects the class, every other key is a constructor kwarg.
    """
    modes = {
        "dense": DenseSparsityConfig,
        "fixed": FixedSparsityConfig,
        "variable": VariableSparsityConfig,
        "bigbird": BigBirdSparsityConfig,
        "bslongformer": BSLongformerSparsityConfig,
    }
    kwargs = dict(sparse_attention_dict)
    mode = kwargs.pop("mode", "fixed")
    if mode not in modes:
        raise ValueError(f"unknown sparse attention mode {mode!r}; "
                         f"expected one of {sorted(modes)}")
    return modes[mode](num_heads=num_heads, **kwargs)
