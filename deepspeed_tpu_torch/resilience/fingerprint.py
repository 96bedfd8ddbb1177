"""The state fingerprint the fleet integrity plane votes on (port of the
checksum in ``deepspeed_tpu/runtime/engine.py:1163-1224`` and
``deepspeed_tpu/inference/resilience.py:195-244``), in torch ops on the
tensors' own device.

The value is a position-weighted sum of the raw bits of every leaf in
uint32 wraparound arithmetic::

    Σ_leaves Σ_i bits(x_i) · w_i  mod 2³²,
    w_i = (i · 2654435761 mod 2³²) | 1

with ``i`` counted from 0 in each leaf.  A 2-byte leaf is read as 16-bit
words and widened, a 1-byte or bool leaf as bytes, a 4-byte leaf as one
word and an 8-byte leaf as a pair of words.  Integer math, so replicas
that are bit-identical give identical fingerprints on any device, and
since every weight is odd (a unit mod 2³²) a single flipped bit
anywhere changes the sum; the Knuth multiplier makes element swaps
visible too.  On the same leaves in the same order it equals the JAX
function bit for bit.

Since ``i · K`` is odd exactly when ``i`` is, ``w_i = (i · K mod 2³²)
+ [i even]``, so the sum is linear in the positions::

    K · Σ_i i · bits(x_i)  +  Σ_{i even} bits(x_i)   mod 2³²

and no weight is ever formed.  Each leaf's words, widened to 32 bits,
are laid out as rows of :data:`COLS` (word ``i`` at the leaf's row
``i // COLS``, column ``c``), the last row padded with zero words, and
read as bytes: one int8 matrix product per run of rows, against a fixed
``(4 · COLS, 16)`` matrix, gives each row's sums of each byte position
``b`` weighted by 1, ``c mod 64``, ``c div 64`` and ``[c even]``,
exactly in int32 (each at most ``2¹⁴ · 128 · 127``).  The words are
XORed with ``0x80808080`` first, which makes each byte a signed int8
exactly 128 below its unsigned value, so a word is its bytes' value
plus ``0x80808080``: that constant, over every slot, is added from the
rows' count on the host.  Runs pack whole rows of one word size, many
small leaves to a run, and a big 32-bit leaf's full rows are XORed
straight from the leaf: a run's XORed 32-bit copy (64 MB) is its
temporary, the product reads it once, and what is left is int64
arithmetic on a 16-wide row a row, with each row's index in its leaf,
after the last run.  Rows that pad a run to the product's minimum of
17 are zero words.  The result is a 0-d int64 tensor on the device: the
caller folds it into a fetch it makes anyway.
"""

import torch

KNUTH = 2654435761
MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF
COLS = 1 << 12          # words a row
CHUNK = 1 << 24         # words a run (whole rows, 32 or more): 64 MB
MIN_ROWS = 32           # a product needs more than 16 rows
FLIP = 0x80808080 - (1 << 32)        # the XOR mask as an int32
_CACHE = {}


def _words(leaf):
    """The leaf's bits as a flat tensor of words: bytes for 1-byte and
    bool leaves, 16-bit words for 2-byte leaves, 32-bit words otherwise
    (an 8-byte element is two of them)."""
    x = leaf.detach()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    x = x.reshape(-1)
    if not x.is_contiguous():
        x = x.contiguous()
    size = x.element_size()
    if size >= 4:
        return x.view(torch.int32)
    if size == 2:
        return x.view(torch.int16)
    return x.view(torch.uint8)


def _byte_weights(device):
    """``(4 · COLS, 16)`` int8, column-major: byte ``b`` of column ``c``
    (row ``4c + b``) against column ``4k + b`` holds weight ``k`` of
    ``c``: 1, ``c mod 64``, ``c div 64``, ``[c even]``."""
    key = ("weights", str(device))
    if key not in _CACHE:
        # made on the device: a copy from the host would synchronize
        rows = torch.arange(4 * COLS, device=device)
        c, b = rows // 4, rows % 4
        w = torch.zeros(4 * COLS, 16, dtype=torch.int8, device=device)
        for k, weight in enumerate((torch.ones_like(c), c % 64, c // 64,
                                    (c % 2 == 0).long())):
            w[rows, 4 * k + b] = weight.to(torch.int8)
        _CACHE[key] = w.t().contiguous().t()
    return _CACHE[key]


def _byte_scale(device):
    """``256^b`` for the byte positions ``b`` of a word, int64."""
    key = ("scale", str(device))
    if key not in _CACHE:
        _CACHE[key] = torch.ones(4, dtype=torch.int64, device=device) \
            .bitwise_left_shift_(torch.arange(0, 32, 8, device=device))
    return _CACHE[key]


def _zeros(device, dtype):
    """``MIN_ROWS`` rows of zero words of ``dtype``, to pad with."""
    key = ("zeros", str(device), dtype)
    if key not in _CACHE:
        _CACHE[key] = torch.zeros(MIN_ROWS * COLS, dtype=dtype,
                                  device=device)
    return _CACHE[key]


def _segments(words, chunk):
    """``(words, first row)`` pieces of a leaf's words, each at most
    ``chunk`` words and starting at a row."""
    rows = chunk // COLS
    for first in range(0, -(-words.numel() // COLS), rows):
        yield words[first * COLS:(first + rows) * COLS], first


def _runs(leaves):
    """Lists of ``(words, first row, rows)`` segments, in order, of one
    word dtype and at most ``CHUNK`` words of whole rows each."""
    run, run_rows = [], 0
    for leaf in leaves:
        for seg, first in _segments(_words(leaf), CHUNK):
            rows = -(-seg.numel() // COLS)
            if run and (run[0][0].dtype != seg.dtype
                        or (run_rows + rows) * COLS > CHUNK):
                yield run
                run, run_rows = [], 0
            run.append((seg, first, rows))
            run_rows += rows
    if run:
        yield run


def _product(run, index):
    """The run's int32 ``(rows, 16)`` byte sums, its rows' indices in
    their leaves (``index`` sliced: a view for each segment), and its
    rows' count and index sum, padding rows (index 0) included."""
    (seg, first, rows), device = run[0], run[0][0].device
    if (len(run) == 1 and seg.dtype == torch.int32 and rows >= MIN_ROWS
            and seg.numel() == rows * COLS):
        flipped = torch.bitwise_xor(seg, FLIP)
        return (torch._int_mm(flipped.view(torch.int8).view(rows, 4 * COLS),
                              _byte_weights(device)),
                [index[first:first + rows]], rows,
                rows * first + rows * (rows - 1) // 2)
    pieces, rows_of, total, index_sum = [], [], 0, 0
    zeros = _zeros(device, seg.dtype)
    for seg, first, rows in run:
        pieces.append(seg)
        if rows * COLS > seg.numel():
            pieces.append(zeros[:rows * COLS - seg.numel()])
        rows_of.append(index[first:first + rows])
        total += rows
        index_sum += rows * first + rows * (rows - 1) // 2
    if total < MIN_ROWS:
        pieces.append(zeros[:(MIN_ROWS - total) * COLS])
        rows_of.append(_zeros(device, torch.int64)[:MIN_ROWS - total])
        total = MIN_ROWS
    flipped = torch.cat(pieces)
    if flipped.dtype != torch.int32:
        flipped = flipped.to(torch.int32)
        if seg.dtype == torch.int16:
            flipped.bitwise_and_(MASK16)
    flipped.bitwise_xor_(FLIP)
    return (torch._int_mm(flipped.view(torch.int8).view(total, 4 * COLS),
                          _byte_weights(device)),
            rows_of, total, index_sum)


def _mul32(a, b):
    """``a · b mod 2³²`` for an int64 tensor ``a`` in ``[0, 2³²)`` and an
    int ``b`` in ``[0, 2³²)``, over ``b``'s 16-bit halves."""
    high = (a * (b >> 16)).bitwise_and_(MASK16).bitwise_left_shift_(16)
    return (a * (b & MASK16)).add_(high).bitwise_and_(MASK32)


def fingerprint(leaves):
    """The fingerprint of ``leaves`` (tensors, or Python ints taken as
    int32 scalars, in the order given) as a 0-d int64 tensor in
    ``[0, 2³²)`` on the tensors' device.  No host sync."""
    tensors = [x for x in leaves if torch.is_tensor(x) and x.numel()]
    device = tensors[0].device if tensors else torch.device("cpu")
    scalar = sum(int(x) & MASK32 for x in leaves if not torch.is_tensor(x))
    even = torch.full((), scalar & MASK32, dtype=torch.int64, device=device)
    if not tensors:
        return even
    longest = max(-(-_words(x).numel() // COLS) for x in tensors)
    index = torch.arange(longest, dtype=torch.int64, device=device)
    products, rows_of, rows, index_sum = [], [], 0, 0
    for run in _runs(tensors):
        p, r, n, s = _product(run, index)
        products.append(p)
        rows_of += r
        rows += n
        index_sum += s
    # each row's sums over its XORed words, by weight: Σ_b 256^b · byte
    # sum, below 2⁵⁶
    by_row = (torch.cat(products).to(torch.int64).view(-1, 4, 4)
              * _byte_scale(device)).sum(2)
    total, lo, hi, evens = by_row.unbind(1)
    # Σ_i i · word = Σ_rows (COLS · r · total_row + Σ_c c · word_c), r
    # the row's index in its leaf
    weighted = (total.bitwise_and_(MASK32).mul_(torch.cat(rows_of))
                .bitwise_and_(MASK32).sum().bitwise_and_(MASK32).mul_(COLS)
                + hi.mul_(64).add_(lo).bitwise_and_(MASK32).sum())
    even.add_(evens.bitwise_and_(MASK32).sum())
    # the XOR's 0x80808080 back over every slot, padding included: a row
    # of index r holds positions r · COLS + c
    weighted.add_(0x80808080 * (COLS * COLS * index_sum
                                + rows * (COLS * (COLS - 1) // 2)) & MASK32)
    even.add_(0x80808080 * (rows * COLS // 2) & MASK32)
    return _mul32(weighted.bitwise_and_(MASK32), KNUTH).add_(
        even.bitwise_and_(MASK32)).bitwise_and_(MASK32)
