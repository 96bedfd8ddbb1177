"""Error-feedback 1-bit all-reduce (port of
``deepspeed_tpu/comm/compression.py:25-150``; the reference's
``Compressed_Allreduce``, ``deepspeed/runtime/fp16/onebit_adam.py:104-228``).

Each rank sends only the sign of its error-compensated buffer and one
scale; each rank then serves one ``1/world`` chunk: it averages the
ranks' signed chunks, compresses that again with its own error
feedback, and every rank gathers the served chunks::

    phase 1 (worker -> server):  all_to_all of packed sign chunks
                                 + all_gather of the worker scales
    phase 2 (server -> worker):  all_gather of the packed server signs
                                 + all_gather of the server scales

Signs are packed 8 to a ``uint8``, most significant bit first (as
``numpy.packbits``), so the wire carries 1/32 of the fp32 bytes.  The
transport is :mod:`deepspeed_tpu_torch.comm` over a mesh's ``data``
axis: NCCL on the card, gloo on the CPU.  Everything here runs outside
autograd, in the optimizer step.
"""

import numpy as np
import torch

from . import all_gather, all_to_all, axis_index, axis_size, psum

def _weights(device):
    """128, 64, ..., 1 (MSB first), made on ``device`` (no copy from the
    host, which would wait for the card)."""
    return (1 << torch.arange(7, -1, -1, device=device)).to(torch.uint8)


def pack_signs(bits):
    """[n] bool (True = +1) -> [n/8] uint8, MSB first like ``packbits``."""
    n = bits.shape[0]
    if n % 8:
        raise ValueError(f"sign buffer length {n} not divisible by 8")
    b = bits.reshape(n // 8, 8).to(torch.uint8)
    return (b * _weights(bits.device)).sum(-1, dtype=torch.uint8)


def unpack_signs(packed):
    """[..., m] uint8 -> [..., m*8] +-1.0 fp32, MSB first."""
    bits = (packed[..., None] // _weights(packed.device)) % 2
    return bits.reshape(*packed.shape[:-1], -1).float() * 2.0 - 1.0


def _compress(buf, error, scale_over=None):
    """Error-feedback sign compression: ``(sign bits, scale, new
    error)``, with scale = ||buf + error|| / sqrt(n), +1 at 0, and the
    quantization residual as the next round's error (reference
    ``onebit_adam.py:122-127``).  The norm sums in fp64: torch's fp32
    norm on the CPU drifts as the buffer grows, and every element of
    the result is +-scale.  ``scale_over``, ``(weights, axes, mesh)``:
    the scale is the weighted RMS sqrt(Σ w·x² / Σ w) with both sums
    taken over ``axes`` too (one all-reduce)."""
    comp = buf + error
    n = comp.shape[0]
    if scale_over is None:
        scale = (torch.linalg.vector_norm(comp, dtype=torch.float64)
                 / np.sqrt(n)).float()
    else:
        w, axes, mesh = scale_over
        sums = psum(torch.stack([(w * comp * comp).sum(dtype=torch.float64),
                                 w.sum(dtype=torch.float64)]), axes, mesh)
        scale = (sums[0] / sums[1].clamp_min(1.0)).sqrt().float()
    sign_bits = comp >= 0
    signs = sign_bits.float() * 2.0 - 1.0
    return sign_bits, scale, comp - scale * signs


def padded_size(n, world):
    """The smallest size >= ``n`` divisible by ``8 * world``: 8 signs a
    byte, one equal chunk per serving rank.  The error buffers live at
    this size; :func:`compressed_allreduce` pads and trims the data."""
    q = 8 * int(world)
    return -(-int(n) // q) * q


def compressed_allreduce(buf, worker_error, server_error, axis_name,
                         mesh=None, scale_axes=None, weights=None):
    """1-bit error-feedback mean all-reduce of the 1-D fp32 ``buf`` over
    ``axis_name``.  ``worker_error`` is this rank's ``[padded_size(n,
    world)]`` residual and ``server_error`` its ``[padded_size / world]``
    one, both carried across steps.  Returns ``(out, new_worker_error,
    new_server_error)``: ``out`` is the ``[n]`` approximation of the
    ranks' mean, the same on every rank.

    ``scale_axes`` (a tuple of other axes, whose ranks hold other parts
    of one buffer: ``model``, ``expert``, ``pipe``) with ``weights``
    (``[n]``, 1 where this rank counts an element, 0 where another rank
    counts its copy): the worker scale is the weighted RMS of the
    compensated buffer over those axes, and the server scale the
    weighted RMS of every served chunk over ``axis_name`` and those
    axes, so an element that several ranks hold, compressed with the
    same value and error on each, gets the same result on each."""
    world = axis_size(axis_name, mesh)
    n = buf.shape[0]
    n_pad = padded_size(n, world)
    if worker_error.shape[0] != n_pad:
        raise ValueError(f"worker_error size {worker_error.shape[0]} must "
                         f"be padded_size(n={n}, world={world}) = {n_pad}")
    if server_error.shape[0] * world != n_pad:
        raise ValueError(f"server_error size {server_error.shape[0]} must "
                         f"be padded_size(n={n}, world={world})/world = "
                         f"{n_pad // world}")
    if n_pad != n:
        buf = torch.cat([buf, buf.new_zeros(n_pad - n)])
    worker_over = server_over = None
    if scale_axes:
        w = weights.float()
        if n_pad != n:
            w = torch.cat([w, w.new_zeros(n_pad - n)])
        chunk = n_pad // world
        r = axis_index(axis_name, mesh)
        worker_over = (w, tuple(scale_axes), mesh)
        server_over = (w[r * chunk:(r + 1) * chunk],
                       (axis_name, *scale_axes), mesh)
    # worker compression (reference :118-127)
    sign_bits, worker_scale, new_worker_error = _compress(buf, worker_error,
                                                          worker_over)
    # phase 1: chunk r of every rank's signs to rank r (reference :146-165)
    chunks = pack_signs(sign_bits).reshape(world, n_pad // 8 // world)
    recv = all_to_all(chunks, axis_name, 0, 0, mesh=mesh)
    scales = all_gather(worker_scale.reshape(1), axis_name, mesh=mesh)
    # server: the mean of the signed chunks, compressed again (:174-193)
    compensated = torch.einsum("w,wn->n", scales / world, unpack_signs(recv))
    srv_bits, server_scale, new_server_error = _compress(
        compensated, server_error, server_over)
    # phase 2: every rank gathers the served chunks (:202-214)
    all_packed = all_gather(pack_signs(srv_bits)[None], axis_name,
                            mesh=mesh)
    all_scales = all_gather(server_scale.reshape(1), axis_name, mesh=mesh)
    out = (unpack_signs(all_packed) * all_scales[:, None]).reshape(n_pad)
    return out[:n], new_worker_error, new_server_error


def buffer_bytes(n, world):
    """The bytes of the buffers that :func:`compressed_allreduce` of ``n``
    elements hands its collectives, as ``comm.counter`` counts them: the
    packed signs of each phase (``padded_size(n, world) / 8``, 1/32 of
    the fp32 buffer) and the two gathered fp32 scale vectors.  A dense
    fp32 all-reduce's is ``4 n``, so the ratio is about 1/16."""
    return 2 * (padded_size(n, world) // 8) + 2 * 4 * int(world)


def compressed_allreduce_reference(bufs, worker_errors, server_errors):
    """Host (numpy, fp64) simulation of the same algorithm over
    ``len(bufs)`` ranks, for tests: ``(out, new_worker_errors,
    new_server_errors)``."""
    bufs = [np.asarray(b, np.float64) for b in bufs]
    world = len(bufs)
    n = bufs[0].shape[0]
    signs, scales, new_werrs = [], [], []
    for b, e in zip(bufs, worker_errors):
        comp = b + np.asarray(e, np.float64)
        scale = np.linalg.norm(comp) / np.sqrt(n)
        s = np.where(comp >= 0, 1.0, -1.0)
        new_werrs.append(comp - scale * s)
        signs.append(s)
        scales.append(scale)
    chunk = n // world
    outs, new_serrs = [], []
    for r in range(world):
        comp = sum(scales[w] / world * signs[w][r * chunk:(r + 1) * chunk]
                   for w in range(world))
        comp = comp + np.asarray(server_errors[r], np.float64)
        sscale = np.linalg.norm(comp) / np.sqrt(chunk)
        ss = np.where(comp >= 0, 1.0, -1.0)
        new_serrs.append(comp - sscale * ss)
        outs.append(sscale * ss)
    return np.concatenate(outs), new_werrs, new_serrs
