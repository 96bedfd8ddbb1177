"""Activation checkpointing: recompute a layer in backward instead of
keeping its activations (port of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``).

The JAX package expresses recompute-in-backward as ``jax.checkpoint``
with a remat policy; here it is ``torch.utils.checkpoint.checkpoint``
with ``use_reentrant=False`` (the reentrant form drops the gradients of
parameters handed in inside a dict, which is how the models pass them).
Only the wrapped function's tensor arguments are kept for backward;
everything it computes is recomputed there.  The knobs of the
``activation_checkpointing`` block:

- ``number_checkpoints``: checkpoint only that many evenly spaced layers
  (:func:`should_checkpoint_layer`), every layer when unset;
- ``cpu_checkpointing``: the kept layer inputs go to pinned host memory
  between forward and backward, through
  ``torch.autograd.graph.saved_tensors_hooks`` around the checkpoint
  call.  Only the wrapped function's tensor arguments (or those
  ``argnums`` picks) pass through those hooks, never the weights, which
  the models hand in inside a dict and which stay where they are;
- ``partition_activations``: above one rank of the current mesh's
  ``model`` axis, each rank keeps only its ``1/m`` of a kept input's dim
  1 (the sequence of ``[b, s, h]``; JAX ``:105-113`` shards it so), and
  backward all-gathers the slices before the recompute, through the
  same saved-tensor hooks (so a dim 1 that ``m`` does not divide is
  kept whole).  The gathered input is the input, so the run is bitwise
  the run without it.  At one ``model`` rank it is no change, as in the
  JAX package on a mesh whose ``model`` axis is 1.
  ``partition_stats`` counts the bytes the hooks were handed and kept;
- ``contiguous_memory_optimization``, ``synchronize_checkpoint_boundary``
  and ``profile`` are parsed and have no effect, as in the JAX package.

Randomness: ``torch.utils.checkpoint`` restores only the global RNG
states before it recomputes.  The models draw their dropout from their
own ``torch.Generator`` objects, so a checkpointed layer builds its
generator inside the checkpointed function from an integer seed, and a
checkpointed sub-block replays its generator's state
(``models/layers.py``): the recompute draws the forward's masks.

API parity with the reference's ``deepspeed.checkpointing``:
:func:`configure`, :func:`get_config`, :func:`is_configured`,
:func:`checkpoint`; :func:`checkpoint_wrapper` is the form the models
use.
"""

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from ...comm import all_gather, axis_index, axis_size
from ...parallel.mesh import MODEL_AXIS, get_current_mesh

from .config import DeepSpeedActivationCheckpointingConfig

# the module config, as the reference's checkpointing globals
_config = DeepSpeedActivationCheckpointingConfig({})


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None,
              act_config=None):
    """Set the module config (the reference's ``checkpointing.configure``):
    a parsed config (the engine's path) and/or the reference's keyword
    overrides (a client's)."""
    global _config
    if act_config is not None:
        _config = act_config
    if partition_activations is not None:
        _config.partition_activations = partition_activations
    if contiguous_checkpointing is not None:
        _config.contiguous_memory_optimization = contiguous_checkpointing
    if num_checkpoints is not None:
        _config.number_checkpoints = num_checkpoints
    if checkpoint_in_cpu is not None:
        _config.cpu_checkpointing = checkpoint_in_cpu
    if synchronize is not None:
        _config.synchronize_checkpoint_boundary = synchronize
    if profile is not None:
        _config.profile = profile
    return _config


def get_config():
    return _config


def is_configured():
    return _config is not None


def should_checkpoint_layer(index, num_layers, cfg=None):
    """``number_checkpoints`` spreads exactly k checkpoints evenly over
    the stack (the reference's ``num_checkpoints``); unset, every
    layer."""
    cfg = cfg or _config
    k = cfg.number_checkpoints
    if not k or k >= num_layers:
        return True
    return index in {round(j * num_layers / k) for j in range(k)}


# bytes handed to the partitioning hooks and bytes they kept (the
# ``partition_activations`` receipt)
partition_stats = {"full_bytes": 0, "kept_bytes": 0}


def _offload_hooks(selected, offload=True, mesh=None):
    """Saved-tensor hooks for the tensors in ``selected`` (by identity):
    with ``mesh`` (``partition_activations`` above one ``model`` rank)
    each keeps only this rank's slice of its dim 1 and backward
    all-gathers the slices; with ``offload`` (``cpu_checkpointing``) what
    is kept waits in host memory, pinned when it comes from the card,
    and goes back to its device when backward unpacks it.  Other saved
    tensors pass through."""
    m = axis_size(MODEL_AXIS, mesh) if mesh is not None else 1

    def pack(t):
        if id(t) not in selected:
            return None, False, t
        split = m > 1 and t.dim() >= 2 and t.shape[1] % m == 0
        if split:
            partition_stats["full_bytes"] += t.numel() * t.element_size()
            t = t.chunk(m, dim=1)[axis_index(MODEL_AXIS, mesh)].clone()
            partition_stats["kept_bytes"] += t.numel() * t.element_size()
        if not offload:
            return t.device, split, t
        host = torch.empty(t.size(), dtype=t.dtype, layout=t.layout,
                           pin_memory=t.is_cuda)
        host.copy_(t, non_blocking=t.is_cuda)
        return t.device, split, host

    def unpack(packed):
        device, split, t = packed
        if device is None:
            return t
        t = t.to(device, non_blocking=device.type == "cuda")
        if not split:
            return t
        parts = all_gather(t.movedim(1, 0), MODEL_AXIS, mesh=mesh)
        return parts.movedim(0, 1).contiguous()

    return torch.autograd.graph.saved_tensors_hooks(pack, unpack)


def checkpoint_wrapper(fn, cfg=None, argnums=None):
    """``fn`` recomputed in backward under the config's knobs.  Under
    ``cpu_checkpointing`` its tensor arguments (or, with ``argnums``,
    the arguments at those positions) wait for backward in host memory.
    By the models' convention ``fn(params_dict, x, ...)``, that is the
    layer input and never a weight."""
    cfg = cfg or _config

    def wrapped(*args, **kwargs):
        mesh = get_current_mesh()
        partition = (cfg.partition_activations and mesh is not None
                     and mesh.size(MODEL_AXIS) > 1)
        if not (cfg.cpu_checkpointing or partition):
            return _torch_checkpoint(fn, *args, use_reentrant=False,
                                     **kwargs)
        selected = {id(a) for i, a in enumerate(args)
                    if isinstance(a, torch.Tensor)
                    and (argnums is None or i in argnums)}
        hooks = (_offload_hooks(selected, offload=cfg.cpu_checkpointing,
                                mesh=mesh) if partition
                 else _offload_hooks(selected))
        with hooks:
            return _torch_checkpoint(fn, *args, use_reentrant=False,
                                     **kwargs)

    return wrapped


def checkpoint(function, *args):
    """The reference API's immediate form
    (``deepspeed.checkpointing.checkpoint``)."""
    return checkpoint_wrapper(function)(*args)
