"""Host-side checkpoint snapshots (port of
``deepspeed_tpu/checkpoint/snapshot.py``).

:func:`capture_engine_snapshot` gathers the engine's state from the
device ONCE (the only part of a save that must block training) and
returns an immutable :class:`CheckpointSnapshot` of plain numpy arrays
and JSON-able metadata that a background writer thread serializes
without touching live engine state or any CUDA tensor.  Client state is
pickled eagerly for the same reason.

The files are the JAX package's, key for key (``meta.json`` with the
loss scaler's state and the skipped-step count): model states in their
NATIVE dtype, keyed by the ``/``-joined tree path; the flat fp32 master
and the optimizer's moments unpadded (so a checkpoint loads at another
ZeRO stage or data-parallel degree); the optimizer's step as a 0-d
int32 under ``opt/.step`` (a NamedTuple field's path key in JAX keeps
its leading dot).  numpy has no bfloat16 (and this package does not
need ``ml_dtypes``), so a bf16 leaf is stored as its 16-bit words with
``"bfloat16"`` under ``model_dtypes`` in ``meta.json`` and the manifest;
:func:`load_model_states` reverses this into torch tensors.
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import torch

from .constants import (CLIENT_STATE_PKL, META_JSON, MODEL_STATES_NPZ,
                        OPTIM_STATES_NPZ)

def encode_array(t):
    """A CPU tensor -> (npz-safe numpy array, recorded dtype name or
    None): a bf16 tensor as its 16-bit words under ``"bfloat16"``, the
    name and word width the JAX package records for it."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def decode_array(arr, dtype_name):
    """Inverse of :func:`encode_array`: a CPU tensor in the recorded
    dtype (numpy-native arrays pass through ``torch.from_numpy``)."""
    arr = np.ascontiguousarray(arr)
    if dtype_name is None:
        return torch.from_numpy(arr)
    if dtype_name != "bfloat16":
        raise TypeError(f"cannot decode dtype {dtype_name!r}")
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


class CheckpointSnapshot:
    """Immutable host copy of everything one checkpoint contains."""

    __slots__ = ("tag", "model_states", "model_dtypes", "optim_states",
                 "meta", "client_state_pkl", "save_latest")

    def __init__(self, tag, model_states, model_dtypes, optim_states, meta,
                 client_state_pkl=None, save_latest=True):
        self.tag = str(tag)
        self.model_states = model_states
        self.model_dtypes = model_dtypes
        self.optim_states = optim_states
        self.meta = meta
        self.client_state_pkl = client_state_pkl
        self.save_latest = bool(save_latest)

    @property
    def global_steps(self):
        return int(self.meta.get("global_steps", -1))

    def file_writers(self):
        """Ordered {filename: fn(file_object)} for the atomic writer."""
        writers = {
            MODEL_STATES_NPZ:
                lambda f: np.savez(f, **self.model_states),
            OPTIM_STATES_NPZ:
                lambda f: np.savez(f, **self.optim_states),
            META_JSON:
                lambda f: f.write(json.dumps(self.meta, indent=2).encode()),
        }
        if self.client_state_pkl is not None:
            writers[CLIENT_STATE_PKL] = (
                lambda f: f.write(self.client_state_pkl))
        return writers

    def manifest_extra(self):
        return {"global_steps": self.global_steps,
                "model_dtypes": self.model_dtypes}


def state_fields(state):
    """{field name: value} of an optimizer state dataclass, without
    copying tensors."""
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def capture_engine_snapshot(engine, tag, client_state=None, save_latest=True):
    """Gather engine state to the host and freeze it as a snapshot: the
    compute params in ONE device->host copy of their flat buffer, the
    master and each flat optimizer buffer unpadded on the device and
    then copied once each.  Under offload they are read from the host
    buffers once the copies to them landed, upcast to fp32 (exact), and
    error-feedback residuals go under ``qres/<name>`` with the storage
    layout under ``offload_state_dtype`` in ``meta.json``, as the JAX
    package writes them (its ``snapshot.py:156-166``)."""
    engine._sync_host()
    model_states, model_dtypes = {}, {}
    for key, leaf in engine._params_to_host().items():
        enc, dtype_name = encode_array(leaf)
        model_states[key] = enc
        if dtype_name is not None:
            model_dtypes[key] = dtype_name

    optim_states = {"master": engine._gather_unpadded(engine.master)}
    local = engine._rank_local_fields()
    for name, leaf in state_fields(engine.opt_state).items():
        key = f"opt/.{name}"
        if name in local:
            # every rank's own buffer, stacked [dp, ...] (1-bit Adam's
            # error feedback, as the JAX engine stores it)
            optim_states[key] = engine._gather_rank_local(leaf)
        elif isinstance(leaf, torch.Tensor):
            # a flat buffer in the master's layout: saved unpadded
            optim_states[key] = engine._gather_unpadded(leaf)
        else:
            # host step counter: the JAX package's i32 scalar
            optim_states[key] = np.asarray(leaf, np.int32)
    for name, buf in getattr(engine, "_qres", {}).items():
        optim_states[f"qres/{name}"] = engine._gather_unpadded(buf)

    meta = {
        "global_steps": engine.global_steps,
        "micro_steps": engine.micro_steps,
        "global_samples": engine.global_samples,
        "skipped_steps": engine.skipped_steps,
        # the loss scaler's state (a run without fp16 keeps its initial
        # static scale 1.0, as the JAX engine's does): a float and three
        # ints, in the JAX package's key order
        "scale_state": engine._scale_state._asdict(),
        # the JAX engine's count of optimizer updates (its dropout-stream
        # counter), one per global step here
        "ustep": engine.global_steps,
        "lr_scheduler": (engine.lr_scheduler.state_dict()
                         if engine.lr_scheduler is not None else None),
        "dp_world_size": engine.dp_world_size,
        "mp_world_size": engine.mp_world_size,
        "zero_stage": engine.zero_optimization_stage(),
        "param_count": engine._param_count(),
        "model_dtypes": model_dtypes,
    }
    # dataloader cursor: a resumed run consumes the exact next samples
    loader = getattr(engine, "training_dataloader", None)
    if loader is not None and hasattr(loader, "state_dict"):
        meta["data_state"] = loader.state_dict()
    zc = engine._config.zero_config
    if zc.cpu_offload and zc.offload_state_reduced:
        # the layout that wrote the file: a load into the same layout
        # keeps the residuals, any other folds them
        meta["offload_state_dtype"] = dict(zc.offload_state_dtype)

    client_state_pkl = (pickle.dumps(client_state)
                        if client_state else None)
    return CheckpointSnapshot(tag, model_states, model_dtypes, optim_states,
                              meta, client_state_pkl, save_latest)


def load_model_states(ckpt_dir):
    """``model_states.npz`` as {key: CPU tensor} in the true dtypes.

    Checkpoints without a dtype map (all fp32) pass through unchanged.
    """
    meta_path = os.path.join(str(ckpt_dir), META_JSON)
    dtype_map = {}
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            dtype_map = json.load(f).get("model_dtypes") or {}
    with np.load(os.path.join(str(ckpt_dir), MODEL_STATES_NPZ)) as npz:
        return {k: decode_array(npz[k], dtype_map.get(k))
                for k in npz.files}

