"""DeepSpeedCPUAdam: Adam on the host for ZeRO-Offload (port of
``deepspeed_tpu/ops/adam/cpu_adam.py``, kernel
``deepspeed_tpu/csrc/adam/cpu_adam.cpp``).

Under ``cpu_offload`` the fp32 master and both moments already live in
pinned host memory, so the update can run where they are: the host C++
kernel ``ds_adam_step`` (``csrc/adam/cpu_adam.cpp``, the port's copy of
the JAX package's, built by :mod:`~deepspeed_tpu_torch.ops.op_builder`
with g++ and OpenMP at first use) updates them in place, its output
pointers equal to its inputs (each element is read before it is
written).  The engine brings the gradient to the host first (cast to
fp32 on the card, copied into a pinned buffer, and waited for) and the
new params back after.  Above one data rank each rank's buffers are its
rows of the flat layout, and each rank's kernel runs on its own share
of the host's CPUs (:func:`host_threads`): several ranks on one host
would otherwise each start a team as large as the host.

The params go back as the engine's other offload paths send them: the
fp32 master (4 bytes a parameter) up through the chunk stream, cast on
the card.  ``examples/profile_torch_train.py --offload`` times that
against a cast to bf16 on the host into a pinned staging buffer and one
2-byte copy (PERF.md): the card's way takes under half the host
way's time at GPT-2-large.

The plain version (:func:`plain_adam_step`) is the port's
:class:`~deepspeed_tpu_torch.ops.adam.fused_adam.FusedAdam` arithmetic on
CPU tensors; the tests and ``chip_smoke.py`` hold the kernel to it, and
the training path never runs it.
"""

import ctypes
import os
import time

import numpy as np
import torch

from .. import op_builder
from .fused_adam import AdamState, FusedAdam

def _kernel():
    lib = op_builder.load("cpu_adam")
    fn = lib.ds_adam_step
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + \
            [ctypes.c_float] * 7 + [ctypes.c_int] * 2
        fn.restype = None
    return fn


def host_threads(env=None, cpus=None, host_cpus=None):
    """The kernel's OpenMP team.  0 (OpenMP's own choice:
    ``OMP_NUM_THREADS``, else every CPU) for the one rank of a host, and
    where ``OMP_NUM_THREADS`` is set to more than 1 (1 is what torchrun
    sets in every rank when it starts several, so that value is taken
    for its and not the user's).  Else, where several ranks share the
    host (``LOCAL_WORLD_SIZE``, which torchrun and the port's launcher
    set), the rank's CPUs (``cpus``: its affinity): split evenly over
    the local ranks when the rank may run on every CPU of the host
    (``host_cpus``), all of them when it was pinned to a set of its
    own.  Split beat torchrun's 1 and every CPU in each rank on the
    card's host (PERF.md)."""
    env = os.environ if env is None else env
    local = int(env.get("LOCAL_WORLD_SIZE", "1") or 1)
    omp = env.get("OMP_NUM_THREADS", "").strip()
    if local <= 1 or (omp.isdigit() and int(omp) > 1):
        return 0
    cpus = len(os.sched_getaffinity(0)) if cpus is None else cpus
    host_cpus = os.cpu_count() if host_cpus is None else host_cpus
    if cpus < host_cpus:
        return cpus
    return max(1, cpus // local)


def _host_f32(t, name):
    if t.device.type != "cpu" or t.dtype != torch.float32 \
            or not t.is_contiguous():
        raise ValueError(f"ds_adam_step: {name} must be a contiguous fp32 "
                         f"host tensor, got {t.dtype} on {t.device}")
    return t.data_ptr()


def ds_adam_step(p, m, v, g, lr, beta1, beta2, eps, weight_decay, bc1, bc2,
                 adamw, threads=None):
    """One Adam(W) step of the host kernel over ``p``, ``m``, ``v`` in
    place, with the gradient ``g`` (each a contiguous fp32 host tensor
    of one size), on ``threads`` OpenMP threads (None:
    :func:`host_threads`; 0: OpenMP's choice).  Counts its launch in
    ``ds_adam_step.launches`` and its host seconds in
    ``ds_adam_step.seconds``."""
    n = p.numel()
    if not (m.numel() == v.numel() == g.numel() == n):
        raise ValueError("ds_adam_step: p, m, v and g differ in size")
    ptrs = [_host_f32(t, name) for t, name in
            ((p, "p"), (m, "m"), (v, "v"), (g, "g"))]
    fn = _kernel()
    ds_adam_step.launches += 1
    t0 = time.perf_counter()
    fn(*ptrs[:3], *ptrs, n, lr, beta1, beta2, eps, weight_decay, bc1, bc2,
       int(bool(adamw)), host_threads() if threads is None else threads)
    ds_adam_step.seconds += time.perf_counter() - t0


ds_adam_step.launches = 0
ds_adam_step.seconds = 0.0


def f32(x):
    """``x`` rounded to fp32, as the kernel receives it."""
    return float(np.float32(x))


def bias_corrections(beta1, beta2, step, bias_correction=True):
    """(bc1, bc2) of optimizer step ``step`` (1-based) from the fp32
    betas the kernel sees, as FusedAdam computes them."""
    if not bias_correction:
        return 1.0, 1.0
    return 1.0 - f32(beta1) ** step, 1.0 - f32(beta2) ** step


def plain_adam_step(p, m, v, g, lr, beta1, beta2, eps, weight_decay, step,
                    adamw=True, bias_correction=True):
    """The plain version: FusedAdam's arithmetic on the same tensors, in
    place, at optimizer step ``step``, with the betas rounded to fp32 as
    the kernel gets them (so ``1 - beta`` is the kernel's: from the
    double 0.999 it differs by 1.3e-5 relative)."""
    opt = FusedAdam(lr=lr, betas=(f32(beta1), f32(beta2)), eps=eps,
                    weight_decay=weight_decay,
                    bias_correction=bias_correction, adam_w_mode=adamw)
    opt.update(AdamState(exp_avg=m, exp_avg_sq=v, step=step - 1), p, g,
               opt.hyperparams())


class DeepSpeedCPUAdam:
    """Flat-space Adam whose arithmetic runs in the host kernel, on host
    tensors (the offloaded master and moments).  ``adam_w_mode`` (or
    the JAX package's ``adamw_mode``) selects decoupled weight decay."""

    name = "cpu_adam"

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, bias_correction=True, adamw_mode=True,
                 adam_w_mode=None, **_ignored):
        _kernel()  # a failed build raises here, at initialize
        self.bias_correction = bias_correction
        self.adamw_mode = adamw_mode if adam_w_mode is None else adam_w_mode
        self.eps = eps
        self.param_groups = [{"lr": lr, "betas": tuple(betas), "eps": eps,
                              "weight_decay": weight_decay}]
        self.defaults = {"lr": lr, "betas": tuple(betas)}

    def init_state(self, flat_master):
        return AdamState(exp_avg=torch.zeros_like(flat_master),
                         exp_avg_sq=torch.zeros_like(flat_master))

    def hyperparams(self):
        g = self.param_groups[0]
        return {"lr": float(g["lr"]), "beta1": float(g["betas"][0]),
                "beta2": float(g["betas"][1]),
                "weight_decay": float(g["weight_decay"])}

    def update(self, state, flat_master, flat_grads, hp, segments=None,
               shard=None, tensor_reduce=None):
        """One step on host tensors, in place: the master and the moments
        in ``state`` are overwritten.  A gradient that is not a
        contiguous fp32 host tensor is copied into one.  Adam is
        elementwise, so it runs on a rank's rows (``shard``) and slices
        unchanged (``tensor_reduce`` is Lamb's)."""
        g = flat_grads
        if g.device.type != "cpu" or g.dtype != torch.float32 \
                or not g.is_contiguous():
            g = g.to("cpu", torch.float32).contiguous()
        state.step += 1
        bc1, bc2 = bias_corrections(hp["beta1"], hp["beta2"], state.step,
                                    self.bias_correction)
        ds_adam_step(flat_master, state.exp_avg, state.exp_avg_sq, g,
                     hp["lr"], hp["beta1"], hp["beta2"], self.eps,
                     hp["weight_decay"], bc1, bc2, self.adamw_mode)
        return flat_master, state
