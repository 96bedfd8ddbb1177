"""1-bit Adam over the flat parameter space (port of
``deepspeed_tpu/runtime/fp16/onebit_adam.py:48-241``; the reference's
``deepspeed/runtime/fp16/onebit_adam.py:18-374``).

Two phases, switched on the host at ``freeze_step``:

1. **Warmup** (``step < freeze_step``): the engine's dense step, its
   usual gradient exchange included, with Adam's two moments updated in
   :meth:`OnebitAdam.update`.
2. **Compressed phase**: the backward makes no gradient exchange.  Each
   rank folds its local gradient into its momentum, and
   :func:`~deepspeed_tpu_torch.comm.compression.compressed_allreduce`
   gives the consensus momentum, 1 bit an element on the wire with worker
   and server error feedback (:meth:`OnebitAdam.compressed_update`).  The
   variance is frozen.

As in the reference (``:230-260``) neither phase corrects the bias, and
weight decay is L2-style, added to the update after the momentum term.
The engine keeps the JAX package's restrictions (its ``engine.py:3412-3440``):
ZeRO stage 0, no fp16 dynamic loss scaling, no ``cpu_offload``; gradient
clipping applies to the warmup only.

The state is ``(exp_avg, exp_avg_sq, worker_error, server_error, step)``:
the moments in the master's flat layout, and this rank's error buffers,
``[padded_size(n, dp)]`` and ``[padded_size(n, dp) / dp]`` for the ``n``
elements of the flat buffer.  Both error buffers persist across steps;
a checkpoint stacks every rank's, ``[dp, ...]``, as the JAX engine
stores them.

Above one rank of ``model``, ``expert`` or ``pipe`` each rank's flat
buffer is its own part of the model (its Megatron slices, its experts,
its stage), and the compressed all-reduce runs over its data group on
that part, with the error buffers of that part.  The JAX engine
compresses the whole model's buffer, whose scales are the whole
buffer's RMS; here the scales are the RMS over the whole model too
(summed over those axes, a replicated or tied leaf counted once), so
that every copy of a leaf gets the same update.  The server chunks are
each rank's, so the result is close to the JAX engine's, not equal.
"""

from dataclasses import dataclass

import torch

from ...comm.compression import compressed_allreduce, padded_size
from ...parallel.mesh import DATA_AXIS, Mesh


@dataclass
class OnebitAdamState:
    exp_avg: torch.Tensor       # m, fp32, the master's shape
    exp_avg_sq: torch.Tensor    # v, frozen in the compressed phase
    worker_error: torch.Tensor  # [padded_size(n, dp)], this rank's
    server_error: torch.Tensor  # [padded_size(n, dp) / dp], this rank's
    step: int = 0


class OnebitAdam:
    """Flat-space 1-bit Adam.  ``dp`` is the data-parallel degree and
    ``zero_stage`` the engine's (stage 0 only, as in the reference's
    ``ZERO_SUPPORTED_OPTIMIZERS``)."""

    name = "onebit_adam"
    # the state fields that hold this rank's own error feedback: they
    # differ between data ranks by design, so no replica comparison (the
    # fleet fingerprint) may cover them above one data rank
    per_rank_fields = ("worker_error", "server_error")

    def __init__(self, lr=1e-3, freeze_step=100000, betas=(0.9, 0.999),
                 eps=1e-8, weight_decay=0.0, cuda_aware=False, dp=1,
                 zero_stage=0, **_ignored):
        if zero_stage != 0:
            raise ValueError(
                f"OneBitAdam is incompatible with ZeRO (stage={zero_stage}); "
                f"the reference has the same restriction "
                f"(ZERO_SUPPORTED_OPTIMIZERS)")
        self.freeze_step = int(freeze_step)
        self.eps = eps
        self.dp = int(dp)
        self.param_groups = [{"lr": lr, "betas": tuple(betas), "eps": eps,
                              "weight_decay": weight_decay}]
        self.defaults = {"lr": lr, "betas": tuple(betas)}

    def init_state(self, flat_master):
        n_pad = padded_size(flat_master.numel(), self.dp)
        return OnebitAdamState(
            exp_avg=torch.zeros_like(flat_master),
            exp_avg_sq=torch.zeros_like(flat_master),
            worker_error=flat_master.new_zeros(n_pad),
            server_error=flat_master.new_zeros(n_pad // self.dp))

    def hyperparams(self):
        g = self.param_groups[0]
        return {"lr": float(g["lr"]), "beta1": float(g["betas"][0]),
                "beta2": float(g["betas"][1]),
                "weight_decay": float(g["weight_decay"])}

    def compressing(self, step):
        """True from ``freeze_step`` on: the step's gradients stay local
        and the momentum goes through the compressed all-reduce."""
        return step >= self.freeze_step

    def update(self, state, flat_master, flat_grads, hp, segments=None,
               shard=None, tensor_reduce=None):
        """The warmup (dense) update, in place: Adam without bias
        correction, the error buffers untouched.  Elementwise, so a
        tensor-parallel rank's slices take it unchanged
        (``tensor_reduce`` is Lamb's).

        The frozen ``exp_avg_sq`` is what accumulated by ``freeze_step``:
        with beta2 = 0.999 only ``1 - 0.999^t`` of the second moment, so
        an early freeze makes every compressed update about ``1 /
        sqrt(1 - beta2^t)`` times too hot (the reference's recipes freeze
        after ~23k steps)."""
        lr, beta1, beta2, wd = (hp["lr"], hp["beta1"], hp["beta2"],
                                hp["weight_decay"])
        g = flat_grads.float()
        p = flat_master
        state.exp_avg.mul_(beta1).add_((1.0 - beta1) * g)
        state.exp_avg_sq.mul_(beta2).add_((1.0 - beta2) * (g * g))
        self._apply(state, p, lr, wd)
        return p, state

    def compressed_update(self, state, flat_master, local_grads, hp,
                          mesh=None, scale_axes=None, weights=None):
        """The compressed-phase update, in place, from this rank's local
        gradient: the rank's momentum, its 1-bit consensus over the
        ``data`` axis of ``mesh`` (a collective: every rank calls it),
        and the step on the frozen variance.  Above one rank of another
        axis that splits the model (``scale_axes``: ``model``,
        ``expert``, ``pipe``) the consensus runs over this rank's data
        group on its own part of the model, with the compression's
        scales taken over the whole model (``weights``, one a flat
        element: 1 where this rank counts the element's leaf, see
        :func:`~deepspeed_tpu_torch.comm.compression.compressed_allreduce`)."""
        lr, beta1, wd = hp["lr"], hp["beta1"], hp["weight_decay"]
        m_local = beta1 * state.exp_avg + (1.0 - beta1) * local_grads.float()
        m_bar, we, se = compressed_allreduce(
            m_local.reshape(-1), state.worker_error, state.server_error,
            DATA_AXIS, mesh=mesh if mesh is not None
            else Mesh({DATA_AXIS: 1}), scale_axes=scale_axes,
            weights=weights)
        state.exp_avg.copy_(m_bar.view(state.exp_avg.shape))
        state.worker_error.copy_(we)
        state.server_error.copy_(se)
        self._apply(state, flat_master, lr, wd)
        return flat_master, state

    def _apply(self, state, p, lr, wd):
        update = state.exp_avg / (state.exp_avg_sq.sqrt() + self.eps) \
            + wd * p
        p.sub_(lr * update)
        state.step += 1

    @staticmethod
    def rank_local_fields():
        """The state fields that each rank holds for itself (not in the
        master's flat layout)."""
        return ("worker_error", "server_error")
