"""Adam and AdamW over the flat parameter space (port of
``deepspeed_tpu/ops/adam/fused_adam.py``).

The JAX package fuses the update into one jitted elementwise program over
the flat fp32 buffer.  The port runs the same arithmetic as a handful of
in-place PyTorch ops over the same buffer: the master and both moments
are updated in place, so a step holds no second copy of them (the JAX
package donates the buffers to the same effect).  The step count and
the hyperparameters are host numbers, so a step reads nothing back from
the card.
"""

from dataclasses import dataclass

import torch


@dataclass
class AdamState:
    exp_avg: torch.Tensor     # m, fp32, the master's shape
    exp_avg_sq: torch.Tensor  # v, fp32
    step: int = 0


class FusedAdam:
    """Flat-space Adam/AdamW.  ``adam_w_mode`` selects decoupled weight
    decay (AdamW); ``param_groups`` is the host-side facade the LR
    schedulers write."""

    name = "adam"

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, bias_correction=True, adam_w_mode=True,
                 amsgrad=False, **_ignored):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        self.bias_correction = bias_correction
        self.adam_w_mode = adam_w_mode
        self.eps = eps
        self.param_groups = [{"lr": lr, "betas": tuple(betas), "eps": eps,
                              "weight_decay": weight_decay}]
        self.defaults = {"lr": lr, "betas": tuple(betas)}

    def init_state(self, flat_master):
        return AdamState(exp_avg=torch.zeros_like(flat_master),
                         exp_avg_sq=torch.zeros_like(flat_master))

    def hyperparams(self):
        """The schedulable hyperparameters, as host floats."""
        g = self.param_groups[0]
        return {"lr": float(g["lr"]), "beta1": float(g["betas"][0]),
                "beta2": float(g["betas"][1]),
                "weight_decay": float(g["weight_decay"])}

    def update(self, state, flat_master, flat_grads, hp, segments=None,
               shard=None):
        """One step on the flat buffer, in place: ``flat_master`` and the
        moments in ``state`` are overwritten.  ``flat_grads`` may be bf16;
        the update runs in fp32.  Adam is elementwise, so it runs on a
        rank's rows (``shard``, under ZeRO-1/2) unchanged."""
        lr, beta1, beta2, wd = (hp["lr"], hp["beta1"], hp["beta2"],
                                hp["weight_decay"])
        p = flat_master
        g = flat_grads.float()
        state.step += 1
        if not self.adam_w_mode:
            # L2 mode: decay folded into the gradient
            g = g + wd * p
        state.exp_avg.mul_(beta1).add_(g, alpha=1.0 - beta1)
        state.exp_avg_sq.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
        if self.bias_correction:
            bc1 = 1.0 - beta1 ** state.step
            bc2 = 1.0 - beta2 ** state.step
        else:
            bc1 = bc2 = 1.0
        denom = (state.exp_avg_sq / bc2).sqrt_().add_(self.eps)
        update = (state.exp_avg / bc1).div_(denom)
        if self.adam_w_mode:
            update.add_(p, alpha=wd)
        p.add_(update, alpha=-lr)
        return p, state
