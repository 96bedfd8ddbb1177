"""LAMB over the flat parameter space (port of
``deepspeed_tpu/ops/lamb/fused_lamb.py``).

Per-tensor trust ratios ``||w|| / ||update||`` come from the flat
layout's row alignment (:func:`~deepspeed_tpu_torch.ops.op_common.segment_l2_norms_rows`)
and are spread back over each tensor's rows by a row-level gather, as in
the JAX package.  The master and both moments are updated in place; the
step count and hyperparameters are host numbers.
"""

import torch

from ..adam.fused_adam import AdamState
from ..op_common import (segment_row_bounds, segment_sq_sums_rows,
                         sq_sums_to_norms)

LambState = AdamState


class FusedLamb:
    """Flat-space LAMB; ``max_coeff`` / ``min_coeff`` clamp the trust
    ratio."""

    name = "lamb"

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, eps_inside_sqrt=False, weight_decay=0.0,
                 max_grad_norm=0.0, max_coeff=10.0, min_coeff=0.01,
                 amsgrad=False, **_ignored):
        if amsgrad:
            raise RuntimeError("FusedLamb does not support the AMSGrad "
                               "variant.")
        self.bias_correction = bias_correction
        self.eps = eps
        self.eps_inside_sqrt = eps_inside_sqrt
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        self.param_groups = [{"lr": lr, "betas": tuple(betas), "eps": eps,
                              "weight_decay": weight_decay,
                              "max_coeff": max_coeff,
                              "min_coeff": min_coeff}]
        self.defaults = {"lr": lr, "betas": tuple(betas)}
        self._layout = None  # (segments, device, shard) -> bounds, row ids

    def init_state(self, flat_master):
        return LambState(exp_avg=torch.zeros_like(flat_master),
                         exp_avg_sq=torch.zeros_like(flat_master))

    def hyperparams(self):
        g = self.param_groups[0]
        return {"lr": float(g["lr"]), "beta1": float(g["betas"][0]),
                "beta2": float(g["betas"][1]),
                "weight_decay": float(g["weight_decay"])}

    def _row_layout(self, segments, device, shard):
        """The segments' row bounds and row ids on ``device`` (on the
        shard's rows), made on the first step and kept."""
        key = (segments, device, shard)
        if self._layout is None or self._layout[0] != key:
            ids = segments.row_segment_ids()
            if shard is not None:
                ids = ids[shard.row0:shard.row0 + shard.rows]
            self._layout = (key, segment_row_bounds(segments, device, shard),
                            ids.to(device))
        return self._layout[1], self._layout[2]

    def update(self, state, flat_master, flat_grads, hp, segments=None,
               shard=None, tensor_reduce=None):
        """One step on the flat buffer, in place.  Under ZeRO-1/2 the
        buffers are one rank's rows (``shard``, a
        :class:`~deepspeed_tpu_torch.ops.op_common.RowShard`): the
        per-tensor sums of squares are summed over the ranks before the
        trust ratios are taken.  Under tensor parallelism a tensor is a
        rank's slice of a whole one: ``tensor_reduce`` (the engine's)
        sums each sliced tensor's partial sums over the ``model`` and
        ``expert`` ranks too, so the trust ratio is the whole tensor's
        (JAX ``fused_lamb.py:96-101``)."""
        if segments is None:
            raise ValueError("FusedLamb needs the segment descriptor for "
                             "per-tensor trust ratios")
        lr, beta1, beta2, wd = (hp["lr"], hp["beta1"], hp["beta2"],
                                hp["weight_decay"])
        p = flat_master
        g = flat_grads.float()
        state.step += 1
        state.exp_avg.mul_(beta1).add_(g, alpha=1.0 - beta1)
        state.exp_avg_sq.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
        if self.bias_correction:
            m_hat = state.exp_avg / (1.0 - beta1 ** state.step)
            v_hat = state.exp_avg_sq / (1.0 - beta2 ** state.step)
        else:
            m_hat, v_hat = state.exp_avg, state.exp_avg_sq
        if self.eps_inside_sqrt:
            denom = (v_hat + self.eps).sqrt_()
        else:
            denom = v_hat.sqrt().add_(self.eps)
        update = m_hat.div_(denom) if m_hat is not state.exp_avg \
            else m_hat / denom
        update.add_(p, alpha=wd)
        bounds, row_ids = self._row_layout(segments, p.device, shard)
        sq = torch.cat([segment_sq_sums_rows(p, segments, bounds),
                        segment_sq_sums_rows(update, segments, bounds)])
        if shard is not None:
            # a tensor's rows can straddle ranks: ONE all-reduce of the
            # partial sums of both norms before the roots
            sq = shard.reduce(sq)
        if tensor_reduce is not None:
            sq = tensor_reduce(sq)
        w_norms, u_norms = sq_sums_to_norms(sq).split(segments.num_segments)
        # trust ratio per tensor: ||w||/||u||, clamped; 1 where degenerate;
        # pad rows (id num_segments) get 1 and multiply a zero update
        ratio = torch.where((w_norms > 0) & (u_norms > 0),
                            (w_norms / u_norms).clamp(self.min_coeff,
                                                      self.max_coeff),
                            torch.ones_like(w_norms))
        ratio_full = torch.cat([ratio, ratio.new_ones(1)])
        p.addcmul_(ratio_full[row_ids][:, None], update, value=-lr)
        return p, state

    def get_lamb_coeffs(self):
        return []
