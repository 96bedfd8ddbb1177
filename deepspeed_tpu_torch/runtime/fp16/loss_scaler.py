"""Loss scaling (port of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``,
itself a clone of the reference ``deepspeed/runtime/fp16/loss_scaler.py``).

Two forms, as in the JAX package:

- the reference-style classes :class:`LossScaler` and
  :class:`DynamicLossScaler` (``:27-165``), with the pinned-at-floor
  detector and its ``anomaly_hook``;
- the functional :class:`DynamicScaleState` and
  :func:`update_scale_state` (``:172-222``), which the engine's step goes
  through.  The JAX engine carries that state on the device because its
  update lives in the compiled step; the port's step fetches the overflow
  flag to the host anyway (one batched fetch a step, as the JAX engine
  does for fp16), so the state is plain Python numbers and the update is
  host arithmetic, with the same results.
"""

import logging
from typing import NamedTuple

logger = logging.getLogger(__name__)

INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
MIN_LOSS_SCALE = "min_scale"


class LossScalerBase:
    """Base of the scaler classes (reference ``loss_scaler.py:34-53``)."""

    def __init__(self, cur_scale):
        self.cur_scale = cur_scale

    @property
    def loss_scale(self):
        return self.cur_scale

    def scale_gradient(self, module, grad_in, grad_out):
        return tuple(self.loss_scale * g for g in grad_in)

    def update_scale(self, overflow):
        pass

    def backward(self, loss, retain_graph=False):
        raise NotImplementedError(
            "the engine scales the loss in its own backward; use "
            "engine.backward()")


class LossScaler(LossScalerBase):
    """Static loss scale (reference ``loss_scaler.py:56-76``)."""

    def __init__(self, scale=1):
        super().__init__(scale)

    def has_overflow(self, params):
        return False

    @staticmethod
    def _has_inf_or_nan(x):
        return False


def _has_inf_or_nan(x):
    import torch

    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return not bool(torch.isfinite(t).all())


class DynamicLossScaler(LossScalerBase):
    """Dynamic loss scale with hysteresis (reference
    ``loss_scaler.py:79-166``).

    ``update_scale``: on overflow, halve (floored at ``min_scale``) when no
    hysteresis is left, else spend one unit of it; either way the growth
    window restarts.  After ``scale_window`` good iterations, double and
    (unless ``consecutive_hysteresis``) refill the hysteresis.  After
    ``floor_patience`` consecutive overflows at ``min_scale`` it logs an
    error once and calls ``anomaly_hook(count)``."""

    def __init__(self,
                 init_scale=2 ** 32,
                 scale_factor=2.0,
                 scale_window=1000,
                 min_scale=1,
                 delayed_shift=1,
                 consecutive_hysteresis=False,
                 floor_patience=8,
                 anomaly_hook=None):
        super().__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.cur_hysteresis = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis
        self.floor_patience = int(floor_patience)
        self.anomaly_hook = anomaly_hook
        self.consecutive_floor_overflows = 0
        self.floor_stuck = False

    def has_overflow_serial(self, params):
        return any(_has_inf_or_nan(p) for p in params)

    has_overflow = has_overflow_serial

    @staticmethod
    def _has_inf_or_nan(x):
        return _has_inf_or_nan(x)

    def update_scale(self, overflow):
        if overflow:
            if self.delayed_shift == 1 or self.cur_hysteresis == 1:
                self.cur_scale = max(self.cur_scale / self.scale_factor,
                                     self.min_scale)
            else:
                self.cur_hysteresis -= 1
            self.last_overflow_iter = self.cur_iter
            if self.cur_scale <= self.min_scale:
                self.consecutive_floor_overflows += 1
                if (self.consecutive_floor_overflows >= self.floor_patience
                        and not self.floor_stuck):
                    self.floor_stuck = True
                    logger.error(
                        "DynamicLossScaler: %d consecutive overflows with "
                        "the loss scale pinned at min_scale=%s: halving "
                        "can no longer recover this run; the model is "
                        "producing non-finite gradients at the smallest "
                        "scale (diverged weights or a data problem). Roll "
                        "back to a checkpoint or abort.",
                        self.consecutive_floor_overflows, self.min_scale)
                    if self.anomaly_hook is not None:
                        self.anomaly_hook(self.consecutive_floor_overflows)
        else:
            self.consecutive_floor_overflows = 0
            self.floor_stuck = False
            if self.consecutive_hysteresis:
                self.cur_hysteresis = self.delayed_shift
            if (self.cur_iter - self.last_overflow_iter) \
                    % self.scale_window == 0:
                if not self.consecutive_hysteresis:
                    self.cur_hysteresis = self.delayed_shift
                self.cur_scale *= self.scale_factor
        self.cur_iter += 1


# ---------------------------------------------------------------------------
# Functional form: the engine's scale state
# ---------------------------------------------------------------------------

class DynamicScaleState(NamedTuple):
    """The scaler state a step carries and a checkpoint records
    (``meta.json``'s ``scale_state``)."""

    cur_scale: float
    cur_iter: int
    last_overflow_iter: int
    cur_hysteresis: int

    @staticmethod
    def create(init_scale=2 ** 32, delayed_shift=1):
        return DynamicScaleState(cur_scale=float(init_scale), cur_iter=0,
                                 last_overflow_iter=-1,
                                 cur_hysteresis=int(delayed_shift))


def _f32(x):
    """``x`` rounded to fp32, as the JAX state's ``cur_scale`` is."""
    import numpy as np

    return float(np.float32(x))


def update_scale_state(state, overflow, scale_factor=2.0, scale_window=1000,
                       min_scale=1.0, delayed_shift=1,
                       consecutive_hysteresis=False):
    """The next :class:`DynamicScaleState` after a step that did or did
    not ``overflow``: the JAX function's rule (and the class's
    ``update_scale``), on host numbers."""
    overflow = bool(overflow)
    no_hyst_left = delayed_shift == 1 or state.cur_hysteresis == 1
    window_hit = (state.cur_iter - state.last_overflow_iter) \
        % scale_window == 0
    if overflow:
        scale = (_f32(max(state.cur_scale / scale_factor, min_scale))
                 if no_hyst_left else state.cur_scale)
        hyst = state.cur_hysteresis if no_hyst_left \
            else state.cur_hysteresis - 1
        last = state.cur_iter
    else:
        scale = (_f32(state.cur_scale * scale_factor) if window_hit
                 else state.cur_scale)
        if consecutive_hysteresis or window_hit:
            hyst = int(delayed_shift)
        else:
            hyst = state.cur_hysteresis
        last = state.last_overflow_iter
    return DynamicScaleState(cur_scale=scale, cur_iter=state.cur_iter + 1,
                             last_overflow_iter=last, cur_hysteresis=hyst)


CLIP_GRAD = "clip_grad"
