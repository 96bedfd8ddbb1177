"""Progressive Layer Drop's schedule (port of
``deepspeed_tpu/runtime/progressive_layer_drop.py``).

Keep probability θ(t) = (1-θ̄)·exp(-γ·t) + θ̄, from 1 at step 0 down to
θ̄.  The engine hands ``pld_theta`` to the model's ``apply`` every step,
as a 0-d tensor on the model's device; the BERT trunk draws the layer
skips (``models/bert.py``).
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)


class ProgressiveLayerDrop:
    def __init__(self, theta=0.5, gamma=0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0
        logger.info(f"Enabled progressive layer dropping (theta = "
                    f"{self.theta})")

    def get_state(self):
        return {"progressive_layer_drop": True,
                "pld_theta": self.get_theta()}

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step):
        self.current_theta = ((1.0 - self.theta)
                              * np.exp(-self.gamma * global_step)
                              + self.theta)
