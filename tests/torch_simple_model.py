"""The JAX package's ``tests/unit/simple_model.py`` fixtures in torch, for
the port's tests of its engine contracts (``test_torch_fp16.py``,
``test_torch_resilience.py``): a linear stack with tanh and an MSE loss
on float inputs, so a NaN batch reaches the loss."""

import numpy as np
import torch


class SimpleModel:
    """Linear stack with MSE loss, the engine's model contract (``init``
    and ``apply``).  Inputs and weights meet in their promoted dtype, as
    ``jnp`` promotes them."""

    def __init__(self, hidden_dim, nlayers=1):
        self.hidden_dim = hidden_dim
        self.nlayers = nlayers

    def init(self, seed):
        rng = np.random.default_rng(seed)
        return {f"layer_{i}": {
            "w": (rng.normal(size=(self.hidden_dim, self.hidden_dim))
                  * 0.1).astype(np.float32),
            "b": np.zeros((self.hidden_dim,), np.float32)}
            for i in range(self.nlayers)}

    def apply(self, params, batch, rng=None, train=True, **kwargs):
        x, y = batch
        h = x
        for i in range(self.nlayers):
            p = params[f"layer_{i}"]
            dtype = torch.promote_types(h.dtype, p["w"].dtype)
            h = torch.tanh(h.to(dtype) @ p["w"].to(dtype)
                           + p["b"].to(dtype))
        return torch.mean((h - y.to(h.dtype)) ** 2)


def random_batches(num_batches, batch_size, hidden_dim, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(batch_size, hidden_dim)).astype(np.float32),
             rng.normal(size=(batch_size, hidden_dim)).astype(np.float32))
            for _ in range(num_batches)]


def base_config(**overrides):
    cfg = {"train_batch_size": 16, "steps_per_print": 100,
           "optimizer": {"type": "Adam", "params": {"lr": 0.01}}}
    cfg.update(overrides)
    return cfg
