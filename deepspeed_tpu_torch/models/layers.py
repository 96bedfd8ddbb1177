"""Transformer building blocks (port of ``deepspeed_tpu/models/layers.py:42-60``).

Weights are plain dicts of tensors with the JAX package's keys and its
``[in, out]`` kernel layout, so ``dense`` is ``x @ kernel + bias`` with no
transpose.  Dtypes follow the JAX package: ``dense`` casts the kernel to
``x.dtype``; ``layer_norm`` and ``gelu`` compute in fp32 and cast back.
``TransformerLayer`` comes with the training slice.
"""

import torch


def dense(params, x):
    return x @ params["kernel"].to(x.dtype) + params["bias"].to(x.dtype)


def layer_norm(params, x, eps=1e-12):
    """LayerNorm with fp32 statistics (bf16-safe)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def gelu(x):
    # tanh approximation, as in the JAX package
    x32 = x.float()
    y = 0.5 * x32 * (1.0 + torch.tanh(
        0.7978845608028654 * (x32 + 0.044715 * x32 ** 3)))
    return y.to(x.dtype)
