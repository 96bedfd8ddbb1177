"""Mixture-of-Experts layer with expert parallelism over the ``expert``
axis (port of ``deepspeed_tpu/models/moe.py``: ``_router_dispatch``,
``MoEFFN``, ``MoETransformerLayer``).

A top-k routed expert FFN.  Routing is grouped per sequence (GShard):
each batch row routes its own S tokens with the static capacity
``ceil(k·S/E·capacity_factor)`` (padded to a multiple of 8), so the
dispatch and combine tensors are ``[B, S, E, C]``; a token over an
expert's capacity contributes nothing there and survives through the
residual.  Top-1 keeps the raw gate probability as its combine weight
(Switch), top-k > 1 renormalizes over the chosen experts (GShard); the
Switch load-balancing loss ``E · Σ_e fraction_e · mean_prob_e`` of the
first choice comes back beside the output.  Ties in the arg-max take
the lowest expert index, as ``jnp.argmax`` does.

Dispatch and combine are einsums, as in the JAX package, which leaves
them to XLA.  Expert parallelism keeps the JAX semantics: the batch is
sharded over ``data`` only, so every rank of the ``expert`` axis sees the
same tokens and routes them alike; each runs its ``E / e`` experts (its
slice of every expert leaf, and under ``model`` its slice of the
experts' intermediate dim, ``fc1`` column- and ``fc2`` row-parallel) on
its slice of the dispatch tensor, and one sum over ``expert``
(:func:`~deepspeed_tpu_torch.comm.reduce_from`) joins the combined
outputs.  The experts' gradients stay on their rank; the router's come
out the same on every rank (the combine tensor's gradient is summed
over ``expert`` by :func:`~deepspeed_tpu_torch.comm.copy_to`).

Under ``seq`` (a rank holds a chunk of each sequence) the routing groups
stay whole sequences, as in the JAX package: the gate probabilities are
gathered over ``seq`` (:func:`~deepspeed_tpu_torch.comm.gather_seq`,
whose backward sends each rank's part of their gradient to the chunk's
owner), every rank routes the whole sequence alike (capacity over the
whole S, slots in the sequence's order), and each dispatches and
combines its own tokens only.  The whole sequence's aux loss is counted
once, at ``seq`` rank 0 (the engine sums the ranks' losses).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..comm import axis_index, axis_size, copy_to, gather_seq, reduce_from
from ..parallel.mesh import EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS
from ..utils.params import EXPERT, MODEL
from .layers import (TransformerLayer, dropout, gelu, layer_norm, recomputed,
                     row_dense)


def route(probs, k, capacity):
    """The routing tensors of every group (batch row) at once from the
    gate probabilities ``probs`` ``[B, S, E]`` (fp32): ``(dispatch [B, S,
    E, C] bool, combine [B, S, E, C] fp32, aux [B])``, the JAX package's
    ``_router_dispatch`` under ``vmap``."""
    B, S, E = probs.shape
    gates = []  # (weight [B, S], index [B, S]) per choice
    masked = probs
    for _ in range(k):
        idx = masked.argmax(dim=-1)
        w = masked.gather(-1, idx[..., None])[..., 0]
        gates.append((w, idx))
        masked = masked * (1.0 - F.one_hot(idx, E).to(probs.dtype))
    if k > 1:
        # GShard: kept tokens combine to weight ~1 across their k experts
        total = sum(w for w, _ in gates) + 1e-9
        gates = [(w / total, idx) for w, idx in gates]
    dispatch = torch.zeros((B, S, E, capacity), dtype=torch.bool,
                           device=probs.device)
    combine = torch.zeros((B, S, E, capacity), dtype=torch.float32,
                          device=probs.device)
    slots = torch.arange(capacity, device=probs.device)
    # the running fill of each expert, so later choices queue behind
    fill = torch.zeros((B, E), dtype=torch.int64, device=probs.device)
    for w, idx in gates:
        onehot = F.one_hot(idx, E)                              # [B, S, E]
        pos_in_expert = (onehot.cumsum(dim=1) - 1) * onehot
        pos = pos_in_expert.sum(-1) + fill.gather(1, idx)       # [B, S]
        keep = pos < capacity
        slot = (pos[..., None] == slots).float()                # [B, S, C]
        contrib = (onehot.float()[..., None] * slot[:, :, None, :]
                   * keep.float()[..., None, None])
        dispatch = dispatch | (contrib > 0.0)
        combine = combine + contrib * w[..., None, None]
        fill = fill + (onehot * keep[..., None]).sum(dim=1)
    fraction = F.one_hot(gates[0][1], E).float().mean(dim=1)     # [B, E]
    mean_prob = probs.mean(dim=1)
    aux = E * (fraction * mean_prob).sum(-1)
    return dispatch, combine, aux


def _router_dispatch(probs, k, capacity):
    """One group's routing tensors from its gate probabilities ``probs``
    ``[T, E]`` fp32: ``(dispatch [T, E, C] bool, combine [T, E, C] fp32,
    aux)`` (the JAX function, ``moe.py:45``)."""
    dispatch, combine, aux = route(probs[None], k, capacity)
    return dispatch[0], combine[0], aux[0]


class MoEFFN:
    """Routed expert FFN: x ``[B, S, H]`` -> ``(y [B, S, H], aux)``.
    Expert leaves carry a leading ``num_experts`` dim, sliced over
    ``expert`` (a rank holds experts ``[r·E/e, (r+1)·E/e)``)."""

    def __init__(self, hidden_size, intermediate_size, num_experts, k=2,
                 capacity_factor=1.25, initializer_range=0.02):
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_experts = num_experts
        self.k = min(k, num_experts)
        self.capacity_factor = capacity_factor
        self.initializer_range = initializer_range

    def init(self, rng):
        """Numpy params from the numpy generator ``rng``."""
        E, H, I = self.num_experts, self.hidden_size, self.intermediate_size
        std = np.float32(self.initializer_range)

        def normal(*shape):
            return rng.standard_normal(shape, dtype=np.float32) * std

        return {"router": {"kernel": normal(H, E)},
                "fc1": {"kernel": normal(E, H, I),
                        "bias": np.zeros((E, I), np.float32)},
                "fc2": {"kernel": normal(E, I, H),
                        "bias": np.zeros((E, H), np.float32)}}

    @staticmethod
    def partition_specs():
        """The JAX specs (``moe.py:119-124``) in the port's form."""
        return {"router": {"kernel": (None, None)},
                "fc1": {"kernel": (EXPERT, None, MODEL),
                        "bias": (EXPERT, MODEL)},
                "fc2": {"kernel": (EXPERT, MODEL, None),
                        "bias": (EXPERT, None)}}

    def capacity(self, group_tokens):
        cap = int(math.ceil(self.k * group_tokens / self.num_experts
                            * self.capacity_factor))
        return max(8, ((cap + 7) // 8) * 8)

    def apply(self, params, x):
        n = axis_size(SEQ_AXIS)
        sl = x.shape[1]
        C = self.capacity(sl * n)
        logits = x.float() @ params["router"]["kernel"].float()
        probs = gather_seq(torch.softmax(logits, dim=-1))
        dispatch, combine, aux = route(probs, self.k, C)
        aux = aux.mean()
        if n > 1:
            # this rank's tokens; the whole sequence's aux counted once
            r = axis_index(SEQ_AXIS)
            dispatch = dispatch[:, r * sl:(r + 1) * sl]
            combine = combine[:, r * sl:(r + 1) * sl]
            aux = aux if r == 0 else aux * 0.0
        # this rank's experts
        n_local = params["fc1"]["kernel"].shape[0]
        e0 = axis_index(EXPERT_AXIS) * n_local if \
            n_local != self.num_experts else 0
        experts = slice(e0, e0 + n_local)
        dt = x.dtype
        x_in = copy_to(x, (MODEL_AXIS, EXPERT_AXIS))
        expert_in = torch.einsum("bsec,bsh->bech",
                                 dispatch[:, :, experts].to(dt), x_in)
        h = gelu(torch.einsum("bech,ehi->beci", expert_in,
                              params["fc1"]["kernel"].to(dt))
                 + params["fc1"]["bias"].to(dt)[None, :, None, :])
        out_e = reduce_from(torch.einsum("beci,eih->bech", h,
                                         params["fc2"]["kernel"].to(dt)),
                            MODEL_AXIS) \
            + params["fc2"]["bias"].to(dt)[None, :, None, :]
        weights = copy_to(combine, EXPERT_AXIS)[:, :, experts].to(dt)
        y = torch.einsum("bsec,bech->bsh", weights, out_e)
        return reduce_from(y, EXPERT_AXIS), aux


class MoETransformerLayer:
    """Pre-LN block with a routed-expert FFN.  The attention half is a
    :class:`TransformerLayer` (its ``attention_core`` and specs), so the
    attention variants and the memory knobs behave as in the dense block;
    ``apply`` returns ``(y, aux)``.  Its dropout sites draw from the
    layer's generator in the dense block's order (attention, attention
    output, FFN output)."""

    _ATTN_PARAM_KEYS = ("qkv", "attn_out", "ln_attn", "ln_mlp")

    def __init__(self, hidden_size, heads, num_experts,
                 intermediate_size=None, causal=True, k=2,
                 capacity_factor=1.25, attn_dropout_ratio=0.1,
                 hidden_dropout_ratio=0.1, initializer_range=0.02,
                 layer_norm_eps=1e-5, attn_impl="auto", sparsity_config=None,
                 gelu_checkpoint=False, attn_dropout_checkpoint=False,
                 normalize_invertible=False):
        self.hidden_size = hidden_size
        self.hidden_dropout_ratio = hidden_dropout_ratio
        self.layer_norm_eps = layer_norm_eps
        self.gelu_checkpoint = gelu_checkpoint
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.normalize_invertible = normalize_invertible
        self.attn = TransformerLayer(
            hidden_size=hidden_size, heads=heads, causal=causal,
            attn_dropout_ratio=attn_dropout_ratio,
            hidden_dropout_ratio=hidden_dropout_ratio,
            initializer_range=initializer_range,
            layer_norm_eps=layer_norm_eps, attn_impl=attn_impl,
            sparsity_config=sparsity_config)
        self.moe = MoEFFN(hidden_size, intermediate_size or 4 * hidden_size,
                          num_experts, k=k, capacity_factor=capacity_factor,
                          initializer_range=initializer_range)

    def init(self, seed):
        """Numpy params: the attention half of a dense layer's draw and
        the experts from the same generator."""
        rng = np.random.default_rng(seed)
        full = self.attn.init(int(rng.integers(2 ** 31)))
        params = {k: full[k] for k in self._ATTN_PARAM_KEYS}
        params["moe"] = self.moe.init(rng)
        return params

    @classmethod
    def partition_specs(cls):
        full = TransformerLayer.partition_specs()
        specs = {k: full[k] for k in cls._ATTN_PARAM_KEYS}
        specs["moe"] = MoEFFN.partition_specs()
        return specs

    def apply(self, params, x, key_padding_mask=None, rng=None,
              deterministic=True, attn_seed_rng=None):
        rate = self.hidden_dropout_ratio

        def attention_block(y):
            ctx = self.attn.attention_core(params, y,
                                           key_padding_mask=key_padding_mask,
                                           attn_rng=rng,
                                           deterministic=deterministic,
                                           attn_seed_rng=attn_seed_rng)
            return dropout(rng, row_dense(params["attn_out"], ctx), rate,
                           deterministic)

        def moe_block(y):
            out, aux = self.moe.apply(params["moe"], y)
            return dropout(rng, out, rate, deterministic), aux

        def ln(p, y):
            return layer_norm(p, y, self.layer_norm_eps)

        if self.attn_dropout_checkpoint:
            attention_block = recomputed(attention_block, rng,
                                         attn_seed_rng)
        if self.gelu_checkpoint:
            moe_block = recomputed(moe_block, rng)
        if self.normalize_invertible:
            ln = recomputed(ln)
        x = x + attention_block(ln(params["ln_attn"], x))
        out, aux = moe_block(ln(params["ln_mlp"], x))
        return x + out, aux
