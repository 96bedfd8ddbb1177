"""GPT-2 model family, eval forward (port of ``deepspeed_tpu/models/gpt2.py``).

Decoder-only transformer with pre-layernorm blocks, causal attention and
a weight-tied LM head, computing what ``GPT2LMHeadTPU.hidden`` and
``.logits`` compute with dropout off.  Parameters are a dict with the
JAX package's keys (``wte``, ``wpe``, ``blocks/layer_i/{qkv, attn_out,
fc1, fc2, ln_attn, ln_mlp}``, ``ln_f``), so a JAX tree carried across by
:func:`~deepspeed_tpu_torch.utils.params.params_from_numpy` drops in.
Training (dropout, remat, MoE, the chunked loss) comes with the training
slice.
"""

import numpy as np
from torch import nn

from ..ops.transformer.attention import dot_product_attention
from .layers import dense, gelu, layer_norm


class GPT2Config:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_position_embeddings=1024,
                 embd_dropout=0.1, attn_dropout=0.1, resid_dropout=0.1,
                 initializer_range=0.02, layer_norm_eps=1e-5):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_position_embeddings = max_position_embeddings
        # read by training; the eval forward here applies no dropout
        self.embd_dropout = embd_dropout
        self.attn_dropout = attn_dropout
        self.resid_dropout = resid_dropout
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps

    @staticmethod
    def gpt2_small(**kw):
        return GPT2Config(hidden_size=768, num_layers=12, num_heads=12, **kw)

    @staticmethod
    def gpt2_medium(**kw):
        """GPT-2 345M (BASELINE config #3)."""
        return GPT2Config(hidden_size=1024, num_layers=24, num_heads=16, **kw)

    @staticmethod
    def gpt2_large(**kw):
        return GPT2Config(hidden_size=1280, num_layers=36, num_heads=20, **kw)

    @staticmethod
    def gpt2_xl(**kw):
        """GPT-2 1.5B (BASELINE config #4)."""
        return GPT2Config(hidden_size=1600, num_layers=48, num_heads=25, **kw)


def random_params(config, seed):
    """A numpy param tree of ``config``'s shapes, drawn the way the JAX
    package initializes (normal(0, initializer_range) kernels and
    embeddings, zero biases, unit layernorm scales) from a numpy
    generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    c = config
    h, inter = c.hidden_size, 4 * c.hidden_size

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) \
            * np.float32(c.initializer_range)

    def dense_p(n_in, n_out):
        return {"kernel": normal(n_in, n_out),
                "bias": np.zeros((n_out,), np.float32)}

    def ln_p():
        return {"scale": np.ones((h,), np.float32),
                "bias": np.zeros((h,), np.float32)}

    return {
        "wte": normal(c.vocab_size, h),
        "wpe": normal(c.max_position_embeddings, h),
        "blocks": {f"layer_{i}": {"qkv": dense_p(h, 3 * h),
                                  "attn_out": dense_p(h, h),
                                  "fc1": dense_p(h, inter),
                                  "fc2": dense_p(inter, h),
                                  "ln_attn": ln_p(), "ln_mlp": ln_p()}
                   for i in range(c.num_layers)},
        "ln_f": ln_p(),
    }


class GPT2LMHead(nn.Module):
    """GPT-2 LM head over a param dict (eval only).

    ``hidden(params, input_ids)`` and ``logits(params, input_ids)`` take
    the param dict as the JAX model's methods do; ``forward(input_ids)``
    uses the dict given at construction.  Attention goes through
    :func:`dot_product_attention`, so prompts on CUDA run the flash
    kernel."""

    def __init__(self, config, params=None):
        super().__init__()
        self.config = config
        self.params = params

    def block(self, lp, x):
        """One pre-LN transformer block (``TransformerLayer.apply``)."""
        c = self.config
        b, s, hid = x.shape
        heads = c.num_heads
        y = layer_norm(lp["ln_attn"], x, c.layer_norm_eps)
        qkv = dense(lp["qkv"], y).reshape(b, s, 3, heads, hid // heads)
        ctx = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                    causal=True)
        x = x + dense(lp["attn_out"], ctx.reshape(b, s, hid))
        z = layer_norm(lp["ln_mlp"], x, c.layer_norm_eps)
        return x + dense(lp["fc2"], gelu(dense(lp["fc1"], z)))

    def hidden(self, params, input_ids):
        """Trunk + final layernorm -> [b, s, hidden]."""
        c = self.config
        s = input_ids.shape[1]
        x = params["wte"][input_ids] + params["wpe"][None, :s]
        for i in range(c.num_layers):
            x = self.block(params["blocks"][f"layer_{i}"], x)
        return layer_norm(params["ln_f"], x, c.layer_norm_eps)

    def logits(self, params, input_ids):
        x = self.hidden(params, input_ids)
        # tied LM head
        return x @ params["wte"].T.to(x.dtype)

    def forward(self, input_ids):
        return self.logits(self.params, input_ids)
