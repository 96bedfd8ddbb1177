"""Prefill/decode forwards over a GPT-2 param dict with a paged KV cache
(port of ``deepspeed_tpu/inference/model.py``).

- ``prefill``: one request, padded to a declared bucket length — full
  causal self-attention over the padded prompt (the flash kernel on
  CUDA), per-layer K/V written into the request's cache blocks, next
  token read at the true last position.
- ``decode``: the fixed-width continuous batch — one token per slot,
  K/V appended through the block table, paged gather of each slot's
  context, one-position dense attention.

Both write ``k_cache`` and ``v_cache`` IN PLACE (the JAX package donates
the buffers to the same effect) and return only the next token(s).  The
math is the JAX package's, op for op — fp32 layernorm, fused-QKV dense,
fp32-softmax attention, tanh-GELU MLP, tied LM head — so greedy decode
through the cache is token-identical to the full-forward reference.
"""

import torch

from ..models.layers import dense, gelu, layer_norm
from ..ops.transformer.attention import dot_product_attention


def build_prefill(model_config, icfg, bucket_len):
    """The bucket's prefill callable ``(params, k_cache, v_cache,
    input_ids [1, S], true_len, block_table) -> next_token``.
    ``block_table`` is the request's int64 table row on the cache's
    device; ``true_len`` a Python int."""
    c = model_config
    bs = icfg.kv_block_size
    heads, head_dim = c.num_heads, c.hidden_size // c.num_heads
    if bucket_len % bs:
        raise ValueError(f"bucket {bucket_len} is not a multiple of the KV "
                         f"block size {bs}")

    def prefill(params, k_cache, v_cache, input_ids, true_len, block_table):
        s = input_ids.shape[1]
        x = params["wte"][input_ids] + params["wpe"][None, :s]
        # pad keys masked out of every softmax row; the causal structure
        # already hides them from positions < true_len, so this only
        # pins the (discarded) pad rows
        visible = (torch.arange(s, device=x.device)[None, :]
                   < true_len).float()
        blocks = block_table[:s // bs]
        for i in range(c.num_layers):
            lp = params["blocks"][f"layer_{i}"]
            y = layer_norm(lp["ln_attn"], x, c.layer_norm_eps)
            qkv = dense(lp["qkv"], y).reshape(1, s, 3, heads, head_dim)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            # whole blocks: S is a bucket, a multiple of the block size
            k_cache[i, blocks] = k[0].reshape(s // bs, bs, heads,
                                              head_dim).to(k_cache.dtype)
            v_cache[i, blocks] = v[0].reshape(s // bs, bs, heads,
                                              head_dim).to(v_cache.dtype)
            ctx = dot_product_attention(q, k, v, key_padding_mask=visible,
                                        causal=True)
            x = x + dense(lp["attn_out"], ctx.reshape(1, s, c.hidden_size))
            z = layer_norm(lp["ln_mlp"], x, c.layer_norm_eps)
            x = x + dense(lp["fc2"], gelu(dense(lp["fc1"], z)))
        x = layer_norm(params["ln_f"], x, c.layer_norm_eps)
        last = x[0, true_len - 1]
        logits = last @ params["wte"].T.to(last.dtype)
        return torch.argmax(logits)

    return prefill


def build_decode(model_config, icfg):
    """The decode callable ``(params, k_cache, v_cache, block_tables,
    ctx_lens, tokens) -> next_tokens`` for the fixed ``max_batch_slots``
    wide continuous batch (int64 index tensors on the cache's device).

    ``ctx_lens[b]`` is the context length BEFORE this token, i.e. the
    new token's position; inactive slots park at position 0 of the null
    block and their output is discarded on the host."""
    c = model_config
    bs = icfg.kv_block_size
    n_slots = icfg.max_batch_slots
    max_seq = icfg.max_seq_len
    heads, head_dim = c.num_heads, c.hidden_size // c.num_heads

    def decode(params, k_cache, v_cache, block_tables, ctx_lens, tokens):
        x = params["wte"][tokens] + params["wpe"][ctx_lens]      # [B, h]
        x = x[:, None, :]                                        # [B, 1, h]
        block_ids = block_tables.gather(1, (ctx_lens // bs)[:, None])[:, 0]
        offsets = ctx_lens % bs
        # after the write, each slot's valid context includes its own
        # new token at position ctx_len
        visible = (torch.arange(max_seq, device=x.device)[None, :]
                   <= ctx_lens[:, None]).float()
        for i in range(c.num_layers):
            lp = params["blocks"][f"layer_{i}"]
            y = layer_norm(lp["ln_attn"], x, c.layer_norm_eps)
            qkv = dense(lp["qkv"], y).reshape(n_slots, 3, heads, head_dim)
            q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
            # one indexed write for every slot.  Inactive slots all land
            # on (null block 0, offset 0): the duplicate writes there race,
            # harmlessly, since that block is scratch no live slot reads
            k_cache[i, block_ids, offsets] = k_new.to(k_cache.dtype)
            v_cache[i, block_ids, offsets] = v_new.to(v_cache.dtype)
            # paged gather: [B, blocks_per_seq, bs, h, d] -> [B, S, h, d]
            k_ctx = k_cache[i][block_tables].reshape(n_slots, max_seq, heads,
                                                     head_dim)
            v_ctx = v_cache[i][block_tables].reshape(n_slots, max_seq, heads,
                                                     head_dim)
            ctx = dot_product_attention(q[:, None].to(x.dtype),
                                        k_ctx.to(x.dtype), v_ctx.to(x.dtype),
                                        key_padding_mask=visible)
            x = x + dense(lp["attn_out"], ctx.reshape(n_slots, 1,
                                                      c.hidden_size))
            z = layer_norm(lp["ln_mlp"], x, c.layer_norm_eps)
            x = x + dense(lp["fc2"], gelu(dense(lp["fc1"], z)))
        x = layer_norm(params["ln_f"], x, c.layer_norm_eps)
        logits = x[:, 0] @ params["wte"].T.to(x.dtype)
        return torch.argmax(logits, dim=-1)

    return decode


def reference_generate(model, params, prompt, max_new_tokens,
                       eos_token_id=-1):
    """The naive one-request-at-a-time reference: full forward over the
    whole growing context per token, greedy argmax.  O(n^2) recompute —
    it exists to be the parity oracle the cached engine must match token
    for token, not to be fast."""
    device = params["wte"].device
    ids = [int(t) for t in prompt]
    out = []
    for _ in range(max_new_tokens):
        logits = model.logits(params, torch.tensor([ids], device=device))
        nxt = int(torch.argmax(logits[0, -1]))
        out.append(nxt)
        ids.append(nxt)
        if eos_token_id >= 0 and nxt == eos_token_id:
            break
    return out
