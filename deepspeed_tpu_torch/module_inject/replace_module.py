"""Module injection by weight surgery (port of
``deepspeed_tpu/module_inject/replace_module.py``): HF BERT and GPT-2
layer params to the port's ``TransformerLayer`` params and back.

- :func:`inject_bert_layer` / :func:`revert_bert_layer`: one HF BERT
  encoder layer's params to the fused layer's (q, k and v concatenated
  into the ``[h, 3h]`` qkv kernel, the reference's
  ``replace_transformer_layer`` weight copy) and back, for checkpoint
  export; :func:`replace_transformer_layer` does every layer of an
  encoder.  The fused layer is post-LayerNorm with tanh GELU, HF's
  ``hidden_act='gelu_new'``.
- The GPT-2 policy: HF GPT-2 checkpoints already store the fused
  ``[h, 3h]`` qkv kernel in ``[in, out]`` layout, so injection is a pure
  re-keying of the param tree.
- :func:`replace_module`: the generic walker that applies a policy at
  every matching subtree.

These functions only move, slice and concatenate leaves, so they work on
trees whose leaves are numpy arrays or torch tensors alike.
"""

import numpy as np
import torch

from ..utils.params import tree_map


def _concat(parts, axis):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def _layer_index(key):
    return int(key) if str(key).isdigit() else int(str(key).split("_")[-1])


def inject_bert_layer(hf_layer):
    """HF BERT layer params -> the fused layer's params (qkv
    concatenated)."""
    att = hf_layer["attention"]
    self_att = att["self"]
    parts = [self_att[n] for n in ("query", "key", "value")]
    return {
        "qkv": {"kernel": _concat([p["kernel"] for p in parts], 1),
                "bias": _concat([p["bias"] for p in parts], 0)},
        "attn_out": {"kernel": att["output"]["dense"]["kernel"],
                     "bias": att["output"]["dense"]["bias"]},
        "fc1": {"kernel": hf_layer["intermediate"]["dense"]["kernel"],
                "bias": hf_layer["intermediate"]["dense"]["bias"]},
        "fc2": {"kernel": hf_layer["output"]["dense"]["kernel"],
                "bias": hf_layer["output"]["dense"]["bias"]},
        "ln_attn": {"scale": att["output"]["LayerNorm"]["scale"],
                    "bias": att["output"]["LayerNorm"]["bias"]},
        "ln_mlp": {"scale": hf_layer["output"]["LayerNorm"]["scale"],
                   "bias": hf_layer["output"]["LayerNorm"]["bias"]},
    }


def revert_bert_layer(ours, hidden_size):
    """The fused layer's params -> HF BERT layer params (checkpoint
    export): the exact inverse of :func:`inject_bert_layer`."""
    h = hidden_size
    k = ours["qkv"]["kernel"]
    b = ours["qkv"]["bias"]
    return {
        "attention": {
            "self": {
                "query": {"kernel": k[:, :h], "bias": b[:h]},
                "key": {"kernel": k[:, h:2 * h], "bias": b[h:2 * h]},
                "value": {"kernel": k[:, 2 * h:], "bias": b[2 * h:]},
            },
            "output": {
                "dense": {"kernel": ours["attn_out"]["kernel"],
                          "bias": ours["attn_out"]["bias"]},
                "LayerNorm": {"scale": ours["ln_attn"]["scale"],
                              "bias": ours["ln_attn"]["bias"]},
            },
        },
        "intermediate": {"dense": {"kernel": ours["fc1"]["kernel"],
                                   "bias": ours["fc1"]["bias"]}},
        "output": {
            "dense": {"kernel": ours["fc2"]["kernel"],
                      "bias": ours["fc2"]["bias"]},
            "LayerNorm": {"scale": ours["ln_mlp"]["scale"],
                          "bias": ours["ln_mlp"]["bias"]},
        },
    }


def replace_transformer_layer(hf_encoder_params, revert=False,
                              hidden_size=None):
    """Every layer of an HF BERT encoder param tree (``{'layer': {'0':
    ...}}`` or ``{'0': ...}``) to fused-layer params keyed ``layer_i``,
    or back (keyed ``'i'``) with ``revert=True``, which needs
    ``hidden_size``."""
    if revert and hidden_size is None:
        raise ValueError("revert needs hidden_size")
    layers = hf_encoder_params.get("layer", hf_encoder_params)
    out = {}
    for key, sub in layers.items():
        idx = _layer_index(key)
        if revert:
            out[str(idx)] = revert_bert_layer(sub, hidden_size)
        else:
            out[f"layer_{idx}"] = inject_bert_layer(sub)
    return out


def inject_gpt2_layer(hf_block):
    """HF GPT-2 block params -> the port's block params: ``ln_1``/``ln_2``
    become the pre-LN ``ln_attn``/``ln_mlp``."""
    att = hf_block["attn"]
    mlp = hf_block["mlp"]
    return {
        "qkv": {"kernel": att["c_attn"]["kernel"],
                "bias": att["c_attn"]["bias"]},
        "attn_out": {"kernel": att["c_proj"]["kernel"],
                     "bias": att["c_proj"]["bias"]},
        "fc1": {"kernel": mlp["c_fc"]["kernel"],
                "bias": mlp["c_fc"]["bias"]},
        "fc2": {"kernel": mlp["c_proj"]["kernel"],
                "bias": mlp["c_proj"]["bias"]},
        "ln_attn": {"scale": hf_block["ln_1"]["scale"],
                    "bias": hf_block["ln_1"]["bias"]},
        "ln_mlp": {"scale": hf_block["ln_2"]["scale"],
                   "bias": hf_block["ln_2"]["bias"]},
    }


def revert_gpt2_layer(ours):
    """Exact inverse of :func:`inject_gpt2_layer` (checkpoint export)."""
    return {
        "ln_1": {"scale": ours["ln_attn"]["scale"],
                 "bias": ours["ln_attn"]["bias"]},
        "attn": {
            "c_attn": {"kernel": ours["qkv"]["kernel"],
                       "bias": ours["qkv"]["bias"]},
            "c_proj": {"kernel": ours["attn_out"]["kernel"],
                       "bias": ours["attn_out"]["bias"]},
        },
        "ln_2": {"scale": ours["ln_mlp"]["scale"],
                 "bias": ours["ln_mlp"]["bias"]},
        "mlp": {
            "c_fc": {"kernel": ours["fc1"]["kernel"],
                     "bias": ours["fc1"]["bias"]},
            "c_proj": {"kernel": ours["fc2"]["kernel"],
                       "bias": ours["fc2"]["bias"]},
        },
    }


def replace_gpt2_transformer_layer(hf_blocks, revert=False):
    """Convert every block of an HF GPT-2 transformer (``{'h': {'0': ...}}``
    or ``{'0': ...}``) to block params keyed ``layer_i``, or back with
    ``revert=True``."""
    blocks = hf_blocks.get("h", hf_blocks)
    out = {}
    for key, sub in blocks.items():
        idx = _layer_index(key)
        if revert:
            out[str(idx)] = revert_gpt2_layer(sub)
        else:
            out[f"layer_{idx}"] = inject_gpt2_layer(sub)
    return out


def ingest_gpt2_model(hf_params):
    """Full HF GPT-2 LM param tree -> the port's GPT-2 params: embeddings
    remapped (``wte.embedding`` -> ``wte``), every block through the
    injection policy, final layernorm carried over.  Accepts the full
    tree (``{'transformer': {...}}``) or the transformer subtree."""
    t = hf_params.get("transformer", hf_params)
    return {
        "wte": t["wte"]["embedding"],
        "wpe": t["wpe"]["embedding"],
        "blocks": replace_gpt2_transformer_layer(t),
        "ln_f": {"scale": t["ln_f"]["scale"], "bias": t["ln_f"]["bias"]},
    }


def cast_weights(params, dtype):
    """Cast every floating-point leaf of a param tree to ``dtype``
    (serving-time bf16 ingestion); integer leaves pass through.  Tensor
    leaves take a torch dtype, numpy leaves a numpy dtype."""
    def cast(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.to(dtype) if leaf.is_floating_point() else leaf
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating):
            return arr.astype(dtype)
        return arr

    return tree_map(cast, params)


def replace_module(params, policy, match):
    """Generic walker: ``policy(subtree)`` at every subtree for which
    ``match(path, subtree)`` is true, other nodes copied unchanged;
    ``path`` is a '/'-joined key string."""
    def walk(node, path):
        if isinstance(node, dict):
            if match(path, node):
                return policy(node)
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        return node

    return walk(params, "")
