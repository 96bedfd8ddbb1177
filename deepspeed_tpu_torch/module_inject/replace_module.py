"""GPT-2 weight surgery for serving (port of
``deepspeed_tpu/module_inject/replace_module.py:102-197``).

HF GPT-2 checkpoints already store the fused ``[h, 3h]`` qkv kernel in
``[in, out]`` layout, so injection is a pure re-keying of the param
tree.  These functions only move dict entries, so they work on trees
whose leaves are numpy arrays or torch tensors alike.  The BERT policy
comes with the training slice.
"""

import numpy as np
import torch

from ..utils.params import tree_map


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
        idx = int(str(key).split("_")[-1]) if not str(key).isdigit() \
            else int(key)
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
