#!/usr/bin/env python3
"""B6a, B6b and B6c (the super-tile block-sparse kernels) on the card,
for the PyTorch/CUDA port.

Builds ``csrc/sparse_attention/flash_block_sparse_agg.cu`` with
``-Xptxas -v`` and reports each kernel's registers and spills, the fp16
ones of the library built apart (``-DDS_AGG_FP16``) too.  Then
builds copies of the source in which the bf16 kernels' bound of blocks
an SM at head_dim 64 (``kAggMinBlocks64Fwd``, ``kAggMinBlocks64Dq`` and
``kAggMinBlocks64Dkv``, all at once) takes each value of
``--min-blocks``, holds the source and each copy against the plain
versions (the bf16 out and lse to 2e-2, grads to 1e-2, at a causal blk
24 layout and the BERT layout), and times them side by side on one
card, in turns (forward order, then backward): B6a, B6b and B6c at the
sparse BERT attention the main path gives them (b=2, h=16, s=4096,
d=64, Fixed bidirectional blk 128, G=4, fused-QKV views), and the three
kernels at G = 1 at the sparse GPT-2 attention (Fixed unidirectional
blk 256, causal), where the bf16 B5a and B5b run them; then B6b and
B6c in their launch order and in grid order, beside SDPA's masked
backward.

    python3 examples/profile_torch_b6.py [--min-blocks 2 3 4] [--out PATH]

Times are device ms per launch (``chip_smoke.device_ms``: median of 10
runs of 10 launches between CUDA events).  Prints one JSON object (also
written to ``--out PATH``) with the card's name and power limit.
"""

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import \
    flash_block_sparse as fbs  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
    FixedSparsityConfig  # noqa: E402

SOURCE = op_builder.CSRC_DIR / op_builder.SOURCES["flash_block_sparse_agg"]
BOUNDS = re.compile(r"constexpr int (kAggMinBlocks64(?:Fwd|Dq|Dkv)) = "
                    r"(\d+);")


def use(lib_path):
    """Points the super-tile wrappers at ``lib_path``'s kernels."""
    lib = ctypes.CDLL(str(lib_path))
    fns = (lib.ds_fbs_agg_fwd, lib.ds_fbs_agg_bwd_dq, lib.ds_fbs_agg_bwd_dkv)
    for fn, argtypes in zip(fns, fbs.AGG_ARGTYPES):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    fbs._agg_kernels = lambda dtype: fns


def check(label):
    """The copy's bf16 B6a, B6b and B6c against the plain versions, and
    its bf16 B5a (the forward at G = 1) at a causal 256-row layout."""
    for i, (layout, b, h, s, G, causal) in enumerate((
            (np.tril(np.ones((1, 6, 6), np.int64)), 1, 4, 144, 3, True),
            (FixedSparsityConfig(**cs.BERT_SPARSE_LAYOUT).make_layout(1024),
             2, 16, 1024, 4, False))):
        q, k, v, _ = cs.make_case(b, h, s, s, 64, "none", True,
                                  torch.bfloat16, i)
        dout = torch.randn(b, s, h, 64, generator=torch.Generator()
                           .manual_seed(i)).to(cs.DEVICE, torch.bfloat16)
        out, lse = fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G, causal)
        ref_out, ref_lse = fbs.flash_block_sparse_agg_reference(
            q, k, v, layout, G, causal)
        torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2,
                                   rtol=2e-2, msg=lambda m: f"{label} "
                                   f"case {i} out: {m}")
        torch.testing.assert_close(lse, ref_lse, atol=2e-2, rtol=2e-2)
        got = fbs.flash_block_sparse_agg_bwd(q, k, v, out, lse, dout, layout,
                                             G, causal)
        ref = fbs.flash_block_sparse_agg_bwd_reference(
            q, k, v, out, lse, dout, layout, G, causal)
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            torch.testing.assert_close(
                a.float(), r.float(), atol=1e-2, rtol=1e-2,
                msg=lambda m: f"{label} case {i} {name}: {m}")
    layout = FixedSparsityConfig(**cs.SPARSE_LAYOUT).make_layout(2048)
    q, k, v, _ = cs.make_case(1, 16, 2048, 2048, 64, "none", True,
                              torch.bfloat16, 2)
    out, lse = fbs.flash_block_sparse_fwd(q, k, v, layout, True)
    ref_out, ref_lse = fbs.flash_block_sparse_reference(q, k, v, layout,
                                                        True)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2,
                               rtol=2e-2, msg=lambda m: f"{label} B5a: {m}")
    torch.testing.assert_close(lse, ref_lse, atol=2e-2, rtol=2e-2)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--min-blocks", type=int, nargs="+",
                        default=[2, 3, 4])
    parser.add_argument("--out", help="also write the result to this "
                        "JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_b6: needs a CUDA card", file=sys.stderr)
        return 1
    card = cs.card_line()
    build = op_builder.BUILD_DIR / "b6_variants"
    build.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    libs = {"source": build / "source.so"}
    result = {"card": card, "torch": torch.__version__,
              "source_min_blocks": dict(BOUNDS.findall(text)),
              "variants": {"source": {
                  "registers_spills": op_builder.ptxas_usage(
                      SOURCE, libs["source"])}},
              # the source's fp16 kernels, the library built apart
              "fp16_registers_spills": op_builder.ptxas_usage(
                  SOURCE, build / "source_fp16.so",
                  op_builder.DEFINES["flash_block_sparse_agg_fp16"])}
    for n in args.min_blocks:
        src = build / f"min_blocks_{n}.cu"
        src.write_text(BOUNDS.sub(rf"constexpr int \1 = {n};", text))
        libs[n] = build / f"min_blocks_{n}.so"
        result["variants"][n] = {
            "registers_spills": op_builder.ptxas_usage(src, libs[n])}
    for name, lib in libs.items():
        use(lib)
        check(f"min_blocks {name}")

    b, h, s, d = cs.SPARSE_ATTN
    layout = FixedSparsityConfig(**cs.BERT_SPARSE_LAYOUT).make_layout(s)
    G = 4
    q, k, v, _ = cs.make_case(b, h, s, s, d, "none", True, torch.bfloat16,
                              cs.SEED + 1000)
    dout = torch.randn(b, s, h, d, generator=torch.Generator()
                       .manual_seed(cs.SEED + 1001)).to(cs.DEVICE,
                                                        torch.bfloat16)
    use(libs["source"])
    out, lse = fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G)
    delta = fbs._delta(out, dout)
    # the sparse GPT-2 attention, where the bf16 B5b runs the same two
    # backward kernels at G = 1
    gpt = FixedSparsityConfig(**cs.SPARSE_LAYOUT).make_layout(s)
    g_q, g_k, g_v, _ = cs.make_case(b, h, s, s, d, "none", True,
                                    torch.bfloat16, cs.SEED + 600)
    g_out, g_lse = fbs.flash_block_sparse_fwd(g_q, g_k, g_v, gpt, True)
    g_delta = fbs._delta(g_out, dout)
    shapes = {
        "fwd": lambda: fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G),
        "b5a_fwd": lambda: fbs.flash_block_sparse_fwd(g_q, g_k, g_v, gpt,
                                                      True),
        "dq": lambda: fbs.flash_block_sparse_agg_bwd_dq(
            q, k, v, out, lse, dout, layout, G, False, delta),
        "dkv": lambda: fbs.flash_block_sparse_agg_bwd_dkv(
            q, k, v, out, lse, dout, layout, G, False, delta),
        "b5b_dq": lambda: fbs.flash_block_sparse_agg_bwd_dq(
            g_q, g_k, g_v, g_out, g_lse, dout, gpt, 1, True, g_delta),
        "b5b_dkv": lambda: fbs.flash_block_sparse_agg_bwd_dkv(
            g_q, g_k, g_v, g_out, g_lse, dout, gpt, 1, True, g_delta)}
    result["clocks_before"] = cs.clocks_line()
    for name in list(libs) + list(libs)[::-1]:
        use(libs[name])
        for label, fn in shapes.items():
            result["variants"][name].setdefault(label, []).append(
                cs.device_ms(fn))
    use(libs["source"])
    result["orders"] = cs.time_agg_orders(q, k, v, out, lse, dout, delta,
                                          layout, G)["launch_order"]
    visible, _ = fbs.expand_layout(layout, s, False, cs.DEVICE)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=visible)
    result["sdpa_masked_bwd_ms"] = cs.device_ms(lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True),
        calls=2, repeats=5, warmup=1)
    result["clocks_after"] = cs.clocks_line()
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
