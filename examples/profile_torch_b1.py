#!/usr/bin/env python3
"""B1's build and its launch bound on the card, for the PyTorch/CUDA port.

Builds ``csrc/transformer/flash_attention_fwd.cu`` with ``-Xptxas -v``
and reports each kernel's registers and spills.  Then builds copies of
the source in which the bf16 kernel's bound of blocks an SM at head_dim
64 (``kMinBlocks64`` without dropout, ``kMinBlocks64Dropout`` with it)
takes each value of ``--min-blocks``, holds the source and each copy
against the plain version (bf16 out to 2e-2, lse to 1e-4, the masked
row, dropout), and times them side by side on one card, in turns
(forward order, then backward), at the shapes B1's main paths give it:
GPT-2-medium's training attention (b=8, h=16, s=1024, d=64, causal,
fused-QKV views) with dropout 0.1 (on keep bits B4 drew once, outside
the timed runs) and without, the serve bucket s=1024 (b=1) and BERT's
b=64, s=128 with a key mask and dropout 0.1.

    python3 examples/profile_torch_b1.py [--min-blocks 3 4] [--out PATH]

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

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import \
    flash_attention as fa  # noqa: E402

SOURCE = op_builder.CSRC_DIR / op_builder.SOURCES["flash_attention_fwd"]
BOUNDS = re.compile(r"constexpr int (kMinBlocks64(?:Dropout)?) = (\d+);")


def use(lib_path):
    """Points the forward wrapper at ``lib_path``'s kernel."""
    fn = ctypes.CDLL(str(lib_path)).ds_flash_attention_fwd
    fn.argtypes = fa.FWD_ARGTYPES
    fn.restype = ctypes.c_int
    fa._fwd_kernel = lambda: fn


def check(label):
    """The copy against the plain version at the edges of its tiles."""
    for i, (b, h, s, kv_len, causal, kind, rate) in enumerate((
            (1, 16, 65, 65, True, "tail", 0.0),
            (1, 8, 100, 201, False, "tail", 0.1),
            (2, 16, 1024, 1024, False, "row", 0.0),
            (cs.BERT_BATCH, 16, cs.BERT_PRED + 1, cs.BERT_SEQ, False, "tail",
             0.1))):
        q, k, v, mask = cs.make_case(b, h, s, kv_len, 64, kind, False,
                                     torch.bfloat16, i)
        seed = cs.seed_words(i) if rate else None
        out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, rate, seed)
        ref_out, ref_lse = fa.flash_attention_reference(
            q, k, v, mask, causal, *cs.plain_keep(q, k, rate, seed))
        torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2,
                                   rtol=2e-2, msg=lambda m: f"{label}: {m}")
        torch.testing.assert_close(lse, ref_lse, atol=cs.BF16_LSE_TOL,
                                   rtol=cs.BF16_LSE_TOL,
                                   msg=lambda m: f"{label} lse: {m}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--min-blocks", type=int, nargs="+",
                        default=[2, 3, 4])
    parser.add_argument("--out", help="also write the result to this "
                        "JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_b1: needs a CUDA card", file=sys.stderr)
        return 1
    card = cs.card_line()
    build = op_builder.BUILD_DIR / "b1_variants"
    build.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    libs = {"source": build / "source.so"}
    result = {"card": card, "torch": torch.__version__,
              "source_min_blocks": dict(BOUNDS.findall(text)),
              "variants": {"source": {
                  "registers_spills": op_builder.ptxas_usage(
                      SOURCE, libs["source"])}}}
    for n in args.min_blocks:
        src = build / f"min_blocks_{n}.cu"
        src.write_text(BOUNDS.sub(rf"constexpr int \1 = {n};", text))
        libs[n] = build / f"min_blocks_{n}.so"
        result["variants"][n] = {
            "registers_spills": op_builder.ptxas_usage(src, libs[n])}
    for name, lib in libs.items():
        use(lib)
        check(f"min_blocks {name}")

    b, h, s, d = cs.TRAIN_ATTN
    g = torch.Generator().manual_seed(cs.SEED + 5)
    qkv = torch.randn(b, s, 3, h, d, generator=g).to(cs.DEVICE,
                                                      torch.bfloat16)
    train = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    seed = cs.seed_words(cs.SEED + 6)
    serve = cs.make_case(1, 16, 1024, 1024, 64, "tail", True,
                         torch.bfloat16, 0)
    bert = cs.make_case(cs.BERT_BATCH, 16, cs.BERT_SEQ, cs.BERT_SEQ, 64,
                        "none", False, torch.bfloat16, 1)[:3] + (
        torch.ones(cs.BERT_BATCH, cs.BERT_SEQ, device=cs.DEVICE),)
    # B1 alone: each shape's keep bits drawn once by B4, outside the runs
    train_bits = cs.draw_bits(train[0], train[1], True, cs.DROPOUT, seed)
    bert_bits = cs.draw_bits(bert[0], bert[1], False, cs.DROPOUT, seed)
    shapes = {
        "train_dropout": lambda: fa.flash_attention_fwd(
            *train, None, True, cs.DROPOUT, keep_bits=train_bits),
        "train": lambda: fa.flash_attention_fwd(*train, None, True),
        "serve_s1024": lambda: fa.flash_attention_fwd(*serve, True),
        "bert_dropout": lambda: fa.flash_attention_fwd(
            *bert, False, cs.DROPOUT, keep_bits=bert_bits)}
    result["clocks_before"] = cs.clocks_line()
    for name in list(libs) + list(libs)[::-1]:
        use(libs[name])
        for label, fn in shapes.items():
            result["variants"][name].setdefault(label, []).append(
                cs.device_ms(fn))
    result["clocks_after"] = cs.clocks_line()
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
