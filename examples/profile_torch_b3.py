#!/usr/bin/env python3
"""B3, the fused dense backward, on the card, for the PyTorch/CUDA port.

Builds ``csrc/transformer/flash_attention_bwd.cu`` with ``-Xptxas -v``
and reports each kernel's registers and spills.  Then builds copies of
the source in which the query rows up to which the bf16 B3 runs 4 warps
a block instead of 8 (``kFusedNarrowRows``) take each value of
``--narrow-rows`` (0: always 8 warps; 160: always 4 at d=64), holds the
source and each copy against the plain backward (bf16 grads to 1e-2
with a padding key mask and dropout 0.1, causal at s=65), and times
them side by side on one card, in turns (forward order, then backward),
beside B2a+B2b on the same precomputed Δ, at the shapes of the BERT
train phase (h=16, d=64, bf16, a key mask of ones, dropout 0.1): b=64
and b=8 at s=128, the last layer's 21 gathered rows against 128 keys at
b=64, and, to place the crossover, s = kv_len = 64 and 160 at b=64 and
s = kv_len = 128 at d=128.

    python3 examples/profile_torch_b3.py [--narrow-rows 0 160] [--out PATH]

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

SOURCE = op_builder.CSRC_DIR / op_builder.SOURCES["flash_attention_bwd"]
NARROW = re.compile(r"constexpr int kFusedNarrowRows = (\d+);")
# label -> (b, s, kv_len, d)
SHAPES = {"bert_b64_s128": (cs.BERT_BATCH, cs.BERT_SEQ, cs.BERT_SEQ, 64),
          "bert_b64_gathered_s21": (cs.BERT_BATCH, cs.BERT_PRED + 1,
                                    cs.BERT_SEQ, 64),
          "bert_b8_s128": (8, cs.BERT_SEQ, cs.BERT_SEQ, 64),
          "b64_s64": (cs.BERT_BATCH, 64, 64, 64),
          "b64_s160": (cs.BERT_BATCH, 160, 160, 64),
          "b64_s128_d128": (cs.BERT_BATCH, 128, 128, 128)}


def use(lib_path):
    """Points the backward wrappers at ``lib_path``'s kernels."""
    fn = ctypes.CDLL(str(lib_path)).ds_flash_attention_bwd
    fn.argtypes = fa.BWD_ARGTYPES
    fn.restype = ctypes.c_int
    fa._bwd_kernel = lambda: fn


def check(label):
    """The copy's bf16 B3 against the plain backward."""
    for i, (b, s, kv_len, causal, rate) in enumerate((
            (2, 128, 128, False, 0.1), (2, 65, 65, True, 0.1),
            (cs.BERT_BATCH, cs.BERT_PRED + 1, cs.BERT_SEQ, False, 0.1))):
        q, k, v, mask = cs.make_case(b, 16, s, kv_len, 64, "tail", False,
                                     torch.bfloat16, i)
        dout = torch.randn(b, s, 16, 64, generator=torch.Generator()
                           .manual_seed(i)).to(cs.DEVICE, torch.bfloat16)
        seed = cs.seed_words(i)
        bits = fa.draw_keep_bits(seed, b, 16, s, kv_len, rate, causal)
        out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, rate,
                                          keep_bits=bits)
        got = fa.flash_attention_bwd_fused(q, k, v, out, lse, dout, mask,
                                           causal, rate, bits)
        keep, inv_keep = cs.plain_keep(q, k, rate, seed)
        ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, dout, mask,
                                               causal, keep, inv_keep)
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            torch.testing.assert_close(
                a.float(), r.float(), atol=1e-2, rtol=1e-2,
                msg=lambda m: f"{label} case {i} {name}: {m}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--narrow-rows", type=int, nargs="+",
                        default=[0, 160])
    parser.add_argument("--out", help="also write the result to this "
                        "JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_b3: needs a CUDA card", file=sys.stderr)
        return 1
    card = cs.card_line()
    build = op_builder.BUILD_DIR / "b3_variants"
    build.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    libs = {"source": build / "source.so"}
    result = {"card": card, "torch": torch.__version__,
              "source_narrow_rows": NARROW.search(text).group(1),
              "variants": {"source": {
                  "registers_spills": op_builder.ptxas_usage(
                      SOURCE, libs["source"])}}}
    for n in args.narrow_rows:
        src = build / f"narrow_rows_{n}.cu"
        src.write_text(NARROW.sub(f"constexpr int kFusedNarrowRows = {n};",
                                  text))
        libs[n] = build / f"narrow_rows_{n}.so"
        result["variants"][n] = {
            "registers_spills": op_builder.ptxas_usage(src, libs[n])}
    for name, lib in libs.items():
        use(lib)
        check(f"narrow rows {name}")

    g = torch.Generator().manual_seed(cs.SEED + 7)
    seed = cs.seed_words(cs.SEED + 8)
    cases = {}
    for label, (b, s, kv_len, d) in SHAPES.items():
        q = torch.randn(b, s, 16, d, generator=g).to(cs.DEVICE,
                                                     torch.bfloat16)
        k, v = (torch.randn(b, kv_len, 16, d, generator=g)
                .to(cs.DEVICE, torch.bfloat16) for _ in range(2))
        dout = torch.randn(b, s, 16, d, generator=g).to(cs.DEVICE,
                                                        torch.bfloat16)
        mask = torch.ones(b, kv_len, device=cs.DEVICE)
        # the backward kernels alone: on keep bits B4 drew once
        bits = cs.draw_bits(q, k, False, cs.DROPOUT, seed)
        out, lse = fa.flash_attention_fwd(q, k, v, mask, False, cs.DROPOUT,
                                          keep_bits=bits)
        args_ = (q, k, v, out, lse, dout, mask, False, cs.DROPOUT)
        cases[label] = (args_, fa._delta(out, dout), bits)
    use(libs["source"])
    result["b2_ms"] = {label: cs.device_ms(lambda: cs.b2_pair(
        *a, delta=delta, keep_bits=bits))
        for label, (a, delta, bits) in cases.items()}
    result["clocks_before"] = cs.clocks_line()
    for name in list(libs) + list(libs)[::-1]:
        use(libs[name])
        for label, (a, delta, bits) in cases.items():
            result["variants"][name].setdefault(label, []).append(
                cs.device_ms(lambda: fa.flash_attention_bwd_fused(
                    *a, delta=delta, keep_bits=bits)))
    result["clocks_after"] = cs.clocks_line()
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
