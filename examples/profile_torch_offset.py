#!/usr/bin/env python3
"""The query-row offset's cost at offset 0: the port's attention kernels
(B1, B2a, B2b, B3, B4, B5a/B5b and B6a/B6b/B6c in bf16) of this checkout
against those of another checkout, on the same inputs at the kernel
table's shapes.

Builds the dense, dropout and super-tile sources of ``--base`` with the
port's nvcc flags (one nvcc a source, all started together) and calls
them through this checkout's wrappers, the arguments that the base's C
entries lack dropped (found by name in the two checkouts' sources:
here the query-row offset, and B6c's key length), so both builds see
the same tensors, strides and launch orders.  For each
kernel: whether its outputs are bitwise equal, and its device time in
the order base, this, this, base (median of 10 runs of 10 launches each,
``chip_smoke.device_ms``).

    python3 examples/profile_torch_offset.py --base build/parent [--out PATH]

Prints one line a kernel and one JSON object (also to ``--out PATH``)
with the card's name and power limit; exits 1 where a kernel's outputs
differ.
"""

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import \
    flash_block_sparse as fbs  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
    FixedSparsityConfig  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import \
    flash_attention as fa  # noqa: E402

SOURCES = {"flash_attention_fwd": "transformer/flash_attention_fwd.cu",
           "flash_attention_bwd": "transformer/flash_attention_bwd.cu",
           "flash_dropout": "transformer/flash_dropout.cu",
           "flash_block_sparse_agg":
               "sparse_attention/flash_block_sparse_agg.cu"}
ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def entry_params(root, name):
    """``{entry: [parameter names]}`` of the C entries of source ``name``
    in the checkout at ``root``."""
    text = (Path(root) / "deepspeed_tpu_torch" / "csrc" /
            SOURCES[name]).read_text()
    return {m.group(1): [re.findall(r"\w+", p)[-1]
                         for p in m.group(2).split(",")]
            for m in ENTRY.finditer(text)}


def dropped(base, this, entry):
    """The positions of ``this``'s parameters (names) that ``base``
    lacks; exits where the rest differ from ``base`` (a parameter
    removed, renamed or moved), which dropping cannot bridge."""
    drop = tuple(i for i, p in enumerate(this) if p not in base)
    if [p for i, p in enumerate(this) if i not in drop] != base:
        raise SystemExit(f"{entry}: the base's parameters {base} are not "
                         f"this checkout's {this} less some")
    return drop


def build(root, name, out):
    """``name``'s source of the checkout at ``root`` built into ``out``;
    returns ``(out, {kernel: [registers, spill bytes stored]})``."""
    csrc = Path(root) / "deepspeed_tpu_torch" / "csrc"
    cmd = [op_builder.find_nvcc(), *op_builder.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(csrc), "-o", str(out), str(csrc / SOURCES[name])]
    err = subprocess.run(cmd, check=True, capture_output=True,
                         text=True).stderr
    usage, kernel = {}, None
    for line in err.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if entry:
            kernel = op_builder.kernel_name(entry.group(1))
            usage[kernel] = [0, 0]
        elif spill and kernel:
            usage[kernel][1] = int(spill.group(1))
        elif regs and kernel:
            usage[kernel][0] = int(regs.group(1))
    return out, usage


def shim(fn, argtypes, drop):
    """``fn`` (a base entry) called with this checkout's arguments, those
    at ``drop`` left out."""
    fn.argtypes = [t for i, t in enumerate(argtypes) if i not in drop]
    fn.restype = ctypes.c_int

    def call(*args):
        return fn(*[a for i, a in enumerate(args) if i not in drop])
    return call


def base_entries(libs, base_root):
    """The wrappers' kernel getters pointed at the base libraries."""
    def base_shim(name, entry, cur):
        drop = dropped(entry_params(base_root, name)[entry],
                       entry_params(ROOT, name)[entry], entry)
        return shim(getattr(libs[name], entry), cur.argtypes, drop)

    fwd = base_shim("flash_attention_fwd", "ds_flash_attention_fwd",
                    fa._fwd_kernel())
    bwd = base_shim("flash_attention_bwd", "ds_flash_attention_bwd",
                    fa._bwd_kernel())
    keep = base_shim("flash_dropout", "ds_flash_keep_bits",
                     fa._keep_kernel())
    aggs = tuple(base_shim("flash_block_sparse_agg", entry, cur)
                 for entry, cur in zip(
                     ("ds_fbs_agg_fwd", "ds_fbs_agg_bwd_dq",
                      "ds_fbs_agg_bwd_dkv"),
                     fbs._agg_kernels(torch.bfloat16)))
    return {"_fwd_kernel": lambda: fwd, "_bwd_kernel": lambda: bwd,
            "_keep_kernel": lambda: keep,
            "_agg_kernels": lambda dtype: aggs}


@contextlib.contextmanager
def using(entries):
    """The wrappers on ``entries`` (None: this checkout's) inside."""
    saved = {name: getattr(fa if name != "_agg_kernels" else fbs, name)
             for name in ("_fwd_kernel", "_bwd_kernel", "_keep_kernel",
                          "_agg_kernels")}
    try:
        for name, fn in (entries or {}).items():
            setattr(fa if name != "_agg_kernels" else fbs, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(fa if name != "_agg_kernels" else fbs, name, fn)


def cases():
    """``{kernel: run()}`` at the kernel table's shapes, bf16: each run
    returns the kernel's outputs."""
    dev, bf = cs.DEVICE, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 51)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    # the train attention: b=8 h=16 s=1024 d=64, causal, dropout 0.1
    b, h, s, d = 8, 16, 1024, 64
    q, k, v, do = (randn(b, s, h, d) for _ in range(4))
    seed = cs.seed_words(cs.SEED + 51)
    bits = fa.draw_keep_bits(seed, b, h, s, s, cs.DROPOUT, True)
    out, lse = fa.flash_attention_fwd(q, k, v, None, True, cs.DROPOUT,
                                      keep_bits=bits)
    delta = fa._delta(out, do)
    train = (q, k, v, out, lse, do, None, True, cs.DROPOUT, bits, delta)
    # BERT's attention: b=64 s=128, a key mask, dropout 0.1
    bq, bk, bv, bdo = (randn(64, 128, 16, 64) for _ in range(4))
    mask = torch.ones(64, 128, device=dev)
    mask[::3, 100:] = 0.0
    bbits = fa.draw_keep_bits(seed, 64, 16, 128, 128, cs.DROPOUT, False)
    bout, blse = fa.flash_attention_fwd(bq, bk, bv, mask, False, cs.DROPOUT,
                                        keep_bits=bbits)
    bert = (bq, bk, bv, bout, blse, bdo, mask, False, cs.DROPOUT, bbits,
            fa._delta(bout, bdo))
    # the sparse GPT-2 (block 256, G = 1) and BERT (block 128, G = 4)
    # attentions: b=2 h=16 s=4096 d=64
    sb, sh, ss, sd = cs.SPARSE_ATTN
    sq, sk, sv, sdo = (randn(sb, ss, sh, sd) for _ in range(4))
    gpt_layout = FixedSparsityConfig(**cs.SPARSE_LAYOUT).make_layout(ss)
    bert_layout = FixedSparsityConfig(**cs.BERT_SPARSE_LAYOUT) \
        .make_layout(ss)
    s_out, s_lse = fbs.flash_block_sparse_fwd(sq, sk, sv, gpt_layout, True)
    a_out, a_lse = fbs.flash_block_sparse_agg_fwd(sq, sk, sv, bert_layout, 4)
    a_delta = fbs._delta(a_out, sdo)
    return {
        "B1": lambda: fa.flash_attention_fwd(q, k, v, None, True,
                                             cs.DROPOUT, keep_bits=bits),
        "B2a": lambda: (fa.flash_attention_bwd_dq(*train),),
        "B2b": lambda: fa.flash_attention_bwd_dkv(*train),
        "B3": lambda: fa.flash_attention_bwd_fused(*bert),
        "B4": lambda: (fa.draw_keep_bits(seed, b, h, s, s, cs.DROPOUT,
                                         True),),
        "B5a": lambda: fbs.flash_block_sparse_fwd(sq, sk, sv, gpt_layout,
                                                  True),
        "B5b": lambda: fbs.flash_block_sparse_bwd(sq, sk, sv, s_out, s_lse,
                                                  sdo, gpt_layout, True),
        "B6a": lambda: fbs.flash_block_sparse_agg_fwd(sq, sk, sv,
                                                      bert_layout, 4),
        "B6b": lambda: (fbs.flash_block_sparse_agg_bwd_dq(
            sq, sk, sv, a_out, a_lse, sdo, bert_layout, 4, False,
            a_delta),),
        "B6c": lambda: fbs.flash_block_sparse_agg_bwd_dkv(
            sq, sk, sv, a_out, a_lse, sdo, bert_layout, 4, False, a_delta)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--base", required=True,
                        help="root of the checkout to compare with")
    parser.add_argument("--out", help="also write the JSON here")
    args = parser.parse_args(argv)
    card = cs.card_line()
    op_builder.build()
    tmp = Path(tempfile.mkdtemp(prefix="offset_", dir=ROOT / "build"))
    jobs = [(root, n) for root in (args.base, ROOT) for n in SOURCES]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build(
            job[0], job[1], tmp / f"{job[0] == ROOT}_{job[1]}.so"), jobs))
    libs = {n: ctypes.CDLL(str(out)) for (root, n), (out, _) in
            zip(jobs, built) if root != ROOT}
    # registers and spill bytes a kernel, base against this checkout
    usage = {}
    for (root, _), (_, kernels) in zip(jobs, built):
        for kernel, ru in kernels.items():
            usage.setdefault(kernel, {})["this" if root == ROOT
                                         else "base"] = ru
    base = base_entries(libs, args.base)
    runs = cases()
    rows, ok = {}, True
    for name, run in runs.items():
        with using(base):
            want = [t.clone() for t in run()]
        got = [t.clone() for t in run()]
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        times = []
        for entries in (base, None, None, base):
            with using(entries):
                times.append(cs.device_ms(run))
        rows[name] = {"bitwise": same, "base_ms": [times[0], times[3]],
                      "ms": [times[1], times[2]],
                      "ratio": (times[1] + times[2]) / (times[0] + times[3])}
        ok = ok and same
        print(f"{name}: bitwise {same}, base {times[0]:.5f} / "
              f"{times[3]:.5f} ms, this {times[1]:.5f} / {times[2]:.5f} ms, "
              f"ratio {rows[name]['ratio']:.4f} [{card}]")
    changed = {k: v for k, v in usage.items() if v.get("base") != v.get(
        "this")}
    print("registers, spill bytes (base, this) where they differ:",
          json.dumps(changed))
    result = {"card": card, "base": args.base, "kernels": rows,
              "registers_spills": usage, "clocks": cs.clocks_line()}
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
