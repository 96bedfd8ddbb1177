#!/usr/bin/env python3
"""Whether the port's tensor-core kernels compile to the same machine
code in two checkouts: the proof that a change which adds instantiations
of a kernel template left the existing ones as they were.

Builds the dense flash sources (``csrc/transformer/flash_attention_fwd.cu``
and ``flash_attention_bwd.cu``) and the super-tile source
(``csrc/sparse_attention/flash_block_sparse_agg.cu``) of this checkout and
of ``--base`` with the port's nvcc flags, dumps each library's SASS with
``cuobjdump -sass``, and compares every kernel of ``--base`` with the
kernel of this checkout whose demangled name is the same once the element
type argument a template gained (``__nv_bfloat16, ``) is dropped.  The
instructions are compared with their addresses and encodings stripped.

    python3 examples/profile_torch_sass.py --base build/parent [--out PATH]

Prints one line per kernel (identical, or the number of differing
instructions) and one JSON object, also written to ``--out PATH``, with
the card's name and power limit; exits 1 if a kernel of ``--base`` is
missing or differs.
"""

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deepspeed_tpu_torch.ops import op_builder  # noqa: E402

SOURCES = ("transformer/flash_attention_fwd.cu",
           "transformer/flash_attention_bwd.cu",
           "sparse_attention/flash_block_sparse_agg.cu")
# an instruction line of `cuobjdump -sass`: /*0a70*/  OP operands ;  /* enc */
INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]+\*/\s*(.*?)\s*;?\s*/\*[^*]*\*/\s*$")


def build(root, source, out):
    csrc = Path(root) / "deepspeed_tpu_torch" / "csrc"
    cmd = [op_builder.find_nvcc(), *op_builder.NVCC_FLAGS, "-I", str(csrc),
           "-o", str(out), str(csrc / source)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def demangle(names):
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return out.splitlines()


def kernels(lib):
    """{demangled kernel name with the bf16 type argument dropped:
    [instructions]} of a library."""
    cuobjdump = Path(op_builder.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    functions, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            functions[name] = []
            continue
        ins = INSTRUCTION.match(line)
        if name and ins:
            functions[name].append(ins.group(1))
    plain = demangle(list(functions))
    return {re.sub(r"<__nv_bfloat16, ", "<", p): functions[m]
            for p, m in zip(plain, functions)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--base", required=True,
                        help="root of the checkout to compare with")
    parser.add_argument("--out", help="also write the JSON result here")
    args = parser.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows, ok = [], True
    with tempfile.TemporaryDirectory() as tmp:
        for source in SOURCES:
            libs = []
            for tag, root in (("base", args.base), ("this", ROOT)):
                lib = Path(tmp) / f"{tag}-{Path(source).stem}.so"
                build(root, source, lib)
                libs.append(kernels(lib))
            base, this = libs
            for name, code in sorted(base.items()):
                other = this.get(name)
                differ = (None if other is None else
                          sum(a != b for a, b in zip(code, other))
                          + abs(len(code) - len(other)))
                ok &= differ == 0
                rows.append({"source": source, "kernel": name,
                             "instructions": len(code),
                             "differing": differ})
                print(f"{source} {name}: "
                      + ("missing" if differ is None else
                         "identical" if differ == 0 else
                         f"{differ} instructions differ")
                      + f" ({len(code)} instructions) [{card}]")
            rows.append({"source": source, "new_kernels": sorted(
                set(this) - set(base))})
    result = {"card": card, "identical": ok, "kernels": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"card": card, "identical": ok,
                      "kernels_compared": sum("kernel" in r for r in rows)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
