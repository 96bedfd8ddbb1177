"""Environment / op-compatibility report (``ds_report_torch``; port of
``deepspeed_tpu/env_report.py``, the reference's ``ds_report``,
``deepspeed/env_report.py:23-100``).

The reference reports which CUDA extension ops can build against the
local torch/CUDA install; this one does the same for the port's
hand-written kernels: python, torch, the CUDA runtime torch was built
for, ``nvcc`` and its version, whether that ``nvcc`` targets ``sm_90a``
(the kernels' only target), the cards and their memory, and one row per
library of :mod:`~deepspeed_tpu_torch.ops.op_builder` — built, buildable,
or why not.  It runs, and exits 0, on a machine without a card or a
toolkit, and says so.
"""

import argparse
import importlib
import subprocess
import sys


def _try_version(mod):
    try:
        m = importlib.import_module(mod)
        return getattr(m, "__version__", "unknown")
    except Exception:
        return None


def _run(cmd):
    """stdout of ``cmd``, or None where it cannot run."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return proc.stdout if proc.returncode == 0 else None


def toolkit():
    """``{nvcc, version, sm_90a, gxx}``: the nvcc ``op_builder`` would use
    (None: none found), its release line, whether it lists ``sm_90a``
    among the codes it generates (None: unknown), and g++."""
    from .ops import op_builder

    out = {"nvcc": None, "version": None, "sm_90a": None, "gxx": None}
    try:
        out["nvcc"] = op_builder.find_nvcc()
    except RuntimeError:
        pass
    if out["nvcc"] is not None:
        text = _run([out["nvcc"], "--version"]) or ""
        lines = [ln for ln in text.splitlines() if "release" in ln]
        out["version"] = lines[-1].strip() if lines else None
        codes = _run([out["nvcc"], "--list-gpu-code"])
        out["sm_90a"] = None if codes is None else "sm_90a" in codes.split()
    try:
        out["gxx"] = op_builder.find_gxx()
    except RuntimeError:
        pass
    return out


def op_report(tools=None):
    """[(library, compatible, detail)] over every library ``op_builder``
    knows: the CUDA kernels (``SOURCES``) and the host kernels
    (``HOST_SOURCES``)."""
    from .ops import op_builder

    tools = tools or toolkit()
    rows = []
    for name, src in op_builder.SOURCES.items():
        built = op_builder.library_path(name).is_file()
        if built:
            rows.append((name, True, f"built ({src})"))
        elif tools["nvcc"] is None:
            rows.append((name, False, "no nvcc (set CUDA_HOME or put nvcc "
                         "on PATH)"))
        elif tools["sm_90a"] is False:
            rows.append((name, False, f"{tools['nvcc']} does not target "
                         "sm_90a"))
        else:
            rows.append((name, True, f"buildable ({src})"))
    for name, src in op_builder.HOST_SOURCES.items():
        if tools["gxx"] is None:
            rows.append((name, False, "no g++ on PATH"))
            continue
        built = op_builder.host_library_path(name).is_file()
        rows.append((name, True, f"{'built' if built else 'buildable'} "
                     f"({src}, g++)"))
    tb_ok = True
    try:
        from torch.utils import tensorboard  # noqa: F401
    except Exception:
        tb_ok = False
    rows.append(("tensorboard monitor", tb_ok,
                 "torch.utils.tensorboard"
                 + ("" if tb_ok else " MISSING — JSONL only")))
    return rows


def main(argv=None):
    argparse.ArgumentParser(
        prog="ds_report_torch",
        description="DeepSpeed-TPU PyTorch/CUDA port environment report: "
        "the toolchain, the cards and which kernels build").parse_args(argv)
    import torch

    print("-" * 64)
    print("DeepSpeed-TPU PyTorch/CUDA port environment report")
    print("-" * 64)
    print(f"python ................ {sys.version.split()[0]}")
    for mod in ("torch", "numpy", "triton"):
        v = _try_version(mod)
        print(f"{mod:<22} {v if v else 'NOT INSTALLED'}")
    print(f"torch CUDA runtime .... {torch.version.cuda or 'none (CPU build)'}")
    tools = toolkit()
    print(f"nvcc .................. {tools['nvcc'] or 'NOT FOUND'}")
    if tools["nvcc"] is not None:
        print(f"nvcc version .......... {tools['version'] or 'unknown'}")
        sm = {True: "yes", False: "NO", None: "unknown"}[tools["sm_90a"]]
        print(f"nvcc targets sm_90a ... {sm}")
    print(f"g++ ................... {tools['gxx'] or 'NOT FOUND'}")
    print("-" * 64)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        print("cards ................. none (no CUDA device)")
    for i in range(n):
        props = torch.cuda.get_device_properties(i)
        print(f"card {i} ................ {props.name}, "
              f"{props.total_memory / 1024 ** 3:.2f} GiB, "
              f"sm_{props.major}{props.minor}")
    print("-" * 64)
    print(f"{'op name':<28} {'compatible':<12} detail")
    print("-" * 64)
    for name, ok, detail in op_report(tools):
        mark = "[OKAY]" if ok else "[NO]"
        print(f"{name:<28} {mark:<12} {detail}")
    print("-" * 64)
    return 0


if __name__ == "__main__":
    sys.exit(main())
