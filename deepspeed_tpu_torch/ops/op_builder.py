"""Builds the port's CUDA sources at first use and loads them with ctypes.

Takes the role of ``deepspeed_tpu/ops/op_builder.py``: there a builder
JIT-compiles the host C++ kernel; here each ``csrc/**/*.cu`` source is
compiled by ``nvcc`` into its own shared library with a plain C
interface, built for Hopper (``sm_90a``), and loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds.

Libraries land in ``build/deepspeed_tpu_torch/`` beside the package,
named by a hash of the source, the headers under ``csrc/`` (which is on
the include path) and the flags, so an edited source or header is rebuilt and an unchanged one is loaded as it is.  A failed build raises
with nvcc's stderr; there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "deepspeed_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel library name -> source under csrc/
SOURCES = {
    "flash_attention_fwd": "transformer/flash_attention_fwd.cu",
    "flash_attention_bwd": "transformer/flash_attention_bwd.cu",
    "flash_block_sparse": "sparse_attention/flash_block_sparse.cu",
}

_lock = threading.Lock()
_loaded = {}


def find_nvcc():
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then the
    toolkit's default install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("building the CUDA kernels needs nvcc; set CUDA_HOME "
                       "or put nvcc on PATH")


def library_path(name):
    """Where ``name``'s library is (or will be) built: keyed by a hash
    of its source, every header it could include (all ``*.cuh`` under
    ``csrc/``, since a source may share a header of another directory)
    and the compiler flags."""
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.rglob("*.cuh")):
        digest.update(str(header.relative_to(CSRC_DIR)).encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=None):
    """Compile every named library (default: all) that is not built yet,
    one ``nvcc`` per source, all started together.  Raises with nvcc's
    stderr if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [(n, library_path(n)) for n in names
            if not library_path(n).exists()]
    if not todo:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        procs.append((name, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, out, tmp, cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: {' '.join(cmd)}\n{err}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def load(name):
    """The ``ctypes.CDLL`` of kernel library ``name``, built on first
    use and cached for the process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
