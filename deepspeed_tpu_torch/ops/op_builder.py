"""Builds the port's CUDA sources at first use and loads them with ctypes.

Takes the role of ``deepspeed_tpu/ops/op_builder.py``: there a builder
JIT-compiles the host C++ kernel; here each ``csrc/**/*.cu`` source is
compiled by ``nvcc`` into its own shared library with a plain C
interface, built for Hopper (``sm_90a``), and loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds.

Libraries land in ``build/deepspeed_tpu_torch/`` beside the package,
named by a hash of the source, the headers under ``csrc/`` (which is on
the include path) and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is.  A source may build
several libraries with their own defines (``DEFINES``): the block-sparse
super-tile source builds its fp16 kernels apart, in parallel.  A failed
build raises with nvcc's stderr; there is no fallback.

The host kernel of ``DeepSpeedCPUAdam`` (``csrc/adam/cpu_adam.cpp``,
``HOST_SOURCES``) is built the same way with ``g++`` and the JAX
builder's first tier of flags plus ``-fno-math-errno`` (``GXX_FLAGS``),
into the same directory;
its name also hashes the compiler's version and the host CPU's model,
since ``-march=native`` code belongs to the CPU that built it.  A failed
``g++`` build raises with its stderr: there is no tier of weaker flags.
"""

import ctypes
import hashlib
import os
import re
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
    "flash_dropout": "transformer/flash_dropout.cu",
    "flash_block_sparse": "sparse_attention/flash_block_sparse.cu",
    "flash_block_sparse_agg": "sparse_attention/flash_block_sparse_agg.cu",
    # the same source's fp16 kernels, a library of their own so that the
    # two halves of its instantiations compile side by side
    "flash_block_sparse_agg_fp16":
        "sparse_attention/flash_block_sparse_agg.cu",
}

# kernel library name -> its own nvcc flags (preprocessor defines)
DEFINES = {"flash_block_sparse_agg_fp16": ("-DDS_AGG_FP16",)}

# host (g++) library name -> source under csrc/, and the JAX builder's
# first-tier flags (deepspeed_tpu/ops/op_builder.py: jit_build) with
# -fno-math-errno, without which sqrtf keeps the Adam loop scalar
HOST_SOURCES = {"cpu_adam": "adam/cpu_adam.cpp"}
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native",
             "-fopenmp", "-fno-math-errno")

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
    digest.update(" ".join(NVCC_FLAGS + DEFINES.get(name, ())).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def find_gxx():
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("building the host Adam kernel needs g++ on "
                           "PATH")
    return found


def host_library_path(name):
    """Where host library ``name`` is built: keyed by its source, the
    flags, the compiler's version and the CPU model."""
    digest = hashlib.sha256((CSRC_DIR / HOST_SOURCES[name]).read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    digest.update(subprocess.run([find_gxx(), "--version"],
                                 capture_output=True, text=True).stdout
                  .encode())
    with open("/proc/cpuinfo") as f:
        digest.update(next((line for line in f
                            if line.startswith("model name")), "").encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _path(name):
    return (host_library_path(name) if name in HOST_SOURCES
            else library_path(name))


def _command(name, out):
    if name in HOST_SOURCES:
        return [find_gxx(), *GXX_FLAGS, "-o", str(out),
                str(CSRC_DIR / HOST_SOURCES[name])]
    return [find_nvcc(), *NVCC_FLAGS, *DEFINES.get(name, ()), "-I",
            str(CSRC_DIR), "-o", str(out), str(CSRC_DIR / SOURCES[name])]


def build(names=None):
    """Compile every named library (default: every CUDA source; a host
    library is built when named) that is not built yet, one compiler per
    source, all started together.  Raises with the compiler's stderr if
    any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [(n, _path(n)) for n in names if not _path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = _command(name, tmp)
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
        raise RuntimeError("build failed:\n" + "\n".join(errors))


def load(name):
    """The ``ctypes.CDLL`` of library ``name`` (a CUDA kernel library or
    a host one), built on first use and cached for the process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_path(name)))
            _loaded[name] = lib
        return lib


def kernel_name(mangled):
    """A short name for a mangled kernel of the port: the kernel's own
    name, the storage type of a scalar kernel (and ``_fp16`` for a
    tensor-core kernel's fp16 instantiation; its bf16 one has none), the
    head_dim, and the B3's warps a block or B1's dropout instantiation;
    B4's keep-bit kernel is named by the words a store writes."""
    if "keep_bits_kernel" in mangled:
        return "keep_bits_kernel_v" + re.search(r"ILi(\d+)E", mangled).group(1)
    end = mangled.index("_kernel") + len("_kernel")
    start = max(mangled.rfind(prefix, 0, end)
                for prefix in ("agg_", "fbs_", "flash_fwd", "flash_bwd"))
    name = mangled[start:end]
    if "mma" in name:
        dtype = "_fp16" if "6__half" in mangled else ""
    else:
        dtype = "_bf16" if "bfloat16" in mangled else "_fp32"
    warps = re.search(r"Li\d+ELi(\d+)E", mangled)
    return (name + dtype + ("_d128" if "Li128E" in mangled else "_d64")
            + (f"_w{warps.group(1)}" if warps else "")
            + ("_dropout" if "Lb1E" in mangled else ""))


def ptxas_usage(src, out, defines=()):
    """Builds ``src`` (a CUDA source, or an edited copy of one) into
    ``out`` as :func:`build` does, with ``-Xptxas -v`` and ``defines``
    (a library's :data:`DEFINES`); returns ``{kernel_name: [registers,
    spill bytes stored]}`` from ptxas's report.  For the profiling
    scripts."""
    cmd = [find_nvcc(), *NVCC_FLAGS, *defines, "-Xptxas", "-v", "-I",
           str(CSRC_DIR), "-I", str(CSRC_DIR / "transformer"), "-o",
           str(out), str(src)]
    err = subprocess.run(cmd, capture_output=True, text=True,
                         check=True).stderr
    kernels, name = {}, None
    for line in err.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if entry:
            name = kernel_name(entry.group(1))
            kernels[name] = [0, 0]
        elif spill and name:
            kernels[name][1] = int(spill.group(1))
        elif regs and name:
            kernels[name][0] = int(regs.group(1))
    return kernels
