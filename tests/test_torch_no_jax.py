"""The port stands alone: no file of ``deepspeed_tpu_torch/``, and not
``chip_smoke.py`` or the port's examples, imports ``jax`` or anything of
``deepspeed_tpu``, and importing any module of the port (the training
engine included) loads neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "deepspeed_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"] \
    + sorted((REPO / "examples").glob("profile_torch_*.py"))
PORT_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (REPO / "deepspeed_tpu_torch").rglob("*.py"))


def forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "deepspeed_tpu")


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    bad = [(line, mod) for line, mod in imported_modules(path)
           if forbidden(mod)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_sparse_subpackage_imports_with_jax_blocked():
    """``deepspeed_tpu_torch.ops.sparse_attention`` and the layer that
    uses it import, and run one block-sparse call, in an interpreter
    where importing ``jax``, ``jaxlib`` or ``deepspeed_tpu`` raises."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'deepspeed_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deepspeed_tpu')]:\n"
        "    del sys.modules[m]\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "import deepspeed_tpu_torch.ops.sparse_attention as sa\n"
        "import deepspeed_tpu_torch.models.layers\n"
        "names = ['BertSparseSelfAttention', 'SparseSelfAttention', "
        "'SparseAttentionUtils', 'FixedSparsityConfig', "
        "'build_sparsity_config', 'build_block_luts', "
        "'flash_block_sparse_attention', 'block_sparse_attention', "
        "'layout_gather_indices']\n"
        "assert all(hasattr(sa, n) for n in names)\n"
        "lay = sa.FixedSparsityConfig(num_heads=2, block=16)"
        ".make_layout(64)\n"
        "q = torch.ones(1, 64, 2, 8)\n"
        "out = sa.flash_block_sparse_attention(q, q, q, lay, "
        "q_agg='never')\n"
        "assert out.shape == q.shape\n"
        "try:\n"
        "    import jax\n"
        "except ImportError:\n"
        "    sys.exit(0)\n"
        "sys.exit(2)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_the_port_loads_no_jax():
    """Every module of the port, ``runtime.engine``, ``models.bert``, the
    ``checkpoint`` and ``resilience`` packages, the fp16 loss scaler,
    activation checkpointing, Progressive Layer Drop and the injection
    policies among them."""
    assert {"deepspeed_tpu_torch.runtime.engine",
            "deepspeed_tpu_torch.models.bert",
            "deepspeed_tpu_torch.runtime.activation_checkpointing",
            "deepspeed_tpu_torch.runtime.activation_checkpointing"
            ".checkpointing",
            "deepspeed_tpu_torch.runtime.activation_checkpointing.config",
            "deepspeed_tpu_torch.runtime.progressive_layer_drop",
            "deepspeed_tpu_torch.module_inject.replace_module",
            "deepspeed_tpu_torch.checkpoint",
            "deepspeed_tpu_torch.checkpoint.manager",
            "deepspeed_tpu_torch.checkpoint.snapshot",
            "deepspeed_tpu_torch.checkpoint.writer",
            "deepspeed_tpu_torch.runtime.fp16.loss_scaler",
            "deepspeed_tpu_torch.resilience",
            "deepspeed_tpu_torch.resilience.chaos",
            "deepspeed_tpu_torch.resilience.config",
            "deepspeed_tpu_torch.resilience.constants",
            "deepspeed_tpu_torch.resilience.guard",
            "deepspeed_tpu_torch.resilience.rollback",
            "deepspeed_tpu_torch.resilience.watchdog",
            "deepspeed_tpu_torch.profiling.step_profiler"} \
        <= set(PORT_MODULES)
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for name in {PORT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deepspeed_tpu'))\n"
        "print(len(new), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
