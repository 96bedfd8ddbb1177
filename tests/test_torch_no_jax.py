"""The port stands alone: no file of ``deepspeed_tpu_torch/``, and not
``chip_smoke.py`` or the port's example, imports ``jax`` or anything of
``deepspeed_tpu``, and importing the port loads neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "deepspeed_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py", REPO / "examples" / "profile_torch_serve.py"]


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


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import deepspeed_tpu_torch, deepspeed_tpu_torch.inference, "
        "deepspeed_tpu_torch.models, deepspeed_tpu_torch.module_inject, "
        "deepspeed_tpu_torch.ops.transformer, deepspeed_tpu_torch.utils\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deepspeed_tpu'))\n"
        "print(len(new), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
