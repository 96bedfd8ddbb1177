"""The kernel builder's cache key, on the CPU (nothing is compiled): a
library's path changes when its source, ANY header under ``csrc/`` or the
flags change, so a source that includes a header of another directory
(``sparse_attention/flash_block_sparse.cu`` includes
``transformer/flash_common.cuh``) is rebuilt when that header is edited;
and ``nvcc`` gets ``csrc/`` on its include path."""

import shutil
import subprocess

import pytest

from deepspeed_tpu_torch.ops import op_builder


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(op_builder.CSRC_DIR, copy)
    monkeypatch.setattr(op_builder, "CSRC_DIR", copy)
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "build")
    return copy


def test_every_source_is_registered_and_exists():
    on_disk = {str(p.relative_to(op_builder.CSRC_DIR))
               for p in op_builder.CSRC_DIR.rglob("*.cu")}
    assert set(op_builder.SOURCES.values()) == on_disk
    assert "flash_block_sparse" in op_builder.SOURCES


@pytest.mark.parametrize("name", sorted(op_builder.SOURCES))
def test_library_path_follows_source_headers_and_flags(csrc_copy,
                                                       monkeypatch, name):
    base = op_builder.library_path(name)
    assert base == op_builder.library_path(name)       # stable
    assert base.parent == op_builder.BUILD_DIR
    assert base.name.startswith(name + "-") and base.suffix == ".so"
    # a header in ANOTHER directory than some of the sources
    header = csrc_copy / "transformer" / "flash_common.cuh"
    text = header.read_text()
    header.write_text(text + "\n// edited\n")
    edited_header = op_builder.library_path(name)
    assert edited_header != base
    header.write_text(text)
    assert op_builder.library_path(name) == base
    # a new header anywhere under csrc/ counts too
    (csrc_copy / "sparse_attention" / "new.cuh").write_text("// new\n")
    assert op_builder.library_path(name) != base
    (csrc_copy / "sparse_attention" / "new.cuh").unlink()
    source = csrc_copy / op_builder.SOURCES[name]
    source.write_text(source.read_text() + "\n// edited\n")
    assert op_builder.library_path(name) not in (base, edited_header)
    monkeypatch.setattr(op_builder, "NVCC_FLAGS",
                        op_builder.NVCC_FLAGS + ("-lineinfo",))
    flagged = op_builder.library_path(name)
    assert flagged not in (base, edited_header)


def test_the_sparse_source_shares_the_dense_kernels_header():
    text = (op_builder.CSRC_DIR
            / op_builder.SOURCES["flash_block_sparse"]).read_text()
    assert '#include "transformer/flash_common.cuh"' in text


def test_build_gives_nvcc_the_csrc_include_path(csrc_copy, monkeypatch):
    """``build`` starts one nvcc per source, all together, each with
    ``-I csrc``; a stand-in compiler records its arguments."""
    commands = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            commands.append(cmd)
            out = cmd[cmd.index("-o") + 1]
            open(out, "w").close()

        def communicate(self):
            return "", ""

    monkeypatch.setattr(op_builder, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    op_builder.build()
    assert len(commands) == len(op_builder.SOURCES)
    for cmd in commands:
        assert cmd[cmd.index("-I") + 1] == str(csrc_copy)
        assert "arch=compute_90a,code=sm_90a" in cmd
    for name in op_builder.SOURCES:
        assert op_builder.library_path(name).exists()
    commands.clear()
    op_builder.build()                  # all built: nothing to compile
    assert commands == []
