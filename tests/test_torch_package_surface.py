"""The port's top-level surface (``deepspeed_tpu_torch/__init__.py``)
against the JAX package's (``deepspeed_tpu/__init__.py``):
``add_config_arguments`` gives the JAX parser's arguments and defaults,
``get_sparse_attention_config`` the JAX layout for the same json, the
logging and mesh names are exported, the serving stack stays lazy, and
``ds_report_torch`` (``env_report.main``) runs on a machine without a
card."""

import argparse
import json
import random
import subprocess
import sys

import numpy as np
import pytest

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch import env_report

SPARSE_JSONS = [
    {"mode": "fixed", "block": 16, "num_local_blocks": 2,
     "num_global_blocks": 1, "attention": "unidirectional"},
    {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
     "num_sliding_window_blocks": 3, "num_global_blocks": 1},
    {"mode": "bslongformer", "block": 16, "num_sliding_window_blocks": 3,
     "global_block_indices": [0]},
    {"mode": "variable", "block": 16, "local_window_blocks": [2, 4],
     "global_block_indices": [0]},
    {"mode": "dense", "block": 16},
]


def parser_actions(parser):
    return {a.dest: (a.option_strings, a.default, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_add_config_arguments_is_the_jax_parsers():
    port = tds.add_config_arguments(argparse.ArgumentParser())
    ref = jds.add_config_arguments(argparse.ArgumentParser())
    assert parser_actions(port) == parser_actions(ref)
    argv = ["--deepspeed", "--deepspeed_config", "ds.json"]
    assert vars(port.parse_args(argv)) == vars(ref.parse_args(argv))
    assert vars(port.parse_args([])) == {
        "deepspeed": False, "deepspeed_config": None, "deepscale": False,
        "deepscale_config": None}


@pytest.mark.parametrize("section", SPARSE_JSONS,
                         ids=[s["mode"] for s in SPARSE_JSONS])
def test_get_sparse_attention_config_gives_the_jax_layout(section,
                                                          tmp_path):
    """The same json, as a dict and as a file, builds the JAX layout
    (BigBird's random blocks drawn from one ``random`` seed each)."""
    cfg = {"train_batch_size": 8, "sparse_attention": section}
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(cfg))
    random.seed(25)
    want = np.asarray(jds.get_sparse_attention_config(cfg, 4)
                      .make_layout(128))
    for arg in (cfg, str(path)):
        got = tds.get_sparse_attention_config(arg, 4)
        random.seed(25)
        np.testing.assert_array_equal(np.asarray(got.make_layout(128)),
                                      want)
    assert tds.get_sparse_attention_config({"train_batch_size": 8},
                                           4) is None


def test_the_jax_top_level_names_are_exported():
    for name in ("initialize", "add_config_arguments",
                 "get_sparse_attention_config", "init_distributed",
                 "log_dist", "logger", "DeepSpeedConfig", "comm",
                 "elasticity", "telemetry", "checkpoint", "checkpointing",
                 "CANONICAL_AXES", "DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS",
                 "SEQ_AXIS", "MeshGrid", "PipeDataParallelTopology",
                 "PipeModelDataParallelTopology", "ProcessTopology",
                 "make_mesh"):
        assert hasattr(jds, name) and hasattr(tds, name), name
        assert name in tds.__all__
    assert tds.CANONICAL_AXES == jds.CANONICAL_AXES
    cfg = tds.DeepSpeedConfig({"train_batch_size": 8})
    assert cfg.train_batch_size == 8


def test_log_dist_filters_by_rank(caplog):
    messages = []

    class Keep:
        level = 0

        def handle(self, record):
            messages.append(record.getMessage())

    tds.logger.handlers.append(Keep())
    try:
        tds.log_dist("to all")
        tds.log_dist("to rank 0", ranks=[0])
        tds.log_dist("to rank 3", ranks=[3])
    finally:
        tds.logger.handlers.pop()
    assert messages == ["[Rank 0] to all", "[Rank 0] to rank 0"]


def test_the_serving_stack_stays_lazy():
    code = ("import sys, deepspeed_tpu_torch as ds; "
            "assert 'deepspeed_tpu_torch.inference' not in sys.modules; "
            "assert 'jax' not in sys.modules; "
            "assert ds.InferenceEngine.__name__ == 'InferenceEngine'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_env_report_runs_without_a_card(capsys):
    assert env_report.main([]) == 0
    out = capsys.readouterr().out
    assert "environment report" in out
    for line in ("torch CUDA runtime", "nvcc", "g++"):
        assert line in out
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "flash_dropout", "flash_block_sparse",
                 "flash_block_sparse_agg", "cpu_adam"):
        assert any(row.startswith(name) for row in out.splitlines()), name
    import torch

    if not torch.cuda.is_available():
        assert "none (no CUDA device)" in out


def test_env_report_rows_say_why_not():
    """Without nvcc every CUDA library is refused with the reason; a
    toolkit whose nvcc lacks sm_90a is named."""
    rows = env_report.op_report({"nvcc": None, "version": None,
                                 "sm_90a": None, "gxx": "/usr/bin/g++"})
    cuda = [r for r in rows if r[0].startswith("flash")]
    assert cuda and all(not ok and "no nvcc" in d for _, ok, d in cuda
                        if "built" not in d)
    rows = env_report.op_report({"nvcc": "/x/nvcc", "version": "12",
                                 "sm_90a": False, "gxx": None})
    assert any("sm_90a" in d for _, ok, d in rows if not ok)
    assert ("cpu_adam", False, "no g++ on PATH") in rows
