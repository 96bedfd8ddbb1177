"""The port's ``DeepSpeedConfig`` against the JAX package's: both parsers
read every config dict of ``tests/unit/test_config.py`` and resolve the
keys the port reads to equal values (the fp16 loss-scale values among
them), or both reject the dict.  Unknown keys warn with a "did you mean"
hint and raise under ``strict_config``; blocks the port does not
implement warn; the ``checkpoint``, ``resilience``,
``activation_checkpointing`` and ``progressive_layer_drop`` blocks parse
as the JAX package's."""

import logging

import pytest

from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.config import \
    get_sparse_attention as j_get_sparse_attention
from deepspeed_tpu_torch.ops.sparse_attention import build_sparsity_config
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                DeepSpeedConfigError,
                                                get_sparse_attention)

# every config dict of tests/unit/test_config.py, with its world size
UNIT_CONFIGS = [
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 16,
      "gradient_accumulation_steps": 1}, 2),
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 8,
      "gradient_accumulation_steps": 2}, 2),
    ({"train_batch_size": 33, "train_micro_batch_size_per_gpu": 17,
      "gradient_accumulation_steps": 2}, 2),
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 18,
      "gradient_accumulation_steps": 1}, 2),
    ({"train_batch_size": 32, "gradient_accumulation_steps": 2}, 4),
    ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4}, 4),
    ({"train_batch_size": 32}, 4),
    ({"train_micro_batch_size_per_gpu": 8}, 4),
    ({"steps_per_print": 5}, 1),
    ({"train_batch_size": 8, "bf16": {"enabled": True},
      "zero_optimization": {"stage": 2, "cpu_offload": True}}, 1),
    ({"train_batch_size": 8, "bf16": {"enabled": True},
      "zero_optimization": True}, 1),
    ({"train_batch_size": 8, "bf16": {"enabled": True},
      "zero_optimization": {"stage": 1, "cpu_offload": True}}, 1),
] + [
    ({"train_batch_size": 8, "bf16": {"enabled": True},
      "zero_optimization": {"stage": 2, "cpu_offload": True,
                            "offload_chunk_mb": bad}}, 1)
    for bad in (True, False, -1, "512")
] + [
    # the offload tuning keys (zero/config.py), good and bad values
    ({"train_batch_size": 8, "bf16": {"enabled": True},
      "zero_optimization": dict({"stage": 2, "cpu_offload": True}, **kv)},
     1)
    for kv in ({"offload_group_mb": 512}, {"offload_group_mb": 0},
               {"offload_group_mb": 4096}, {"offload_group_mb": True},
               {"offload_uniform_chunks": True},
               {"offload_uniform_chunks": 1},
               {"offload_overlap": False}, {"offload_overlap": 0},
               {"offload_prefetch_depth": 3},
               {"offload_prefetch_depth": 0},
               {"offload_state_dtype": "bf16"},
               {"offload_state_dtype": "int8"},
               {"offload_state_dtype": {"master": "fp16"}},
               {"offload_state_dtype": {"momentum": "bf16",
                                        "error_feedback": True}},
               {"offload_state_dtype": {"rounding": "sideways"}},
               {"offload_state_dtype": {"seed": "7"}},
               {"offload_gradients": True})
] + [
    ({"train_batch_size": 8, "fp16": {"enabled": True},
      "bf16": {"enabled": True}}, 1),
    ({"train_batch_size": 8, "fp16": {
        "enabled": True, "initial_scale_power": 16,
        "loss_scale_window": 500, "hysteresis": 4,
        "min_loss_scale": 0.5}}, 1),
    ({"train_batch_size": 8,
      "optimizer": {"type": "Adam", "params": {"lr": 0.001}},
      "scheduler": {"type": "WarmupLR",
                    "params": {"warmup_num_steps": 10}}}, 1),
    ({"train_batch_size": 8, "sparse_attention": {
        "mode": "fixed", "block": 32, "num_local_blocks": 8}}, 1),
    ({"train_batch_size": 8, "sparse_attention": {"mode": "bogus"}}, 1),
    ({"train_batch_size": 8}, 1),
    ({"train_batch_size": 2, "steps_per_print": 10 ** 9,
      "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
      "sparse_attention": {"mode": "fixed", "block": 8,
                           "num_local_blocks": 2,
                           "num_global_blocks": 1}}, 1),
    ({"train_batch_size": 2, "steps_per_print": 10 ** 9,
      "zero_optimization": {"stage": 1},
      "zero_allow_untested_optimizer": True}, 1),
]
RESOLVED = ("train_batch_size", "train_micro_batch_size_per_gpu",
            "gradient_accumulation_steps", "steps_per_print",
            "zero_optimization_stage", "zero_enabled", "bf16_enabled",
            "fp16_enabled", "gradient_clipping", "optimizer_name",
            "optimizer_params", "scheduler_name", "scheduler_params",
            "wall_clock_breakdown", "zero_allow_untested_optimizer",
            "loss_scale", "initial_dynamic_scale", "dynamic_loss_scale_args")


def parse(cls, d, world_size):
    try:
        return cls(dict(d), world_size=world_size), None
    except (AssertionError, ValueError, NotImplementedError) as e:
        return None, e
    except Exception as e:  # the JAX package's own config error class
        if type(e).__name__ == "DeepSpeedConfigError":
            return None, e
        raise


@pytest.mark.parametrize("d,world_size", UNIT_CONFIGS,
                         ids=[f"cfg{i}" for i in range(len(UNIT_CONFIGS))])
def test_both_parsers_resolve_equal_values(d, world_size):
    theirs, their_error = parse(JConfig, d, world_size)
    ours, our_error = parse(DeepSpeedConfig, d, world_size)
    if their_error is not None:
        assert our_error is not None, f"the port accepts {d}"
        same_kind = (type(our_error).__name__ == type(their_error).__name__
                     or isinstance(our_error, type(their_error)))
        assert same_kind, (our_error, their_error)
        return
    assert our_error is None, our_error
    for field in RESOLVED:
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.zero_config.cpu_offload == theirs.zero_config.cpu_offload
    for key in ("offload_chunk_mb", "offload_gradients", "offload_group_mb",
                "offload_uniform_chunks", "offload_overlap",
                "offload_prefetch_depth", "offload_state_dtype"):
        assert (getattr(ours.zero_config, key)
                == getattr(theirs.zero_config, key)), key


@pytest.mark.parametrize("section", [
    {"mode": "dense"},
    {"mode": "dense", "block": 64, "different_layout_per_head": True},
    {},
    {"mode": "fixed", "block": 128, "num_local_blocks": 4,
     "num_global_blocks": 1, "attention": "unidirectional"},
    {"mode": "variable"},
    {"mode": "variable", "num_random_blocks": 2,
     "local_window_blocks": [2, 4], "global_block_indices": [0, 3],
     "global_block_end_indices": [1, 4]},
    {"mode": "bigbird"},
    {"mode": "bigbird", "num_sliding_window_blocks": 5, "block": 32},
    {"mode": "bslongformer"},
    {"mode": "bslongformer", "global_block_indices": [0, 2]},
], ids=["dense", "dense_set", "fixed_default", "fixed_set", "variable",
        "variable_set", "bigbird", "bigbird_set", "bslongformer",
        "bslongformer_set"])
def test_get_sparse_attention_resolves_the_jax_defaults(section, caplog):
    """All five modes: the block resolves, defaults filled, to the dict
    the JAX parser gives; it is stored as ``config.sparse_attention``,
    builds a sparsity config, and no longer warns as unported."""
    d = {"train_batch_size": 8, "sparse_attention": section}
    want = j_get_sparse_attention(d)
    assert get_sparse_attention(d) == want
    with caplog.at_level(logging.WARNING):
        cfg = DeepSpeedConfig(dict(d))
    assert cfg.sparse_attention == want
    assert cfg.sparse_attention == JConfig(dict(d)).sparse_attention
    assert "sparse_attention" not in caplog.text
    built = build_sparsity_config(cfg.sparse_attention, num_heads=4)
    assert built.block == want["block"]
    assert get_sparse_attention({"train_batch_size": 8}) is None
    assert DeepSpeedConfig({"train_batch_size": 8}).sparse_attention is None


def test_unknown_keys_warn_with_a_hint_and_raise_under_strict(caplog):
    with caplog.at_level(logging.WARNING):
        cfg = DeepSpeedConfig({"train_batch_size": 8,
                               "gradient_clippin": 1.0,
                               "zero_optimization": {"stag": 2}})
    text = caplog.text
    assert "did you mean 'gradient_clipping'?" in text
    assert "did you mean 'stage'?" in text
    assert cfg.gradient_clipping == 0.0
    with pytest.raises(DeepSpeedConfigError, match="gradient_clippin"):
        DeepSpeedConfig({"train_batch_size": 8, "gradient_clippin": 1.0,
                         "strict_config": True})


def test_unported_blocks_warn_naming_their_roadmap_item(caplog):
    """A set block the port lacks warns with its ROADMAP item; the
    ``mesh`` block is ported for its data and pipe axes (ROADMAP A5,
    A13) and its model, expert and seq axes (A10), and warns for none of
    them; the ``pipeline`` block (A13) warns no more, and the
    ``ring_attention`` block (A10) logs at info that it has no effect,
    since ``attn_impl="ring"`` and the mesh's seq axis select the ring.
    The ``telemetry`` and ``tensorboard`` blocks (A12) are ported: set
    and on, they are parsed and warn nothing; so are the
    ``flops_profiler`` and ``profiling`` blocks (A16, A12's profiling
    block), while ``compilation`` still warns, naming A16."""
    with caplog.at_level(logging.WARNING):
        cfg = DeepSpeedConfig({"train_batch_size": 8,
                               "compilation": {"cache": True},
                               "flops_profiler": {"enabled": True,
                                                  "profile_step": 2},
                               "profiling": {"memory_ledger": True,
                                             "memory_watermarks": True,
                                             "comm_ledger": True},
                               "tensorboard": {"enabled": True,
                                               "job_name": "unit"},
                               "telemetry": {"enabled": True,
                                             "run_dir": "/tmp/t",
                                             "trace": True},
                               "mesh": {"data": 2}})
    assert "'compilation'" in caplog.text
    assert "A16" in caplog.text
    assert "flops_profiler" not in caplog.text
    assert "profiling" not in caplog.text
    assert cfg.flops_profiler_config.enabled
    assert cfg.flops_profiler_config.profile_step == 2
    assert cfg.profiling_config.comm_ledger is True
    assert "tensorboard" not in caplog.text and "A12" not in caplog.text
    assert "telemetry" not in caplog.text
    assert cfg.tensorboard_enabled and cfg.tensorboard_job_name == "unit"
    assert cfg.telemetry_config.enabled and cfg.telemetry_config.trace
    assert cfg.telemetry_config.run_dir == "/tmp/t"
    assert "mesh" not in caplog.text
    caplog.clear()
    with caplog.at_level(logging.INFO):
        DeepSpeedConfig({"train_batch_size": 8,
                         "mesh": {"data": 1, "model": 2, "pipe": 2,
                                  "expert": 2, "seq": 2},
                         "pipeline": {"stages": 2, "interleave": 2},
                         "ring_attention": {"enabled": True}})
    ring = [r for r in caplog.records if "ring_attention" in r.getMessage()]
    assert len(ring) == 1 and ring[0].levelno == logging.INFO
    assert "no effect" in ring[0].getMessage()
    assert "attn_impl='ring'" in ring[0].getMessage()
    warned = " ".join(r.getMessage() for r in caplog.records
                      if r.levelno >= logging.WARNING)
    assert "'seq'" not in warned and "A10" not in warned
    assert "ring_attention" not in warned
    assert "'model'" not in warned and "'expert'" not in warned
    assert "'pipe'" not in warned
    assert "section 'pipeline'" not in warned
    assert "A13" not in warned


@pytest.mark.parametrize("blocks", [
    {},
    {"activation_checkpointing": {}, "progressive_layer_drop": {}},
    {"activation_checkpointing": {"partition_activations": True,
                                  "cpu_checkpointing": True,
                                  "number_checkpoints": 4,
                                  "contiguous_memory_optimization": True,
                                  "synchronize_checkpoint_boundary": True,
                                  "profile": True},
     "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                "gamma": 0.001}},
    {"progressive_layer_drop": {"enabled": False, "theta": 0.7}}],
    ids=["absent", "empty", "every_key", "pld_off"])
def test_memory_blocks_parse_as_the_jax_package_does(blocks, caplog):
    """``activation_checkpointing`` and ``progressive_layer_drop`` are
    ported: they parse into the JAX package's values, no longer warn,
    and pass ``strict_config``."""
    with caplog.at_level(logging.WARNING):
        cfg = DeepSpeedConfig(dict(blocks, train_batch_size=8,
                                   strict_config=True))
    assert caplog.text == ""
    want = JConfig(dict(blocks, train_batch_size=8))
    assert cfg.activation_checkpointing_config.repr() == \
        want.activation_checkpointing_config.repr()
    assert cfg.pld_params == want.pld_params
    assert cfg.pld_enabled == want.pld_enabled


def test_checkpoint_block_parses_as_the_jax_package_does(caplog):
    """The ``checkpoint`` block is ported: it parses into the same values
    as the JAX package's config, no longer warns, and passes
    ``strict_config``."""
    block = {"async_save": False, "keep_last_n": 3,
             "keep_every_n_steps": 100, "verify_on_load": False,
             "save_retries": 1, "retry_backoff_secs": 0.25,
             "save_on_preemption": True}
    with caplog.at_level(logging.WARNING):
        cfg = DeepSpeedConfig({"train_batch_size": 8, "checkpoint": block,
                               "strict_config": True})
    assert "checkpoint" not in caplog.text
    want = JConfig({"train_batch_size": 8,
                    "checkpoint": block}).checkpoint_config
    assert vars(cfg.checkpoint_config) == vars(want)
    assert vars(DeepSpeedConfig({"train_batch_size": 8})
                .checkpoint_config) == vars(
        JConfig({"train_batch_size": 8}).checkpoint_config)


def test_config_from_a_json_file_rejects_duplicate_keys(tmp_path):
    path = tmp_path / "dup.json"
    path.write_text('{"train_batch_size": 8, "train_batch_size": 16}')
    with pytest.raises(ValueError):
        DeepSpeedConfig(str(path))
    path.write_text('{"train_batch_size": 8, "steps_per_print": 3}')
    assert DeepSpeedConfig(str(path)).steps_per_print == 3


def test_resilience_block_parses_as_the_jax_package_does(caplog):
    """The ``resilience`` block is ported (ROADMAP A15): it parses into
    the same values as the JAX package's config, no longer warns, and
    passes ``strict_config``; the fleet integrity plane's keys
    (``integrity: true`` with its window, action and peer timeout) parse
    as the JAX package's too."""
    block = {"enabled": True, "policy": "rollback", "spike_window": 16,
             "spike_zscore": 5.0, "divergence_patience": 2,
             "max_rollbacks": 1, "rollback_cooldown_steps": 4,
             "hang_timeout_secs": 30.0, "floor_scale_patience": 3,
             "checkpoint_dir": "/ckpt"}
    with caplog.at_level(logging.WARNING):
        cfg = DeepSpeedConfig({"train_batch_size": 8, "resilience": block,
                               "strict_config": True})
    assert "resilience" not in caplog.text
    want = JConfig({"train_batch_size": 8,
                    "resilience": block}).resilience_config
    got = cfg.resilience_config
    for field in ("enabled", "policy", "spike_window", "spike_zscore",
                  "divergence_patience", "max_rollbacks",
                  "rollback_cooldown_steps", "hang_timeout_secs",
                  "floor_scale_patience", "checkpoint_dir",
                  "straggler_factor", "integrity", "integrity_window",
                  "integrity_action", "integrity_peer_timeout_secs"):
        assert getattr(got, field) == getattr(want, field), field
    fleet = {"enabled": True, "integrity": True, "integrity_window": 4,
             "integrity_action": "warn",
             "integrity_peer_timeout_secs": 12.5}
    got = DeepSpeedConfig({"train_batch_size": 8, "resilience": fleet,
                           "strict_config": True}).resilience_config
    want = JConfig({"train_batch_size": 8,
                    "resilience": fleet}).resilience_config
    for field in ("integrity", "integrity_window", "integrity_action",
                  "integrity_peer_timeout_secs"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.integrity is True
