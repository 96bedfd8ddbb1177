"""The port's ``DeepSpeedConfig`` against the JAX package's: both parsers
read every config dict of ``tests/unit/test_config.py`` and resolve the
keys the port reads to equal values, or both reject the dict.  Unknown
keys warn with a "did you mean" hint and raise under ``strict_config``;
blocks the port does not implement warn; ``fp16.enabled`` raises
``NotImplementedError`` naming ROADMAP A4."""

import logging

import pytest

from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                DeepSpeedConfigError)

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
            "wall_clock_breakdown", "zero_allow_untested_optimizer")


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
    if d.get("fp16", {}).get("enabled") and their_error is None:
        # the JAX package trains fp16 with its loss scaler; the port
        # names the missing piece
        with pytest.raises(NotImplementedError, match="A4"):
            DeepSpeedConfig(dict(d), world_size=world_size)
        return
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
    with caplog.at_level(logging.WARNING):
        DeepSpeedConfig({"train_batch_size": 8,
                         "activation_checkpointing": {
                             "partition_activations": True},
                         "tensorboard": {"enabled": False}})
    assert "activation_checkpointing" in caplog.text
    assert "A7" in caplog.text
    assert "tensorboard" not in caplog.text   # set but off


def test_config_from_a_json_file_rejects_duplicate_keys(tmp_path):
    path = tmp_path / "dup.json"
    path.write_text('{"train_batch_size": 8, "train_batch_size": 16}')
    with pytest.raises(ValueError):
        DeepSpeedConfig(str(path))
    path.write_text('{"train_batch_size": 8, "steps_per_print": 3}')
    assert DeepSpeedConfig(str(path)).steps_per_print == 3
