"""The port's sparsity configs against the JAX package's: every layout
class over its options gives the SAME layout (equality, not closeness),
with Python's ``random`` seeded alike before each ``make_layout`` where
the pattern draws random blocks; the same errors; and
``build_sparsity_config`` builds the same class with the same fields."""

import random

import numpy as np
import pytest

from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

CASES = [
    ("dense", "DenseSparsityConfig", dict(num_heads=4, block=16)),
    ("fixed_bi", "FixedSparsityConfig",
     dict(num_heads=4, block=16, num_local_blocks=4, num_global_blocks=1)),
    ("fixed_uni", "FixedSparsityConfig",
     dict(num_heads=4, block=16, num_local_blocks=4, num_global_blocks=2,
          attention="unidirectional")),
    ("fixed_uni_128", "FixedSparsityConfig",
     dict(num_heads=16, block=128, num_local_blocks=4, num_global_blocks=1,
          attention="unidirectional")),
    ("fixed_horiz", "FixedSparsityConfig",
     dict(num_heads=4, block=16, num_local_blocks=4, num_global_blocks=1,
          horizontal_global_attention=True)),
    ("fixed_perhead", "FixedSparsityConfig",
     dict(num_heads=4, block=16, num_local_blocks=4, num_global_blocks=1,
          different_layout_per_head=True, num_different_global_patterns=4)),
    ("variable", "VariableSparsityConfig",
     dict(num_heads=4, block=16, num_random_blocks=0,
          local_window_blocks=[2, 4], global_block_indices=[0, 5])),
    ("variable_random", "VariableSparsityConfig",
     dict(num_heads=4, block=16, num_random_blocks=2,
          local_window_blocks=[4], different_layout_per_head=True)),
    ("variable_span", "VariableSparsityConfig",
     dict(num_heads=4, block=16, num_random_blocks=0,
          global_block_indices=[0], global_block_end_indices=[2],
          horizontal_global_attention=True)),
    ("variable_uni", "VariableSparsityConfig",
     dict(num_heads=4, block=16, num_random_blocks=0,
          attention="unidirectional")),
    ("bigbird", "BigBirdSparsityConfig",
     dict(num_heads=4, block=16, num_random_blocks=1,
          num_sliding_window_blocks=3, num_global_blocks=1)),
    ("bigbird_perhead", "BigBirdSparsityConfig",
     dict(num_heads=4, block=32, num_random_blocks=2,
          num_sliding_window_blocks=3, num_global_blocks=1,
          different_layout_per_head=True)),
    ("longformer", "BSLongformerSparsityConfig",
     dict(num_heads=4, block=16, num_sliding_window_blocks=3,
          global_block_indices=[0, 7])),
    ("longformer_span", "BSLongformerSparsityConfig",
     dict(num_heads=4, block=16, num_sliding_window_blocks=3,
          global_block_indices=[0, 4], global_block_end_indices=[1, 6])),
]


@pytest.mark.parametrize("name,cls,kwargs", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seq_len", [128, 512, 2048])
def test_layouts_equal_the_jax_package(name, cls, kwargs, seq_len):
    if seq_len % kwargs["block"] or seq_len // kwargs["block"] < 8:
        seq_len = 8 * kwargs["block"]   # block 128: at least 8 blocks
    random.seed(1234)
    theirs = getattr(jsc, cls)(**kwargs).make_layout(seq_len)
    random.seed(1234)
    ours = getattr(tsc, cls)(**kwargs).make_layout(seq_len)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("mod", [jsc, tsc], ids=["jax", "port"])
def test_layout_validation_errors(mod):
    with pytest.raises(ValueError):
        mod.FixedSparsityConfig(num_heads=2, num_local_blocks=4,
                                num_global_blocks=3)
    with pytest.raises(ValueError):
        mod.FixedSparsityConfig(num_heads=2, num_different_global_patterns=2)
    with pytest.raises(ValueError):
        mod.SparsityConfig(num_heads=2, block=16).setup_layout(100)
    with pytest.raises(NotImplementedError):
        mod.FixedSparsityConfig(num_heads=2, attention="diagonal")
    with pytest.raises(NotImplementedError):
        mod.VariableSparsityConfig(num_heads=2, attention="diagonal")
    with pytest.raises(ValueError):
        mod.BigBirdSparsityConfig(
            num_heads=2, block=16, num_sliding_window_blocks=9).make_layout(64)
    with pytest.raises(ValueError, match="bogus"):
        mod.build_sparsity_config({"mode": "bogus"}, num_heads=2)


@pytest.mark.parametrize("section", [
    {"block": 16},
    {"mode": "dense", "block": 32},
    {"mode": "fixed", "block": 32, "num_local_blocks": 8,
     "attention": "unidirectional"},
    {"mode": "variable", "local_window_blocks": [2, 4],
     "global_block_indices": [0, 3]},
    {"mode": "bigbird", "num_random_blocks": 2},
    {"mode": "bslongformer", "num_sliding_window_blocks": 5},
], ids=["default_mode", "dense", "fixed", "variable", "bigbird", "bslongformer"])
def test_build_sparsity_config_equals_the_jax_package(section):
    theirs = jsc.build_sparsity_config(section, num_heads=4)
    ours = tsc.build_sparsity_config(section, num_heads=4)
    assert type(ours).__name__ == type(theirs).__name__
    assert vars(ours) == vars(theirs)
    random.seed(7)
    want = theirs.make_layout(256)
    random.seed(7)
    np.testing.assert_array_equal(ours.make_layout(256), want)
