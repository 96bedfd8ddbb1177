"""The port's flat-space optimizers, row-aligned layout and LR schedules
against the JAX package's, on the same numpy inputs.

Adam, AdamW and Lamb take 20 steps on identical flat gradients and one
``Segments`` layout; master and both moments must agree to 1e-6 (fp32,
the same formulas; the port updates in place and computes per-tensor
norms through a float64 prefix sum, so the last bits may differ).  The
LR schedules are host arithmetic in both packages and must agree to
1e-12 over 100 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import op_common as jop
from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JAdam
from deepspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JLamb
from deepspeed_tpu.runtime import lr_schedules as jls
from deepspeed_tpu_torch.ops import op_common as top
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.runtime import lr_schedules as tls

SIZES = [1000, 3000, 5, 2048, 1]
STATE_TOL = 1e-6


def padded(rng, seg, scale):
    """A (rows, LANES) buffer with random values in every tensor's
    elements and zeros in the padding."""
    flat = np.zeros(seg.total, np.float32)
    for ro, n in zip(seg.row_offsets, seg.sizes):
        flat[ro * top.LANES:ro * top.LANES + n] = \
            rng.randn(n).astype(np.float32) * scale
    return flat.reshape(seg.shape)


def test_build_segments_and_row_norms_match_jax():
    t, j = top.build_segments(SIZES, pad_to=4), jop.build_segments(SIZES, 4)
    assert tuple(t) == tuple(j)
    np.testing.assert_array_equal(t.row_segment_ids().numpy(),
                                  j.row_segment_ids())
    flat = padded(np.random.RandomState(0), t, 1.0)
    np.testing.assert_allclose(
        top.segment_l2_norms_rows(torch.from_numpy(flat), t).numpy(),
        np.asarray(jop.segment_l2_norms_rows(jnp.asarray(flat), j)),
        atol=STATE_TOL, rtol=STATE_TOL)


@pytest.mark.parametrize("name,kwargs", [
    ("adam", {"lr": 1e-2, "weight_decay": 0.0, "adam_w_mode": False}),
    ("adam_l2", {"lr": 1e-2, "weight_decay": 0.01, "adam_w_mode": False}),
    ("adamw", {"lr": 1e-2, "weight_decay": 0.01, "adam_w_mode": True}),
    ("lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    ("lamb_eps_inside", {"lr": 1e-2, "eps_inside_sqrt": True,
                         "max_coeff": 0.5, "min_coeff": 0.1})])
def test_twenty_steps_match_jax(name, kwargs):
    seg = top.build_segments(SIZES)
    jseg = jop.build_segments(SIZES)
    rng = np.random.RandomState(1)
    master = padded(rng, seg, 0.5)
    grads = [padded(rng, seg, 0.1) for _ in range(20)]
    cls_t, cls_j = (FusedLamb, JLamb) if name.startswith("lamb") \
        else (FusedAdam, JAdam)
    opt_t, opt_j = cls_t(**kwargs), cls_j(**kwargs)
    p_t = torch.from_numpy(master.copy())
    st_t = opt_t.init_state(p_t)
    p_j = jnp.asarray(master)
    st_j = opt_j.init_state(p_j)
    for g in grads:
        opt_t.update(st_t, p_t, torch.from_numpy(g), opt_t.hyperparams(),
                     segments=seg)
        p_j, st_j = opt_j.update(st_j, p_j, jnp.asarray(g),
                                 opt_j.hyperparams(), segments=jseg)
    assert st_t.step == int(st_j.step) == 20
    for label, got, want in (("master", p_t, p_j),
                             ("exp_avg", st_t.exp_avg, st_j.exp_avg),
                             ("exp_avg_sq", st_t.exp_avg_sq,
                              st_j.exp_avg_sq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=STATE_TOL, rtol=STATE_TOL,
                                   err_msg=label)


def test_bf16_grads_update_in_fp32():
    seg = top.build_segments([300])
    rng = np.random.RandomState(2)
    master = torch.from_numpy(padded(rng, seg, 0.5))
    g = torch.from_numpy(padded(rng, seg, 0.1))
    a, b = FusedAdam(lr=1e-2), FusedAdam(lr=1e-2)
    pa, pb = master.clone(), master.clone()
    a.update(a.init_state(pa), pa, g.bfloat16(), a.hyperparams())
    b.update(b.init_state(pb), pb, g.bfloat16().float(), b.hyperparams())
    assert pa.dtype == torch.float32 and torch.equal(pa, pb)


class Groups:
    def __init__(self):
        self.param_groups = [{"lr": 0.5, "betas": (0.9, 0.999)}]


@pytest.mark.parametrize("name,kwargs", [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-3,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_step_rate": 2.0}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-3,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 20, "decay_lr_rate": 0.1,
                  "decay_step_size": 5}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 30}),
    ("WarmupDecayLR", {"total_num_steps": 80, "warmup_min_lr": 0.0,
                       "warmup_max_lr": 1e-3, "warmup_num_steps": 30})])
def test_schedules_match_jax_over_100_steps(name, kwargs):
    ours, theirs = Groups(), Groups()
    s_t = tls.SCHEDULE_CLASSES[name](ours, **kwargs)
    s_j = jls.SCHEDULE_CLASSES[name](theirs, **kwargs)
    for _ in range(100):
        s_t.step()
        s_j.step()
        assert ours.param_groups[0]["lr"] == pytest.approx(
            theirs.param_groups[0]["lr"], rel=1e-12, abs=1e-15)
        assert ours.param_groups[0]["betas"] == pytest.approx(
            theirs.param_groups[0]["betas"], rel=1e-12)
    assert s_t.get_last_lr() == pytest.approx(s_j.get_last_lr(), rel=1e-12)
    state = s_t.state_dict()
    again = tls.SCHEDULE_CLASSES[name](Groups(), **kwargs)
    again.load_state_dict(state)
    assert again.optimizer.param_groups[0]["lr"] == pytest.approx(
        ours.param_groups[0]["lr"], rel=1e-12)
