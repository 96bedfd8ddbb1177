"""Learning-rate schedules (a copy of
``deepspeed_tpu/runtime/lr_schedules.py``, which imports no JAX; the port
keeps its own copy so that it loads nothing of that package).

Behavioral port of ``deepspeed/runtime/lr_schedules.py`` (LRRangeTest
``:301``, OneCycle ``:408``, WarmupLR ``:677``, WarmupDecayLR ``:761``).
Schedulers are host-side step-driven objects, exactly as in the reference:
the engine reads ``optimizer.param_groups[g]['lr']`` after each
``scheduler.step()`` and hands the value to the update as a host float.

Any object exposing ``param_groups`` (list of dicts with ``'lr'`` and
optionally ``'betas'``) can be scheduled; our optimizer wrappers provide it
for parity with torch optimizers.
"""

import argparse
import logging
import math

logger = logging.getLogger(__name__)

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

LR_RANGE_TEST_MIN_LR = "lr_range_test_min_lr"
LR_RANGE_TEST_STEP_RATE = "lr_range_test_step_rate"
LR_RANGE_TEST_STEP_SIZE = "lr_range_test_step_size"
LR_RANGE_TEST_STAIRCASE = "lr_range_test_staircase"

EDGE_VALUE = "edge_value"
MID_VALUE = "mid_value"

CYCLE_FIRST_STEP_SIZE = "cycle_first_step_size"
CYCLE_FIRST_STAIR_COUNT = "cycle_first_stair_count"
CYCLE_SECOND_STEP_SIZE = "cycle_second_step_size"
CYCLE_SECOND_STAIR_COUNT = "cycle_second_stair_count"
DECAY_STEP_SIZE = "decay_step_size"

CYCLE_MIN_LR = "cycle_min_lr"
CYCLE_MAX_LR = "cycle_max_lr"
DECAY_LR_RATE = "decay_lr_rate"

CYCLE_MIN_MOM = "cycle_min_mom"
CYCLE_MAX_MOM = "cycle_max_mom"
DECAY_MOM_RATE = "decay_mom_rate"

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"

TOTAL_NUM_STEPS = "total_num_steps"


def add_tuning_arguments(parser):
    """CLI knobs for LR schedules (reference ``lr_schedules.py:54-232``)."""
    group = parser.add_argument_group("Convergence Tuning", "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None,
                       help="LR schedule for training.")
    # LR range test
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001,
                       help="Starting lr value.")
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0,
                       help="scaling rate for LR range test.")
    group.add_argument("--lr_range_test_step_size", type=int, default=1000,
                       help="training steps per LR change.")
    group.add_argument("--lr_range_test_staircase", type=bool, default=False,
                       help="use staircase scaling for LR range test.")
    # OneCycle
    group.add_argument("--cycle_first_step_size", type=int, default=1000,
                       help="size of first step of 1Cycle schedule (training steps).")
    group.add_argument("--cycle_first_stair_count", type=int, default=-1,
                       help="first stair count for 1Cycle schedule.")
    group.add_argument("--cycle_second_step_size", type=int, default=-1,
                       help="size of second step of 1Cycle schedule (default first_step_size).")
    group.add_argument("--cycle_second_stair_count", type=int, default=-1,
                       help="second stair count for 1Cycle schedule.")
    group.add_argument("--decay_step_size", type=int, default=1000,
                       help="size of intervals for applying post cycle decay (training steps).")
    group.add_argument("--cycle_min_lr", type=float, default=0.01,
                       help="1Cycle LR lower bound.")
    group.add_argument("--cycle_max_lr", type=float, default=0.1,
                       help="1Cycle LR upper bound.")
    group.add_argument("--decay_lr_rate", type=float, default=0.0,
                       help="post cycle LR decay rate.")
    group.add_argument("--cycle_momentum", type=bool, default=False,
                       help="enable 1Cycle momentum schedule.")
    group.add_argument("--cycle_min_mom", type=float, default=0.8,
                       help="1Cycle momentum lower bound.")
    group.add_argument("--cycle_max_mom", type=float, default=0.9,
                       help="1Cycle momentum upper bound.")
    group.add_argument("--decay_mom_rate", type=float, default=0.0,
                       help="post cycle momentum decay rate.")
    # Warmup
    group.add_argument("--warmup_min_lr", type=float, default=0,
                       help="WarmupLR minimum/initial LR value.")
    group.add_argument("--warmup_max_lr", type=float, default=0.001,
                       help="WarmupLR maximum LR value.")
    group.add_argument("--warmup_num_steps", type=int, default=1000,
                       help="WarmupLR step count for LR warmup.")
    return parser


def parse_arguments():
    parser = argparse.ArgumentParser()
    parser = add_tuning_arguments(parser)
    lr_sched_args, unknown_args = parser.parse_known_args()
    return lr_sched_args, unknown_args


def get_lr_from_config(config):
    """Extract a nominal LR from a scheduler config (reference ``:262-281``)."""
    if "type" not in config:
        return None, "LR schedule type not defined in config"
    if "params" not in config:
        return None, "LR schedule params not defined in config"
    lr_schedule = config["type"]
    lr_params = config["params"]
    if lr_schedule not in VALID_LR_SCHEDULES:
        return None, f"{lr_schedule} is not a valid LR schedule"
    if lr_schedule == LR_RANGE_TEST:
        return lr_params[LR_RANGE_TEST_MIN_LR], ""
    if lr_schedule == ONE_CYCLE:
        return lr_params[CYCLE_MAX_LR], ""
    # Warmup LRs
    return lr_params[WARMUP_MAX_LR], ""


def _format_param(optimizer, param_value, param_name):
    if isinstance(param_value, (list, tuple)):
        if len(param_value) != len(optimizer.param_groups):
            raise ValueError(f"expected {len(optimizer.param_groups)} values for "
                             f"{param_name}, got {len(param_value)}")
        return list(param_value)
    return [param_value] * len(optimizer.param_groups)


class _BaseSchedule:
    def get_last_lr(self):
        assert getattr(self, "_last_lr", None) is not None, "need to call step() first"
        return self._last_lr

    def _update_optimizer(self, group_lrs):
        for param_group, lr in zip(self.optimizer.param_groups, group_lrs):
            param_group["lr"] = lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._update_optimizer(self.get_lr())
        self._last_lr = [group["lr"] for group in self.optimizer.param_groups]

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
        # re-apply the restored-iteration schedule to the optimizer NOW:
        # the next step() only fires after the first resumed update, so
        # without this the first post-resume update runs at the
        # construction-time hyperparameters (caught by the checkpoint-
        # continuity gate, tests/model/run_checkpoint_test.py — one
        # warmup-step-0 update after resume shifted the whole curve).
        # Delegating to step() re-applies everything a subclass schedules
        # (OneCycle: lr AND betas).  A pre-first-step checkpoint
        # (iteration -1) is exactly the construction state — applying
        # would hit get_lr()'s -1 sentinel, so leave it alone.
        if self.last_batch_iteration >= 0:
            self.step(self.last_batch_iteration)


class LRRangeTest(_BaseSchedule):
    """LR range test policy (reference ``lr_schedules.py:301-405``):
    lr = min_lr * (1 + step_rate * interval(iter)) with continuous or
    staircase intervals."""

    def __init__(self, optimizer, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, last_batch_iteration=-1):
        self.optimizer = optimizer
        self.min_lr = _format_param(optimizer, lr_range_test_min_lr, "lr_range_test_min_lr")
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.last_batch_iteration = last_batch_iteration
        self.staircase = lr_range_test_staircase
        if last_batch_iteration == -1:
            self._update_optimizer(self.min_lr)

    def _interval(self):
        x = float(self.last_batch_iteration + 1) / self.step_size
        return math.floor(x) if self.staircase else x

    def get_lr(self):
        lr_increase = 1 + self.step_rate * self._interval()
        return [min_lr * lr_increase for min_lr in self.min_lr]


class OneCycle(_BaseSchedule):
    """1Cycle LR (and momentum) policy (reference ``lr_schedules.py:408-674``):
    one triangular cycle between min/max followed by decay."""

    def __init__(self, optimizer, cycle_min_lr, cycle_max_lr, decay_lr_rate=0.0,
                 cycle_first_step_size=2000, cycle_second_step_size=None,
                 cycle_first_stair_count=0, cycle_second_stair_count=None,
                 decay_step_size=0, cycle_momentum=True, cycle_min_mom=0.8,
                 cycle_max_mom=0.9, decay_mom_rate=0.0, last_batch_iteration=-1):
        self.optimizer = optimizer

        first = float(cycle_first_step_size)
        second = float(cycle_second_step_size) if cycle_second_step_size is not None else first
        self.total_size = first + second
        self.step_ratio = first / self.total_size
        self.first_stair_count = cycle_first_stair_count
        self.second_stair_count = (cycle_first_stair_count if cycle_second_stair_count is None
                                   else cycle_second_stair_count)
        self.decay_step_size = decay_step_size

        self.min_lrs = [cycle_min_lr] * len(optimizer.param_groups)
        self.max_lrs = [cycle_max_lr] * len(optimizer.param_groups)
        self.decay_lr_rate = decay_lr_rate
        if last_batch_iteration == -1:
            self._update_optimizer(self.min_lrs)

        self.cycle_momentum = cycle_momentum
        if cycle_momentum:
            self.decay_mom_rate = decay_mom_rate
            self.min_moms = [(cycle_min_mom, 0.99)] * len(optimizer.param_groups)
            self.max_moms = [(cycle_max_mom, 0.99)] * len(optimizer.param_groups)
            if last_batch_iteration == -1:
                for momentum, group in zip(self.min_moms, optimizer.param_groups):
                    group["betas"] = momentum

        self.last_batch_iteration = last_batch_iteration

    def _get_scale_factor(self):
        batch_iteration = self.last_batch_iteration + 1
        cycle = math.floor(1 + batch_iteration / self.total_size)
        x = 1.0 + batch_iteration / self.total_size - cycle
        if x <= self.step_ratio:
            return x / self.step_ratio
        return (x - 1) / (self.step_ratio - 1)

    def _get_cycle_lr(self):
        scale_factor = self._get_scale_factor()
        return [cycle_min_lr + (cycle_max_lr - cycle_min_lr) * scale_factor
                for cycle_min_lr, cycle_max_lr in zip(self.min_lrs, self.max_lrs)]

    def _get_decay_lr(self, decay_batch_iteration):
        decay_interval = decay_batch_iteration / self.decay_step_size
        lr_decay_factor = 1 + self.decay_lr_rate * decay_interval
        return [cycle_min_lr / lr_decay_factor for cycle_min_lr in self.min_lrs]

    def get_lr(self):
        if self.last_batch_iteration < self.total_size:
            return self._get_cycle_lr()
        return self._get_decay_lr(self.last_batch_iteration - self.total_size + 1)

    def _get_cycle_mom(self):
        scale_factor = self._get_scale_factor()
        momentums = []
        for base_betas, max_betas in zip(self.min_moms, self.max_moms):
            height = (max_betas[0] - base_betas[0]) * scale_factor
            momentums.append((max_betas[0] - height, base_betas[1]))
        return momentums

    def _get_decay_mom(self, decay_batch_iteration):
        decay_interval = decay_batch_iteration / self.decay_step_size
        mom_decay_factor = 1 + self.decay_mom_rate * decay_interval
        return [(beta0 * mom_decay_factor, beta1) for beta0, beta1 in self.max_moms]

    def get_mom(self):
        if not self.cycle_momentum:
            return None
        if self.last_batch_iteration < self.total_size:
            return self._get_cycle_mom()
        return self._get_decay_mom(self.last_batch_iteration - self.total_size + 1)

    def step(self, batch_iteration=None):
        if batch_iteration is None:
            batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = batch_iteration
        self._update_optimizer(self.get_lr())
        self._last_lr = [group["lr"] for group in self.optimizer.param_groups]
        if self.cycle_momentum:
            for param_group, momentum in zip(self.optimizer.param_groups, self.get_mom()):
                param_group["betas"] = momentum


class WarmupLR(_BaseSchedule):
    """Log-warmup from min to max LR over ``warmup_num_steps``, then hold
    (reference ``lr_schedules.py:677-757``)."""

    def __init__(self, optimizer, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, last_batch_iteration=-1):
        self.optimizer = optimizer
        self.min_lrs = _format_param(optimizer, warmup_min_lr, "min_lr")
        self.max_lrs = _format_param(optimizer, warmup_max_lr, "max_lr")
        self.delta_lrs = [big - small for big, small in zip(self.max_lrs, self.min_lrs)]
        self.warmup_num_steps = warmup_num_steps
        self.inverse_log_warm_up = 1.0 / math.log(warmup_num_steps)
        self.last_batch_iteration = last_batch_iteration

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(self.last_batch_iteration + 1)
        return 1.0

    def get_lr(self):
        if self.last_batch_iteration < 0:
            logger.warning("Attempting to get learning rate from scheduler before it has started")
            return [0.0]
        gamma = self._get_gamma()
        return [min_lr + (delta_lr * gamma)
                for min_lr, delta_lr in zip(self.min_lrs, self.delta_lrs)]


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to zero over ``total_num_steps``
    (reference ``lr_schedules.py:761-809``)."""

    def __init__(self, optimizer, total_num_steps, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000, last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         last_batch_iteration)
        if self.total_num_steps < self.warmup_num_steps:
            logger.warning(f"total_num_steps {total_num_steps} is less than "
                           f"warmup_num_steps {warmup_num_steps}")

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(self.last_batch_iteration + 1)
        return max(0.0,
                   float(self.total_num_steps - self.last_batch_iteration) /
                   float(max(1.0, self.total_num_steps - self.warmup_num_steps)))


SCHEDULE_CLASSES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}
