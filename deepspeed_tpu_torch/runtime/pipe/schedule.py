"""Pipeline instruction schedules (port of
``deepspeed_tpu/runtime/pipe/schedule.py:21-272``, pure Python, copied).

In the JAX package a schedule is the description of one compiled
program.  Here it is what runs: each stage's process walks its
schedule's steps and executes every instruction
(:class:`~deepspeed_tpu_torch.runtime.pipe.engine.PipelineEngine`), with
``Send``/``Recv`` as point-to-point transfers over ``torch.distributed``.

A schedule is a generator of steps; each step is a list of
:class:`PipeInstruction`.  Steps are "barrier-atomic": inserting a global
barrier between successive steps cannot deadlock.
"""

from abc import ABC, abstractmethod


class PipeInstruction:
    """One engine instruction; kwargs become attributes (reference ``:317``)."""

    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        if not self.kwargs:
            return f"{self.name}()"
        args = ", ".join(f"{k}={v!r}" for k, v in sorted(self.kwargs.items()))
        return f"{self.name}({args})"

    def __eq__(self, other):
        return type(self) is type(other) and self.kwargs == other.kwargs

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.kwargs.items()))))


class OptimizerStep(PipeInstruction):
    """Apply the optimizer and zero gradients (after Reduce*Grads)."""


class ReduceGrads(PipeInstruction):
    """Data-parallel gradient reduction within the stage."""


class ReduceTiedGrads(PipeInstruction):
    """Reduce gradients of tied modules across their pipeline stages.

    Each stage holds its own copy of a tied parameter; this all-reduces
    the copies' gradients over the stages that hold them."""


class BufferOpInstruction(PipeInstruction):
    def __init__(self, buffer_id, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    """buffers['inputs'][buffer_id] = next(data_iter) (first/last stage)."""


class ForwardPass(BufferOpInstruction):
    """buffers['outputs'][buffer_id] = fwd(buffers['inputs'][buffer_id])."""


class BackwardPass(BufferOpInstruction):
    """Backprop buffers['outputs'][buffer_id] with received output grads."""


class SendActivation(BufferOpInstruction):
    """Send activations to the next stage."""


class RecvActivation(BufferOpInstruction):
    """Receive activations from the previous stage."""


class SendGrad(BufferOpInstruction):
    """Send activation gradients to the previous stage."""


class RecvGrad(BufferOpInstruction):
    """Receive activation gradients from the next stage."""


class PipeSchedule(ABC):
    """Base schedule for one training/inference batch (reference ``:6-127``).

    Args:
        micro_batches: micro-batches per global batch.
        stages: number of pipeline stages.
        stage_id: the stage this schedule instance drives.
    """

    def __init__(self, micro_batches, stages, stage_id):
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    @abstractmethod
    def steps(self):
        """Yield a list of :class:`PipeInstruction` per schedule tick."""

    def num_pipe_buffers(self):
        return self.micro_batches

    def _valid_micro_batch(self, mb):
        return 0 <= mb < self.micro_batches

    def _valid_stage(self, stage):
        return 0 <= stage < self.stages

    @property
    def stage(self):
        return self.stage_id

    @property
    def num_stages(self):
        return self.stages

    @property
    def num_micro_batches(self):
        return self.micro_batches

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _buffer_idx(self, mb):
        assert self._valid_micro_batch(mb)
        return mb % self.num_pipe_buffers()

    def __iter__(self):
        return self.steps()


class InferenceSchedule(PipeSchedule):
    """Fill-drain forward-only schedule (reference ``:129-179``).

    Total ticks = micro_batches + stages - 1; at tick ``t`` stage ``s``
    forwards micro-batch ``t - s``.  Send/recv buffers alternate parity so
    neighbor stages exchange without deadlock.
    """

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        for step_id in range(total_steps):
            cmds = []
            mb = step_id - self.stage_id

            if self.stage_id % 2 == 0:
                recv_buf, send_buf = step_id % 2, (step_id + 1) % 2
            else:
                recv_buf, send_buf = (step_id + 1) % 2, step_id % 2

            if (self.is_first_stage or self.is_last_stage) and \
                    self._valid_micro_batch(mb):
                cmds.append(LoadMicroBatch(recv_buf))

            if self.stage_id % 2 == 0:
                if self._valid_stage(self.next_stage) and \
                        self._valid_micro_batch(mb - 1):
                    cmds.append(SendActivation(send_buf))
                if self._valid_stage(self.prev_stage) and \
                        self._valid_micro_batch(mb):
                    cmds.append(RecvActivation(recv_buf))
            else:
                if self._valid_stage(self.prev_stage) and \
                        self._valid_micro_batch(mb):
                    cmds.append(RecvActivation(recv_buf))
                if self._valid_stage(self.next_stage) and \
                        self._valid_micro_batch(mb - 1):
                    cmds.append(SendActivation(send_buf))

            if self._valid_micro_batch(mb):
                cmds.append(ForwardPass(recv_buf))

            yield cmds

    def num_pipe_buffers(self):
        return 2


class TrainSchedule(PipeSchedule):
    """1F1B-interleaved training schedule (reference ``:182-289``).

    Total ticks = 2·(micro_batches + stages − 1).  Even/odd ticks alternate
    between forward and backward work per stage parity, giving the classic
    one-forward-one-backward steady state that bounds live activations at
    ``stages − stage_id + 1`` buffers.
    """

    def steps(self):
        prev_mb = -1
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        for step_id in range(total_steps):
            mb, is_forward = self._step_to_micro_batch(step_id)

            cmds = []
            if is_forward:
                if self._valid_micro_batch(mb) and self._valid_stage(self.prev_stage):
                    cmds.append(RecvActivation(self._buffer_idx(mb)))
                if self._valid_micro_batch(prev_mb) and self._valid_stage(self.prev_stage):
                    cmds.append(SendGrad(self._buffer_idx(prev_mb)))
            else:
                if self._valid_micro_batch(prev_mb) and self._valid_stage(self.next_stage):
                    cmds.append(SendActivation(self._buffer_idx(prev_mb)))
                if self._valid_micro_batch(mb) and self._valid_stage(self.next_stage):
                    cmds.append(RecvGrad(self._buffer_idx(mb)))

            if (self.is_first_stage or self.is_last_stage) and is_forward and \
                    self._valid_micro_batch(mb):
                cmds.append(LoadMicroBatch(self._buffer_idx(mb)))

            if self._valid_micro_batch(mb):
                cmds.append(ForwardPass(self._buffer_idx(mb)) if is_forward
                            else BackwardPass(self._buffer_idx(mb)))

            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())

            prev_mb = mb
            yield cmds

    def num_pipe_buffers(self):
        buffers = min(self.stages - self.stage_id + 1, self.micro_batches)
        return max(2, buffers)

    def _step_to_micro_batch(self, step_id):
        """Map tick → (micro_batch_id, is_forward) per the even/odd
        interleave (reference ``:249-289``)."""
        even_step, even_stage = step_id % 2 == 0, self.stage_id % 2 == 0
        if even_step == even_stage:
            # forward tick
            base = step_id // 2 if even_step else (step_id - 1) // 2
            return base - self.stage_id // 2, True
        if even_step:  # odd stage, even step: backward
            return step_id // 2 - self.stages + (self.stage_id + 1) // 2, False
        # even stage, odd step: backward
        return (step_id - 1) // 2 - self.stages + 1 + self.stage_id // 2, False


class DataParallelSchedule(PipeSchedule):
    """Plain gradient-accumulation DP schedule (reference ``:292-314``)."""

    def steps(self):
        for step_id in range(self.micro_batches):
            cmds = [
                LoadMicroBatch(buffer_id=0),
                ForwardPass(buffer_id=0),
                BackwardPass(buffer_id=0),
            ]
            if step_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self):
        return 1
