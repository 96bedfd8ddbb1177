"""Pipeline parallelism (port of ``deepspeed_tpu/runtime/pipe/``)."""

from .module import LayerSpec, PipelineModule, TiedLayerSpec
from .schedule import (BackwardPass, DataParallelSchedule, ForwardPass,
                       InferenceSchedule, LoadMicroBatch, OptimizerStep,
                       PipeInstruction, PipeSchedule, RecvActivation, RecvGrad,
                       ReduceGrads, ReduceTiedGrads, SendActivation, SendGrad,
                       TrainSchedule)
