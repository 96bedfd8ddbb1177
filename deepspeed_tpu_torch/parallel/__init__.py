"""Mesh axes and process topology (port of ``deepspeed_tpu/parallel/``)."""

from .mesh import (CANONICAL_AXES, DATA_AXIS, EXPERT_AXIS, MODEL_AXIS,
                   PIPE_AXIS, SEQ_AXIS, Mesh, MeshGrid, current_mesh,
                   data_parallel_process_info, get_current_mesh, make_mesh)
from .topology import (PipeDataParallelTopology,
                       PipeModelDataParallelTopology, ProcessTopology)

__all__ = ["CANONICAL_AXES", "DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS",
           "PIPE_AXIS", "SEQ_AXIS", "Mesh", "MeshGrid",
           "PipeDataParallelTopology", "PipeModelDataParallelTopology",
           "ProcessTopology", "current_mesh",
           "data_parallel_process_info", "get_current_mesh", "make_mesh"]
