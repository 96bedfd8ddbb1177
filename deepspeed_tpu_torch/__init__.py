"""DeepSpeed-TPU's PyTorch/CUDA port for NVIDIA Hopper.

Port of ``deepspeed_tpu/__init__.py``.  The package mirrors the JAX
package's module paths (``deepspeed_tpu_torch/<path>`` ports
``deepspeed_tpu/<path>``) and imports neither ``jax`` nor anything of
``deepspeed_tpu``.  It serves and trains: ``InferenceEngine`` serves the
GPT-2 family through a paged KV cache, and ``initialize`` builds the
training engine (flat fp32 master, Adam/AdamW, Lamb or 1-bit Adam, ZeRO
stages 0–3 at one rank or over a mesh of ``torch.distributed`` ranks,
``mesh=parallel.make_mesh({"data": n, ...})`` with data, pipe, model,
expert and seq axes, bf16, fp16 under the dynamic loss scaler, or fp32).
Attention runs on hand-written CUDA flash-attention kernels
(``csrc/transformer/``): the forward, the dq and dk/dv backward kernels,
the fused single-tile backward and in-kernel dropout; block-sparse
attention on the block-sparse and super-tile kernels
(``csrc/sparse_attention/``), in fp32, bf16 and fp16.  ``checkpoint``
saves and resumes a run in the JAX package's checkpoint files, so a run
moves between the two packages; ``resilience`` skips non-finite steps,
rolls back to the last checkpoint on divergence and watches for hung
steps.  ``checkpointing`` is activation checkpointing, the reference's
``deepspeed.checkpointing`` (``configure``, ``checkpoint``).
``PipelineModule`` (with ``LayerSpec`` and ``TiedLayerSpec``) trains a
layer sequence split into stages, one process a stage over the mesh's
``pipe`` axis (``runtime/pipe``).  ``profiling`` counts a step's FLOPs
(the ``flops_profiler`` block), measures its memory and records its
collectives (the ``profiling`` block); ``ds_report_torch``
(:mod:`.env_report`) reports the toolchain and which kernels build.

The top-level surface is the JAX package's (``deepspeed_tpu/__init__.py``):
``initialize``, ``add_config_arguments``, ``get_sparse_attention_config``,
``init_distributed``, ``log_dist`` and ``logger``, ``DeepSpeedConfig``,
the mesh axis names and topologies, and the ``comm``, ``elasticity``,
``telemetry`` and ``checkpoint`` subpackages.
"""

from . import checkpoint  # noqa: F401
from . import comm  # noqa: F401
from . import elasticity  # noqa: F401
from . import telemetry  # noqa: F401
from .parallel import (CANONICAL_AXES, DATA_AXIS, EXPERT_AXIS,  # noqa: F401
                       MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, MeshGrid,
                       PipeDataParallelTopology,
                       PipeModelDataParallelTopology, ProcessTopology,
                       make_mesh)
from .runtime.activation_checkpointing import checkpointing  # noqa: F401
from .runtime.config import DeepSpeedConfig  # noqa: F401
from .utils.distributed import init_distributed  # noqa: F401
from .utils.logging import log_dist, logger  # noqa: F401

__version__ = "0.1.0"

__all__ = ["CANONICAL_AXES", "DATA_AXIS", "DeepSpeedConfig", "EXPERT_AXIS",
           "InferenceEngine", "LayerSpec", "MODEL_AXIS", "MeshGrid",
           "PIPE_AXIS", "PipeDataParallelTopology",
           "PipeModelDataParallelTopology", "PipelineModule",
           "ProcessTopology", "SEQ_AXIS", "TiedLayerSpec",
           "add_config_arguments", "checkpoint", "checkpointing", "comm",
           "elasticity", "get_sparse_attention_config", "init_distributed",
           "initialize", "log_dist", "logger", "make_mesh", "telemetry",
           "__version__"]


def initialize(*args, **kwargs):
    """Engine factory: ``(engine, optimizer, training_dataloader,
    lr_scheduler)`` (:func:`deepspeed_tpu_torch.runtime.engine.initialize`)."""
    from .runtime.engine import initialize as _initialize

    return _initialize(*args, **kwargs)


def add_config_arguments(parser):
    """Add --deepspeed / --deepspeed_config args (reference
    ``__init__.py:193``)."""
    from .runtime.arguments import add_config_arguments as _add

    return _add(parser)


def get_sparse_attention_config(config, num_heads):
    """Json config (dict or path) → live ``SparsityConfig`` for model
    construction (JAX ``__init__.py:38-58``): the ``sparse_attention``
    section as :class:`DeepSpeedConfig` parses it
    (:func:`~deepspeed_tpu_torch.runtime.config.get_sparse_attention`),
    built into the layout object models take as ``sparsity_config=...``;
    callable before ``initialize()``, since the model is built first.
    None without the section."""
    import json as _json

    from .ops.sparse_attention import build_sparsity_config
    from .runtime.config import get_sparse_attention

    if isinstance(config, str):
        with open(config) as f:
            config = _json.load(f)
    section = get_sparse_attention(config)
    if section is None:
        return None
    return build_sparsity_config(section, num_heads)


def __getattr__(name):
    # lazy: importing the package must not pull in the serving stack
    if name == "InferenceEngine":
        from .inference.engine import InferenceEngine

        return InferenceEngine
    if name in ("LayerSpec", "PipelineModule", "TiedLayerSpec"):
        from .runtime import pipe

        return getattr(pipe, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
