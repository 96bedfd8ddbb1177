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
``pipe`` axis (``runtime/pipe``).
"""

from . import checkpoint  # noqa: F401
from .runtime.activation_checkpointing import checkpointing  # noqa: F401

__version__ = "0.1.0"

__all__ = ["InferenceEngine", "LayerSpec", "PipelineModule", "TiedLayerSpec",
           "checkpoint", "checkpointing", "initialize", "__version__"]


def initialize(*args, **kwargs):
    """Engine factory: ``(engine, optimizer, training_dataloader,
    lr_scheduler)`` (:func:`deepspeed_tpu_torch.runtime.engine.initialize`)."""
    from .runtime.engine import initialize as _initialize

    return _initialize(*args, **kwargs)


def __getattr__(name):
    # lazy: importing the package must not pull in the serving stack
    if name == "InferenceEngine":
        from .inference.engine import InferenceEngine

        return InferenceEngine
    if name in ("LayerSpec", "PipelineModule", "TiedLayerSpec"):
        from .runtime import pipe

        return getattr(pipe, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
