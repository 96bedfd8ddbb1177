"""DeepSpeed-TPU's PyTorch/CUDA port for NVIDIA Hopper.

Port of ``deepspeed_tpu/__init__.py``.  The package mirrors the JAX
package's module paths (``deepspeed_tpu_torch/<path>`` ports
``deepspeed_tpu/<path>``) and imports neither ``jax`` nor anything of
``deepspeed_tpu``.  This slice carries serving: ``InferenceEngine``
serves the GPT-2 family through a paged KV cache, and prefill attention
runs on a hand-written CUDA flash-attention forward kernel
(``csrc/transformer/flash_attention_fwd.cu``).  The training API comes
with a later slice.
"""

__version__ = "0.1.0"

__all__ = ["InferenceEngine", "__version__"]


def __getattr__(name):
    # lazy: importing the package must not pull in the serving stack
    if name == "InferenceEngine":
        from .inference.engine import InferenceEngine

        return InferenceEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
