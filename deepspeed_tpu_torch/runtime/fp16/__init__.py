"""fp16 mixed precision: the loss scaler (port of
``deepspeed_tpu/runtime/fp16/``; 1-bit Adam is ROADMAP A14)."""
