"""ZeRO config and the flat fp32 master (port of ``deepspeed_tpu/runtime/zero``)."""
