"""Tensor ops of the port: quantizer, encoder, BPSK channel, reference
decoder (counterparts of `ldpc_tpu/ops/`)."""
