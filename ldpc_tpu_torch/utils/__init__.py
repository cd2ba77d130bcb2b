"""Timing, tracing and native-library helpers of the port (counterparts of
`ldpc_tpu/utils/`)."""
