"""The least time the card could take to decode, from the code's shapes
alone, whatever implements the decoder.

Operations: 12 integer operations an edge and iteration for a min-sum-family
check row (the count the simulator's kernel notes use), times the iterations
the lanes ran. Bytes: one int8 LLR read a code bit, one bit written an
information bit, and the five int64 counters a batch. The peaks are the
H100 SXM5 data sheet's: 67e12 float32 operations a second outside the tensor
cores (the int32 units have half as many lanes, so the true floor is
higher) and 3.35e12 bytes a second of HBM3, both at the full 700 W.
"""
from __future__ import annotations

OPS_PER_EDGE_ITERATION = 12
PEAK_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
COUNTER_BYTES = 5 * 8


def decode_ops(edges: int, iteration_sum: int) -> float:
    """Operations of a decode whose lanes ran `iteration_sum` iterations in
    all."""
    return float(OPS_PER_EDGE_ITERATION) * edges * iteration_sum


def decode_bytes(n: int, k: int, lanes: int) -> float:
    return float(n * lanes) + -(-k * lanes // 8) + COUNTER_BYTES


def bound_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)
