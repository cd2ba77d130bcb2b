"""Simulation layer of the port (counterpart of `ldpc_tpu/sim/`): the
simulation step, the BER/FER sweep loop and its statistics."""
from .pipeline import BatchCounters, make_run_batch, select_decoder
from .stats import SnrPoint, rates_compatible, wilson_interval
from .sweep import Sweep, SweepResult

__all__ = ["BatchCounters", "make_run_batch", "select_decoder", "SnrPoint",
           "rates_compatible", "wilson_interval", "Sweep", "SweepResult"]
