"""The port's offline analysis layer (counterpart of `ldpc_tpu/analysis/`):
the trapping-set tools (`trapping`) and the exact absorbing-set census
(`asenum`, a host C enumerator) that error-floor estimation draws its
proposals from. Density evolution (`de`, `exit`, `proto_de`) is not ported
yet."""
from .asenum import (  # noqa: F401
    EnumResult, absorbing_spectrum_key, enumerate_sets,
    exact_absorbing_census)
from .trapping import (  # noqa: F401
    classify, dominant_sets, is_absorbing, odd_checks, refine_support,
    search_trapping_sets)
