"""The port's offline analysis layer (counterpart of `ldpc_tpu/analysis/`),
numpy and host C only: the design funnel's three threshold tools, exact
quantized density evolution over degree spectra (`de`), protograph EXIT
under the Gaussian approximation (`exit`) and exact quantized
multi-edge-type DE (`proto_de`), and the trapping-set tools (`trapping`)
and exact absorbing-set census (`asenum`, a host C enumerator) that
error-floor estimation draws its proposals from. Every module is a copy of
the reference's under the same names, and exports what the reference's
package exports."""
from .asenum import (  # noqa: F401
    EnumResult, absorbing_spectrum_key, enumerate_sets,
    exact_absorbing_census)
from .exit import (  # noqa: F401
    J, J_inv, exit_curves_regular, pexit_threshold_awgn,
    pexit_threshold_sigma, pexit_trajectory, sigma_ch_columns,
    sigma_ch_for)
from .proto_de import (  # noqa: F401
    column_channel_pmfs, proto_de_threshold_awgn, proto_de_trajectory)
from .trapping import (  # noqa: F401
    classify, dominant_sets, is_absorbing, odd_checks, refine_support,
    search_trapping_sets)
from .de import (  # noqa: F401
    DegreeSpectra, chan_pmf_awgn, chan_pmf_bsc, de_pe_trajectory,
    de_pe_trajectory_spectra, de_threshold_awgn, de_threshold_awgn_spectra,
    de_threshold_bsc, de_threshold_bsc_spectra,
    decision_weights_min_degree, gallager_threshold,
    gallager_threshold_spectra, gallager_trajectory,
    gallager_trajectory_spectra, regular_spectra, spectra_from_code)
