"""Configuration dataclasses of the port (a copy of `ldpc_tpu/config.py`, so
that the port loads nothing of the reference package; the two exchange
configs as JSON, `SimConfig.to_json`/`from_json`).

These pin the free parameters that the (unavailable) reference source would have
fixed at compile time — quantization format, offset value, saturation rule,
schedule — per SURVEY.md §5.6 and §8. The reference's golden model is the
single source of truth for the bit-exact semantics these configs describe; the
XLA ops and Pallas kernels must match it exactly.

Reference parity note: the reference (tyc85/FixedPointLDPC) is a C/MATLAB
simulator whose canonical run is 802.11n rate-1/2 n=648 QC-LDPC, BPSK over AWGN,
8-bit fixed-point min-sum, 20 iterations (BASELINE.json:7). The reference
checkout is empty (SURVEY.md §0), so file:line citations into it are impossible;
capabilities are cited as BASELINE.json line numbers instead.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class QuantConfig:
    """Fixed-point LLR quantization format (BASELINE.json:5 'fixed-point LLR
    quantization ... explicit int8/int16 quantized ops with verified overflow
    behavior').

    q = clip(round_half_away_from_zero(llr * scale), -qmax, +qmax), stored int8.
    Saturation is symmetric: qmax = 2**(bits-1) - 1; the value -(qmax+1) is never
    produced (avoids sign-flip pathologies on negation).

    beta_lsb is the offset-min-sum offset in integer LSBs (0 => plain min-sum).
    With the default scale=4.0, beta_lsb=2 corresponds to beta=0.5 in LLR units.

    alpha_num/alpha_shift define the normalized-min-sum scaling factor as
    the dyadic rational alpha = alpha_num / 2**alpha_shift (default 3/4 —
    the canonical NMS choice). Integer semantics, pinned by the golden
    model: mag' = max(((mag * alpha_num) >> alpha_shift) - beta, 0),
    applied to the post-exclusion CN magnitude; >> is a floor shift on the
    nonnegative magnitude, so every implementation reproduces it exactly.
    """

    bits: int = 8
    scale: float = 4.0
    beta_lsb: int = 2
    alpha_num: int = 3
    alpha_shift: int = 2

    def __post_init__(self):
        # The whole fixed-point datapath (jnp quantize op, Pallas kernels,
        # C-oracle marshalling) stores channel LLRs as int8: bits > 8 would
        # silently WRAP in the int8 cast instead of saturating.
        if not 2 <= self.bits <= 8:
            raise ValueError(f"QuantConfig.bits={self.bits}: the int8 "
                             f"datapath supports 2..8 bits")

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def qmin(self) -> int:
        return -self.qmax


@dataclass(frozen=True)
class CodeConfig:
    """Which LDPC code to simulate.

    family: 'ieee80211n' | '5gnr' | 'dvbs2' | 'toy' | 'alist'
    For ieee80211n: n in {648, 1296, 1944}, rate in {'1/2','2/3','3/4','5/6'}.
    For 5gnr: base_graph in {1, 2}, lifting Z, rate matching params.
    For dvbs2: n = 64800 (normal) or 16200 (short frame), rate string.
    For alist: path names a MacKay-format H file (codes/alist.py); n and
    rate are derived from the file.
    """

    family: str = "ieee80211n"
    n: int = 648
    rate: str = "1/2"
    base_graph: int = 1
    Z: Optional[int] = None  # lifting size; derived from (family, n, rate) if None
    k_info: Optional[int] = None  # 5G NR payload bits (< kb*Z => shortening)
    path: Optional[str] = None  # alist family: H-matrix file
    # family='qcpeg' (codes/peg.py): girth-optimized QC-PEG construction,
    # deterministic from (n, rate, Z, profile, code_seed) — so constructed
    # codes are first-class config citizens (sweeps, checkpoints, CLI).
    # profile: info-column base degrees, either 'deg:frac,...' (node-
    # perspective fractions) or an explicit 'd0,d1,...' list of length kb;
    # None = uniform degree 3.
    profile: Optional[str] = None
    code_seed: int = 0
    # family='pbrl' (codes/peg.py pbrl_construct): raptor-like
    # rate-compatible construction — core_rows dual-diagonal core rows
    # (cb), the remaining parity rows are weight-1-parity extensions with
    # ext_row_degree PEG-placed circulants each. n/rate set the MOTHER
    # geometry: kb = rate*n/Z, mb = n/Z - kb, n_ext = mb - core_rows.
    # profile = core info-column degrees. Tail puncturing (punct_frac)
    # climbs the IR ladder toward the core rate kb/(kb+core_rows).
    core_rows: int = 4
    ext_row_degree: int = 3
    # Generic rate-compatible puncturing (codes/rate_compat.py): fraction of
    # the mother code's parity bits punctured (never transmitted, LLR 0 at
    # the decoder), applied AFTER family construction to any family.
    # Nested across fractions (prefixes of one puncture order), so a set of
    # configs differing only in punct_frac forms a rate-compatible ladder.
    punct_frac: float = 0.0
    punct_scheme: str = "tail"  # 'tail' | 'random' (seeded by run.seed)
    # Generic shortening: the LAST shorten_bits information bits are known
    # zeros (not transmitted; decoder sees saturated +LLR). Any family;
    # composes with punct_frac and NR's k_info. build_code applies
    # shortening FIRST, then puncturing (puncture candidates exclude
    # info/shortened positions, so the two commute today — but the
    # shorten-then-puncture order is the contract).
    shorten_bits: int = 0


@dataclass(frozen=True)
class ChannelConfig:
    """Modulation + channel (BASELINE.json:5 'AWGN channel + BPSK/QAM LLR
    computation')."""

    modulation: str = "bpsk"  # ops.channel.MODULATIONS: bpsk/qpsk/16qam/
    # 64qam + the DVB-S2 set 8psk/16apsk/32apsk
    ebn0_db: float = 2.0


@dataclass(frozen=True)
class DecoderConfig:
    """Decoder algorithm selection (BASELINE.json:5 'min-sum / offset-min-sum',
    BASELINE.json:9 'layered decoding schedule', BASELINE.json:8 'early
    termination')."""

    # 'min-sum' | 'offset-min-sum' | 'normalized-min-sum' | 'min-star'
    # (threshold-LUT Jacobian correction, see minstar_thresholds) | floats
    algorithm: str = "min-sum"
    schedule: str = "flooding"  # 'flooding' | 'layered'
    max_iter: int = 20
    early_term: bool = True
    # Two-phase early termination (TPU operating-point optimization): run
    # phase1_iters on the whole batch, then COMPACT the unconverged lanes
    # (a static-capacity gather) and restart only those with the full
    # max_iter budget. Bit-exact: integer min-sum is deterministic, so the
    # restart replays the identical trajectory and the per-lane first-
    # convergence latch sees the same states. None = single-phase.
    # phase2_frac sizes the compacted batch (fraction of the full batch,
    # rounded up to the kernel tile); pick it a safe margin above the
    # unconverged fraction at phase1_iters (overflow falls back to a
    # full-batch decode — exact but not faster). -1 = AUTO: the sweep
    # loop probes the convergence CDF per SNR point and picks
    # (phase1_iters, phase2_frac) itself (sim/tune.py) — never slower
    # than single-phase by construction (falls back when it won't pay).
    phase1_iters: Optional[int] = None
    phase2_frac: float = 0.25


@dataclass(frozen=True)
class RunConfig:
    """Monte-Carlo sweep run parameters (SURVEY.md §5.6)."""

    batch: int = 1024
    seed: int = 0
    max_frames: int = 1_000_000
    target_frame_errors: int = 100
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("batch",)
    # The reference's classic shortcut: transmit the all-zeros codeword
    # (valid for any linear code + symmetric channel), skipping the encoder.
    all_zeros: bool = False
    # RNG placement: "host" = draws from a torch.Generator on the code's
    # device, one per batch, seeded from (seed, point, batch). "device" =
    # the Monte-Carlo megakernel: info bits + AWGN from a Philox4x32-10
    # stream inside the decode kernel (a different, still fully
    # deterministic random family, keyed by the batch seed and counted by
    # codeword lane; statistically, not bitwise, comparable to host mode).
    # Falls back to the host chain off the megakernel's path (sim/pipeline
    # use_mc).
    rng: str = "host"


@dataclass(frozen=True)
class SimConfig:
    code: CodeConfig = CodeConfig()
    channel: ChannelConfig = ChannelConfig()
    quant: QuantConfig = QuantConfig()
    decoder: DecoderConfig = DecoderConfig()
    run: RunConfig = RunConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "SimConfig":
        d = json.loads(s)
        return SimConfig(
            code=CodeConfig(**d["code"]),
            channel=ChannelConfig(**d["channel"]),
            quant=QuantConfig(**d["quant"]),
            decoder=DecoderConfig(**d["decoder"]),
            run=RunConfig(
                **{
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in d["run"].items()
                }
            ),
        )


# The five BASELINE.json configs (lines 6-12) as named presets.
PRESETS = {
    # BASELINE.json:7 — canonical, CPU-runnable.
    "wifi-648-r12-minsum": SimConfig(
        code=CodeConfig(family="ieee80211n", n=648, rate="1/2"),
        channel=ChannelConfig(modulation="bpsk", ebn0_db=2.0),
        quant=QuantConfig(bits=8, scale=4.0, beta_lsb=0),
        decoder=DecoderConfig(algorithm="min-sum", schedule="flooding",
                              max_iter=20, early_term=False),
        run=RunConfig(batch=1024),
    ),
    # BASELINE.json:8 — full 802.11n set with OMS + early termination.
    "wifi-full-oms": SimConfig(
        code=CodeConfig(family="ieee80211n", n=1944, rate="5/6"),
        channel=ChannelConfig(modulation="bpsk", ebn0_db=3.0),
        quant=QuantConfig(bits=8, scale=4.0, beta_lsb=2),
        # phase1_iters=-1: AUTO two-phase ET (sim/tune.py) — the ET preset
        # never pays the round-2 "ET slower than fixed at waterfall SNRs"
        # regression; the tuner declines where two-phase can't win.
        decoder=DecoderConfig(algorithm="offset-min-sum", schedule="layered",
                              max_iter=20, early_term=True,
                              phase1_iters=-1),
        run=RunConfig(batch=1024),
    ),
    # BASELINE.json:9 — 5G NR layered. Fixed-iteration like the DVB preset:
    # Z=384 state exceeds VMEM, and in the HBM-streaming regime the
    # pipelined stream kernel (fixed iters, layered) beats the XLA path
    # with early termination (measured round 2, docs/PERFORMANCE.md).
    "nr-bg1-layered": SimConfig(
        code=CodeConfig(family="5gnr", base_graph=1, Z=384, rate="1/2"),
        channel=ChannelConfig(modulation="bpsk", ebn0_db=2.0),
        quant=QuantConfig(bits=8, scale=4.0, beta_lsb=2),
        decoder=DecoderConfig(algorithm="offset-min-sum", schedule="layered",
                              max_iter=20, early_term=False),
        run=RunConfig(batch=256),
    ),
    # BASELINE.json:10 — DVB-S2 long codes, HBM-resident messages. Layered
    # with fixed iterations: the HBM-streaming kernel's domain (layered
    # needs half the iterations of flooding for equal BER, and per-iteration
    # syndrome passes are not worth their bandwidth in this regime).
    "dvbs2-64800-r12": SimConfig(
        code=CodeConfig(family="dvbs2", n=64800, rate="1/2"),
        channel=ChannelConfig(modulation="bpsk", ebn0_db=1.5),
        quant=QuantConfig(bits=8, scale=4.0, beta_lsb=2),
        decoder=DecoderConfig(algorithm="offset-min-sum", schedule="layered",
                              max_iter=20, early_term=False),
        run=RunConfig(batch=8192),
    ),
    # BASELINE.json:11 — multi-host full-chain SDR workload.
    "multihost-qam-chain": SimConfig(
        code=CodeConfig(family="ieee80211n", n=1944, rate="3/4"),
        channel=ChannelConfig(modulation="16qam", ebn0_db=6.0),
        quant=QuantConfig(bits=8, scale=4.0, beta_lsb=2),
        decoder=DecoderConfig(algorithm="offset-min-sum", schedule="layered",
                              max_iter=20, early_term=True),
        run=RunConfig(batch=4096, mesh_shape=(2, 4), mesh_axes=("dcn", "ici")),
    ),
}


def cn_params(dec: DecoderConfig, quant: QuantConfig):
    """(beta, alpha) for the fixed-point CN magnitude transform
    mag' = max(((mag * num) >> shift) - beta, 0), where alpha is
    (num, shift) or None for the identity. Single mapping shared by every
    decoder implementation (golden, jnp, QC, Pallas, C oracle) so the
    algorithm -> parameters choice cannot diverge between them."""
    alg = dec.algorithm
    if alg == "offset-min-sum":
        return quant.beta_lsb, None
    if alg == "normalized-min-sum":
        if not (0 < quant.alpha_num <= (1 << quant.alpha_shift)):
            raise ValueError(
                f"normalized-min-sum needs 0 < alpha <= 1, got "
                f"{quant.alpha_num}/2^{quant.alpha_shift}")
        if (quant.alpha_num, quant.alpha_shift) == (1, 0):
            return 0, None  # alpha = 1 is plain min-sum
        return 0, (quant.alpha_num, quant.alpha_shift)
    if alg == "min-sum":
        return 0, None
    if alg == "min-star":
        raise ValueError("min-star uses minstar_thresholds(), not the "
                         "min1/min2 magnitude transform")
    raise ValueError(f"no fixed-point CN parameters for algorithm {alg}")


def minstar_thresholds(quant: QuantConfig) -> tuple:
    """Integer thresholds for the fixed-point min* (approx sum-product)
    Jacobian correction, derived deterministically from the LLR scale.

    The exact pairwise box-plus is min(|x|,|y|) + c(|x|+|y|) - c(||x|-|y||)
    with c(u) = ln(1+e^-u) in LLR units. In the integer domain the
    correction is the hardware-classic threshold LUT:

        c_int(u) = #{ i : u <= T_i }   (one LSB per crossed threshold)

    where T_i is the largest integer u with scale*ln(1+e^(-u/scale))
    >= i - 0.5 (round-to-nearest of the true correction), i = 1..C,
    C = round(scale*ln 2) = the correction at u=0. scale=4 gives
    T = (8, 3, 0): c(0)=3, c(1..3)=2, c(4..8)=1, 0 beyond. Every
    implementation (golden, QC-jnp) derives the SAME tuple from the same
    QuantConfig, so the algorithm cannot diverge between backends."""
    import math
    scale = quant.scale
    C = int(math.floor(scale * math.log(2.0) + 0.5))
    out = []
    for i in range(1, C + 1):
        # largest u with c_float(u) >= i - 0.5
        u = math.floor(-scale * math.log(math.exp((i - 0.5) / scale) - 1.0))
        out.append(max(int(u), 0))
    return tuple(out)
