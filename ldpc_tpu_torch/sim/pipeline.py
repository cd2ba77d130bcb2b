"""The simulation step (counterpart of `ldpc_tpu/sim/pipeline.py`:
`make_run_batch`, `BatchCounters`, `select_decoder`,
`make_two_phase_decoder`, `make_two_phase_decoder_t`).

Ported scope: `make_run_batch` for one Eb/N0 point or for n_points striped
over the batch (the fused multi-SNR sweep: lane b simulates point
b % n_points with its own sigma), over a process mesh or on one device
(below), no superbatching; any
modulation of `ops.channel.MODULATIONS`; rate matching (punctured and
shortened variables), the all-zeros shortcut; flooding or layered decoding
with the min-sum family or min*, fixed iterations or early termination,
two-phase early termination, and the float decoders. A call runs one of
three chains:

  * transposed, host RNG (pipeline.py:600-644), batch last: info bits
    (k, B) -> encode -> modulate -> AWGN -> max-log demap -> an on-chip
    decoder (quantizes in the kernel, and counts info-bit errors there when
    the info bits are the codeword's prefix), with the draws from a
    torch.Generator on the code's device;
  * transposed, device RNG, the Monte-Carlo megakernel
    (pipeline.py:520-599): one launch of `kernels.minsum.McDecoder` draws
    the words from Philox keyed by the 64-bit batch seed, encodes, adds the
    noise, quantizes, decodes and counts. Taken where the reference takes
    it (`use_mc`); elsewhere rng="device" runs a host chain, as in the
    reference, and `run_batch.mc` says which ran;
  * batch first (`run_batch_bf`, pipeline.py:648-692): info bits (B, k)
    (shortened info bits zeroed) -> encode -> gather the transmitted
    positions -> modulate -> AWGN -> demap -> scatter back (LLR 0 at
    punctured, 1e6 at shortened positions) -> quantize (not in float
    mode) -> decode (B, n) -> info-bit errors. Every long code (n > 4096),
    every rate-matched code, all_zeros, the float algorithms and every
    decoder that is not an on-chip kernel take it, as in the reference
    (pipeline.py:396-401, 446-448).

`select_decoder` is the H100's admission rule (see there). Either way the
step returns the (5,) counter stack, or (5, n_points).

With a mesh (`parallel.make_mesh`; pipeline.py:482-493, 533-553) each rank
runs lanes [lane0, lane0 + B/W) of the global batch of B codewords
(`parallel.shard_lanes`), its decoder built for B/W, and `run_batch`
returns the global counters (`parallel.all_sum`). The draws keep the
mesh-size contract: every rank draws the global tensors from the batch's
generator, in the order and shapes of a run on one device (info bits,
then the noise of the global symbol shape), and keeps its own lanes; the
megakernel counts its Philox stream from the global lane (`lane0`). The
same seed therefore gives the same counters at every mesh size and shape,
and a mesh of one rank equals the run without a mesh bit for bit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..config import SimConfig

from ..codes import CodeTensors
from ..kernels import minsum
from ..kernels import minsum_stream as stream
from ..ops import channel as ch
from ..ops import decode_qc, decode_ref
from ..ops.encode import (DENSE_MAX_N, has_qc_struct, make_encoder,
                          make_encoder_t)
from ..ops.mc import gain_for
from ..ops.quantize import quantize
from ..parallel.mesh import all_sum, shard_lanes

MIN_SUM_FAMILY = ("min-sum", "offset-min-sum", "normalized-min-sum")
FIXED_POINT = MIN_SUM_FAMILY + ("min-star",)
FLOAT_ALGOS = ("sum-product", "min-sum-float", "offset-min-sum-float",
               "normalized-min-sum-float")
# `backend` values of select_decoder: "auto", a route to force, or the
# reference's `decoder_backend` names.
BACKENDS = ("auto", "stream", "qc", "pallas", "qc-jnp", "jnp")
SHORTENED_LLR = 1e6     # a shortened variable is a known zero


def is_float_mode(cfg: SimConfig) -> bool:
    """Float decoding: no quantizer, the float BP decoder takes raw LLRs."""
    return cfg.decoder.algorithm in FLOAT_ALGOS


@dataclass(frozen=True)
class BatchCounters:
    """Scalar results of one batch."""
    frames: int
    bit_errs: int        # info-bit errors
    frame_errs: int
    iter_sum: int
    converged: int

    def __add__(self, o: "BatchCounters") -> "BatchCounters":
        return BatchCounters(
            self.frames + o.frames, self.bit_errs + o.bit_errs,
            self.frame_errs + o.frame_errs, self.iter_sum + o.iter_sum,
            self.converged + o.converged)

    @staticmethod
    def zero() -> "BatchCounters":
        return BatchCounters(0, 0, 0, 0, 0)


def rate_matching(ct: CodeTensors):
    """(tx_pos, short_pos, keep) of a rate-matched code, int64 / uint8
    numpy arrays, or (None, None, None) without rate matching. tx_pos: the
    transmitted positions, every variable outside the union of punctured
    and shortened ones (pipeline.py:455-467); short_pos: the shortened
    positions or None; keep (k,): 0 at the info bits that are shortened,
    or None when no info bit is (pipeline.py:501-513)."""
    code = ct.code
    if not (len(code.punct_vns) or len(code.shortened_vns)):
        return None, None, None
    excluded = np.union1d(np.asarray(code.punct_vns, np.int64),
                          np.asarray(code.shortened_vns, np.int64))
    tx_pos = np.setdiff1d(np.arange(code.n, dtype=np.int64), excluded)
    short_pos = keep = None
    if len(code.shortened_vns):
        short_pos = np.asarray(code.shortened_vns, np.int64)
        info_pos = ct.info_positions.cpu().numpy()
        hit = np.isin(info_pos, short_pos)
        if hit.any():
            keep = (~hit).astype(np.uint8)
    return tx_pos, short_pos, keep


def check_in_slice(ct: CodeTensors, cfg: SimConfig) -> None:
    """Raise for configurations no step runs: an unknown algorithm,
    modulation or rng, and a transmitted length that does not fill the
    modulation's symbols (pipeline.py:471-480)."""
    dec = cfg.decoder
    if dec.algorithm not in FIXED_POINT + FLOAT_ALGOS:
        raise ValueError(f"unknown decoder algorithm {dec.algorithm!r}")
    mod = cfg.channel.modulation
    if mod not in ch.MODULATIONS:
        raise ValueError(f"unknown modulation {mod!r}")
    tx_pos, _, _ = rate_matching(ct)
    n_tx = ct.n if tx_pos is None else len(tx_pos)
    if n_tx % ch.BITS_PER_SYM[mod]:
        raise ValueError(
            f"{ct.code.name}: transmitted length {n_tx} is not a multiple "
            f"of {mod}'s {ch.BITS_PER_SYM[mod]} bits per symbol")
    if cfg.run.rng not in ("host", "device"):
        raise ValueError(f"rng={cfg.run.rng!r}: expected 'host' or 'device'")


def explicit_two_phase(cfg: SimConfig) -> bool:
    dc = cfg.decoder
    return bool(dc.phase1_iters and dc.phase1_iters > 0 and dc.early_term
                and dc.phase1_iters < dc.max_iter)


def stream_first(ct: CodeTensors, cfg: SimConfig) -> bool:
    """Whether `auto` takes the streaming library for a layered
    min-sum-family configuration that an on-chip kernel also admits: where
    no packed layered block takes the code (K3 would be the one-lane
    template) and the library's own rule (`instance_auto`) picks a
    redesigned kernel for it, the packed resident kernel or the pipelined
    kernel. Measured (chip_smoke.py, two runs, NVIDIA H100 80GB HBM3,
    700.00 W, in turns, CUDA-event medians, OMS; the streaming library's
    kernel at the instance's lanes against K3 behind its transposes):
    DVB-S2 n=16,200 at B = 1,024 fixed-20 1.5702, 1.5943 (packed resident)
    against 3.4186, 3.4549 ms, with early termination at 1.4 dB 1.2483,
    1.2565 against 2.6211, 2.6142; NR BG1 Z=384 at B = 1,024 fixed-20
    2.2425, 2.1109 against 4.1532, 4.1293, with early termination at
    1.25 dB 2.0783, 2.0230 against 3.8336, 3.8257; at B = 256 (two lanes)
    early termination 1.0983, 1.0276 against 1.3179, 1.2388, and fixed-20
    a tie, 1.0521, 1.0840 against 1.0736, 1.1502 (as slice 5d launched
    them 0.9904, 0.9999 against 1.0709, 1.0497); n=16,200 rate 8/9 at
    B = 1,024 1.4528, 1.3491 against 2.5725, 2.4925 and with early
    termination 1.3771, 1.4086 against 1.7520, 1.7516, and at B = 256,
    where the pipelined kernel's 28-entry row takes it, 0.4126 against
    0.7304 and with early termination 0.4914 against 0.7979. The route
    rests on the wins at B = 1,024 and with early termination."""
    dc = cfg.decoder
    if (dc.schedule != "layered" or dc.algorithm not in MIN_SUM_FAMILY
            or minsum.is_packed(ct, "layered", 0, dc.early_term)):
        return False
    auto = stream.instance_auto(ct, dc.early_term)
    # the resident instance is the packed kernel wherever its block fits
    return auto == "pipelined" or (auto == "resident"
                                   and stream.resident_packed_fits(ct, 2))


def resolve_route(ct: CodeTensors, cfg: SimConfig,
                  backend: str = "auto") -> str:
    """The decoder route of (code, config) on the H100, in place of the
    reference's VMEM ladder (pipeline.py:147-176):

      "float"   the float algorithms, whatever `backend` says;
      "onchip"  K1/K2/K3/K5, where one codeword's state fits an SM's
                shared memory (`MinsumDecoder.onchip_domain`), except where
                `stream_first` holds;
      "stream"  else, for layered min-sum-family configs inside its domain,
                the streaming library (`kernels/minsum_stream`), which
                picks its kernel by its own rule (`instance_auto`);
      "qc"      else the plain QC decoder (`ops/decode_qc`), the
                reference's qc-jnp backend (min* and flooding on long
                codes).

    `backend` forces a route: "stream", "qc", or the reference's names
    "pallas" (a kernel: on-chip, else stream, never a plain decoder; it
    keeps K3 where `auto` streams),
    "qc-jnp" (= "qc") and "jnp" (route "ref": the plain edge-gather
    decoder, `ops/decode_ref`). A forced route that cannot run raises
    ValueError; nothing falls back. The rule reads shapes only, so it is
    the same on a CPU code, where the wrappers run their plain versions.
    With "auto", tensors on the card reach a plain decoder on one route
    only: "qc", min* or flooding on a code too long for shared memory,
    which has no kernel in the reference either."""
    if is_float_mode(cfg):
        return "float"
    if backend not in BACKENDS:
        raise ValueError(f"unknown decoder backend {backend!r}: expected "
                         f"one of {BACKENDS}")
    b = {"qc-jnp": "qc", "jnp": "ref"}.get(backend, backend)
    dc = cfg.decoder
    if dc.schedule not in minsum.LIBRARIES:
        raise ValueError(f"unknown schedule {dc.schedule!r}")
    onchip_why = minsum.onchip_domain(ct, dc, cfg.quant)
    if dc.algorithm not in MIN_SUM_FAMILY:
        stream_why = f"the streaming library has no {dc.algorithm} form"
    elif dc.schedule != "layered":
        stream_why = "the streaming library is layered-only"
    else:
        stream_why = stream.stream_domain(ct, cfg.quant.qmax)
    if b in ("auto", "pallas"):
        if onchip_why is None and not (b == "auto" and stream_why is None
                                       and stream_first(ct, cfg)):
            return "onchip"
        if stream_why is None:
            return "stream"
        if b == "pallas":
            raise ValueError(f"no kernel takes this configuration: "
                             f"{onchip_why}; {stream_why}")
        return "qc"
    if b == "stream" and stream_why is not None:
        raise ValueError(stream_why)
    return b


def use_transposed(ct: CodeTensors, cfg: SimConfig, route: str) -> bool:
    """The reference's rule for the batch-last chain (pipeline.py:396-401,
    446-448): an on-chip decoder, fixed point, no rate matching, not
    all_zeros, n <= 4096 and whole symbols."""
    code = ct.code
    return (route == "onchip" and not cfg.run.all_zeros
            and not (len(code.punct_vns) or len(code.shortened_vns))
            and ct.n <= DENSE_MAX_N
            and ct.n % ch.BITS_PER_SYM[cfg.channel.modulation] == 0)


def use_mc(ct: CodeTensors, cfg: SimConfig, backend: str = "auto") -> bool:
    """The reference's rule for the megakernel (pipeline.py:396-445): the
    transposed chain, BPSK, rng == "device", no explicit two-phase (AUTO
    is fine: the sweep keeps the megakernel), info bits the identity
    prefix, and the encodable QC parity structure."""
    return (cfg.channel.modulation == "bpsk" and cfg.run.rng == "device"
            and not explicit_two_phase(cfg)
            and use_transposed(ct, cfg, resolve_route(ct, cfg, backend))
            and ct.ident_info and has_qc_struct(ct.code))


class TwoPhaseDecoder:
    """Two-phase early termination (`make_two_phase_decoder_t`,
    pipeline.py:222-266, counting form included, for the batch-last
    decoders; `make_two_phase_decoder`, pipeline.py:269-319, for the
    batch-first ones: `batch_first=True`).

      phase 1: dec_p1 (early termination, p1 iterations) on the full batch;
      repack:  the unconverged lanes are gathered on the batch axis into
               `capacity` lanes (LLRs and info rows; the unused lanes read
               a zero padding lane appended to the batch);
      phase 2: dec_full (early termination, max_iter) on the repacked
               lanes, restarting from the channel LLRs, and its results are
               scattered back (the padding lane's writes are sliced off);
      overflow: more than `capacity` unconverged lanes decode the whole
               batch with dec_full.

    Exact: integer min-sum is deterministic, so the restart replays each
    lane's trajectory, and per-lane results equal the single-phase run.
    The unconverged count is read on the host (one .item() sync per call)
    to choose between repack and overflow."""

    def __init__(self, dec_p1, dec_full, capacity: int,
                 batch_first: bool = False):
        self.dec_p1, self.dec_full = dec_p1, dec_full
        self.capacity = capacity
        self.batch_first = batch_first
        self.counting = dec_full.counting
        self.batch_tile = dec_full.batch_tile

    def __call__(self, chan: torch.Tensor,
                 info: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        args = (chan,) if info is None else (chan, info)
        out1 = self.dec_p1(*args)
        uncv = ~out1[-1]
        n_uncv = int(uncv.sum().item())
        if n_uncv > self.capacity:
            return self.dec_full(*args)
        first = self.batch_first
        B = chan.shape[0 if first else -1]
        idx = torch.full((self.capacity,), B, dtype=torch.int64,
                         device=chan.device)
        idx[:n_uncv] = torch.nonzero(uncv).flatten()

        def pad(x):
            """x with a zero lane appended on the batch axis."""
            shape = ((1,) + x.shape[1:]) if first else (x.shape[:-1] + (1,))
            return torch.cat([x, x.new_zeros(shape)], dim=0 if first else -1)

        def lanes(x, i):
            return x[i] if first else x[..., i]

        out2 = self.dec_full(*(lanes(pad(a), idx).contiguous()
                               for a in args))
        merged = []
        for a, b in zip(out1, out2):
            ap = pad(a)
            if first:
                ap[idx] = b
                merged.append(ap[:B])
            else:
                ap[..., idx] = b
                merged.append(ap[..., :B])
        return tuple(merged)


class BatchFirstDecoder:
    """An on-chip decoder (K1/K2/K3/K5, batch last) for a batch-first
    caller, with the transposes around it, as the reference's
    non-pre_transposed Pallas decoder: decode(q (B, n) int8) -> (hard (B, n)
    uint8, iters, conv)."""
    counting = False

    def __init__(self, inner: minsum.MinsumDecoder):
        self.inner = inner
        self.library = inner.library

    @property
    def batch_tile(self) -> int:
        return self.inner.batch_tile

    def _around(self, fn: Callable, q: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
        ct = self.inner.ct
        B = q.shape[0]
        hard, iters, conv = fn(q.T.reshape(ct.nb, ct.Z, B).contiguous())
        return hard.reshape(ct.n, B).T.contiguous(), iters, conv

    def __call__(self, q: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self._around(self.inner, q)

    def kernel(self, q: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self._around(self.inner.kernel, q)

    def plain(self, q: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self._around(self.inner.plain, q)


class PlainDecoder:
    """A plain torch batch-first decoder (`ops/decode_qc`, `ops/decode_ref`
    or a float decoder) as a route of its own: the reference computes these
    outside any kernel too."""
    counting = False
    batch_tile = 1

    def __init__(self, fn: Callable, what: str):
        self.fn, self.what = fn, what

    def __call__(self, q: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.fn(q)


def make_float_decoder(ct: CodeTensors, cfg: SimConfig,
                       dec_cfg=None) -> PlainDecoder:
    """The float decoder of a float-mode config (pipeline.py:97-108): the
    normalized variant's factor alpha_num / 2**alpha_shift rides the beta
    slot, the offset variant's beta is beta_lsb / scale in the LLR domain."""
    dc = dec_cfg or cfg.decoder
    alg = dc.algorithm.replace("-float", "")
    if alg == "normalized-min-sum":
        beta = cfg.quant.alpha_num / (1 << cfg.quant.alpha_shift)
    else:
        beta = cfg.quant.beta_lsb / cfg.quant.scale
    return PlainDecoder(decode_ref.make_float_decoder(
        ct.code, max_iter=dc.max_iter, algorithm=alg, beta=beta,
        early_term=dc.early_term, schedule=dc.schedule), "float")


Decoder = Union[minsum.MinsumDecoder, minsum.McDecoder, TwoPhaseDecoder,
                BatchFirstDecoder, stream.StreamDecoder, PlainDecoder]


def select_decoder(ct: CodeTensors, cfg: SimConfig,
                   batch: Optional[int] = None,
                   n_points: int = 1, backend: str = "auto",
                   batch_first: Optional[bool] = None
                   ) -> Tuple[Decoder, str]:
    """The decoder of the step and its label, by `resolve_route` (the
    admission rule; `backend` forces a route) and `use_transposed`
    (batch_first=None; True asks for the batch-first form of an on-chip
    decoder too).

    Transposed: the fused-IO on-chip decoder, float32 LLRs (nb, Z, B) in,
    the quantizer in the kernel; error counting in the kernel too when the
    info bits are the identity prefix (ct.ident_info), hard bits out
    otherwise. Where `use_mc` holds, the Monte-Carlo megakernel of `batch`
    codewords instead (per-lane sigma rows when n_points > 1).
    Batch first: decode(q (B, n) int8, or float32 LLRs in float mode) ->
    (hard (B, n) uint8, iters, conv).

    The label names what runs: the CUDA kernel or the plain version, the
    CN update where it is min*, the schedule, two-phase and megakernel
    forms (`cuda-minsum`, `cuda-minstar-layered`,
    `torch-plain-layered-2phase`, `cuda-minsum-mc`, ...; `-bf` for an
    on-chip decoder behind transposes), the streaming library's instance
    (`cuda-stream-pipelined`, `cuda-stream-pipelined-et`,
    `cuda-stream`, `cuda-stream-resident`, `cuda-stream-et`,
    `cuda-stream-resident-et`; `torch-plain-stream...` on a CPU code), or
    the plain routes `torch-qc`, `torch-ref`, `torch-float`.
    decoder.batch_tile is its batch granularity.

    A positive cfg.decoder.phase1_iters below max_iter, with early
    termination and a batch, wraps the decoder in `TwoPhaseDecoder` with
    capacity phase2_frac * batch rounded up to the tile; -1 is the sweep's
    AUTO sentinel and builds the single-phase decoder here, as the
    reference does (pipeline.py:194-219)."""
    route = resolve_route(ct, cfg, backend)
    transposed = use_transposed(ct, cfg, route)
    if batch_first is None:
        batch_first = not transposed
    elif not batch_first and not transposed:
        raise ValueError("this configuration runs batch first only")
    dc = cfg.decoder
    cuda = ct.device.type == "cuda"
    if route == "float":
        label = "torch-float"

        def build(dec_cfg):
            return make_float_decoder(ct, cfg, dec_cfg)
    elif route == "onchip":
        star = dc.algorithm == "min-star"
        if cuda:
            label = "cuda-minstar" if star else "cuda-minsum"
        else:
            label = "torch-plain-minstar" if star else "torch-plain"
        if dc.schedule == "layered":
            label += "-layered"
        if batch_first:
            label += "-bf"

            def build(dec_cfg):
                return BatchFirstDecoder(
                    minsum.make_decoder(ct, dec_cfg, cfg.quant))
        else:
            def build(dec_cfg, **mc):
                return minsum.make_decoder(
                    ct, dec_cfg, cfg.quant,
                    input_scale=float(cfg.quant.scale),
                    count_info_cols=ct.kb if ct.ident_info else None, **mc)

            if use_mc(ct, cfg, backend):
                if not batch:
                    raise ValueError("the megakernel needs a batch size")
                return build(dc, mc_batch=batch,
                             mc_lane_sigma=n_points > 1), label + "-mc"
    elif route == "stream":
        def build(dec_cfg, at=batch):
            return stream.make_decoder(ct, dec_cfg, cfg.quant, batch=at)

        label = (("cuda-" if cuda else "torch-plain-")
                 + build(dc).variant)
    elif route == "qc":
        label = "torch-qc"

        def build(dec_cfg):
            return PlainDecoder(decode_qc.make_decoder(
                ct.code, dec_cfg, cfg.quant), "qc")
    else:
        label = "torch-ref"

        def build(dec_cfg):
            return PlainDecoder(decode_ref.make_decoder(
                ct.code, dec_cfg, cfg.quant), "ref")
    dec = build(dc)
    p1 = dc.phase1_iters
    if p1 and p1 > 0 and dc.early_term and batch and p1 < dc.max_iter:
        dec_p1 = build(dataclasses.replace(dc, max_iter=p1))
        tile = dec.batch_tile
        want = max(int(batch * dc.phase2_frac), tile)
        cap = min(batch, -(-want // tile) * tile)
        if route == "stream":
            # phase 2 decodes `cap` codewords: its kernel is the one
            # measured fastest at that batch
            dec = build(dc, at=cap)
            label = (("cuda-" if cuda else "torch-plain-") + dec.variant)
        return (TwoPhaseDecoder(dec_p1, dec, cap, batch_first=batch_first),
                label + "-2phase")
    return dec, label




def make_lane_step(ct: CodeTensors, cfg: SimConfig,
                   batch: Optional[int] = None,
                   n_points: int = 1,
                   backend: str = "auto", mesh=None) -> Callable[..., Tuple]:
    """Returns step(rng, sigma, **draws) -> per-lane (bit_errs, frame_err,
    iters, conv), each (B,) on ct's device, or (B/W,) for this rank's lanes
    over a mesh of W ranks.

    rng: for the host chains a torch.Generator on ct's device, from which
    it draws the info bits first, then the noise, each of the global
    batch; for the megakernel (step.mc) the int batch seed that keys its
    Philox stream (`Sweep.draw` gives either). sigma: the noise standard
    deviation, taken to float32; with n_points > 1 a vector (n_points,),
    global lane b taking sigma[b % n_points]. Injected draws (tests), with
    which no generator is needed, are of the global batch too: for the
    transposed chain (step.transposed) info_t (k, B) uint8 and noise
    float32 of the symbols' shape ((n, B) for BPSK, (n / m, 2, B) for m
    bits per symbol); for the batch-first chain info (B, k) uint8 and noise
    (B, n_tx) or (B, n_tx / m, 2), n_tx the transmitted length; words
    (W, B) int32 for the megakernel. The step carries `decoder`,
    `backend_label`, `mc`, `transposed`, `lane0` and `local_batch` (this
    rank's lanes), and a batch-first step `chain`, its part before the
    decoder: chain(rng, sigma, **draws) -> (info bits (B/W, k), the
    decoder's input (B/W, n))."""
    check_in_slice(ct, cfg)
    B = batch or cfg.run.batch
    if n_points < 1 or B % n_points:
        raise ValueError(f"batch {B} not divisible by n_points {n_points}")
    lane0, Bl = (0, B) if mesh is None else shard_lanes(mesh, B)
    if Bl % n_points:
        raise ValueError(f"a rank's batch {Bl} not divisible by n_points "
                         f"{n_points}")
    local = slice(lane0, lane0 + Bl)
    mod = cfg.channel.modulation
    dec, label = select_decoder(ct, cfg, batch=Bl, n_points=n_points,
                                backend=backend)
    mc = isinstance(dec, minsum.McDecoder)
    transposed = use_transposed(ct, cfg, resolve_route(ct, cfg, backend))
    dev = ct.device
    n, k, nb, Z = ct.n, ct.k, ct.nb, ct.Z
    point = torch.arange(lane0, lane0 + Bl, device=dev) % n_points
    scale = float(cfg.quant.scale)
    m = ch.BITS_PER_SYM[mod]

    def lane_sigma(sigma) -> torch.Tensor:
        s = torch.as_tensor(np.asarray(sigma, np.float32), device=dev)
        if tuple(s.shape) != (n_points,):
            raise ValueError(f"fused sweep expects sigma of shape "
                             f"({n_points},), got {tuple(s.shape)}")
        return s[point]

    def check_draws(name, info, info_shape, noise, sym_shape):
        if info is not None and (tuple(info.shape) != info_shape
                                 or info.dtype != torch.uint8):
            raise ValueError(f"{name} must be {info_shape} uint8")
        if noise is not None and (tuple(noise.shape) != sym_shape
                                  or noise.dtype != torch.float32):
            raise ValueError(f"noise must be {sym_shape} float32")

    def draw_info(rng, shape) -> torch.Tensor:
        if rng is None:
            raise ValueError("run_batch needs a torch.Generator")
        return torch.randint(0, 2, shape, generator=rng, device=dev,
                             dtype=torch.uint8)

    if mc:
        def step(rng, sigma, *, words: Optional[torch.Tensor] = None
                 ) -> Tuple:
            if rng is None and words is None:
                raise ValueError("run_batch needs a seed or injected words")
            if rng is not None and not isinstance(rng, int):
                raise TypeError(f"the megakernel takes the int batch seed, "
                                f"got {type(rng).__name__}")
            if words is not None:
                words = words[:, local].contiguous()
            if n_points > 1:
                sig = lane_sigma(sigma)
                return dec(rng, words=words, sigma_lane=sig,
                           gain_lane=gain_for(sig, scale), lane0=lane0)
            s32 = np.float32(sigma)
            return dec(rng, s32, gain_for(s32, scale), words=words,
                       lane0=lane0)
    elif transposed:
        enc_t = make_encoder_t(ct)
        sym_shape = (n, B) if mod == "bpsk" else (n // m, 2, B)

        def step(rng, sigma, *, info_t: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> Tuple:
            if info_t is None:
                info_t = draw_info(rng, (k, B))
            check_draws("info_t", info_t, (k, B), noise, sym_shape)
            if noise is None:
                noise = ch.standard_normal(rng, sym_shape, dev)
            info_t = info_t[:, local].contiguous()
            sig = lane_sigma(sigma) if n_points > 1 else sigma
            x = ch.modulate_t(enc_t(info_t), mod)
            y = ch.awgn_t(None, x, sig, noise=noise[..., local])
            llr = ch.demap_t(y, sig, mod).reshape(nb, Z, Bl)
            if dec.counting:
                return dec(llr, info_t.reshape(ct.kb, Z, Bl))
            hard_t, iters, conv = dec(llr)
            err = hard_t.reshape(n, Bl)[ct.info_positions] != info_t
            return err.sum(dim=0), err.any(dim=0), iters, conv
    else:
        float_mode = is_float_mode(cfg)
        all_zeros = cfg.run.all_zeros
        tx_np, short_np, keep_np = rate_matching(ct)

        def on_dev(a):
            return None if a is None else torch.as_tensor(a, device=dev)

        tx_pos, short_pos, keep = map(on_dev, (tx_np, short_np, keep_np))
        n_tx = n if tx_pos is None else len(tx_np)
        sym_shape = (B, n_tx) if mod == "bpsk" else (B, n_tx // m, 2)
        enc = None if all_zeros else make_encoder(ct)

        def chain(rng, sigma, *, info: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> Tuple:
            """(info bits (B/W, k) as scored, the decoder's input
            (B/W, n))."""
            check_draws("info", info, (B, k), noise, sym_shape)
            if all_zeros:
                info = torch.zeros((Bl, k), dtype=torch.uint8, device=dev)
            else:
                if info is None:
                    info = draw_info(rng, (B, k))
                info = info[local]
            if keep is not None:
                info = info * keep
            if noise is None:
                noise = ch.standard_normal(rng, sym_shape, dev)
            sig = lane_sigma(sigma) if n_points > 1 else sigma
            cw = (torch.zeros((Bl, n), dtype=torch.uint8, device=dev)
                  if all_zeros else enc(info))
            tx = cw if tx_pos is None else cw[:, tx_pos]
            y = ch.awgn(None, ch.modulate(tx, mod), sig, noise=noise[local])
            llr = ch.demap(y, sig, mod)
            if tx_pos is not None:
                full = torch.zeros((Bl, n), dtype=llr.dtype, device=dev)
                full[:, tx_pos] = llr
                if short_pos is not None:
                    full[:, short_pos] = SHORTENED_LLR
                llr = full
            return info, (llr.to(torch.float32) if float_mode
                          else quantize(llr, cfg.quant))

        def step(rng, sigma, **draws) -> Tuple:
            info, q = chain(rng, sigma, **draws)
            hard, iters, conv = dec(q)
            err = hard[:, ct.info_positions] != info
            return err.sum(dim=1), err.any(dim=1), iters, conv

        step.chain = chain

    step.backend_label = label
    step.decoder = dec
    step.mc = mc
    step.transposed = transposed
    step.lane0, step.local_batch = lane0, Bl
    return step


def make_run_batch(ct: CodeTensors, cfg: SimConfig,
                   batch: Optional[int] = None,
                   n_points: int = 1,
                   backend: str = "auto",
                   mesh=None) -> Callable[..., torch.Tensor]:
    """Returns run_batch(rng, sigma, **draws) -> int64 tensor on ct's
    device stacking (frames, bit_errs, frame_errs, iter_sum, converged):
    shape (5,) for one point, (5, n_points) summed per point (global lane b
    counts for point b % n_points) for a fused sweep. The sums of
    `make_lane_step`'s per-lane results, over every rank of `mesh` (the
    global batch's counters on every rank), with the same arguments and
    attributes (`backend_label`, `decoder`, `mc`, `transposed`, `lane0`,
    `local_batch`, `chain`: None unless the step is batch first);
    `backend` forces a decoder route (`resolve_route`)."""
    B = batch or cfg.run.batch
    step = make_lane_step(ct, cfg, batch=B, n_points=n_points,
                          backend=backend, mesh=mesh)
    Bl = step.local_batch
    dev = ct.device
    i64 = torch.int64

    def run_batch(rng, sigma, **draws) -> torch.Tensor:
        bits, frame, iters, conv = step(rng, sigma, **draws)
        lanes = torch.stack([bits.to(i64), frame.to(i64), iters.to(i64),
                             conv.to(i64)])                      # (4, B/W)
        if n_points == 1:
            out = torch.cat([torch.full((1,), Bl, dtype=i64, device=dev),
                             lanes.sum(dim=1)])
        else:
            # lane0 is a multiple of n_points: local lane b is point
            # b % n_points
            per = lanes.reshape(4, Bl // n_points, n_points).sum(dim=1)
            frames = torch.full((1, n_points), Bl // n_points, dtype=i64,
                                device=dev)
            out = torch.cat([frames, per])
        return all_sum(out, mesh)

    for name in ("backend_label", "decoder", "mc", "transposed", "lane0",
                 "local_batch"):
        setattr(run_batch, name, getattr(step, name))
    run_batch.chain = getattr(step, "chain", None)
    run_batch.mesh = mesh
    return run_batch
