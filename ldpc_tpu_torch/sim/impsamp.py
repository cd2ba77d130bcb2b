"""Error-floor estimation by defensive mixture importance sampling
(counterpart of `ldpc_tpu/sim/impsamp.py`, function by function under the
same names).

Plain Monte-Carlo cannot reach the error-floor region (FER 1e-9 needs
~1e10 frames). The estimator draws each frame's AWGN noise from a MIXTURE
proposal built from trapping sets (`analysis/trapping.py`,
`analysis/asenum.py`): the noise mean is shifted toward each candidate
set's error region, and the unshifted channel stays in the mixture with
weight pi0, so

  * the estimator is UNBIASED for the true FER regardless of which sets
    were found — a missed error mechanism costs variance, never bias;
  * likelihood weights are bounded by 1/pi0 (q >= pi0 * p pointwise).

All-zeros transmission, BPSK/AWGN only. Rate matching follows the
batch-first step's contract (`sim/pipeline.py`): the channel, the noise
space and the mean shifts cover the transmitted positions only; punctured
variables enter the decoder at LLR 0, shortened ones at `SHORTENED_LLR`
before quantizing. Eb/N0 -> sigma uses the effective rate (`code.rate`),
as `sim/sweep.py` does, so floor curves line up with waterfall curves.

Estimator: FER = E_q[ 1{frame error} * p(z)/q(z) ], with
p = N(0, sigma^2 I), q = pi0*p + (1-pi0)/K * sum_k N(mu_k, sigma^2 I),
mu_k = -delta_k * indicator(S_k).

On the card an IS batch is: standard-normal draws and the component of
each lane (`torch.Generator` on the device), the mixture shift, the weights
(one (B, n) x (n, K) `torch.matmul` and a `torch.logsumexp` in float32, as
the reference computes them with `jnp` outside any kernel), demap,
quantize, and the decoder `select_decoder` gives in its batch-first form
(on the canonical code K3's packed layered kernel behind its transposes),
then the per-batch sums (a segmented sum per stratum). Every batch's draws
can be injected (`eps`, `comp`), which is how the tests hold the datapath
to the JAX function. The sums of a point are accumulated in float64 on the
device and read once per point (after the pilot too, with Neyman
allocation). Batch i of a point draws from a generator seeded with
`sweep.batch_seed(seed, round(ebn0_db * 1000), i)`, so a floor curve's
points are independent and a run repeats from its seed. The streams are
not the reference's: port and reference agree statistically, not bitwise.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codes import config_from_reference, from_reference, own_code
from ..codes.code import qc_block_cover
from ..config import SimConfig
from ..device import DeviceLike, resolve_device
from ..ops import channel as ch
from ..ops.quantize import quantize
from .pipeline import SHORTENED_LLR, select_decoder
from .sweep import batch_seed

# elements of the (B, U, P, Z) boolean gather of the symmetric run's match
# profile held at once (the supports are taken in chunks below it)
_GATHER_ELEMS = 1 << 28


def _not_ported_mesh():
    raise NotImplementedError(
        "mesh=: sharding the IS batch over devices waits for the port of "
        "parallel/mesh.py")


def _check_domain(cfg: SimConfig, code=None) -> None:
    del code  # rate matching is modeled natively (see _rate_match)
    if cfg.channel.modulation != "bpsk":
        raise ValueError("importance sampling supports BPSK only")


def _rate_match(code) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(tx_pos, short_pos) int32, mirroring the step's rate-matching
    contract: punctured variables are never transmitted and enter the
    decoder with LLR 0; shortened variables are known zeros and enter
    saturated. The channel, and so the noise space and the mixture's mean
    shifts, covers ONLY the n_tx transmitted positions. (None, None) for a
    code without rate matching."""
    if not (len(code.punct_vns) or len(code.shortened_vns)):
        return None, None
    excluded = set(map(int, code.punct_vns)) | set(
        map(int, code.shortened_vns))
    tx_pos = np.asarray([v for v in range(code.n) if v not in excluded],
                        np.int32)
    short_pos = (np.asarray(code.shortened_vns, np.int32)
                 if len(code.shortened_vns) else None)
    return tx_pos, short_pos


def _positions(pos, device) -> Optional[torch.Tensor]:
    return None if pos is None else torch.as_tensor(
        np.asarray(pos, np.int64) if not isinstance(pos, torch.Tensor)
        else pos, dtype=torch.int64, device=device)


def _assemble_llr(z: torch.Tensor, sigma, code, tx_pos, short_pos,
                  batch: int) -> torch.Tensor:
    """Channel observations (1 + z over transmitted positions, all-zeros
    codeword) -> full-length float32 LLR rows (batch, n), the step's
    rate-matching rules. tx_pos, short_pos: numpy or int64 tensors."""
    llr = ch.demap(1.0 + z, sigma, "bpsk")
    if tx_pos is None:
        return llr
    full = torch.zeros((batch, code.n), dtype=llr.dtype, device=llr.device)
    full[:, _positions(tx_pos, llr.device)] = llr
    if short_pos is not None:
        full[:, _positions(short_pos, llr.device)] = SHORTENED_LLR
    return full


def _sigma32(sigma, device) -> torch.Tensor:
    return torch.as_tensor(np.float32(sigma), device=device)


def _generator(device: torch.device, seed: int, ebn0_db: float,
               i: int) -> torch.Generator:
    """Batch i of a point: (seed, round(ebn0_db * 1000), i), as
    `sweep.batch_seed` keys a sweep's batch."""
    g = torch.Generator(device=device)
    g.manual_seed(batch_seed(seed, int(round(ebn0_db * 1000)) & 0x7FFFFFFF,
                             i))
    return g


# ---------------------------------------------------------------------------
# Failure harvesting (the empirical source of trapping-set candidates)
# ---------------------------------------------------------------------------

def harvest_error_supports(code, cfg: SimConfig, ebn0_db: float,
                           frames: int = 4096, batch: int = 512,
                           backend: str = "auto", seed: int = 1,
                           device: DeviceLike = "cuda",
                           max_supports: int = 256,
                           eps: Optional[Sequence[torch.Tensor]] = None
                           ) -> List[np.ndarray]:
    """Run plain all-zeros Monte-Carlo and return the error supports
    (positions of nonzero decoded bits) of the failed frames, at most
    min(64, batch) a batch in frame order. Harvested at a waterfall-floor
    transition SNR these are the dominant trapping-set cores (after
    analysis.trapping.refine_support). eps: injected standard-normal draws,
    one (batch, n_tx) float32 tensor a batch (tests)."""
    cfg = config_from_reference(cfg)
    code = own_code(code)
    _check_domain(cfg, code)
    dev = resolve_device(device)
    ct = from_reference(code, dev)
    dec, _ = select_decoder(ct, cfg, batch=batch, backend=backend,
                            batch_first=True)
    sigma = _sigma32(ch.sigma_for(ebn0_db, code.rate, "bpsk"), dev)
    tx_np, short_np = _rate_match(code)
    tx_pos, short_pos = _positions(tx_np, dev), _positions(short_np, dev)
    n_ch = code.n if tx_np is None else len(tx_np)
    nb = (frames + batch - 1) // batch
    if eps is not None and len(eps) != nb:
        raise ValueError(f"eps holds {len(eps)} batches, the run {nb}")
    # failures beyond the per-batch cap are dropped: max_supports caps the
    # total anyway, and failure supports are exchangeable samples
    max_bad = min(64, batch)
    out: List[np.ndarray] = []
    for i in range(nb):
        if eps is None:
            e = torch.randn((batch, n_ch), generator=_generator(
                dev, seed, ebn0_db, i), device=dev, dtype=torch.float32)
        else:
            e = eps[i].to(dev)
        llr = _assemble_llr(sigma * e, sigma, code, tx_pos, short_pos, batch)
        hard, _, _ = dec(quantize(llr, cfg.quant))
        bad = torch.nonzero(hard.any(dim=1)).flatten()[:max_bad]
        for r in hard[bad].cpu().numpy():
            out.append(np.nonzero(r)[0].astype(np.int32))
            if len(out) >= max_supports:
                return out
    return out


# ---------------------------------------------------------------------------
# Mixture-IS estimator
# ---------------------------------------------------------------------------

def mixture_log_weight(z: torch.Tensor, M: torch.Tensor, sizes: torch.Tensor,
                       log_pi: torch.Tensor, delta: float,
                       sigma) -> torch.Tensor:
    """log p(z)/q(z) for the defensive Gaussian mixture (B,), float32. The
    common N(., sigma^2 I) normalizers cancel, so only the mean shifts
    enter:

      log w = -logsumexp_k[ log pi_k + (2 z.mu_k - |mu_k|^2) / (2 sigma^2) ]

    with mu_0 = 0 and mu_k = -delta * M[k-1]. Bounded above by -log pi_0."""
    sigma = _sigma32(sigma, z.device) if not isinstance(
        sigma, torch.Tensor) else sigma.to(torch.float32)
    s_k = torch.matmul(z, M.T)                 # (B, K): z . indicator_k
    expo = (-2.0 * delta * s_k - (delta ** 2) * sizes) / (2.0 * sigma ** 2)
    terms = torch.cat([torch.zeros((z.shape[0], 1), dtype=torch.float32,
                                   device=z.device), expo], dim=1) + log_pi
    return -torch.logsumexp(terms, dim=1)


@dataclasses.dataclass
class ISEstimate:
    ebn0_db: float
    fer: float                 # importance-sampled FER estimate
    rel_std: float             # relative standard error of fer
    frames: int
    raw_hits: int              # frames that erred under the proposal
    fer_plain_ci95: float      # what plain MC could have resolved: 2/frames
    ber: float                 # importance-sampled info-BER estimate

    def to_dict(self):
        d = dataclasses.asdict(self)
        if not np.isfinite(d["rel_std"]):
            d["rel_std"] = None  # strict-JSON safe (Infinity is not RFC 8259)
        return d


def expand_radial(sets: Sequence[Sequence[int]],
                  deltas: Sequence[float]
                  ) -> Tuple[List[Sequence[int]], np.ndarray]:
    """Radial-ladder proposal: replicate every support at every shift
    depth, as separate mixture components. Returns (sets_expanded,
    delta_vector) for make_is_run/estimate_fer. Covering several radii of
    each basin tames the heavy-tailed weights that a single full-flip
    depth produces deep in the floor."""
    ds = [float(d) for d in deltas]
    if not ds:
        raise ValueError("deltas must be non-empty")
    out_sets: List[Sequence[int]] = []
    out_d: List[float] = []
    for s in sets:
        for d in ds:
            out_sets.append(s)
            out_d.append(d)
    return out_sets, np.asarray(out_d, np.float32)


def _apportion(pis: np.ndarray, total: int, min_each: int = 1) -> np.ndarray:
    """Largest-remainder apportionment of `total` lanes to len(pis) strata,
    each stratum guaranteed >= min_each (an unsampled stratum would bias a
    stratified estimator — every mixture component must appear)."""
    k = len(pis)
    if total < k * min_each:
        raise ValueError(f"batch {total} too small for {k} strata "
                         f"(min {min_each} each)")
    rem_total = total - k * min_each
    p = np.asarray(pis, np.float64)
    quota = p / p.sum() * rem_total
    base = np.floor(quota).astype(np.int64)
    frac = quota - base
    left = int(rem_total - base.sum())
    order = np.argsort(-frac, kind="stable")
    base[order[:left]] += 1
    return (base + min_each).astype(np.int32)


def _mean_matrix(sets, deltas: np.ndarray, n: int, tx_pos, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, sizes) on the device: row k is deltas[k] at set k's UNIQUE
    positions, restricted to the transmitted space; sizes[k] = |mu_k|^2.
    The depths are folded into M, so the weights run at delta = 1."""
    M = np.zeros((len(sets), n), np.float32)
    for k, s in enumerate(sets):
        M[k, np.asarray(sorted(set(map(int, s))), np.int64)] = deltas[k]
    if tx_pos is not None:
        M = M[:, tx_pos]
    sizes = (deltas ** 2 * (M > 0).sum(axis=1)).astype(np.float32)
    return (torch.as_tensor(M, device=device),
            torch.as_tensor(sizes, device=device))


def _log_pi(pi0: float, K: int, device) -> torch.Tensor:
    return torch.log(torch.cat([
        torch.tensor([pi0], dtype=torch.float32),
        torch.full((K,), (1.0 - pi0) / K, dtype=torch.float32)])).to(device)


class _MixtureRun:
    """What make_is_run and make_symmetric_run share: the code on the
    device, the decoder, the mean matrix (uploaded once), and the chain
    up to the decoder's input. run(rng, sigma, ...) = tally(decoder(q), w,
    comp) with (q, w, comp) = chain(rng, sigma, ...)."""

    def __init__(self, code, cfg: SimConfig, sets, deltas: np.ndarray,
                 pi0: float, batch: int, backend: str,
                 device: DeviceLike):
        self.cfg = cfg
        self.code = code
        self.batch = batch
        self.device = resolve_device(device)
        self.ct = from_reference(code, self.device)
        self.decoder, self.backend_label = select_decoder(
            self.ct, cfg, batch=batch, backend=backend, batch_first=True)
        tx_np, short_np = _rate_match(code)
        self.n_ch = code.n if tx_np is None else len(tx_np)
        self.tx_pos = _positions(tx_np, self.device)
        self.short_pos = _positions(short_np, self.device)
        self.info_pos = self.ct.info_positions
        K = self.K = len(sets)
        # the mixture's probabilities: the defensive component, then the sets
        self.pis = (np.concatenate([[pi0], np.full(K, (1.0 - pi0) / K)])
                    if K else np.ones(1))
        if K:
            self.M, self.sizes = _mean_matrix(sets, deltas, code.n, tx_np,
                                              self.device)
            self.log_pi = _log_pi(pi0, K, self.device)
            self.cdf = torch.cumsum(torch.as_tensor(
                self.pis, dtype=torch.float64, device=self.device), dim=0)

    def _draws(self, rng, eps, comp, counts):
        """(eps (B, n_ch), comp (B,) or None): injected or drawn from rng,
        eps first, then the components (inverse CDF on uniform draws), or
        the stratified lane blocks of `counts`."""
        B, dev = self.batch, self.device
        if eps is None:
            if rng is None:
                raise ValueError("an IS batch needs a torch.Generator or "
                                 "injected draws")
            eps = torch.randn((B, self.n_ch), generator=rng, device=dev,
                              dtype=torch.float32)
        elif tuple(eps.shape) != (B, self.n_ch) or eps.dtype != torch.float32:
            raise ValueError(f"eps must be ({B}, {self.n_ch}) float32")
        eps = eps.to(dev)
        if not self.K:
            return eps, None
        if counts is not None:
            if comp is not None:
                raise ValueError("a stratified batch takes its components "
                                 "from counts")
            # deterministic lane blocks: lanes [0, counts[0]) are the
            # defensive component, the next counts[1] are set 1, ...
            c = torch.as_tensor(np.asarray(counts) if not isinstance(
                counts, torch.Tensor) else counts, device=dev).to(
                    torch.int64)
            if tuple(c.shape) != (self.K + 1,):
                raise ValueError(f"counts must have {self.K + 1} entries")
            comp = torch.searchsorted(torch.cumsum(c, dim=0),
                                      torch.arange(B, device=dev),
                                      right=True)
        elif comp is None:
            if rng is None:
                raise ValueError("an IS batch needs a torch.Generator or "
                                 "injected components")
            u = torch.rand(B, generator=rng, device=dev, dtype=torch.float64)
            comp = torch.searchsorted(self.cdf, u, right=True).clamp_(
                max=self.K)
        elif tuple(comp.shape) != (B,):
            raise ValueError(f"comp must have shape ({B},)")
        return eps, comp.to(device=dev, dtype=torch.int64)

    def chain(self, rng, sigma, counts=None, *,
              eps: Optional[torch.Tensor] = None,
              comp: Optional[torch.Tensor] = None):
        """(q (B, n) int8, the decoder's input; w (B,) float32 weights;
        comp (B,) int64 components, or None without sets)."""
        sig = _sigma32(sigma, self.device)
        eps, comp = self._draws(rng, eps, comp, counts)
        z = sig * eps
        if self.K:
            # depths are folded into M's rows (mu_k = -deltas_k * m_k), so
            # the shift is the row itself and the weights run at delta=1
            shift = torch.where(comp[:, None] > 0,
                                -self.M[(comp - 1).clamp(min=0)], 0.0)
            z = z + shift
            w = torch.exp(mixture_log_weight(z, self.M, self.sizes,
                                             self.log_pi, 1.0, sig))
        else:
            w = torch.ones((self.batch,), dtype=torch.float32,
                           device=self.device)
        llr = _assemble_llr(z, sig, self.code, self.tx_pos, self.short_pos,
                            self.batch)
        return quantize(llr, self.cfg.quant), w, comp

    def __call__(self, rng, sigma, counts=None, *,
                 eps: Optional[torch.Tensor] = None,
                 comp: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, w, comp = self.chain(rng, sigma, counts, eps=eps, comp=comp)
        hard, _, _ = self.decoder(q)
        return self.tally(hard, w, comp)


class ISRun(_MixtureRun):
    """One IS batch (make_is_run): run(rng, sigma) -> float32 sums
    [sum w*err, sum (w*err)^2, raw err frames, sum w*bit_errs] (4,) on the
    device, or with `stratified` run(rng, sigma, counts) -> the same per
    stratum (4, K+1). rng: a torch.Generator on the device; eps
    ((B, n_ch) float32) and comp ((B,) int) inject the draws."""

    def __init__(self, code, cfg, sets, deltas, pi0, batch, backend, device,
                 stratify):
        super().__init__(code, cfg, sets, deltas, pi0, batch, backend,
                         device)
        self.stratified = bool(stratify) and self.K > 0
        self.n_comp = self.K + 1

    def __call__(self, rng, sigma, counts=None, *, eps=None, comp=None):
        if self.stratified == (counts is None):
            raise ValueError("a stratified run takes counts, and only it")
        return super().__call__(rng, sigma, counts, eps=eps, comp=comp)

    def tally(self, hard: torch.Tensor, w: torch.Tensor,
              comp: Optional[torch.Tensor]) -> torch.Tensor:
        info_err = hard[:, self.info_pos] != 0
        err = info_err.any(dim=-1).to(torch.float32)
        bits = info_err.sum(dim=-1).to(torch.float32)
        we = w * err
        rows = torch.stack([we, we * we, err, w * bits], dim=1)   # (B, 4)
        if self.stratified:
            # the lanes of a stratum are contiguous (the lane blocks of
            # `counts`): a segmented sum, deterministic where index_add_'s
            # float atomics on the card are not, so a batch's sums repeat
            # bit for bit
            lengths = torch.bincount(comp, minlength=self.n_comp)
            return torch.segment_reduce(rows, "sum", lengths=lengths,
                                        axis=0, initial=0.0).T
        return rows.sum(dim=0)


def make_is_run(code, cfg: SimConfig, sets: Sequence[Sequence[int]],
                delta=2.0, pi0: float = 0.5, batch: int = 1024,
                backend: str = "auto", device: DeviceLike = "cuda",
                mesh=None, stratify: bool = False) -> ISRun:
    """One IS batch (see ISRun); the decoder is `select_decoder`'s
    batch-first form, its label `run.backend_label`.

    sets may be empty: the proposal is then exactly p and every weight is
    1 — the estimator degenerates to plain Monte-Carlo by construction.

    delta: scalar shift depth, or a per-set vector (a RADIAL LADDER: the
    same support at several depths, see expand_radial).

    stratify: lanes take their mixture component from a (K+1,) lane
    allocation `counts` (sum == batch, every entry >= 1) instead of a
    multinomial draw, and the sums come per stratum; the weights stay p/q
    against the FULL mixture, and the host combines strata as
    sum_j pi_j * mean_j (stratified IS; Neyman allocation without a
    rebuild). mesh: not ported."""
    cfg = config_from_reference(cfg)
    code = own_code(code)
    _check_domain(cfg, code)
    if mesh is not None:
        _not_ported_mesh()
    if not 0 < pi0 <= 1:
        raise ValueError(f"pi0 must be in (0, 1], got {pi0}")
    if np.any(np.asarray(delta, np.float32) <= 0):
        raise ValueError("delta (shift depth) must be > 0 per component")
    tx_pos, _ = _rate_match(code)
    deltas = np.broadcast_to(np.asarray(delta, np.float32),
                             (len(sets),)).copy()
    if len(sets) and tx_pos is not None:
        # the mixture can only shift transmitted positions: a set whose
        # variables are all punctured/shortened would duplicate p
        keep_idx = [i for i, s in enumerate(sets)
                    if len(np.intersect1d(
                        np.asarray(sorted(set(map(int, s))), np.int64),
                        tx_pos))]
        if len(keep_idx) != len(sets):
            warnings.warn(f"importance sampling: dropped "
                          f"{len(sets) - len(keep_idx)} proposal set(s) "
                          "with no transmitted positions (fully "
                          "punctured/shortened)")
            sets = [sets[i] for i in keep_idx]
            deltas = deltas[keep_idx]
    if not sets and pi0 < 1:
        pi0 = 1.0
    return ISRun(code, cfg, sets, deltas, pi0, batch, backend, device,
                 stratify)


def canonical_rotation(code, support: Sequence[int]) -> Tuple[int, ...]:
    """Rotate a QC-code support to its canonical orbit representative: the
    lexicographically smallest of its Z rotations (rotation r maps
    b*Z + o -> b*Z + (o + r) % Z). Dedup key for orbit folding."""
    Z = int(code.Z)
    s = np.asarray(sorted(set(map(int, support))), np.int64)
    blocks, offs = s // Z, s % Z
    best = None
    for r in range(Z):
        cand = tuple(sorted(blocks * Z + (offs + r) % Z))
        if best is None or cand < best:
            best = cand
    return best


def _orbit_index(reps: Sequence[Sequence[int]], Z: int, n: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The rotation-match gather of the DISTINCT supports among reps
    (expand_radial repeats each support once per depth; its match profile
    depends on the support alone): idx (U, P, Z) int64 with
    idx[u, p, r] = b*Z + (o + r) % Z for support u's p-th position (b, o),
    padded with n (a column of zeros); inv (K,) maps rep k to its support;
    mult (U,) float32 counts the reps of each support."""
    supports = [tuple(sorted(set(map(int, s)))) for s in reps]
    uniq = list(dict.fromkeys(supports))
    where = {s: u for u, s in enumerate(uniq)}
    inv = np.asarray([where[s] for s in supports], np.int64)
    P = max(len(s) for s in uniq)
    idx = np.full((len(uniq), P, Z), n, np.int64)
    r = np.arange(Z)
    for u, s in enumerate(uniq):
        for p, v in enumerate(s):
            b, o = divmod(v, Z)
            idx[u, p] = b * Z + (o + r) % Z
    mult = np.bincount(inv, minlength=len(uniq)).astype(np.float32)
    return idx, inv, mult


def _match_profile(hard: torch.Tensor, idx: torch.Tensor, inv: torch.Tensor,
                   mult: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Mtot (B,), m0 (B, K)) float32 of the symmetric estimator: for rep k,
    mr_k[r] = OR over its positions (b, o) of hard[b*Z + (o + r) % Z];
    m_k = #matching rotations, Mtot = sum_k m_k, m0[:, k] = mr_k[0]. One
    column gather per distinct support, in chunks of _GATHER_ELEMS."""
    B = hard.shape[0]
    hp = torch.cat([hard != 0, torch.zeros((B, 1), dtype=torch.bool,
                                           device=hard.device)], dim=1)
    U, P, Z = idx.shape
    step = max(1, _GATHER_ELEMS // max(1, B * P * Z))
    m_u, m0_u = [], []
    for lo in range(0, U, step):
        mr = hp[:, idx[lo:lo + step]].any(dim=2)        # (B, u, Z)
        m_u.append(mr.sum(dim=2))
        m0_u.append(mr[:, :, 0])
    m_u = torch.cat(m_u, dim=1).to(torch.float32)
    m0 = torch.cat(m0_u, dim=1)[:, inv].to(torch.float32)
    return m_u @ mult, m0


class SymmetricRun(_MixtureRun):
    """One symmetry-folded IS batch (make_symmetric_run): run(rng, sigma)
    -> (4, K+2) float32 on the device. Columns 0..K-1: per-representative
    Z-folded shares; column K: unmatched remainder; column K+1: totals.
    Rows: [sum xi (the per-frame FER contribution), sum xi^2, raw fail
    counts, sum w*anyfail]."""

    def __init__(self, code, cfg, reps, deltas, pi0, batch, backend, device):
        super().__init__(code, cfg, reps, deltas, pi0, batch, backend,
                         device)
        self.orbit_multiplier = int(code.Z)
        idx, inv, mult = _orbit_index(reps, int(code.Z), code.n)
        self.idx = torch.as_tensor(idx, device=self.device)
        self.inv = torch.as_tensor(inv, device=self.device)
        self.mult = torch.as_tensor(mult, device=self.device)

    def tally(self, hard: torch.Tensor, w: torch.Tensor,
              comp: Optional[torch.Tensor] = None) -> torch.Tensor:
        del comp
        fail_any = hard.any(dim=1).to(torch.float32)
        info_err = hard[:, self.info_pos] != 0
        fail = info_err.any(dim=-1).to(torch.float32)
        Mtot, m0 = _match_profile(hard, self.idx, self.inv, self.mult)
        inv_M = torch.where(Mtot > 0, 1.0 / Mtot.clamp(min=1.0), 0.0)
        we = w * fail
        share = (we[:, None] * m0 * inv_M[:, None]
                 * np.float32(self.orbit_multiplier))
        none = Mtot == 0
        rem = we * none
        xi = share.sum(dim=1) + rem        # per-frame FER contribution
        cols = torch.cat([share, rem[:, None], xi[:, None]], dim=1)
        matched = m0 > 0
        raw = torch.cat([fail[:, None] * matched, (fail * none)[:, None],
                         fail[:, None]], dim=1)
        wa = w * fail_any
        anyc = torch.cat([wa[:, None] * matched, (wa * none)[:, None],
                          wa[:, None]], dim=1)
        return torch.stack([cols.sum(dim=0), (cols * cols).sum(dim=0),
                            raw.sum(dim=0), anyc.sum(dim=0)])


def make_symmetric_run(code, cfg: SimConfig, reps: Sequence[Sequence[int]],
                       delta=2.0, pi0: float = 0.25, batch: int = 1024,
                       backend: str = "auto", device: DeviceLike = "cuda",
                       mesh=None) -> SymmetricRun:
    """Symmetry-folded mixture IS (see SymmetricRun).

    A QC code + iid channel + all-zeros transmission is bit-exactly
    invariant under the Z circulant rotations, so every failure mechanism
    comes in an orbit of Z equally likely rotations. The proposal covers
    ONE canonical representative per orbit (expand_radial over `reps`),
    and the estimator Z-folds with an EXACT multiplicity correction. Per
    failing frame, let match(k, r) = 1 iff the error support intersects
    rotation r of representative k, M = sum_{k,r} match(k,r) and
    M0_k = match(k, 0). Because M is rotation-invariant,

        FER = Z * sum_k E_q[w*fail*M0_k/M] + E_q[w*fail*1{M=0}]

    holds EXACTLY: a failure meeting several representatives or rotations
    is shared fractionally and never counted twice. Rate matching must be
    block-aligned (whole Z-blocks), which `qc_block_cover` enforces.
    mesh: not ported."""
    cfg = config_from_reference(cfg)
    code = own_code(code)
    _check_domain(cfg, code)
    if mesh is not None:
        _not_ported_mesh()
    if code.Z is None:
        raise ValueError("symmetric IS requires a QC code")
    if not reps:
        raise ValueError("need at least one orbit representative")
    tx_pos, _ = _rate_match(code)
    if tx_pos is not None:
        qc_block_cover(code.punct_vns, int(code.Z), "punctured")
        qc_block_cover(code.shortened_vns, int(code.Z), "shortened")
    deltas = np.broadcast_to(np.asarray(delta, np.float32),
                             (len(reps),)).copy()
    return SymmetricRun(code, cfg, reps, deltas, pi0, batch, backend, device)


def _device_of(run, device: DeviceLike) -> torch.device:
    dev = getattr(run, "device", None)
    return dev if dev is not None else resolve_device(device)


def estimate_fer_symmetric(code, cfg: SimConfig,
                           reps: Sequence[Sequence[int]], ebn0_db: float,
                           frames: int, delta=2.0, pi0: float = 0.25,
                           batch: int = 1024, backend: str = "auto",
                           seed: int = 0, device: DeviceLike = "cuda",
                           mesh=None, run=None) -> dict:
    """Symmetry-folded FER estimate at one SNR (see make_symmetric_run).
    Returns a dict: fer (Z-folded total), rel_std, the per-orbit top
    contributions, the unattributed remainder and its rel_std, raw hit
    counts, frames."""
    if run is None:
        run = make_symmetric_run(code, cfg, reps, delta=delta, pi0=pi0,
                                 batch=batch, backend=backend, device=device,
                                 mesh=mesh)
    code = own_code(code)
    batch = run.batch
    K, Z = run.K, run.orbit_multiplier
    dev = _device_of(run, device)
    sigma = ch.sigma_for(ebn0_db, code.rate, "bpsk")
    nb = (frames + batch - 1) // batch
    acc = torch.zeros((4, K + 2), dtype=torch.float64, device=dev)
    for i in range(nb):
        acc += torch.as_tensor(run(_generator(dev, seed, ebn0_db, i), sigma),
                               device=dev).to(torch.float64)
    acc = acc.cpu().numpy()
    N = nb * batch
    mean = acc[0] / N                      # columns already Z-folded
    var = np.maximum(acc[1] / N - mean ** 2, 0.0) / N
    fer = float(mean[K + 1])               # exact total (xi column)
    rel = (float(np.sqrt(var[K + 1]) / fer) if fer > 0 else float("inf"))
    fer_rem = float(mean[K])
    order = np.argsort(-mean[:K])
    return {
        "ebn0_db": float(ebn0_db), "fer": fer, "rel_std": rel,
        "fer_attributed_zfold": float(mean[:K].sum()),
        "fer_unattributed": fer_rem,
        "rel_std_unattributed": (float(np.sqrt(var[K]) / fer_rem)
                                 if fer_rem > 0 else None),
        "raw_hits": int(acc[2, K + 1]),
        "raw_hits_attributed": int(acc[2, :K].sum()),
        "frames": int(N), "orbit_multiplier": int(Z),
        "fer_plain_ci95": 2.0 / N,
        "top_orbits": [{"rep": int(k), "zfold_fer": float(mean[k]),
                        "raw": int(acc[2, k])}
                       for k in order[:8] if mean[k] > 0],
    }


def estimate_fer(code, cfg: SimConfig, sets: Sequence[Sequence[int]],
                 ebn0_db: float, frames: int, delta=2.0,
                 pi0: float = 0.5, batch: int = 1024,
                 backend: str = "auto", seed: int = 0,
                 device: DeviceLike = "cuda", mesh=None, run=None,
                 stratify: bool = False,
                 allocation: str = "proportional",
                 pilot_frames: int = 0) -> ISEstimate:
    """Mixture-IS FER estimate at one SNR point. `frames` is rounded up to
    whole batches. Pass a prebuilt `run` (make_is_run) to reuse its
    decoder and mean matrix across SNR points; its batch wins.

    stratify: deterministic per-component lane allocation (see
    make_is_run). allocation:
      "proportional" — counts follow the mixture probabilities pi_j;
      "neyman"       — a pilot phase (pilot_frames, proportional) measures
                       each stratum's std of w*err, then the main phase
                       allocates counts ~ pi_j * std_j (each stratum kept
                       >= 1 lane). The pilot is EXCLUDED from the estimate,
                       so the reported figure stays strictly unbiased;
                       `frames` counts the main phase only.
    """
    if allocation not in ("proportional", "neyman"):
        raise ValueError(f"unknown allocation {allocation!r}")
    if run is None:
        run = make_is_run(code, cfg, sets, delta=delta, pi0=pi0, batch=batch,
                          backend=backend, device=device, mesh=mesh,
                          stratify=stratify)
    batch = run.batch
    code = own_code(code)
    stratified = getattr(run, "stratified", False)
    dev = _device_of(run, device)
    sigma = ch.sigma_for(ebn0_db, code.rate, "bpsk")
    nb = (frames + batch - 1) // batch

    def accumulate(first: int, n: int, shape, counts=None) -> np.ndarray:
        """float64 sums of batches first..first+n-1, read once."""
        acc = torch.zeros(shape, dtype=torch.float64, device=dev)
        extra = () if counts is None else (counts,)
        for i in range(first, first + n):
            acc += torch.as_tensor(run(_generator(dev, seed, ebn0_db, i),
                                       sigma, *extra),
                                   device=dev).to(torch.float64)
        return acc.cpu().numpy()

    if not stratified:
        sw, sw2, raw, swb = accumulate(0, nb, (4,))
        N = nb * batch
        fer = sw / N
        var = max(sw2 / N - fer ** 2, 0.0) / N
        rel = float(np.sqrt(var) / fer) if fer > 0 else float("inf")
        return ISEstimate(ebn0_db=float(ebn0_db), fer=float(fer),
                          rel_std=rel, frames=int(N), raw_hits=int(raw),
                          fer_plain_ci95=2.0 / N,
                          ber=float(swb / (N * code.k_eff)))

    pis = np.asarray(run.pis, np.float64)
    nc = run.n_comp
    counts = _apportion(pis, batch)
    ib = 0  # batch counter shared across phases -> distinct draws everywhere
    if allocation == "neyman" and pilot_frames > 0:
        npb = (pilot_frames + batch - 1) // batch
        acc = accumulate(ib, npb, (4, nc),
                         torch.as_tensor(counts, device=dev))
        ib += npb
        n_j = counts.astype(np.float64) * npb
        mean_j = acc[0] / n_j
        std_j = np.sqrt(np.maximum(acc[1] / n_j - mean_j ** 2, 0.0))
        alloc_w = pis * std_j
        if alloc_w.sum() > 0:
            counts = _apportion(alloc_w, batch)

    acc = accumulate(ib, nb, (4, nc), torch.as_tensor(counts, device=dev))
    n_j = counts.astype(np.float64) * nb
    mean_j = acc[0] / n_j
    var_j = np.maximum(acc[1] / n_j - mean_j ** 2, 0.0)
    fer = float(np.sum(pis * mean_j))
    var = float(np.sum(pis ** 2 * var_j / n_j))
    rel = float(np.sqrt(var) / fer) if fer > 0 else float("inf")
    N = nb * batch
    return ISEstimate(ebn0_db=float(ebn0_db), fer=fer, rel_std=rel,
                      frames=int(N), raw_hits=int(acc[2].sum()),
                      fer_plain_ci95=2.0 / N,
                      ber=float(np.sum(pis * acc[3] / n_j) / code.k_eff))
