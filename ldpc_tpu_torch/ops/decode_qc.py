"""QC-structured plain torch decoder (counterpart of
`ldpc_tpu/ops/decode_qc.py`: `make_qc_decoder`, `make_decoder`).

Posteriors as (B, nb, Z) tensors, circulant shifts as `torch.roll`, the
base entries of one layer stacked into one (B, Z, d) CN update. Two roles:

  * the plain version of the streaming CUDA library
    (`kernels/csrc/minsum_stream.cu`, through `kernels/minsum_stream.py`);
  * the reference's `qc-jnp` backend: the decoder it takes for min* and for
    flooding on codes too long for the on-chip kernels. The reference
    computes it outside any kernel, so it stays plain torch here, under the
    label `torch-qc`.

Batch first: decode(chan (B, n) int8) -> (hard (B, n) uint8, iters (B,)
int32, conv (B,) bool), on chan's device. Flooding or layered, fixed
iterations or per-lane early termination, the min-sum family (beta, dyadic
alpha) or min*. Bit-exact with `golden.decoder.decode_fixed` and the
reference decoder on equal int8 inputs. Messages are stored as int8, as in
the reference; the state updates in place.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..codes import qc_entries
from ..codes.code import LDPCCode
from ..config import DecoderConfig, QuantConfig, cn_params, minstar_thresholds
from .decode_ref import Decoded, _cn_fn

_I32 = torch.int32


def make_qc_decoder(
    code: LDPCCode,
    max_iter: int = 20,
    beta: int = 0,
    qmax: int = 127,
    schedule: str = "layered",
    early_term: bool = True,
    alpha=None,
    minstar=None,
) -> Callable[[torch.Tensor], Decoded]:
    """minstar: the threshold tuple of `config.minstar_thresholds` selects
    the min* CN update (beta and alpha must then be 0 and None)."""
    if schedule not in ("flooding", "layered"):
        raise ValueError(schedule)
    if code.base is None or code.Z is None:
        raise ValueError(f"{code.name}: the QC decoder requires QC structure")
    cn_update = _cn_fn(beta, alpha, minstar, qmax)
    qc, layers = qc_entries(code)
    Z, nb, n = int(qc.Z), int(qc.nb), int(code.n)
    n_entries = sum(len(row) for row in layers)
    flooding = schedule == "flooding"

    def rot_fwd(x, s):
        """y[..., r] = x[..., (r + s) % Z]."""
        return x if s == 0 else torch.roll(x, -s, dims=-1)

    def rot_bwd(x, s):
        return x if s == 0 else torch.roll(x, s, dims=-1)

    def syndrome_ok(post: torch.Tensor) -> torch.Tensor:
        """post (B, nb, Z) -> (B,) bool."""
        neg = post < 0
        unsat = torch.zeros(post.shape[0], dtype=torch.bool,
                            device=post.device)
        for row in layers:
            acc = None
            for j, s, _ in row:
                h = rot_fwd(neg[:, j], s)
                acc = h if acc is None else acc ^ h
            unsat |= acc.any(dim=-1)
        return ~unsat

    def layer_news(read, c2v, row):
        """(old, new) messages of one base row, each (B, Z, d) int32; the
        row's entry ids are consecutive. read: (B, nb, Z) totals."""
        e0 = row[0][2]
        old = c2v[:, e0: e0 + len(row)].transpose(1, 2).to(_I32)
        tot = torch.stack([rot_fwd(read[:, j], s) for j, s, _ in row],
                          dim=-1)
        v2c = torch.clamp(tot - old, -qmax, qmax)
        mask = torch.ones(len(row), dtype=torch.bool, device=read.device)
        return old, cn_update(v2c, mask)

    def decode(chan: torch.Tensor) -> Decoded:
        B, dev = chan.shape[0], chan.device
        chan3 = chan.to(_I32).reshape(B, nb, Z)
        c2v = torch.zeros((B, n_entries, Z), dtype=torch.int8, device=dev)
        done = (syndrome_ok(chan3) if early_term
                else torch.zeros(B, dtype=torch.bool, device=dev))
        iters = torch.zeros(B, dtype=_I32, device=dev)
        post = chan3.clone()       # flooding: the totals of the last sweep
        for _ in range(max_iter):
            if early_term and bool(done.all()):
                break
            act = (~done)[:, None, None]
            if flooding:
                cols = chan3.clone()
                for row in layers:
                    old, new = layer_news(post, c2v, row)
                    e0 = row[0][2]
                    store = torch.where(act, new, old) if early_term else new
                    c2v[:, e0: e0 + len(row)] = store.transpose(1, 2).to(
                        torch.int8)
                    for t, (j, s, _) in enumerate(row):
                        cols[:, j] += rot_bwd(new[..., t], s)
                post = torch.where(act, cols, post) if early_term else cols
            else:
                for row in layers:
                    old, new = layer_news(post, c2v, row)
                    e0 = row[0][2]
                    store = torch.where(act, new, old) if early_term else new
                    c2v[:, e0: e0 + len(row)] = store.transpose(1, 2).to(
                        torch.int8)
                    delta = store - old
                    for t, (j, s, _) in enumerate(row):
                        post[:, j] += rot_bwd(delta[..., t], s)
            iters += (~done).to(_I32)
            if early_term:
                done = done | syndrome_ok(post)
        hard = (post < 0).reshape(B, n).to(torch.uint8)
        conv = done if early_term else syndrome_ok(post)
        return hard, iters, conv

    return decode


def make_decoder(code: LDPCCode, dec: DecoderConfig, quant: QuantConfig
                 ) -> Callable[[torch.Tensor], Decoded]:
    """Factory from configs: (beta, alpha) from `config.cn_params`, the
    min* thresholds from `config.minstar_thresholds`."""
    if dec.algorithm == "min-star":
        return make_qc_decoder(code, max_iter=dec.max_iter, beta=0,
                               qmax=quant.qmax, schedule=dec.schedule,
                               early_term=dec.early_term,
                               minstar=minstar_thresholds(quant))
    if dec.algorithm not in ("min-sum", "offset-min-sum",
                             "normalized-min-sum"):
        raise ValueError(f"the QC decoder supports the min-sum family and "
                         f"min-star, got {dec.algorithm}")
    beta, alpha = cn_params(dec, quant)
    return make_qc_decoder(code, max_iter=dec.max_iter, beta=beta,
                           qmax=quant.qmax, schedule=dec.schedule,
                           early_term=dec.early_term, alpha=alpha)
