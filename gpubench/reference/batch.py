"""The counters of one simulated batch, worked out from the seed alone:
(frames, information-bit errors, frame errors, iteration sum, converged).

This is the plain reference of the sweep's step. It reads the configuration
file and the cell's traffic, and imports nothing of the simulator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from . import channel as chn
from .decode import Decoder, cn_beta
from .encode import Encoder
from .qc import QCCode, from_config


@dataclass(frozen=True)
class Setting:
    """What one batch needs: the code, the decoder's format and the
    traffic's draws."""
    code: QCCode
    batch: int
    bits: int
    scale: float
    beta: int
    schedule: str
    max_iter: int
    early_term: bool
    rng: str                  # "host" or "device"
    all_zeros: bool
    ebn0_db: float

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def sigma(self) -> np.float32:
        return chn.sigma_bpsk(self.ebn0_db, self.code.k / self.code.n)


def setting(config: dict, traffic: dict, batch: Optional[int] = None,
            bits: Optional[int] = None) -> Setting:
    """The setting of a configuration file under a traffic mix. `bits`
    below the configuration's keeps its LLR range: each bit less doubles
    the LSB (the control's lower precision)."""
    if config["channel"]["modulation"] != "bpsk":
        raise ValueError("the reference's channel is BPSK")
    q, dec = config["quant"], config["decoder"]
    b = int(q["bits"]) if bits is None else int(bits)
    shift = int(q["bits"]) - b
    beta = cn_beta(dec["algorithm"], q.get("beta_lsb", 0))
    return Setting(code=from_config(config["code"]),
                   batch=int(batch or config["run"]["batch"]), bits=b,
                   scale=float(q["scale"]) / (1 << shift),
                   beta=int(round(beta / (1 << shift))),
                   schedule=dec["schedule"], max_iter=int(dec["max_iter"]),
                   early_term=bool(dec["early_term"]), rng=traffic["rng"],
                   all_zeros=bool(traffic.get("all_zeros", False)),
                   ebn0_db=float(traffic["ebn0_db"]))


class Reference:
    def __init__(self, st: Setting, device):
        if st.rng == "device" and st.all_zeros:
            raise ValueError("the device draws always encode")
        self.st, self.device = st, device
        self.encoder = Encoder(st.code)
        self.decoder = Decoder(st.code, st.schedule, st.max_iter, st.beta,
                               st.qmax, st.early_term, device)

    def llrs(self, seed: int, index: int):
        """(info (B, k) uint8, quantized LLRs (B, n) int8) of batch
        `index` of point 0."""
        st, code, dev = self.st, self.st.code, self.device
        key = chn.batch_seed(seed, 0, index)
        if st.rng == "device":
            words = chn.device_words(key, code.k, code.nb, code.Z, st.batch,
                                     dev)
            info = chn.device_info(words, code.k)
            cw = self.encoded(info)
            return info, chn.device_llrs(words, cw, code.k, code.nb, code.Z,
                                         st.sigma, st.scale, st.qmax)
        if st.rng != "host":
            raise ValueError(f"unknown rng {st.rng!r}")
        info, noise = chn.host_draws(key, code.k, code.n, st.batch,
                                     st.all_zeros, dev)
        cw = (torch.zeros((st.batch, code.n), dtype=torch.uint8, device=dev)
              if st.all_zeros else self.encoded(info))
        return info, chn.host_llrs(cw, noise, st.sigma, st.scale, st.qmax)

    def encoded(self, info: torch.Tensor) -> torch.Tensor:
        cw = self.encoder(info)
        if not bool(self.decoder.syndrome_ok(cw).all()):
            raise RuntimeError("the reference encoder made a word that is "
                               "no codeword")
        return cw

    def counters(self, seed: int, index: int) -> List[int]:
        info, q = self.llrs(seed, index)
        hard, iters, conv = self.decoder(q)
        err = hard[:, :self.st.code.k] != info
        bits = err.sum(dim=1)
        return [int(self.st.batch), int(bits.sum()),
                int((bits > 0).sum()), int(iters.sum()), int(conv.sum())]
