"""The plain reference: its Philox stream, its encoder, its decoder on a
hand case, and the control's lower precision, which has to read as not
correct."""
import numpy as np
import pytest
import torch

from gpubench import check, registry
from gpubench.reference import channel, decode
from gpubench.reference.batch import Reference, setting
from gpubench.reference.encode import Encoder
from gpubench.reference.qc import from_config


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    out = channel.philox(tuple(torch.tensor([c]) for c in ctr), key)
    assert tuple(int(o) for o in out) == want


@pytest.mark.parametrize("config", ["ieee80211n-648-r12-minsum",
                                    "dvbs2-64800-r12-oms-layered"])
def test_encoder_makes_codewords(config):
    cfg = registry.workload(
        {"ieee80211n-648-r12-minsum": "wifi648-host",
         "dvbs2-64800-r12-oms-layered": "dvbs2-64800-host"}[config]).config
    code = from_config(cfg["code"])
    info = torch.randint(0, 2, (3, code.k), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    cw = Encoder(code)(info)
    dec = decode.Decoder(code, "flooding", 1, 0, 127, False, "cpu")
    assert bool(dec.syndrome_ok(cw).all())
    assert torch.equal(cw[:, :code.k], info)


def test_check_update_hand_case():
    v2c = torch.tensor([[3, -1, 5, -7]], dtype=torch.int32)
    pad = torch.zeros(4, dtype=torch.bool)
    # signs: two negatives, S = +1; minima 1 (at slot 1) and 3
    assert decode.check_update(v2c, pad, 0, 127).tolist() == [[1, -3, 1, -1]]
    # the offset takes one LSB off each magnitude, not below 0
    assert decode.check_update(v2c, pad, 1, 127).tolist() == [[0, -2, 0, 0]]


def test_sample_is_drawn_from_the_seed():
    a = check.sample(7, 500, 3)
    assert a == check.sample(7, 500, 3) and 499 in a and len(a) == 4
    assert a != check.sample(8, 500, 3)
    assert check.sample(7, 1, 3) == [0] and check.sample(7, 0, 3) == []


@pytest.mark.parametrize("workload,batch,seed", [
    ("wifi648-mc", 64, 21), ("wifi648-host", 64, 22),
    ("dvbs2-64800-host", 2, 23), ("dvbs2-64800-allzeros", 2, 24),
])
def test_control_reads_not_correct(workload, batch, seed):
    """The reference in the int4 datapath, in the program's place, fails
    the cell's check (at a size the CPU holds; `control.py` reads it on the
    card at the cell's own size)."""
    wl = registry.workload(workload)
    st = setting(wl.config, wl.traffic, batch=batch)
    low = setting(wl.config, wl.traffic, batch=batch, bits=4)
    assert low.qmax == 7 and low.scale == st.scale / 16
    ref, ctl = Reference(st, "cpu"), Reference(low, "cpu")
    idx = check.sample(seed, 50, 1)
    checks = check.judge({i: ctl.counters(seed, i) for i in idx},
                         {i: ref.counters(seed, i) for i in idx},
                         wl.traffic["limits"])
    assert not check.passed(checks), checks


@pytest.mark.card
def test_control_on_the_card_at_the_cell_size(card):
    from gpubench import control
    for w in ("wifi648-mc", "dvbs2-64800-host"):
        r = control.readings(registry.workload(w), 31, 1000, program=True)
        limit = registry.workload(w).traffic["limits"]["counter_gap"]
        assert r["program_gap"] <= limit < r["control_gap"]
