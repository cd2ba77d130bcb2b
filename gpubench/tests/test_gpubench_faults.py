"""A whole run on the CPU, past the look for a card (the program's plain
versions at a batch the CPU holds), with the timed path sound and then
broken underneath: `correct` has to come out true, then false for each
fault these cells can have. They run no training step and use one card, so
the faults are an answer altered where it is produced and half of the batch
left out, its counters doubled from the other half."""
import pytest
import torch

from gpubench import registry
from gpubench.run import run_workload

CELLS = [("wifi648-mc", 64, 2.0), ("wifi648-host", 64, 2.0),
         ("dvbs2-64800-host", 2, 6.0), ("dvbs2-64800-allzeros", 2, 6.0)]


def altered(step, sweep):
    """One more information-bit error in every batch's counters."""
    def run_batch(rng, sigma):
        out = step(rng, sigma).clone()
        out[1] += 1
        return out
    return run_batch


def half_batch(step, sweep):
    """The counters of half the batch, doubled."""
    from ldpc_tpu_torch.sim.pipeline import make_run_batch
    half = make_run_batch(sweep.ct, sweep.cfg, batch=sweep.batch // 2)

    def run_batch(rng, sigma):
        return half(rng, sigma) * 2
    return run_batch


def run(workload, batch, seconds, wrap=None):
    return run_workload(registry.workload(workload), 4000000007, seconds,
                        traced=False, device="cpu", batch=batch, wrap=wrap)


@pytest.mark.parametrize("workload,batch,seconds", CELLS)
def test_sound_run_is_correct(workload, batch, seconds):
    res = run(workload, batch, seconds)
    assert res["attempted"] >= 1
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [altered, half_batch],
                         ids=["answer-altered", "half-batch"])
@pytest.mark.parametrize("workload,batch,seconds", CELLS)
def test_broken_step_is_not_correct(workload, batch, seconds, fault):
    res = run(workload, batch, seconds, wrap=fault)
    assert res["attempted"] >= 1
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1
