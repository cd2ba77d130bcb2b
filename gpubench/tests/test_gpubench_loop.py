"""The window runs the program's own `Sweep.run`: the stamps wrap the step
and the per-batch save on the instance, and each wrapper still calls what
it wraps, so a cost added to either shows in the window."""
from gpubench import registry
from gpubench.run import Stamps, sim_config


def test_stamps_keep_the_sweeps_own_step_and_save():
    from ldpc_tpu_torch.sim.sweep import Sweep
    wl = registry.workload("wifi648-host")
    sweep = Sweep(sim_config(wl.config, wl.traffic, 4000000011),
                  device="cpu", batch=64, lookahead=2)
    steps, saved = [], []
    step = sweep.run_batch

    def counted(rng, sigma):
        steps.append(1)
        return step(rng, sigma)

    sweep._save = lambda points, meta: saved.append(points[0].batches)
    loop = Stamps(sweep, counted)
    batches, dispatch, t0, t1 = loop.run(float(wl.traffic["ebn0_db"]), 5)
    assert len(steps) == 5 and len(dispatch) == 5
    assert saved == [1, 2, 3, 4, 5]
    assert [b.index for b in batches] == list(range(5))
    assert all(t0 <= b.issued <= b.done <= t1 for b in batches)
    assert sum(b.counters[0] for b in batches) == 5 * 64
