"""Cells, configurations and metrics are found by name: one added as new
files and entries is run with no edit to a file that is there."""
import json
import shutil

from gpubench import registry

ROOT = registry.ROOT


def copy_bench(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_every_workload_resolves():
    bench = registry.load_benchmark()
    for w in bench["workloads"]:
        wl = registry.workload(w["name"])
        assert wl.config["name"] == w["config"]
        assert {"rng", "ebn0_db", "lookahead", "limits"} <= set(wl.traffic)
        for m in wl.metrics:
            assert callable(registry.metric_reader(m.name).read)
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        e2e = [m.name for m in wl.reported(trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert wl.reported(trace=True)


def test_added_cell_config_and_metric_are_found(tmp_path):
    root = copy_bench(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "gpubench/configs/"
                      "ieee80211n-648-r12-minsum.json").read_text())
    cfg["name"] = "wifi648-copy"
    (root / "gpubench/configs/wifi648-copy.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "gpubench/cells/wifi648-host.json"
                          ).read_text())
    traffic["ebn0_db"] = 2.5
    (root / "gpubench/cells/wifi648-host-25db.json").write_text(
        json.dumps(traffic))
    (root / "gpubench/metrics/frames_per_batch.py").write_text(
        "def read(run):\n    return float(run.k)\n")
    bench["configs"].append({"name": "wifi648-copy", "source": "x",
                             "file": "gpubench/configs/wifi648-copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "wifi648-host-25db",
                               "config": "wifi648-copy",
                               "traffic": "wifi648-host-25db", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "frames_per_batch", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "info_Mbps",
                               "workloads": ["wifi648-host-25db"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = registry.workload("wifi648-host-25db", root)
    assert wl.traffic["ebn0_db"] == 2.5
    assert wl.config["name"] == "wifi648-copy"
    names = [m.name for m in wl.reported(trace=True)]
    assert "frames_per_batch" in names
    reader = registry.metric_reader("frames_per_batch", root)

    class R:
        k = 7
    assert reader.read(R()) == 7.0
    # the workloads that were there do not report the new metric
    old = registry.workload("wifi648-host", root)
    assert "frames_per_batch" not in [m.name for m in old.metrics]


def test_decoder_kernels_are_read_from_the_sources():
    names = registry.decoder_kernels()
    for k in ("flood_packed_kernel", "layered_packed_kernel",
              "stream_pipelined_kernel", "resident_packed_kernel",
              "minsum_flood_kernel", "minsum_stream_kernel"):
        assert k in names
    assert "__launch_bounds__" not in names


def test_decoder_kernel_added_in_a_copy_counts(tmp_path):
    csrc = tmp_path / "ldpc_tpu_torch" / "kernels" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "new.cu").write_text(
        "template <int D>\n__global__ void __launch_bounds__(f(D), 1)\n"
        "new_decode_kernel(Params p) {}\n__global__ void other(int x) {}\n")
    assert registry.decoder_kernels(tmp_path) == {"new_decode_kernel",
                                                  "other"}


def test_each_metric_moves_what_its_cells_report():
    bench = registry.load_benchmark()
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]], (m["name"], w)


def test_host_paced_metrics_read_as_their_base():
    from gpubench.run import Batch, Run
    run = Run(setup_s=1.0, window_s=2.0,
              batches=[Batch(i, 0.01 * i, 0.01 * i + 0.05,
                             [1024, 3, 1, 20480, 1023]) for i in range(40)],
              dispatch_s=[0.02] * 40, n=64800, k=32400, edges=227160)
    bench = registry.load_benchmark()
    names = [m["name"] for kind in ("end_to_end", "per_layer")
             for m in bench[kind] if m["name"].endswith(".host_paced")]
    assert names
    for name in names:
        base = name[:-len(".host_paced")]
        assert (registry.metric_reader(name).read(run)
                == registry.metric_reader(base).read(run))
