"""The port's CLI commands beside `sweep` and `floor` (`config`, `presets`,
`codes`, `construct`, `analyze`, `report`; `import-standard` is in
tests/test_torch_import_standard.py) against the reference's CLI, in
process: the same argv through both `main`s, stdout equal (JSON parsed,
text lines as they are), the notes on stderr equal, the same exit codes
and SystemExit texts, and the files they write equal. Every analysis runs
at a small `--iters` and a loose `--tol`."""
import json
import os

import pytest

from ldpc_tpu import cli as rcli
from ldpc_tpu.config import PRESETS
from ldpc_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = ["--iters", "40", "--tol", "1e-2"]


def run_both(capsys, argv):
    """(port, reference) as (rc, stdout, stderr) on one argv; a SystemExit
    counts as its text."""
    out = []
    for main in (cli.main, rcli.main):
        try:
            rc = main(list(argv))
        except SystemExit as e:
            rc = f"SystemExit: {e}"
        o, err = capsys.readouterr()
        # the notes a command prints, not the logging lines
        notes = [ln for ln in err.splitlines() if ln.startswith("#")]
        out.append((rc, o, notes))
    return out


def json_lines(text):
    """One indented JSON document, or one JSON object a line."""
    if text.startswith("{\n"):
        return [json.loads(text)]
    return [json.loads(ln) for ln in text.splitlines() if ln.strip()]


def assert_same(capsys, argv, as_json=True):
    port, ref = run_both(capsys, argv)
    assert port[0] == ref[0]
    assert port[2] == ref[2]
    if as_json:
        assert json_lines(port[1]) == json_lines(ref[1])
    else:
        assert port[1].splitlines() == ref[1].splitlines()
    return port


@pytest.mark.parametrize("flags", [
    *(["--preset", p] for p in sorted(PRESETS)),
    ["--family", "toy", "--Z", "8", "--algorithm", "min-star",
     "--beta-lsb", "0", "--modulation", "16qam", "--rng", "device"],
    ["--preset", "wifi-648-r12-minsum", "--auto-two-phase", "--bits", "6"],
], ids=lambda f: "_".join(f).replace("--", ""))
def test_config_equals_the_reference(capsys, flags):
    """`config` prints the resolved config as the reference does, a
    preset's mesh included (it builds none)."""
    (rc, out, _), = [assert_same(capsys, ["config"] + flags)]
    assert rc == 0


def test_presets_and_codes_equal_the_reference(capsys, tmp_path):
    assert_same(capsys, ["presets"], as_json=False)
    rc, out, _ = assert_same(capsys, ["codes"], as_json=False)
    assert rc == 0 and len(out.splitlines()) == 12
    dirs = [tmp_path / "own", tmp_path / "ref"]
    outs = []
    for main, d in zip((cli.main, rcli.main), dirs):
        assert main(["codes", "--export-alist", str(d)]) == 0
        outs.append(capsys.readouterr().out.replace(str(d), "DIR"))
    assert outs[0] == outs[1]
    names = sorted(os.listdir(dirs[0]))
    assert len(names) == 12 and names == sorted(os.listdir(dirs[1]))
    for n in names:
        assert (dirs[0] / n).read_text() == (dirs[1] / n).read_text()


@pytest.mark.parametrize("flags", [
    ["--preset", "wifi-648-r12-minsum"],
    ["--family", "5gnr", "--base-graph", "2", "--Z", "16"],
    ["--family", "qcpeg", "--n", "216", "--Z", "9", "--rate", "1/2",
     "--profile", "2:0.5,3:0.5", "--code-seed", "2"],
], ids=["wifi648", "nr_bg2_z16", "qcpeg"])
@pytest.mark.parametrize("census", [None, "5,3,3"])
def test_construct_equals_the_reference(capsys, tmp_path, flags, census):
    """`construct`: girth, rank, the absorbing-set census (the port's host C
    enumerator) and the exported alist equal the reference's."""
    argv = ["construct"] + flags + (["--census", census] if census else [])
    port, ref = [], []
    for main, got, tag in ((cli.main, port, "own"), (rcli.main, ref, "ref")):
        path = str(tmp_path / f"{tag}.alist")
        assert main(argv + ["--export-alist", path]) == 0
        d = json.loads(capsys.readouterr().out)
        assert d.pop("alist") == path
        got += [d, open(path).read()]
    assert port == ref
    assert "girth" in port[0] and port[0]["full_rank"]
    assert ("absorbing_census" in port[0]) == bool(census)


WIFI = ["--family", "ieee80211n", "--n", "648", "--rate", "1/2"]


@pytest.mark.parametrize("argv", [
    # AWGN, the preset's min-sum and OMS, with the notes on ignored flags
    ["--preset", "wifi-648-r12-minsum", "--bracket", "0.6", "1.3", *FAST],
    WIFI + ["--beta-lsb", "1", "--max-iter", "5", "--schedule", "layered",
            "--bracket", "0.6", "1.3", *FAST],
    # BSC
    WIFI + ["--channel", "bsc", *FAST],
    # min*
    WIFI + ["--algorithm", "min-star", "--beta-lsb", "0", "--bracket", "0.6",
            "1.3", *FAST],
    # degree-1 variables: the note, then --min-decision-degree 2
    ["--family", "5gnr", "--base-graph", "2", "--Z", "16", "--beta-lsb", "2",
     "--target", "1e-4", "--bracket", "0.5", "1.6", *FAST],
    ["--family", "5gnr", "--base-graph", "2", "--Z", "16", "--beta-lsb", "2",
     "--target", "1e-4", "--min-decision-degree", "2", "--bracket", "0.5",
     "1.6", *FAST],
    # --proto on a rate-matched toy code (punctured and shortened columns)
    ["--family", "toy", "--Z", "8", "--puncture-frac", "0.3334",
     "--shorten-bits", "8", "--proto", "--iters", "12", "--tol", "2e-2",
     "--target", "1e-3", "--bracket", "0.3", "1.2"],
    # --scan-scale, min-sum and min*
    WIFI + ["--scan-scale", "3:6:2", "--beta-lsb", "2", "--bracket", "0.6",
            "1.3", *FAST],
    WIFI + ["--scan-scale", "3:6:2", "--algorithm", "min-star", "--beta-lsb",
            "0", "--bracket", "0.6", "1.3", *FAST],
    # refusals: the algorithm gate, BSC with --pexit, a bracket with no
    # threshold at its easy end
    WIFI + ["--algorithm", "sum-product"],
    WIFI + ["--pexit", "--channel", "bsc"],
    WIFI + ["--bracket", "1.4", "1.5", "--iters", "5"],
], ids=["awgn_minsum", "awgn_oms_notes", "bsc", "minstar", "nr_deg1_note",
        "nr_min_decision_degree", "proto", "scan_scale", "scan_scale_minstar",
        "refuse_algorithm", "refuse_pexit_bsc", "refuse_bracket"])
def test_analyze_equals_the_reference(capsys, argv):
    rc, out, _ = assert_same(capsys, ["analyze"] + argv)
    if rc == 0:
        assert "sigma_star" in out or "p_star" in out or "best_scale" in out


def test_analyze_pexit_and_exit_chart_equal_the_reference(capsys, tmp_path):
    """`--pexit` dispatches before the algorithm gate, notes the flags it
    ignores, and writes the EXIT chart; JSON and chart equal the
    reference's."""
    charts = [str(tmp_path / "own.json"), str(tmp_path / "ref.json")]
    got = []
    for main, chart in zip((cli.main, rcli.main), charts):
        assert main(["analyze"] + WIFI + [
            "--pexit", "--exit-chart", chart, "--algorithm", "sum-product",
            "--bits", "6", "--tol", "1e-2"]) == 0
        out, err = capsys.readouterr()
        d = json.loads(out)
        assert d.pop("exit_chart") == chart
        notes = [ln for ln in err.splitlines() if ln.startswith("#")]
        got.append((d, notes, json.load(open(chart))))
    assert got[0] == got[1]
    d, notes, chart = got[0]
    assert d["method"].startswith("pexit") and len(chart["I_a"]) > 10
    assert notes == ["# note: ignored by --pexit (float sum-product "
                     "ensemble analysis): --algorithm --bits"]


def test_report_writes_a_png(capsys, tmp_path):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "w.png")
    assert cli.main(["report", os.path.join(ROOT, "results",
                                            "wifi648_minsum.json"),
                     "--out", out, "--metric", "fer"]) == 0
    assert capsys.readouterr().out == f"wrote {out}\n"
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_every_reference_command_is_registered():
    """The nine commands of the reference, and each one's flags (dest
    names) the reference's, plus `--device` where the port runs a decoder
    on the card."""
    def flags(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {name: {a.dest for a in p._actions}
                for name, p in sub.choices.items()}

    own, ref = flags(cli.build_parser()), flags(rcli.build_parser())
    assert sorted(own) == sorted(ref)
    for name in ("config", "construct", "analyze", "presets", "codes",
                 "report"):
        assert own[name] == ref[name], name
    assert own["import-standard"] == ref["import-standard"] | {"device"}
