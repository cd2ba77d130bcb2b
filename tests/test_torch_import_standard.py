"""The port's exact-table swap-in (`ldpc_tpu_torch/codes/imported.py` and
the CLI's `import-standard`) against the reference's: the eleven cases of
`tests/test_import_standard.py` on the port, each on a temporary registry
($LDPC_TPU_TABLES, which both packages read) and on the CPU, each with the
reference's verdict beside the port's (the same report, or the same
ValueError text); and the smoke decode's step held to the reference's QC
decoder (`ldpc_tpu/ops/decode_qc.make_decoder`, the decoder the reference's
smoke test runs) on the same int8 batch: hard bits and convergence flags
equal."""
import json

import numpy as np
import pytest
import torch

from ldpc_tpu.codes import imported as rimp
from ldpc_tpu.codes.ieee80211n import make_code as rmake_wifi
from ldpc_tpu_torch.codes import imported as imp
from ldpc_tpu_torch.codes.ieee80211n import is_standard_exact
from ldpc_tpu_torch.codes.ieee80211n import make_code as make_wifi


@pytest.fixture()
def registry(tmp_path, monkeypatch):
    reg = tmp_path / "tables"
    monkeypatch.setenv("LDPC_TPU_TABLES", str(reg))
    yield reg


def _wifi_like():
    # one of the three girth-repaired '_like' tables
    code = make_wifi(648, "3/4")
    assert not code.standard_exact
    return code


def _both_validate(base, Z, **kw):
    """The port's and the reference's validate_table on one candidate: the
    same report, or ValueErrors with the same text (returned)."""
    out = []
    for mod in (imp, rimp):
        try:
            out.append(("ok", mod.validate_table("ieee80211n", Z, base,
                                                 **kw)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0] == out[1]
    return out[0]


def _four_cycle(c):
    b = c.base.copy()
    # close a 4-cycle: s[r1,j1] - s[r1,j2] + s[r2,j2] - s[r2,j1] = 0
    rs = np.argwhere(b >= 0)
    for (r1, j1) in rs:
        for (r2, j2) in rs:
            if (r2 > r1 and j2 != j1 and b[r1, j2] >= 0
                    and b[r2, j1] >= 0 and b[r2, j2] >= 0):
                b[r2, j2] = (b[r1, j2] - b[r1, j1] + b[r2, j1]) % c.Z
                return b
    raise AssertionError("no 4-cycle closed")


def _moved_edge(c):
    b = c.base.copy()
    on = tuple(np.argwhere(b >= 0)[0])
    off = tuple(np.argwhere(b < 0)[0])
    b[off] = b[on]
    b[on] = -1
    return b


class TestValidate:
    def test_roundtrip_own_table_passes(self, registry):
        c = _wifi_like()
        verdict, rep = _both_validate(c.base, c.Z, n=648, rate="3/4")
        assert verdict == "ok"
        assert rep["rank"] == c.m and rep["girth"] >= 6

    def test_validation_reference_not_launderable(self, registry):
        c = _wifi_like()
        imp.store("ieee80211n", "n648_r34", c.Z, c.base)
        verdict, msg = _both_validate(_moved_edge(c), c.Z, n=648,
                                      rate="3/4")
        assert verdict == "ValueError" and "profile" in msg

    def test_four_cycle_rejected(self, registry):
        c = _wifi_like()
        verdict, msg = _both_validate(_four_cycle(c), c.Z, n=648,
                                      rate="3/4")
        assert verdict == "ValueError" and "girth" in msg

    def test_wrong_shape_rejected(self, registry):
        c = _wifi_like()
        verdict, msg = _both_validate(c.base[:, :-1], c.Z, n=648,
                                      rate="3/4")
        assert verdict == "ValueError"
        assert "shape" in msg or "profile" in msg

    def test_profile_change_rejected(self, registry):
        c = _wifi_like()
        verdict, msg = _both_validate(_moved_edge(c), c.Z, n=648,
                                      rate="3/4")
        assert verdict == "ValueError" and "profile" in msg

    def test_shift_range_rejected(self, registry):
        c = _wifi_like()
        b = c.base.copy()
        b[np.argwhere(b >= 0)[0][0], np.argwhere(b >= 0)[0][1]] = c.Z
        verdict, msg = _both_validate(b, c.Z, n=648, rate="3/4")
        assert verdict == "ValueError" and "range" in msg


class TestRegistrySwap:
    def test_store_flips_builder_to_exact(self, registry):
        c = _wifi_like()
        p = imp.store("ieee80211n", "n648_r34", c.Z, c.base)
        # the reference's builder reads the port's file: one registry
        assert rmake_wifi(648, "3/4").standard_exact
        rimp.remove("ieee80211n", "n648_r34")
        assert rimp.store("ieee80211n", "n648_r34", c.Z, c.base) == p
        c2 = make_wifi(648, "3/4")
        assert c2.standard_exact and c2.name.endswith("_std")
        assert c2.name == rmake_wifi(648, "3/4").name
        assert is_standard_exact(648, "3/4")
        assert all(np.array_equal(a, b)
                   for a, b in zip(c.cn_adj, c2.cn_adj))
        assert imp.remove("ieee80211n", "n648_r34")
        c3 = make_wifi(648, "3/4")
        assert not c3.standard_exact
        assert not is_standard_exact(648, "3/4")
        assert not imp.remove("ieee80211n", "n648_r34")

    def test_nr_full_graph_swap(self, registry):
        from ldpc_tpu_torch.codes.nr_bg import full_graph
        from ldpc_tpu_torch.codes.nr_bg import make_code as make_nr
        g = full_graph(2, 52)
        imp.store("5gnr", "bg2_z52", 52, g.base)
        g2 = full_graph(2, 52)
        assert g2.standard_exact and g2.name.endswith("_std")
        # the seed is ignored while the table is stored (the reference's
        # codes/nr_bg.py:78 does the same)
        assert full_graph(2, 52, seed=7).name == g2.name
        code = make_nr(2, 52, rate="1/3")
        assert code.standard_exact and code.name.endswith("_std")
        imp.remove("5gnr", "bg2_z52")
        assert not full_graph(2, 52).standard_exact

    def test_smoke_decode_catches_broken_table(self, registry):
        c = _wifi_like()
        rep = imp.smoke_decode(c.Z, c.base, frames=64, device="cpu")
        assert rep["ber"] <= rep["uncoded_ber"] / 10.0
        assert set(rep) == {"frames", "ebn0_db", "ber", "uncoded_ber",
                            "conv_rate"}
        # the reference's operating point and uncoded BER
        assert rep["ebn0_db"] == round(
            10 * np.log10((2.0 ** (2 * c.k / c.n) - 1) / (2 * c.k / c.n))
            + 3.5, 2)
        # a table that does not decode fails with the reference's text:
        # all shifts 0 keep the profile but wreck the code
        with pytest.raises(ValueError, match="smoke decode failed"):
            imp.smoke_decode(c.Z, np.where(c.base >= 0, 0, -1), frames=16,
                             device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="does not fall back"):
                imp.smoke_decode(c.Z, c.base, frames=16)


class TestCLI:
    def test_import_and_remove(self, registry, tmp_path, capsys):
        from ldpc_tpu.cli import main as rmain
        from ldpc_tpu_torch.cli import main
        c = _wifi_like()
        p = tmp_path / "tab.json"
        json.dump({"Z": c.Z, "base": c.base.tolist()}, open(p, "w"))
        argv = ["import-standard", "--family", "ieee80211n", "--n", "648",
                "--rate", "3/4", "--file", str(p), "--no-smoke"]
        outs = []
        for m in (rmain, main):
            assert m(argv) == 0
            outs.append(json.loads(capsys.readouterr().out))
            assert make_wifi(648, "3/4").standard_exact
            assert m(argv[:7] + ["--remove"]) == 0
            assert json.loads(capsys.readouterr().out)["removed"] is True
            assert not make_wifi(648, "3/4").standard_exact
        assert outs[0] == outs[1]
        assert main(argv[:7] + ["--remove"]) == 1

    def test_smoke_decode_runs_where_asked(self, registry, tmp_path):
        """`--device cuda` (the default) smoke-decodes on the card, and
        raises without one: no fallback to the CPU, and nothing stored."""
        from ldpc_tpu_torch.cli import main
        c = _wifi_like()
        p = tmp_path / "tab.json"
        json.dump({"Z": c.Z, "base": c.base.tolist()}, open(p, "w"))
        argv = ["import-standard", "--family", "ieee80211n", "--n", "648",
                "--rate", "3/4", "--file", str(p)]
        if torch.cuda.is_available():
            assert main(argv) == 0
        else:
            with pytest.raises(RuntimeError, match="does not fall back"):
                main(argv)
            assert not make_wifi(648, "3/4").standard_exact
        assert main(argv + ["--device", "cpu"]) == 0
        assert make_wifi(648, "3/4").standard_exact

    def test_text_grid_format(self, registry, tmp_path):
        c = _wifi_like()
        p = tmp_path / "tab.txt"
        with open(p, "w") as f:
            for row in c.base:
                f.write(" ".join("-" if s < 0 else str(int(s))
                                 for s in row) + "\n")
        Z, base = imp.parse_table_file(str(p))
        assert Z is None and np.array_equal(base, c.base)
        Zr, base_r = rimp.parse_table_file(str(p))
        assert Zr is None and np.array_equal(base, base_r)


def test_smoke_decode_step_equals_the_reference_qc_decoder():
    """The smoke test's decode step (`smoke_decode_batch`: select_decoder,
    auto, batch first) on an int8 batch drawn with numpy, at the smoke
    test's operating point: hard bits and convergence flags equal the
    reference's `ops/decode_qc.make_decoder` with the smoke test's
    configuration (OMS beta 1, layered, 20 iterations, early termination)
    on the same batch."""
    import jax.numpy as jnp

    from ldpc_tpu.config import DecoderConfig as RDec
    from ldpc_tpu.config import QuantConfig as RQuant
    from ldpc_tpu.ops.decode_qc import make_decoder as rmake_qc
    from ldpc_tpu_torch.codes import from_reference
    from ldpc_tpu_torch.codes.code import expand_qc
    c = _wifi_like()
    code = expand_qc(c.base, c.Z, name="import_smoke")
    ebn0, sigma = imp.smoke_operating_point(code.k / code.n)
    rng = np.random.default_rng(14)
    # a hard operating point too (1.5 dB below it), so that some lanes fail
    llr = np.concatenate([
        2 * (1 + s * rng.standard_normal((24, code.n))) / s ** 2
        for s in (sigma, sigma * 10 ** (1.5 / 20))])
    q = np.clip(np.round(llr * 4), -127, 127).astype(np.int8)
    hard, conv, label = imp.smoke_decode_batch(
        from_reference(code, "cpu"), torch.as_tensor(q))
    assert label == "torch-plain-layered-bf"
    assert imp.SMOKE_DECODER.early_term and imp.SMOKE_QUANT.beta_lsb == 1
    from ldpc_tpu.codes.code import expand_qc as rexpand
    ref = rmake_qc(rexpand(c.base, c.Z, name="import_smoke"),
                   RDec(algorithm="offset-min-sum", max_iter=20,
                        schedule="layered"),
                   RQuant(bits=8, scale=4.0, beta_lsb=1))
    r_hard, _, r_conv = ref(jnp.asarray(q))
    np.testing.assert_array_equal(hard.numpy(), np.asarray(r_hard))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(r_conv))
    assert 0 < int(conv.sum()) < len(q)
