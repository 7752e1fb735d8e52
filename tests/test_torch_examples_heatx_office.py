"""examples_torch/office_idf.py against heatx's command line, f64, CPU, at
its smoke size (48 h): the office IDF under ``testing.write_synthetic_epw``'s
weather (seed 0) through the example (``heatx_torch.cli.main``, the XLA
engine on the CPU) and through ``heatx.cli.main`` with the same
``simulate`` arguments and heatx's XLA engine: the summary JSON within 1e-9
relative (but the wall clock), the zone-temperature and demand CSVs to one
unit of their last printed digit (tests/test_torch_cli.py's criteria)."""

import json

import torch
from test_torch_cli import _csv_close, _json_close, _main
from torch_examples_ref import example

from heatx_torch import testing

torch.set_num_threads(1)


def test_office_idf_matches_heatx_cli(tmp_path, monkeypatch, capsys):
    epw = testing.write_synthetic_epw(tmp_path / "santiago.epw", seed=0)
    monkeypatch.setenv("HEATX_EXAMPLE_FAST", "1")
    od = example("office_idf")
    port = tmp_path / "port"
    port.mkdir()
    rc = od.main(["--platform", "cpu", "--epw", epw, "--out", str(port / "z.csv"), "--loads", str(port / "l.csv"),
                  "--f64", "--summary-json", str(port / "s.json")])
    assert rc == 0
    assert capsys.readouterr().out.rstrip().endswith("(xla engine)")

    ref = tmp_path / "heatx"
    ref.mkdir()
    rc, _, err = _main("heatx", ["simulate", od.IDF, epw, "--hours", "48", "-o", str(ref / "z.csv"), "--loads-csv",
                                 str(ref / "l.csv"), "--mode", "trbdf2", "--engine", "xla", "--platform", "cpu",
                                 "--f64", "--summary-json", str(ref / "s.json")])
    assert rc == 0, err
    with open(port / "s.json") as f, open(ref / "s.json") as g:
        got, want = json.load(f), json.load(g)
    assert got["engine"] == want["engine"] == "xla"
    _json_close(got, want, "summary")
    _csv_close(port / "z.csv", ref / "z.csv", 1e-4, "zone temperatures")
    _csv_close(port / "l.csv", ref / "l.csv", 0.1, "loads")
