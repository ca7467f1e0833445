"""BENCHMARK.json resolves, by name, to the files the harness reads; the
benchmark loads neither JAX nor the JAX package; without a card it exits
non-zero and prints no result."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench import judge as J
from portbench.tests._cells import CELLS

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_entries_resolve():
    b = _bench()
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = harness.load_cell(w["name"])
        assert set(cell.limits) <= set(
            harness.find("judges", cell.traffic["judge"]).NAMES)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert callable(harness.load_reader(m["name"]))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "spatiotemporalentropymodel_tpu_torch_x",
                        sys)
    assert "spatiotemporalentropymodel_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spatiotemporalentropymodel_tpu.sub",
                        sys)
    assert harness.forbidden_modules() == ["spatiotemporalentropymodel_tpu"]


def test_a_run_loads_no_jax():
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "from portbench.tests._cells import run_small, small\n"
        "from portbench import harness\n"
        "run_small(small('res_192.serve_f32'))\n"
        "run_small(small('without_spm_192.serve_f32'))\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "without_spm_192.serve_f32", "--seed", "2147483999", "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name):
    """The reference in the program's place one precision down (TF32 for
    the f32 cells, fp8 for the bf16 cells), at a small size, fails the
    cell's limits."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from portbench import calibrate
    from portbench.tests._cells import small

    cell = small(name, hw=128)
    readings = calibrate.control_readings(cell, 2147484100)
    ok, worst = J.verdict(readings, cell.limits)
    assert not ok, worst


def test_cells_are_made_of_files_found_by_name():
    """A cell's loop, judge and weights are modules named by its data
    files; a traffic key no part reads, a STEM its loop does not drive and a
    limit its judge does not read are refused."""
    cell = harness.load_cell("res_192.serve_f32")
    assert harness.find("loops", cell.traffic["loop"]).VARIANTS == ("res",)
    assert callable(harness.find("weights", cell.cfg["weights"]).make)
    for change, word in ((lambda c: c.traffic.update(sessions=4), "sessions"),
                         (lambda c: c.cfg.update(variant="without_spm"),
                          "does not drive"),
                         (lambda c: c.limits.update(flips=1e-3), "flips")):
        bad = harness.load_cell("res_192.serve_f32")
        change(bad)
        with pytest.raises(SystemExit, match=word):
            harness.check_cell(bad)


def test_split_metrics_read_their_base():
    assert harness.load_reader("step_mfu.host_paced") is \
        harness.load_reader("step_mfu")
