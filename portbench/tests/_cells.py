"""Cells of BENCHMARK.json cut to a size a CPU test run holds."""

from portbench import harness

CELLS = ("without_spm_192.serve_f32", "without_spm_192.estimate_f32",
         "res_192.serve_f32")


def small(name, dtype=None, hw=64, streams=2, gop=3):
    cell = harness.load_cell(name)
    cell.traffic.update(height=hw, width=hw, streams=streams, gop=gop)
    if dtype is not None:
        cell.traffic["dtype"] = dtype
    return cell


def run_small(cell, seed=2147483900, fault=None, seconds=0.5):
    return harness.run(cell, seed, seconds, False, device="cpu",
                       log=lambda *a: None, fault=fault)
