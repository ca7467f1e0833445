"""The plain reference against the program's CPU path and its coder."""

import numpy as np
import pytest
import torch

from portbench import judge as J
from portbench import rans
from portbench import reference as R
from portbench import workload as WL
from portbench.tests._cells import CELLS, run_small, small


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_gaussian_tables_are_the_programs():
    from spatiotemporalentropymodel_tpu_torch.entropy import gaussian

    want = gaussian.update_tables()
    got = R.gaussian_tables()
    assert np.array_equal(got.cdf, want.cdf)
    assert np.array_equal(got.length, want.cdf_length)
    assert np.array_equal(got.offset, want.offset)


def test_bottleneck_tables_are_the_programs():
    from spatiotemporalentropymodel_tpu_torch.entropy import bottleneck

    gen = torch.Generator().manual_seed(3)
    S = WL.draw(WL.stem_specs("without_spm", 16, 8), gen, "cpu")
    WL.realistic_stem(S, np.random.default_rng(3))
    P = {k: v.numpy() for k, v in WL.eb_params(S).items()}
    want = bottleneck.update_tables(P)
    got = R.eb_tables(P)
    assert np.array_equal(got.cdf, want.cdf)
    assert np.array_equal(got.length, want.cdf_length)
    assert np.array_equal(got.offset, want.offset)
    assert np.array_equal(got.medians, want.medians)


def test_rans_bytes_are_the_programs():
    from spatiotemporalentropymodel_tpu_torch.coders import rans as native

    t = R.gaussian_tables()
    rng = np.random.default_rng(5)
    n = 20000
    rows = rng.integers(0, 64, n)
    sym = np.round(rng.normal(0, 1, n) * t.scales[rows]).astype(np.int64)
    sym[::997] = 40000  # escapes
    sym[3::991] = -50000
    want = native.encode_with_indexes(sym.astype(np.int32),
                                      rows.astype(np.int32), t.cdf, t.length,
                                      t.offset)
    got = rans.encode(sym, rows, t)
    assert got == want
    assert np.array_equal(rans.Decoder(got, t).decode(rows), sym)
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=64).astype(np.int32)
    want = native.encode_runs(sym[order].astype(np.int32), counts, t.cdf,
                              t.length, t.offset)
    assert rans.encode_runs(sym[order], counts, t) == want
    assert np.array_equal(rans.decode_runs(want, counts, t), sym[order])


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_cpu(name):
    """A whole run at 64×64 on the CPU (f32 for every cell: the CPU has no
    bf16 kernels to hold to the reference), judged as the card's runs are."""
    out = run_small(small(name, dtype="float32"))
    assert out["correct"], out["checks"]
    for name_, c in out["checks"].items():
        assert c["value"] <= 1e-5, (name_, c)


def test_judge_verdict_needs_every_limit():
    ok, worst = J.verdict([{"g_a": 1e-6}], {"g_a": 1e-4, "g_s": 1e-4})
    assert not ok and worst == {"g_a": 1e-6}
    assert J.verdict([{"g_a": 1e-6, "g_s": 0.0}], {"g_a": 1e-4,
                                                   "g_s": 1e-4})[0]
    assert not J.verdict([], {"g_a": 1.0})[0]
