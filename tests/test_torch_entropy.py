"""The port's entropy models, CDF tables, rANS coder and sparse transport
against the JAX package, on the CPU. Tables, streams and packed planes must
be identical byte for byte."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.coders import get_coder as jax_get_coder
from spatiotemporalentropymodel_tpu.entropy import base as jbase
from spatiotemporalentropymodel_tpu.entropy import bottleneck as jbn
from spatiotemporalentropymodel_tpu.entropy import gaussian as jg
from spatiotemporalentropymodel_tpu.entropy import transport as jtp
from spatiotemporalentropymodel_tpu.entropy.cdf import (
    build_table_rows as jax_build_table_rows,
)
from spatiotemporalentropymodel_tpu_torch.coders import get_coder
from spatiotemporalentropymodel_tpu_torch.convert import load_jax_params
from spatiotemporalentropymodel_tpu_torch.entropy import base as tbase
from spatiotemporalentropymodel_tpu_torch.entropy import bottleneck as tbn
from spatiotemporalentropymodel_tpu_torch.entropy import gaussian as tg
from spatiotemporalentropymodel_tpu_torch.entropy import transport as ttp
from spatiotemporalentropymodel_tpu_torch.entropy.cdf import (
    build_table_rows,
    pmf_to_quantized_cdf,
)

from torch_port_util import to_nchw, to_nhwc


def _tables_equal(a, b):
    for field in ("cdf", "cdf_length", "offset", "scale_table", "medians"):
        va, vb = getattr(a, field), getattr(b, field)
        assert (va is None) == (vb is None), field
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=field)


@pytest.fixture(scope="module")
def eb_pair():
    """A JAX EntropyBottleneck with perturbed parameters and its port."""
    c = 12
    jeb = jbn.EntropyBottleneck(c)
    params = jeb.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, c)))
    rng = np.random.default_rng(0)
    tree = {k: (np.asarray(v) + 0.1 * rng.standard_normal(np.shape(v)))
            .astype(np.float32) for k, v in params["params"].items()}
    tree["quantiles"] = jbn.solve_quantiles(tree).astype(np.float32)
    teb = tbn.EntropyBottleneck(c)
    load_jax_params(teb, tree)
    return jeb, {"params": tree}, teb


def test_gaussian_tables_identical():
    _tables_equal(tg.update_tables(), jg.update_tables())


def test_bottleneck_tables_and_quantiles_identical(eb_pair):
    _, params, teb = eb_pair
    np.testing.assert_array_equal(tbn.solve_quantiles(teb.numpy_params()),
                                  jbn.solve_quantiles(params["params"]))
    _tables_equal(tbn.update_tables(teb.numpy_params()),
                  jbn.update_tables(params["params"]))


def test_bottleneck_forward_matches(eb_pair):
    jeb, params, teb = eb_pair
    x = (3 * np.random.default_rng(1).standard_normal((2, 4, 5, 12))).astype(
        np.float32)
    ref_hat, ref_lk = jeb.apply(params, jnp.asarray(x))
    with torch.no_grad():
        out_hat, out_lk = teb(to_nchw(x))
    np.testing.assert_allclose(to_nhwc(out_hat), np.asarray(ref_hat),
                               atol=1e-5)
    np.testing.assert_allclose(to_nhwc(out_lk), np.asarray(ref_lk),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(teb.aux_loss().detach()),
                               float(jeb.apply(params, method="aux_loss")),
                               rtol=1e-4, atol=1e-4)


def test_gaussian_likelihood_and_indexes_match():
    rng = np.random.default_rng(2)
    v = (3 * rng.standard_normal(4096)).astype(np.float32)
    s = np.exp(5 * rng.random(4096) - 3).astype(np.float32)
    t32 = tg.get_scale_table().astype(np.float32)
    s[:64] = t32  # exactly on table entries
    np.testing.assert_allclose(
        tg.likelihood(torch.from_numpy(v), torch.from_numpy(s)).numpy(),
        np.asarray(jg.likelihood(jnp.asarray(v), jnp.asarray(s))),
        rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(
        tg.build_indexes(torch.from_numpy(s), tg.get_scale_table()).numpy(),
        np.asarray(jg.build_indexes(jnp.asarray(s), jg.get_scale_table())))
    gc = tg.GaussianConditional()
    out, lk = gc(torch.from_numpy(v), torch.from_numpy(s), torch.zeros(4096))
    ref_out, ref_lk = jg.GaussianConditional().apply(
        {}, jnp.asarray(v), jnp.asarray(s), jnp.zeros(4096))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    np.testing.assert_allclose(lk.numpy(), np.asarray(ref_lk), rtol=1e-5,
                               atol=1e-7)


def test_cdf_quantizer_native_matches_spec_and_jax():
    rng = np.random.default_rng(3)
    pmfs, lengths = [], []
    for _ in range(9):
        n = int(rng.integers(2, 40))
        p = rng.random(n) ** 4  # skewed: exercises frequency stealing
        pmfs.append(np.pad(p / p.sum() * (1 - 1e-4), (0, 40 - n)))
        lengths.append(n)
    pmfs = np.array(pmfs)
    tails = np.full(9, 1e-4)
    ours = build_table_rows(pmfs, tails, lengths, 40)
    np.testing.assert_array_equal(
        ours, jax_build_table_rows(pmfs, tails, lengths, 40))
    for i, n in enumerate(lengths):
        spec = pmf_to_quantized_cdf(np.append(pmfs[i, :n], tails[i]))
        np.testing.assert_array_equal(ours[i, :n + 2], spec)


class TestGoldenBitstream:
    """tests/test_coders.py's frozen wire-format fixtures, through the port's
    own coder."""

    PMF = np.array([0.2, 0.5, 0.2, 0.1 - 1e-4, 1e-4])
    GOLDEN_CDF = [0, 13107, 45875, 58982, 65529, 65536]
    SYMBOLS = np.array([0, -2, 1, 1, 0, 2, -1, 1, 5, -7, 0, 1], np.int32)
    GOLDEN_STREAM = bytes.fromhex("e7bd573085770400902fdbe7a6ff0f8f")

    def _tables(self):
        return (np.asarray([self.GOLDEN_CDF], np.int32),
                np.array([6], np.int32), np.array([-2], np.int32))

    def test_cdf_quantizer_frozen(self):
        np.testing.assert_array_equal(pmf_to_quantized_cdf(self.PMF),
                                      self.GOLDEN_CDF)
        np.testing.assert_array_equal(
            build_table_rows(self.PMF[None, :-1], [1e-4], [4], 4)[0],
            self.GOLDEN_CDF)

    def test_stream_bytes_frozen(self):
        cdfs, lengths, offsets = self._tables()
        idx = np.zeros(len(self.SYMBOLS), np.int32)
        s = get_coder().encode_with_indexes(self.SYMBOLS, idx, cdfs,
                                            lengths, offsets)
        assert s == self.GOLDEN_STREAM

    @pytest.mark.parametrize("use_lut", [False, True])
    def test_golden_decodes(self, use_lut):
        cdfs, lengths, offsets = self._tables()
        coder = get_coder()
        lut = coder.build_lut(cdfs, lengths) if use_lut else None
        out = coder.decode_with_indexes(
            self.GOLDEN_STREAM, np.zeros(len(self.SYMBOLS), np.int32), cdfs,
            lengths, offsets, lut)
        np.testing.assert_array_equal(out, self.SYMBOLS)


@pytest.fixture(scope="module")
def gtables():
    return tg.update_tables()


def _grouped_payload(tables, b=2, n=4096, seed=4):
    """Grouped-by-row symbols with escapes, and their per-row counts."""
    rng = np.random.default_rng(seed)
    levels = tables.cdf.shape[0]
    rows = np.sort(rng.integers(0, 24, (b, n)), axis=1)
    counts = np.stack([np.bincount(r, minlength=levels) for r in rows])
    sym = np.round(rng.standard_normal((b, n)) * (rows + 1) * 0.3)
    sym[:, ::97] += 300  # escapes
    sym[rng.random((b, n)) < 0.6] = 0
    return sym.astype(np.int32), counts.astype(np.int32)


def test_grouped_streams_identical_to_jax_and_round_trip(gtables):
    sym, counts = _grouped_payload(gtables)
    ours = ttp.encode_grouped(sym, counts, gtables)
    assert ours == jtp.encode_grouped(sym, counts, gtables,
                                      jax_get_coder("rans"))
    np.testing.assert_array_equal(ttp.decode_grouped(ours, counts, gtables),
                                  sym)
    cap = ttp.sparse_capacity(sym.shape[1])
    sym8 = np.clip(sym, -127, 127)
    sym8[np.random.default_rng(8).random(sym8.shape) < 0.8] = 0  # < n/8 nz
    s8 = ttp.encode_grouped(sym8, counts, gtables)
    maskbits, values = ttp.decode_grouped_packed(s8, counts, cap, gtables)
    ref_bits, ref_vals = ttp.pack_decode_payload(sym8, cap)
    np.testing.assert_array_equal(maskbits, ref_bits)
    np.testing.assert_array_equal(values, ref_vals)


def test_indexed_streams_identical_to_jax(gtables):
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 64, (2, 6, 5, 8)).astype(np.int32)
    sym = np.round(rng.standard_normal(idx.shape) * 2).astype(np.int32)
    ours = tbase.compress(sym, idx, gtables)
    assert ours == jbase.compress(sym, idx, gtables, jax_get_coder("rans"))
    np.testing.assert_array_equal(tbase.decompress(ours, idx, gtables), sym)
    np.testing.assert_array_equal(
        tbase.safe_symbols(np.array([np.nan, 3e12, -3e12, 2.5])),
        jbase.safe_symbols(np.array([np.nan, 3e12, -3e12, 2.5])))
    np.testing.assert_array_equal(tbase.bottleneck_indexes((2, 3, 4, 5), 5),
                                  jbase.bottleneck_indexes((2, 3, 4, 5), 5))


def test_unpack_encode_matches_jax(gtables):
    """A transport buffer in the device layout unpacks to the same planes;
    and the overflow flag is honoured."""
    rng = np.random.default_rng(6)
    b, n, zn, levels = 2, 1024, 16, 64
    layout = ttp.SparseLayout(b=b, n=n, zn=zn, levels=levels)
    y = np.where(rng.random((b, n)) < 0.1,
                 rng.integers(-5, 6, (b, n)), 0).astype(np.int8)
    mask = y != 0
    cap = layout.cap
    values = np.zeros((b, cap), np.int8)
    for i in range(b):
        values[i, :mask[i].sum()] = y[i][mask[i]]
    counts = np.zeros((b, levels), np.int32)
    counts[:, 0] = n
    meta = np.stack([mask.sum(1), np.zeros(b)], -1).astype(np.int32)
    buf = np.concatenate([
        np.packbits(mask, axis=-1, bitorder="little").reshape(-1),
        values.view(np.uint8).reshape(-1), counts.view(np.uint8).reshape(-1),
        rng.integers(-3, 4, b * zn).astype(np.int8).view(np.uint8),
        meta.view(np.uint8).reshape(-1)])
    ours = ttp.unpack_encode(buf, layout)
    ref = jtp.unpack_encode(buf, jtp.SparseLayout(b=b, n=n, zn=zn,
                                                  levels=levels))
    assert not ours.overflow and not ref.overflow
    np.testing.assert_array_equal(ours.y_sorted, y.astype(np.int32))
    for f in ("y_sorted", "counts", "z_sym"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    meta[:, 1] = 1
    buf[-meta.nbytes:] = meta.view(np.uint8).reshape(-1)
    assert ttp.unpack_encode(buf, layout).overflow


def test_pack_counts_identical_and_round_trips():
    rng = np.random.default_rng(7)
    counts = np.zeros((4, 64), np.int64)
    for i in range(4):
        rows = rng.choice(64, size=rng.integers(0, 30), replace=False)
        counts[i, rows] = rng.integers(1, 2**22, rows.size)
    blob = ttp.pack_counts(counts)
    assert blob == jtp.pack_counts(counts)
    np.testing.assert_array_equal(ttp.unpack_counts(io.BytesIO(blob)), counts)
