"""The port's "numpy" and "rans_interleaved" entropy coders against the JAX
package's, on the CPU.

Streams byte for byte the JAX coders' (random symbols over random tables,
with escapes into the bypass chunks), their round trips and cross-decodes;
the grouped transport (``encode_grouped``/``decode_grouped``) through
``rows_from_counts`` for the NumPy coder and through the 8-lane run
container for the interleaved one; ``available_entropy_coders``; the
capability flags every coder states; and the ``.bin`` CLI with ``--coder
numpy`` and ``--coder rans_interleaved`` writing the JAX CLI's files.
"""

import numpy as np
import pytest

import spatiotemporalentropymodel_tpu as stem_tpu
import spatiotemporalentropymodel_tpu_torch as stem_torch
from spatiotemporalentropymodel_tpu.coders import get_coder as jax_coder
from spatiotemporalentropymodel_tpu.entropy import gaussian as jax_gaussian
from spatiotemporalentropymodel_tpu.entropy import transport as jtransport
from spatiotemporalentropymodel_tpu.eval import codec as jax_codec
from spatiotemporalentropymodel_tpu_torch.coders import get_coder
from spatiotemporalentropymodel_tpu_torch.data.png import read_png, write_png
from spatiotemporalentropymodel_tpu_torch.entropy import gaussian as tg
from spatiotemporalentropymodel_tpu_torch.entropy import transport
from spatiotemporalentropymodel_tpu_torch.entropy.cdf import build_table_rows
from spatiotemporalentropymodel_tpu_torch.eval import codec
from spatiotemporalentropymodel_tpu_torch.eval.workload import (
    HERO_DIR,
    structured_frames,
)

CODERS = ("rans", "rans_interleaved", "numpy")


@pytest.fixture(scope="module")
def tables():
    """7 random rows of up to 20 symbols (JAX tests/test_coders.py's)."""
    rng = np.random.default_rng(42)
    max_len = 20
    pmfs, lengths = [], []
    for _ in range(7):
        n = int(rng.integers(2, max_len + 1))
        p = rng.random(n)
        pmfs.append(np.pad(p / p.sum() * (1 - 1e-4), (0, max_len - n)))
        lengths.append(n)
    cdf = build_table_rows(np.array(pmfs), np.full(7, 1e-4), lengths,
                           max_len)
    return (cdf, np.array(lengths, np.int32) + 2,
            rng.integers(-8, 8, 7).astype(np.int32))


def _payload(tables, n, seed):
    """Symbols within their rows, every 53rd and 71st escaping by up to
    500, the first two by ±10⁶ (many bypass nibbles)."""
    cdf, cdf_lengths, offsets = tables
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, cdf.shape[0], n).astype(np.int32)
    lo = offsets[idx]
    hi = lo + cdf_lengths[idx] - 2
    sym = (lo + rng.integers(0, 1 << 16, n) % np.maximum(hi - lo, 1)).astype(
        np.int32)
    sym[::53] += rng.integers(1, 500, sym[::53].shape[0]).astype(np.int32)
    sym[::71] -= rng.integers(1, 500, sym[::71].shape[0]).astype(np.int32)
    sym[:2] += np.array([10**6, -10**6], np.int32)[:n]
    return sym, idx


def test_available_coders_and_their_flags():
    assert stem_torch.available_entropy_coders() == list(CODERS) == \
        stem_tpu.available_entropy_coders()
    flags = ("supports_lut", "supports_runs", "supports_stream_runs")
    for name in CODERS:
        port, ref = get_coder(name), jax_coder(name)
        assert port.name == ref.name == name
        assert [getattr(port, f) for f in flags] == [getattr(ref, f)
                                                     for f in flags]
    assert get_coder("rans_interleaved").n_lanes == \
        jax_coder("rans_interleaved").n_lanes == 8
    with pytest.raises(ValueError, match="unknown entropy coder"):
        get_coder("huffman")


@pytest.mark.parametrize("name", ["numpy", "rans_interleaved"])
@pytest.mark.parametrize("n", [1, 7, 2500])
def test_streams_equal_jax_and_round_trip(tables, name, n):
    """The indexed container (and, for the interleaved coder, its lanes
    capped at n): the JAX coder's bytes; each coder decodes its own and
    the other package's stream; the NumPy spec's stream is the native
    single-stream coder's."""
    cdf, cdf_lengths, offsets = tables
    sym, idx = _payload(tables, n, seed=n)
    coder = get_coder(name)
    s = coder.encode_with_indexes(sym, idx, cdf, cdf_lengths, offsets)
    assert s == jax_coder(name).encode_with_indexes(sym, idx, cdf,
                                                    cdf_lengths, offsets)
    np.testing.assert_array_equal(
        coder.decode_with_indexes(s, idx, cdf, cdf_lengths, offsets), sym)
    np.testing.assert_array_equal(
        jax_coder(name).decode_with_indexes(s, idx, cdf, cdf_lengths,
                                            offsets), sym)
    if name == "numpy":
        assert s == get_coder("rans").encode_with_indexes(
            sym, idx, cdf, cdf_lengths, offsets)


def test_interleaved_decode_with_the_lut(tables):
    """The interleaved decode through the acceleration tables gives the
    symbols the table-free decode gives."""
    cdf, cdf_lengths, offsets = tables
    sym, idx = _payload(tables, 3000, seed=5)
    coder = get_coder("rans_interleaved")
    s = coder.encode_with_indexes(sym, idx, cdf, cdf_lengths, offsets)
    lut = coder.build_lut(cdf, cdf_lengths)
    np.testing.assert_array_equal(
        coder.decode_with_indexes(s, idx, cdf, cdf_lengths, offsets, lut),
        sym)


def test_numpy_stream_decoder_reads_in_chunks(tables):
    cdf, cdf_lengths, offsets = tables
    sym, idx = _payload(tables, 900, seed=6)
    coder = get_coder("numpy")
    s = coder.encode_stream(sym, idx, cdf, cdf_lengths, offsets, esym=None)
    dec = coder.make_stream_decoder(s)
    parts = [dec.decode(idx[i:i + 333], cdf, cdf_lengths, offsets)
             for i in range(0, len(idx), 333)]
    np.testing.assert_array_equal(np.concatenate(parts), sym)


@pytest.fixture(scope="module")
def gtables():
    """The Gaussian tables of each package (each caches its coder's
    acceleration tables on its own)."""
    return tg.update_tables(), jax_gaussian.update_tables()


def _grouped(tables, b=2, n=2048, seed=4):
    """Grouped-by-row symbols with escapes, and their per-row counts."""
    rng = np.random.default_rng(seed)
    levels = tables.cdf.shape[0]
    rows = np.sort(rng.integers(0, 24, (b, n)), axis=1)
    counts = np.stack([np.bincount(r, minlength=levels) for r in rows])
    sym = np.round(rng.standard_normal((b, n)) * (rows + 1) * 0.3)
    sym[:, ::97] += 200
    return sym.astype(np.int32), counts.astype(np.int32)


@pytest.mark.parametrize("name", ["numpy", "rans_interleaved"])
def test_grouped_transport_equals_jax(gtables, name):
    """encode_grouped/decode_grouped: the NumPy coder codes the grouped
    order through the indexed path with rows_from_counts, the interleaved
    coder through its 8-lane run container; the JAX package's bytes and
    symbols. decode_grouped_packed has no NumPy path (None)."""
    ours, theirs = gtables
    sym, counts = _grouped(ours)
    rows = transport.rows_from_counts(counts)
    np.testing.assert_array_equal(rows, jtransport.rows_from_counts(counts))
    assert rows.shape == sym.shape
    strings = transport.encode_grouped(sym, counts, ours, get_coder(name))
    assert strings == jtransport.encode_grouped(sym, counts, theirs,
                                                jax_coder(name))
    for dec in (transport.decode_grouped(strings, counts, ours,
                                         get_coder(name)),
                jtransport.decode_grouped(strings, counts, theirs,
                                          jax_coder(name))):
        np.testing.assert_array_equal(dec, sym)
    packed = transport.decode_grouped_packed(
        strings, counts, sym.shape[1], ours, get_coder(name))
    assert (packed is None) == (name == "numpy")
    if packed is not None:
        np.testing.assert_array_equal(
            packed[0], np.packbits(sym != 0, axis=-1, bitorder="little"))


def test_sparse_unpack_without_the_native_path(monkeypatch):
    """unpack_encode expands the bitmask in NumPy when the default coder
    has no run-based path: the same planes as the native expand."""
    rng = np.random.default_rng(8)
    b, n, zn, levels = 2, 256, 8, 64
    y = np.where(rng.random((b, n)) < 0.2, rng.integers(-9, 10, (b, n)), 0)
    mask, values = transport.pack_decode_payload(y, n // 2)
    counts = rng.integers(0, 5, (b, levels)).astype(np.int32)
    meta = np.stack([(y != 0).sum(1), np.zeros(b)], -1).astype(np.int32)
    buf = np.concatenate([mask.reshape(-1), values.view(np.uint8).reshape(-1),
                          counts.view(np.uint8).reshape(-1),
                          np.zeros(b * zn, np.uint8),
                          meta.view(np.uint8).reshape(-1)])
    layout = transport.SparseLayout(b=b, n=n, zn=zn, levels=levels,
                                    cap_value=n // 2)
    native = transport.unpack_encode(buf, layout)
    monkeypatch.setattr(stem_torch, "_entropy_coder", "numpy")
    spec = transport.unpack_encode(buf, layout)
    np.testing.assert_array_equal(native.y_sorted, y)
    np.testing.assert_array_equal(spec.y_sorted, y)


@pytest.mark.parametrize("name", ["numpy", "rans_interleaved"])
def test_bin_cli_with_each_coder_writes_the_jax_file(name, tmp_path,
                                                     monkeypatch):
    """``main`` with ``--coder`` and the hero I checkpoint (mbt2018-mean,
    quality 3) on a 64×64 PNG: the .bin file equals the JAX CLI's byte
    for byte, and its decode with the same coder writes the PNG of the
    decoded x̂. Each CLI sets its package's default coder; the fixture
    puts both back."""
    monkeypatch.setattr(stem_torch, "_entropy_coder", "rans")
    monkeypatch.setattr(stem_tpu, "_entropy_coder", "rans")
    ckpt = str(HERO_DIR / "ckpt_i_0.012.pkl.gz")
    img = tmp_path / "img.png"
    write_png(img, structured_frames(np.random.default_rng(6), 1,
                                     (64, 64))[0])
    args = ["--model", "mbt2018-mean", "--quality", "3", "--checkpoint",
            ckpt, "--coder", name]
    codec.main(["encode", str(img), "-o", str(tmp_path / "port.bin"), *args,
                "--device", "cpu"])
    assert stem_torch.get_entropy_coder() == name
    jax_codec.main(["encode", str(img), "-o", str(tmp_path / "jax.bin"),
                    *args])
    ours = (tmp_path / "port.bin").read_bytes()
    assert ours == (tmp_path / "jax.bin").read_bytes()
    # the NumPy spec writes the native single-stream coder's bytes; the
    # interleaved container is a format of its own
    assert (ours == _rans_file(img, ckpt, tmp_path)) == (name == "numpy")
    codec.main(["decode", str(tmp_path / "jax.bin"), "-o",
                str(tmp_path / "rec.png"), "--checkpoint", ckpt, "--coder",
                name, "--device", "cpu"])
    model = codec._build_model("mbt2018-mean", 3, ckpt, "cpu")
    x_hat = codec.decode(tmp_path / "jax.bin", model=model, device="cpu")
    np.testing.assert_array_equal(read_png(tmp_path / "rec.png"),
                                  codec.to_png_array(x_hat[0]))


def _rans_file(img, ckpt, tmp_path):
    out = tmp_path / "rans.bin"
    codec.main(["encode", str(img), "-o", str(out), "--model",
                "mbt2018-mean", "--quality", "3", "--checkpoint", ckpt,
                "--coder", "rans", "--device", "cpu"])
    return out.read_bytes()
