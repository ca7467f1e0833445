"""The port's wavefront scheduling, tiling, wire-order and coder helpers
against the JAX package's (models/ar_wavefront.py, coders/rans.py,
entropy/base.py), on the same NumPy inputs, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.coders import get_coder as jax_coder
from spatiotemporalentropymodel_tpu.entropy import base as jbase
from spatiotemporalentropymodel_tpu.layers.masked_conv import (
    make_causal_mask as jax_mask,
)
from spatiotemporalentropymodel_tpu.models import ar_wavefront as jwf
from spatiotemporalentropymodel_tpu.models import (
    SpatioTemporalPriorModel as JaxStem,
)
from spatiotemporalentropymodel_tpu_torch.coders import (
    get_coder,
    make_stream_decoder,
)
from spatiotemporalentropymodel_tpu_torch.entropy import base as tbase
from spatiotemporalentropymodel_tpu_torch.entropy import (
    EntropyBottleneck,
    get_scale_table,
    update_bottleneck_tables,
    update_gaussian_tables,
)
from spatiotemporalentropymodel_tpu_torch.layers import (
    MaskedConv2d,
    make_causal_mask,
)
from spatiotemporalentropymodel_tpu_torch.models import ar_wavefront as twf
from spatiotemporalentropymodel_tpu_torch.models import (
    SpatioTemporalPriorModel,
)

M = 24
B, HGT, WID = 2, 8, 8


@pytest.fixture(scope="module")
def gc_tables():
    return update_gaussian_tables(get_scale_table())


@pytest.mark.parametrize("tile", [None, (1, 2), (1, 4), (2, 4)])
def test_wavefront_helpers_match_jax(tile, gc_tables):
    """wavefront_tables, tile_plane/untile_plane, flatten_wavefront(_grouped),
    round_sizes, group_round_symbols and, through a segmented stream,
    decode_round_grouped: the port's against the JAX package's."""
    th, tw = tile or (HGT, WID)
    nt = (HGT // th) * (WID // tw)
    coords, valid = twf.wavefront_tables(th, tw)
    jc, jv = jwf.wavefront_tables(th, tw)
    np.testing.assert_array_equal(coords, np.asarray(jc))
    np.testing.assert_array_equal(valid, np.asarray(jv))
    assert coords.shape[0] == 3 * (th - 1) + tw

    rng = np.random.default_rng(3)
    plane = rng.standard_normal((B, HGT, WID, M)).astype(np.float32)
    tiled = twf.tile_plane(torch.from_numpy(plane), th, tw)
    np.testing.assert_array_equal(
        tiled.numpy(), np.asarray(jwf.tile_plane(jnp.asarray(plane), th, tw)))
    np.testing.assert_array_equal(
        twf.untile_plane(tiled, B, HGT, WID).numpy(), plane)

    levels = gc_tables.cdf.shape[0]
    sym = rng.integers(-3, 4, (B * nt, th, tw, M)).astype(np.int16)
    idx = rng.integers(0, levels, (B * nt, th, tw, M)).astype(np.uint8)
    flat = [twf.flatten_wavefront_grouped(torch.from_numpy(p), coords, valid,
                                          B).numpy() for p in (sym, idx)]
    for got, p in zip(flat, (sym, idx)):
        np.testing.assert_array_equal(
            got, jwf.flatten_wavefront_grouped(p, jc, jv, B))
    if nt == 1:
        np.testing.assert_array_equal(
            twf.flatten_wavefront(torch.from_numpy(sym), coords,
                                  valid).numpy(),
            jwf.flatten_wavefront(sym, jc, jv))

    sizes = twf.round_sizes(valid, nt, M)
    np.testing.assert_array_equal(sizes, jwf.round_sizes(jv, nt, M))
    assert sizes.sum() == flat[0].shape[1]
    sym_flat, idx_flat = flat[0][0], flat[1][0]
    grouped = twf.group_round_symbols(sym_flat, idx_flat, sizes, levels)
    ref = jwf.group_round_symbols(sym_flat, idx_flat, sizes, levels)
    for got, want in zip(grouped, ref):
        np.testing.assert_array_equal(got, want)

    t = gc_tables
    stream = get_coder().encode_runs_segmented(
        grouped[0], grouped[1], t.cdf, t.cdf_length, t.offset)
    assert stream == jax_coder().encode_runs_segmented(
        grouped[0], grouped[1], t.cdf, t.cdf_length, t.offset)
    dec, jdec = make_stream_decoder(stream), jax_coder().make_stream_decoder(
        stream)
    lut = get_coder().build_lut(t.cdf, t.cdf_length)
    start = 0
    for n in sizes:
        idx_r = idx_flat[start:start + n]
        got = twf.decode_round_grouped(dec, idx_r, t, lut=lut)
        np.testing.assert_array_equal(
            got, jwf.decode_round_grouped(jdec, idx_r, t))
        np.testing.assert_array_equal(got, sym_flat[start:start + n])
        start += n


def test_stream_decoder_reads_plain_stream_round_by_round(gc_tables):
    """encode_stream's bytes are the JAX coder's; the stream decodes in
    pieces, with and without the LUT."""
    t = gc_tables
    rng = np.random.default_rng(5)
    n = 3 * M * 7
    sym = rng.integers(-4, 5, n).astype(np.int32)
    idx = rng.integers(0, t.cdf.shape[0], n).astype(np.int32)
    coder = get_coder()
    esym = coder.build_enc_table(t.cdf, t.cdf_length)
    stream = coder.encode_stream(sym, idx, t.cdf, t.cdf_length, t.offset,
                                 esym=esym)
    assert stream == jax_coder().encode_stream(sym, idx, t.cdf, t.cdf_length,
                                               t.offset)
    for lut in (None, coder.build_lut(t.cdf, t.cdf_length)):
        dec = make_stream_decoder(stream)
        parts = [dec.decode(idx[i:i + M * 7], t.cdf, t.cdf_length, t.offset,
                            lut=lut) for i in range(0, n, M * 7)]
        np.testing.assert_array_equal(np.concatenate(parts), sym)
        dec.close()


def test_wire_format_and_masks():
    coder = get_coder("rans")
    with pytest.raises(ValueError, match="wavefront_format"):
        twf.wire_format("runs", coder)
    assert twf.wire_format("auto", coder) == "lane"
    assert [twf.wire_format(f, coder) for f in ("lane", "grouped")] == [
        "lane", "grouped"]
    # the NumPy coder has no stream runs: "grouped" raises as in the JAX
    # package, "lane" and "auto" stay
    assert twf.wire_format("auto", get_coder("numpy")) == "lane"
    with pytest.raises(ValueError, match="stream-run"):
        twf.wire_format("grouped", get_coder("numpy"))
    for kind in ("A", "B"):
        np.testing.assert_array_equal(make_causal_mask(5, 5, kind),
                                      jax_mask(5, 5, kind)[:, :, 0, 0])
    with pytest.raises(ValueError):
        make_causal_mask(5, 5, "C")
    conv = MaskedConv2d(M, 2 * M, 5, "A")
    assert len(conv.taps) == 12 and conv.taps[-1] == (2, 1)
    assert "mask" not in conv.state_dict()


def test_bottleneck_codec_and_eb_helpers_match_jax():
    """bottleneck_compress/decompress and the models' _eb_* helpers against
    the JAX package's, on the same z and tables."""
    rng = np.random.default_rng(6)
    c = 8
    eb = EntropyBottleneck(c, generator=torch.Generator().manual_seed(0))
    # each package caches its own coder's tables on the tables object
    tables, jtables = (update_bottleneck_tables(eb.numpy_params())
                       for _ in range(2))
    z = (3 * rng.standard_normal((2, 2, 3, c))).astype(np.float32)
    strings = tbase.bottleneck_compress(z, tables)
    assert strings == jbase.bottleneck_compress(z, jtables)
    np.testing.assert_array_equal(
        tbase.bottleneck_decompress(strings, (2, 3), tables),
        jbase.bottleneck_decompress(strings, (2, 3), jtables))

    port = SpatioTemporalPriorModel(variant="res",
                                    entropy_bottleneck_channels=c,
                                    in_channels=4, device="cpu")
    jax_m = JaxStem(variant="res", entropy_bottleneck_channels=c,
                    in_channels=4)
    port.tables = {"entropy_bottleneck": tables}
    jax_m.tables = {"entropy_bottleneck": jtables}
    assert port._eb_compress(z) == jax_m._eb_compress(z)
    np.testing.assert_array_equal(port._eb_quantize(z),
                                  jax_m._eb_quantize(z))
    np.testing.assert_array_equal(port._eb_decompress(strings, (2, 3)),
                                  jax_m._eb_decompress(strings, (2, 3)))
    np.testing.assert_array_equal(port._eb_decompress(strings, (2, 3)),
                                  port._eb_quantize(z))


@pytest.mark.parametrize("tile,match", [((2, 2), "tw >= 3 or th == 1"),
                                        ((3, 3), "divisible")])
def test_tile_dims_errors(tile, match):
    """JAX tests/test_stem.py:324-346: a multi-row tile narrower than 3
    leaves empty rounds, and a tile must divide the latent."""
    m = SpatioTemporalPriorModel(variant="res", entropy_bottleneck_channels=8,
                                 in_channels=M, wavefront_tile=tile,
                                 device="cpu")
    m.update()
    y = torch.zeros((1, M, HGT, WID))
    with pytest.raises(ValueError, match=match):
        m.compress(y, y)
