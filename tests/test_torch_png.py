"""The port's PNG reader and writer (data/png.py), with PIL as the oracle:
what the port writes PIL reads back exactly; what PIL writes, and files
whose rows use every filter type, the port reads as
``np.asarray(Image.open(path).convert("RGB"))``; 16-bit, interlaced and
non-PNG files raise; and data/gop.py reads a folder of sequences as the JAX
package's GOPDataset does."""

import struct
import zlib

import numpy as np
import pytest

from spatiotemporalentropymodel_tpu_torch.data.png import (
    SIGNATURE,
    read_png,
    write_png,
)
from spatiotemporalentropymodel_tpu_torch.eval.workload import (
    structured_frames,
)

Image = pytest.importorskip("PIL.Image")


def _frame(h=48, w=40, seed=0):
    """A structured frame (gradient and moving blocks) with mild noise, so
    rows differ in what suits them."""
    rng = np.random.default_rng(seed)
    f = structured_frames(rng, 1, (h, w))[0].astype(np.int64)
    f += rng.integers(-2, 3, f.shape)
    return np.clip(f, 0, 255).astype(np.uint8)


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_row(kind, row, prior, bpp):
    """PNG spec §9 filters, byte by byte (an independent encoder)."""
    out = bytearray()
    for x, v in enumerate(row):
        a = int(row[x - bpp]) if x >= bpp else 0
        b = int(prior[x])
        c = int(prior[x - bpp]) if x >= bpp else 0
        if kind == 0:
            p = 0
        elif kind == 1:
            p = a
        elif kind == 2:
            p = b
        elif kind == 3:
            p = (a + b) // 2
        else:
            q = a + b - c
            pa, pb, pc = abs(q - a), abs(q - b), abs(q - c)
            p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((int(v) - p) & 0xFF)
    return bytes(out)


def _write_all_filters(path, pixels, color, bpp):
    """A PNG whose row r uses filter r % 5; returns the filter bytes."""
    h, w = pixels.shape[:2]
    rows = pixels.reshape(h, -1)
    prior = np.zeros(rows.shape[1], np.uint8)
    raw, kinds = b"", []
    for r in range(h):
        kind = r % 5
        kinds.append(kind)
        raw += bytes([kind]) + _filter_row(kind, rows[r], prior, bpp)
        prior = rows[r]
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">2I5B", w, h, 8, color, 0, 0,
                                              0))
                + _chunk(b"IDAT", zlib.compress(raw))
                + _chunk(b"IEND", b""))
    return kinds


def _idat_filters(path, h):
    data = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(h, -1)[:, 0]


def test_port_file_reads_back_in_pil(tmp_path):
    frame = _frame()
    write_png(tmp_path / "a.png", frame)
    with Image.open(tmp_path / "a.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), frame)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), frame)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P16"])
def test_pil_written_modes_read_as_pil_converts_them(tmp_path, mode):
    """PIL's writer chooses a filter per row; a palette of 16 colours or
    fewer it writes at 4 bits per pixel (``P16``)."""
    rgb = _frame(seed=1)
    im = Image.fromarray(rgb)
    if mode == "P16":
        im = im.quantize(16)
    elif mode == "P":
        im = im.quantize(200)
    else:
        im = im.convert(mode)
        if mode in ("LA", "RGBA"):  # a varying alpha that must be dropped
            alpha = Image.fromarray(_frame(seed=2)[..., 0])
            im.putalpha(alpha)
    path = tmp_path / f"{mode}.png"
    im.save(path)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == rgb.shape
    np.testing.assert_array_equal(got, _pil_rgb(path))


@pytest.mark.parametrize("mode,color,bpp", [("RGB", 2, 3), ("RGBA", 6, 4),
                                            ("L", 0, 1)])
def test_every_filter_type_reads_as_pil_reads_it(tmp_path, mode, color,
                                                  bpp):
    frame = _frame(40, 36, seed=3)
    pixels = np.asarray(Image.fromarray(frame).convert(mode))
    if mode == "RGBA":
        pixels = pixels.copy()
        pixels[..., 3] = _frame(40, 36, seed=4)[..., 0]
    path = tmp_path / "filters.png"
    _write_all_filters(path, pixels, color, bpp)
    assert set(_idat_filters(path, 40).tolist()) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(read_png(path), _pil_rgb(path))


def test_sixteen_bit_interlaced_and_non_png_raise(tmp_path):
    gray = (np.arange(48 * 40, dtype=np.uint16) * 27).reshape(48, 40)
    Image.fromarray(gray).save(tmp_path / "i16.png")
    with Image.open(tmp_path / "i16.png") as im:
        assert im.mode.startswith("I")  # PIL wrote 16 bits per sample
    with pytest.raises(ValueError, match="16-bit"):
        read_png(tmp_path / "i16.png")

    # the port's file with its header's interlace method set to Adam7
    write_png(tmp_path / "a.png", _frame())
    data = bytearray((tmp_path / "a.png").read_bytes())
    body = bytes(data[16:28]) + b"\x01"  # IHDR's 13 bytes, the last one 1
    data[16:33] = body + struct.pack(">I", zlib.crc32(b"IHDR" + body))
    (tmp_path / "adam7.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(tmp_path / "adam7.png")

    Image.fromarray(_frame()).save(tmp_path / "a.jpg", format="JPEG")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "a.jpg")


def test_gop_dataset_reads_as_the_jax_package(tmp_path):
    """data/gop.py's GOPDataset and GOPSequence through data/png.py give
    the JAX package's (PIL) frames, indexes, intra flags and names, the
    frames in numeric order and cut to gop_size · n_gops."""
    from spatiotemporalentropymodel_tpu.data.gop import (
        GOPDataset as JaxGOPDataset,
    )
    from spatiotemporalentropymodel_tpu_torch.data.gop import (
        HEVC_GOP,
        UVG_GOP,
        GOPDataset,
    )

    assert (UVG_GOP, HEVC_GOP) == (12, 10)
    rng = np.random.default_rng(5)
    for seq in ("seqB", "seqA"):
        (tmp_path / seq).mkdir()
        for t in (1, 2, 10, 3, 11):  # numeric, not lexical, order
            Image.fromarray(structured_frames(rng, 1, (48, 40))[0]).save(
                tmp_path / seq / f"im{t}.png")
    got = GOPDataset(str(tmp_path), gop_size=2, n_gops=2)
    want = JaxGOPDataset(str(tmp_path), gop_size=2, n_gops=2)
    assert [s.name for s in got] == [s.name for s in want] == ["seqA",
                                                               "seqB"]
    for gs, ws in zip(got, want):
        assert gs.files == ws.files == ["im1.png", "im2.png", "im3.png",
                                        "im10.png"]
        for g, w in zip(gs, ws):
            assert (g.index, g.is_intra) == (w.index, w.is_intra)
            assert g.image.dtype == np.float32
            np.testing.assert_array_equal(g.image, w.image)
