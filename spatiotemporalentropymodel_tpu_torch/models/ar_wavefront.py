"""Wavefront (anti-diagonal) scheduling for autoregressive SPM coding.

Counterpart of spatiotemporalentropymodel_tpu/models/ar_wavefront.py. For a
5×5 raster-causal mask two pixels (h, w) and (h', w') are independent
whenever 3h + w == 3h' + w': the dependency set of (h, w) lies strictly below
the line t = 3h + w. Scheduling by t gives T = 3(H−1) + W rounds of up to
about min(H, W/3) pixels each. Encode runs the rounds on the device with no
host sync; decode needs one host rANS call per round and stream.

The planes are NHWC on the device: (B, H, W, M), with the context plane
padded by 2 on each side. A round works on its valid lanes only (the JAX
package computes every lane and drops the invalid ones in its scatter; torch
indexing has no drop mode), and each lane's context comes from the masked
conv's causal taps (layers/masked_conv.py::MaskedConv2d.center), so the
encoder and decoder planes need agree only at pixels already coded. Both
keep zeros elsewhere; the encoder reads each centre from the target.

A batch may hold several independent streams (the S streams of a
multi-stream server). Their gathers and elementwise steps run batched, but
each product of a round (the context and EPM's 1×1 convs) runs once per
stream at the stream's own row count: a GEMM may choose another algorithm,
split or sum order for another row count, and then a stream's (σ, μ), and
so its ŷ, would depend on what it was batched with.

Bitstream symbol order is wavefront order, the JAX package's: round-major,
then tile, lane and channel (``flatten_wavefront_grouped``).
"""

from typing import List, NamedTuple

import numpy as np
import torch

from ..entropy import base as entropy_base
from ..entropy import build_indexes
from ..layers import Conv
from ..layers.masked_conv import per_stream
from ..utils import trace
from .base import _nchw

SPAN = 3  # wavefront slope for a 5x5 causal mask (offset 2)


def wavefront_tables(h: int, w: int, span: int = SPAN):
    """Static scheduling tables.

    Returns (coords, valid) as NumPy arrays: coords (T, L, 2) int32 pixel
    positions per wavefront (padded with (0, 0)), valid (T, L) bool lane
    mask, where T = span·(h−1) + w and L = max pixels per wavefront.
    """
    buckets = {}
    for i in range(h):
        for j in range(w):
            buckets.setdefault(span * i + j, []).append((i, j))
    T = span * (h - 1) + w
    L = max(len(v) for v in buckets.values())
    coords = np.zeros((T, L, 2), np.int32)
    valid = np.zeros((T, L), bool)
    for t in range(T):
        for lane, (i, j) in enumerate(buckets.get(t, [])):
            coords[t, lane] = (i, j)
            valid[t, lane] = True
    return coords, valid


def raster_tables(h: int, w: int):
    """(coords, valid) of the serial AR order: one pixel per round, raster
    order (the reference's, spatiotemporalpriors.py:633-768)."""
    hh, ww = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack([hh.reshape(-1), ww.reshape(-1)], -1).astype(np.int32)
    return coords[:, None, :], np.ones((h * w, 1), bool)


class Round(NamedTuple):
    """Device index tensors of one round's valid lanes."""

    h: torch.Tensor  # (L,) rows
    w: torch.Tensor  # (L,) columns
    tap_h: torch.Tensor  # (L, taps) rows of the causal taps, padded plane
    tap_w: torch.Tensor  # (L, taps) their columns


def device_rounds(coords, valid, taps, device) -> List[Round]:
    """The rounds of (coords, valid) with the causal ``taps`` ((dh, dw) of a
    crop whose top-left corner sits at the pixel in the padded plane), on
    ``device``. Empty rounds are dropped."""
    dh = np.array([t[0] for t in taps], np.int64)
    dw = np.array([t[1] for t in taps], np.int64)
    rounds = []
    for c, v in zip(np.asarray(coords), np.asarray(valid)):
        if not v.any():
            continue
        h = c[v, 0].astype(np.int64)
        w = c[v, 1].astype(np.int64)
        rounds.append(Round(*(torch.from_numpy(a).to(device) for a in (
            h, w, h[:, None] + dh[None, :], w[:, None] + dw[None, :]))))
    return rounds


def conv1x1_rows(seq, x, streams: int = 1):
    """A ``Sequential`` of 1×1 convs and activations (an entropy-parameters
    stack) on (N, C) rows: each conv a product rounded to the rows' dtype
    before its bias is added, as ``Conv`` does, run once for each of
    ``streams`` equal parts of the rows (``per_stream``)."""
    for layer in seq.layers:
        if isinstance(layer, Conv):
            w = layer.weight.flatten(1)
            x = per_stream(lambda r: torch.nn.functional.linear(r, w),
                           streams, x) + layer.bias
        else:
            x = layer(x)
    return x


def _check_rows(scale_table, what: str):
    rows = int(scale_table.shape[0])
    if rows > 256:
        raise ValueError(f"wavefront {what} ships u8 CDF indexes; scale tables"
                         f" are limited to 256 rows (got {rows})")


def _params(apply_ar_step, scale_table, plane_pad, priors, rnd,
            streams: int = 1):
    """(μ, u8 CDF-row indexes), each (B·L, M) in lane order, of one round:
    the causal taps and prior rows of its lanes through ``apply_ar_step``,
    whose products run once per stream (the batch's ``streams`` equal
    parts), so a stream's (σ, μ) do not depend on the batch."""
    b, m = plane_pad.shape[0], plane_pad.shape[3]
    n = b * rnd.h.shape[0]
    taps = plane_pad[:, rnd.tap_h, rnd.tap_w, :].reshape(n, -1)
    pvec = priors[:, rnd.h, rnd.w, :].reshape(n, -1)
    scales, means = apply_ar_step(taps, pvec, streams)
    idx = build_indexes(scales, scale_table).to(torch.uint8)
    return means.reshape(n, m), idx.reshape(n, m)


def _write(plane_pad, rnd, values):
    """values (B·L, M) into the padded plane at the round's pixels."""
    b, m = plane_pad.shape[0], plane_pad.shape[3]
    plane_pad[:, rnd.h + 2, rnd.w + 2, :] = values.view(b, -1, m)


def make_wavefront_encoder(apply_ar_step, scale_table):
    """The device wavefront encoder.

    apply_ar_step: (taps (N, taps·M), prior rows (N, P), streams) -> (σ, μ)
    (N, M), in the nets' dtype, its products run once per stream. Returns
    fn(target (B, H, W, M), priors (B, H, W, P), rounds, streams) ->
    (symbols (B, H, W, M) int16, indexes (B, H, W, M) uint8, reconstruction
    (B, H, W, M) f32); the batch holds ``streams`` streams' tiles, each
    stream's in one run. A symbol is round(centre − μ) with the difference
    taken in the dtype the two promote to, as the JAX package takes it: in
    bf16 where the target and the nets are bf16 (a bf16 I-model's y), in
    f32 where the target is f32. Symbols saturate at int16 (the u8/int16
    planes cut the fetch; identical to int32 for any |round(y−μ)| < 32768),
    and the saturated value feeds the context, so encoder and decoder stay
    consistent even then.
    """
    _check_rows(scale_table, "encode")

    def encode(target, priors, rounds, streams):
        b, h, w, m = target.shape
        plane = torch.zeros((b, h + 4, w + 4, m), dtype=torch.float32,
                            device=target.device)
        syms = torch.zeros((b, h, w, m), dtype=torch.int16,
                           device=target.device)
        idxs = torch.zeros((b, h, w, m), dtype=torch.uint8,
                           device=target.device)
        for rnd in rounds:
            means, idx = _params(apply_ar_step, scale_table, plane, priors,
                                 rnd, streams)
            center = target[:, rnd.h, rnd.w, :].reshape(means.shape)
            sym = torch.clamp(torch.round((center - means).float()), -32768,
                              32767)
            _write(plane, rnd, sym + means.float())
            syms[:, rnd.h, rnd.w, :] = sym.to(torch.int16).view(b, -1, m)
            idxs[:, rnd.h, rnd.w, :] = idx.view(b, -1, m)
        return syms, idxs, plane[:, 2:-2, 2:-2, :]

    return encode


def make_wavefront_decode_step(apply_ar_step, scale_table):
    """Per-round decode helpers:

    params_step(plane_pad, priors, rnd, streams) -> (μ (B·L, M), u8
      indexes)
    write_step(plane_pad, rnd, sym, μ) -> plane_pad, with sym + μ written
      (in f32) at the round's pixels

    The JAX package's fused_step (a write, then the next round's
    parameters, as one jitted dispatch) is the two calls in turn here.
    """
    _check_rows(scale_table, "decode")

    def params_step(plane_pad, priors, rnd, streams):
        return _params(apply_ar_step, scale_table, plane_pad, priors, rnd,
                       streams)

    def write_step(plane_pad, rnd, sym, means):
        _write(plane_pad, rnd, sym.float() + means.float())
        return plane_pad

    return params_step, write_step


def _lanes(coords, valid, device):
    coords, valid = np.asarray(coords), np.asarray(valid)
    return (torch.from_numpy(coords[..., 0][valid].astype(np.int64)).to(device),
            torch.from_numpy(coords[..., 1][valid].astype(np.int64)).to(device))


def flatten_wavefront(planes, coords, valid):
    """(B, H, W, M) planes → (B, N·M) in wavefront order, on the planes'
    device."""
    hh, ww = _lanes(coords, valid, planes.device)
    return planes[:, hh, ww, :].reshape(planes.shape[0], -1)


# ---- tiled wavefront (video-codec slices/tiles idea) ------------------------
#
# Tiling the latent into th×tw blocks resets the masked-conv context at tile
# borders, making every tile's wavefront independent: all tiles advance in
# the SAME round, so decode needs 3(th−1)+tw host rounds instead of
# 3(H−1)+W. Tiles fold into the batch axis and reuse the untiled machinery.


def tile_plane(x, th: int, tw: int):
    """(B, H, W, M) → (B·nt, th, tw, M), tiles raster-ordered per element."""
    b, h, w, m = x.shape
    x = x.reshape(b, h // th, th, w // tw, tw, m).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // th) * (w // tw), th, tw, m)


def untile_plane(x, b: int, h: int, w: int):
    """Inverse of tile_plane."""
    _, th, tw, m = x.shape
    x = x.reshape(b, h // th, w // tw, th, tw, m).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, m)


def wire_format(fmt: str, coder) -> str:
    """Resolve a model's ``wavefront_format`` ("auto"/"grouped"/"lane")
    against the coder's capabilities. "auto" is "lane": the grouped (v2)
    order costs a host-side stable permutation per frame that the JAX
    package measured at about 4× the whole v1 coding cost
    (ar_wavefront.py::wire_format there). "grouped" needs a coder with
    stream runs (the native ones)."""
    if fmt == "auto":
        return "lane"
    if fmt not in ("lane", "grouped"):
        raise ValueError(f"unknown wavefront_format {fmt!r}")
    if fmt == "grouped" and not coder.supports_stream_runs:
        raise ValueError(
            "wavefront_format='grouped' needs a coder with stream-run "
            f"support; {coder.name!r} has none")
    return fmt


def round_sizes(valid, nt: int, m: int) -> np.ndarray:
    """Per-round flat symbol counts for one batch element: round t carries
    nt·n_valid(t)·m symbols in the flattened wavefront order."""
    v = np.asarray(valid)
    return v.sum(axis=1).astype(np.int64) * nt * m


def group_round_symbols(sym_flat, idx_flat, sizes, levels: int):
    """Wavefront wire-format v2 host transform (encode side): each round's
    symbols in grouped-by-CDF-row order (stable, so both sides derive the
    same permutation from the indexes). Returns (sym_grouped (n,),
    seg_counts (T, levels) int32) for ``encode_runs_segmented``."""
    sym_flat = np.asarray(sym_flat).reshape(-1)
    idx_flat = np.asarray(idx_flat, np.int64).reshape(-1)
    sizes = np.asarray(sizes, np.int64)
    t_of = np.repeat(np.arange(sizes.shape[0], dtype=np.int64), sizes)
    key = t_of * levels + idx_flat
    order = np.argsort(key, kind="stable")
    seg_counts = np.bincount(
        key, minlength=sizes.shape[0] * levels
    ).astype(np.int32).reshape(sizes.shape[0], levels)
    return sym_flat[order], seg_counts


def decode_round_grouped(dec, idx_round, tables, lut=None):
    """Wavefront v2 decode of one round: run-decode the segment in
    grouped-by-row order, then scatter back to lane order. `dec` is a
    StreamDecoder over an ``encode_runs_segmented`` stream."""
    idx_round = np.asarray(idx_round, np.int64).reshape(-1)
    levels = tables.cdf.shape[0]
    counts = np.bincount(idx_round, minlength=levels).astype(np.int32)
    decoded = dec.decode_runs(
        counts, tables.cdf, tables.cdf_length, tables.offset, lut=lut
    )
    out = np.empty_like(decoded)
    out[np.argsort(idx_round, kind="stable")] = decoded
    return out


def flatten_wavefront_grouped(planes, coords, valid, b: int):
    """(b·nt, th, tw, M) tile-batch planes → (b, nt·N·M) in ROUND-major
    (wavefront, tile, lane, channel) order, the wire order a per-round
    decoder consumes, on the planes' device. Equals flatten_wavefront when
    nt == 1."""
    coords, valid = np.asarray(coords), np.asarray(valid)
    chunks = []
    for c, v in zip(coords, valid):
        if not v.any():
            continue
        hh, ww = _lanes(c, v, planes.device)
        chunks.append(planes[:, hh, ww, :].reshape(b, -1))
    return torch.cat(chunks, dim=1)


# ---- the rounds as CUDA graphs ---------------------------------------------
#
# A round is about 60 small operations (gathers, a product per stream and
# layer, the CDF search, the writes) on a few dozen pixels: on the card
# each costs its host ~20 µs to launch and the device far less to run, so
# the rounds of a 1080p latent are paced by the host's launches. Captured
# once per plane shape and batch, the encoder's rounds are one replay and
# each decode round one replay after its host rANS. A replay runs the
# captured kernels on the inputs' static copies: the same kernels in the
# same order as the eager rounds.


def _capture(fn, stream, pool):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        out = fn()
    return graph, out


def _static_copy(t):
    """A contiguous device buffer holding ``t``: a graph's input."""
    buf = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    buf.copy_(t)
    return buf


class EncodeGraph:
    """The wavefront encoder of one plane shape and batch as one CUDA
    graph: ``(target, priors)`` → (symbols, indexes, reconstruction), the
    first two the graph's own buffers (read them before the next call), the
    reconstruction a copy."""

    def __init__(self, encoder, rounds, streams, target, priors):
        self.target, self.priors = _static_copy(target), _static_copy(priors)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # lazy initialisations off the graph
            encoder(self.target, self.priors, rounds, streams)
        self.graph, self.out = _capture(
            lambda: encoder(self.target, self.priors, rounds, streams),
            side, None)
        torch.cuda.current_stream().wait_stream(side)

    def __call__(self, target, priors):
        self.target.copy_(target)
        self.priors.copy_(priors)
        self.graph.replay()
        syms, idxs, recon = self.out
        return syms, idxs, recon.clone()


class DecodeRounds:
    """The per-round decoder's device side, run eagerly: ``start(priors)``
    zeroes the plane and computes round 0's parameters, ``indexes(k)`` are
    round k's u8 CDF rows (N·L, M), ``write(k, sym)`` uploads round k's
    host symbols (B, N·L·M / B), writes them and computes round k+1's
    parameters, ``result()`` is the decoded plane (N, H, W, M) f32: N the
    priors' tiles, B the streams they hold."""

    def __init__(self, params_step, write_step, rounds, b, m, priors):
        self.params_step, self.write_step = params_step, write_step
        self.rounds, self.b, self.m = rounds, b, m
        n, h, w = priors.shape[:3]
        self.shape = (n, h + 4, w + 4, m)

    def start(self, priors):
        self.priors = priors
        self.plane = torch.zeros(self.shape, dtype=torch.float32,
                                 device=priors.device)
        self.means, self.idx = self.params_step(
            self.plane, priors, self.rounds[0], self.b)

    def indexes(self, k):
        return self.idx

    def write(self, k, sym):
        sym_dev = trace.upload(torch.from_numpy(sym),
                               self.plane.device).view(-1, self.m)
        self.plane = self.write_step(self.plane, self.rounds[k], sym_dev,
                                     self.means)
        if k + 1 < len(self.rounds):
            self.means, self.idx = self.params_step(
                self.plane, self.priors, self.rounds[k + 1], self.b)

    def result(self):
        return self.plane[:, 2:-2, 2:-2, :]


class DecodeGraphs(DecodeRounds):
    """``DecodeRounds`` with its device steps as CUDA graphs of one plane
    shape and batch: ``start`` one replay, each ``write`` a copy of the
    symbols into the round's buffer and one replay. ``result()`` is a
    copy. The graphs share one memory pool and run in the order they were
    captured; every output a later graph reads stays referenced."""

    def __init__(self, params_step, write_step, rounds, b, m, priors):
        super().__init__(params_step, write_step, rounds, b, m, priors)
        dev = priors.device
        self.priors = _static_copy(priors)
        self.plane = torch.zeros(self.shape, dtype=torch.float32, device=dev)
        self.syms = [torch.zeros((self.shape[0] * int(r.h.shape[0]), m),
                                 dtype=torch.int32, device=dev)
                     for r in rounds]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(side):  # lazy initialisations off the graph
            means, _ = params_step(self.plane, self.priors, rounds[0], b)
            write_step(self.plane, rounds[0], self.syms[0], means)

        def first():
            self.plane.zero_()
            return params_step(self.plane, self.priors, rounds[0], b)

        self.first, out = _capture(first, side, pool)
        self.outs, self.graphs = [out], []
        for k, rnd in enumerate(rounds):
            def step(k=k, rnd=rnd):
                write_step(self.plane, rnd, self.syms[k], self.outs[k][0])
                if k + 1 < len(rounds):
                    return params_step(self.plane, self.priors,
                                       rounds[k + 1], b)
                return None

            graph, out = _capture(step, side, pool)
            self.graphs.append(graph)
            self.outs.append(out)
        torch.cuda.current_stream().wait_stream(side)

    def start(self, priors):
        self.priors.copy_(priors)
        self.first.replay()

    def indexes(self, k):
        return self.outs[k][1]

    def write(self, k, sym):
        trace.upload_into(self.syms[k],
                          torch.from_numpy(sym).view(-1, self.m))
        self.graphs[k].replay()

    def result(self):
        return self.plane[:, 2:-2, 2:-2, :].clone()


# ---- the AR codec legs of a model ------------------------------------------


class ARCodec:
    """The autoregressive codec legs that the SPM STEM variants
    (models/stem.py) and the image models with a context model
    (models/priors.py::JointAutoregressiveHierarchicalPriors, the Cheng2020
    models) share, mixed into their ``CompressionModel``: the rounds of an
    h×w plane (wavefront, or raster when serial), the device encoder and
    the per-round decoder over NHWC tile batches, host rANS between them.

    The model's ``module`` has ``ar_step(taps, prior rows, streams)`` and a
    ``context_prediction`` masked conv, and its ``__init__`` sets
    ``_rounds_cache = {}`` (the device rounds by plane shape and mode).
    ``wavefront_format`` picks the stream order ("lane" v1, "grouped" v2;
    not bitstream compatible with each other). The legs' stages are spans
    (utils/trace.py): ``ar.encode.device`` and ``ar.encode.host`` (one
    ``rans.y.encode`` a stream), then ``ar.decode.params`` and per round
    ``ar.decode.round`` with its ``ar.decode.fetch``, ``ar.decode.rans``
    (one ``rans.y.decode`` a stream) and ``ar.decode.write``.
    ``_codec_stats`` (the stage clock of models/base.py, host seconds):
    the stages add under "hyper_s", "priors_s", "enc_device_s",
    "enc_host_s", "device_s" and "host_rans_s", and the legs count
    "enc_fetch_bytes" and "rounds".

    ``round_graphs``: on a CUDA device, the wavefront rounds (not the
    serial mode's) run as CUDA graphs (``EncodeGraph``, ``DecodeGraphs``),
    captured at a plane shape and batch's first call and kept until the
    model's parameters or scale table move to other storage.
    """

    wavefront_format = "auto"
    round_graphs = False
    _graphs = None  # (the storage the graphs read, {key: graphs})

    def _upload(self, plane_nhwc: np.ndarray):
        """Host NHWC f32 ẑ → device NCHW f32, canonical strides."""
        t = torch.from_numpy(np.ascontiguousarray(plane_nhwc, np.float32))
        return _nchw(trace.upload(t, self.device).permute(0, 3, 1, 2))

    def _wf_format(self) -> str:
        return wire_format(self.wavefront_format, self.coder)

    def _ar_step(self, taps, prior_vec, streams: int = 1):
        return self.module.ar_step(self._cast_in(taps),
                                   self._cast_in(prior_vec), streams)

    def _wavefront_setup(self, h: int, w: int, serial: bool = False):
        """(coords, valid, rounds, encoder, params_step, write_step) of an
        h×w plane (a tile): wavefront order, or raster order when
        ``serial``. The device rounds are cached; the steps read the
        model's current weights and tables."""
        cache = self._rounds_cache
        key = (h, w, serial)
        if key not in cache:
            coords, valid = (raster_tables(h, w) if serial
                             else wavefront_tables(h, w))
            rounds = device_rounds(coords, valid,
                                   self.module.context_prediction.taps,
                                   self.device)
            cache[key] = (coords, valid, rounds)
        table = self._scale_table
        encoder = make_wavefront_encoder(self._ar_step, table)
        steps = make_wavefront_decode_step(self._ar_step, table)
        return (*cache[key], encoder, *steps)

    def _graphed(self, serial: bool) -> bool:
        return (self.round_graphs and not serial
                and self.device.type == "cuda")

    def _graph(self, cls, key, *args):
        """The cached ``cls(*args)`` of ``key``; every one is dropped when
        the parameters or the scale table are no longer where they were
        captured."""
        ptrs = (self._scale_table.data_ptr(),
                *(p.data_ptr() for p in self.module.parameters()))
        if self._graphs is None or self._graphs[0] != ptrs:
            self._graphs = (ptrs, {})
        cache = self._graphs[1]
        if key not in cache:
            cache[key] = cls(*args)
        return cache[key]

    def _ar_encode(self, target, priors, streams: int, nt: int = 1,
                   serial: bool = False):
        """(the y strings, one per stream, the reconstruction (B·nt, th, tw,
        M) f32, the decoder's target ŷ) of ``target`` (B·nt, th, tw, M)
        against ``priors`` (B·nt, th, tw, P), NHWC tile batches whose
        streams' tiles run in one block each. Wavefront order (grouped per
        ``wavefront_format``), or the raster order of the serial mode."""
        _, th, tw, m = target.shape
        coords, valid, rounds, encoder, *_ = self._wavefront_setup(
            th, tw, serial)
        with self._lap("ar.encode.device", "enc_device_s"):
            if self._graphed(serial):
                key = ("encode", target.shape, target.dtype, priors.shape,
                       priors.dtype, streams)
                syms, idxs, recon = self._graph(
                    EncodeGraph, key, encoder, rounds, streams, target,
                    priors)(target, priors)
            else:
                syms, idxs, recon = encoder(target, priors, rounds, streams)
            if nt > 1:
                flat = [flatten_wavefront_grouped(p, coords, valid, streams)
                        for p in (syms, idxs)]
            else:  # the same order in one gather instead of one per round
                flat = [flatten_wavefront(p, coords, valid)
                        for p in (syms, idxs)]
            sym_flat, idx_flat = (trace.fetch(p) for p in flat)
        st = self._codec_stats
        if st is not None:
            st["enc_fetch_bytes"] = (st.get("enc_fetch_bytes", 0)
                                     + sym_flat.nbytes + idx_flat.nbytes)
        t = self.tables["gaussian_conditional"]
        grouped = not serial and self._wf_format() == "grouped"
        with self._lap("ar.encode.host", "enc_host_s"):
            esym = entropy_base.get_enc_table(t, self.coder)
            if grouped:
                sizes, levels = round_sizes(valid, nt, m), t.cdf.shape[0]
            y_strings = []
            for i in range(streams):
                with trace.span("rans.y.encode"):
                    if grouped:
                        sym_g, seg_counts = group_round_symbols(
                            sym_flat[i], idx_flat[i], sizes, levels)
                        y_strings.append(self.coder.encode_runs_segmented(
                            sym_g, seg_counts, t.cdf, t.cdf_length,
                            t.offset, esym=esym))
                    else:
                        y_strings.append(self.coder.encode_stream(
                            sym_flat[i], idx_flat[i], t.cdf, t.cdf_length,
                            t.offset, esym=esym))
        return y_strings, recon

    def _ar_decode(self, y_strings, priors, m: int, nt: int = 1,
                   serial: bool = False):
        """The decoded target (B·nt, th, tw, M) f32, NHWC tile batch, of
        the streams' ``y_strings`` against ``priors`` (B·nt, th, tw, P):
        per round the device's parameters, one host rANS call per stream,
        then the round's write."""
        b = len(y_strings)
        th, tw = priors.shape[1], priors.shape[2]
        t = self.tables["gaussian_conditional"]
        _, _, rounds, _, params_step, write_step = self._wavefront_setup(
            th, tw, serial)
        grouped = not serial and self._wf_format() == "grouped"
        decoders = [self.coder.make_stream_decoder(s) for s in y_strings]
        lut = entropy_base.get_lut(t, self.coder)
        args = (params_step, write_step, rounds, b, m, priors)
        if self._graphed(serial):
            dev = self._graph(DecodeGraphs, ("decode", priors.shape,
                                             priors.dtype, b, m), *args)
        else:
            dev = DecodeRounds(*args)
        # round t's write and round t+1's parameters back to back: one
        # blocking u8 index fetch per round
        st = self._codec_stats
        with self._lap("ar.decode.params", "device_s"):
            dev.start(priors)
        for k in range(len(rounds)):
            with trace.span("ar.decode.round", round=k):
                with self._lap("ar.decode.fetch", "device_s"):
                    idx_np = trace.fetch(dev.indexes(k).view(b, -1))
                sym = np.empty(idx_np.shape, np.int32)
                with self._lap("ar.decode.rans", "host_rans_s"):
                    for i in range(b):
                        with trace.span("rans.y.decode"):
                            if grouped:
                                sym[i] = decode_round_grouped(
                                    decoders[i], idx_np[i], t, lut=lut)
                            else:
                                sym[i] = decoders[i].decode(
                                    idx_np[i], t.cdf, t.cdf_length, t.offset,
                                    lut=lut)
                if st is not None:
                    st["rounds"] = st.get("rounds", 0) + 1
                with self._lap("ar.decode.write", "device_s"):
                    dev.write(k, sym)
        return dev.result()
