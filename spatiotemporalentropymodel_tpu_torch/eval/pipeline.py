"""P-frame serving pipelines: I-model transforms + STEM codec + host rANS.

Counterparts of spatiotemporalentropymodel_tpu/eval/pipeline.py::
StemVideoPipeline (the parallel STEM variants) and WavefrontVideoPipeline
(the SPM variants' AR codec, the flagship ``res``), eager PyTorch on one
device. StemVideoPipeline:

  encode: g_a → HE → EB-quantize → entropy params → quantize_and_index →
          packed transport buffer (one D2H copy) → host rANS
  decode: host rANS (z, then grouped y with the row counts the container
          carries) → one packed upload → params-from-ẑ + sparse unpack +
          reconstruct + g_s, with no device→host fetch

Frames and latents are NCHW tensors on the models' device; the conditioning
latent stays there across frames (GOP recurrence, stem/evalSTEM.py:93-153).
After ``set_compute_dtype(torch.bfloat16)`` on both models the transforms run
in bf16: the frame is cast at ``analysis``, x̂ comes back in bf16, and the ŷ
carry and the codec math stay f32.

With a ``spatial_mesh`` (parallel/spatial.py) StemVideoPipeline serves each
frame W-split over the mesh: g_a, g_s and the encoder's HE run per shard
with their halos (``_SplitHyperAnalysis``); the nets the decoder also runs
(TPM, HD, EPM), the quantizer, the sparse pack and the host coder see the
whole latent on the mesh's first device. So every decoder, split or not,
computes the encoder's (σ, μ) bit for bit and decodes the stream; the
stream itself is the unsplit pipeline's where the split g_a and HE give
the unsplit ones' y and z, which a card's convolution algorithms for the
narrower shapes need not (their sums run in another order).
``gop_forward_sharded`` splits a GOP's batch over a mesh instead.

Both pipelines open spans (utils/trace.py) ``serve.encode``, ``serve.decode``
and ``serve.gs_dispatch`` with the frame's index in the call's sequence
(``frame``; None where a caller codes single frames and gives none). In
``encode_frames`` frame k's host half (``serve.encode.host``) runs while
frame k+1 is on the device, and carries k. The counters
``transport.sparse`` and ``transport.dense`` count frames by the transport
they took.
"""

from typing import Tuple

import numpy as np
import torch

from ..entropy import base as entropy_base
from ..entropy import transport
from ..models.base import _to_nchw
from ..parallel.mesh import (
    DATA_AXIS, canonical_device, check_axis, on_device, replica_on,
)
from ..parallel.spatial import (
    SP_AXIS, Sharded, halo_map, receptive_field, shard_frame, spatial_apply,
    stack_halo, whole,
)
from ..utils import trace


def _shape4(y):
    """NCHW latent → the (b, h, w, m) shape the host side uses."""
    b, m, h, w = y.shape
    return (b, h, w, m)


def _require_deterministic(stem):
    cudnn = torch.backends.cudnn
    if stem.device.type == "cuda" and not cudnn.deterministic:
        # encoder and decoder must compute bit-identical (σ, μ) from ẑ;
        # a nondeterministic cuDNN algorithm breaks the decode
        raise RuntimeError("set torch.backends.cudnn.deterministic = True "
                           "before serving on CUDA")


class _Download:
    """A device→host copy of a packed buffer in flight: the copy is queued on
    the buffer's card's current stream into pinned memory, so the host can
    code the previous frame while the device works on this one."""

    def __init__(self, packed):
        if packed.device.type == "cuda":
            self._host = torch.empty(packed.shape, dtype=packed.dtype,
                                     pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(packed.device))
        else:
            self._host, self._event = packed, None

    def result(self) -> np.ndarray:
        with trace.d2h(self._host.nbytes):
            if self._event is not None:
                self._event.synchronize()
        return self._host.numpy()


class _SplitHyperAnalysis:
    """The encoder's HE (``models/stem.py::HyperAnalysis``'s methods) on
    latents W-split over a mesh: per shard with the halo of its layers where
    the latent's W divides into shards of whole z columns (W divisible by
    the mesh size times HE's stride, 4), else whole on the mesh's first
    device. z comes back whole there, for the quantizer and the pack."""

    def __init__(self, stem, mesh):
        self.stem, self.mesh = stem, mesh
        self._halo = stack_halo(stem.module.HE)
        self._stride = max(1, int(receptive_field([stem.module.HE])[1]))

    def cast(self, t):
        if isinstance(t, Sharded):
            return t.map(self.stem._cast)
        return self.stem._cast(t)

    def whole(self, t):
        return whole(t)

    def hyper_encode(self, y_cur_c, y_cond_c):
        if y_cur_c.shape[3] % (self.mesh.size * self._stride) == 0:
            return whole(halo_map(
                lambda *a: replica_on(self.stem, a[0].device)
                .module.hyper_encode(*a),
                (y_cur_c, y_cond_c), self.mesh, self._halo))
        return self.stem.module.hyper_encode(whole(y_cur_c), whole(y_cond_c))


class StemVideoPipeline:
    """(i_model: MeanScaleHyperprior, stem: SpatioTemporalPriorModel).

    Construct AFTER the models' final weights and ``update()``.

    ``transport_mode="sparse"`` (default) ships symbols as bitmask +
    compacted int8 nonzeros in grouped-by-CDF-row order
    (entropy/transport.py) and falls back to the dense int16 format when a
    frame overflows int8 or the values capacity, as the JAX package does;
    each enc dict records the transport it took. ``"dense"`` keeps the
    dense format whose y/z streams are byte-identical to the model API's.

    ``spatial_mesh`` (a parallel/spatial.py mesh): serve every frame
    W-split over it, frame W divisible by the mesh size × 16 (g_a's
    stride). g_a (``analysis``) and g_s run per shard, and so does the
    encoder's HE where the latent's W divides at its stride (else whole on
    the first device, ``_SplitHyperAnalysis``). y and z are gathered on
    the first device, where TPM, HD, EPM, the quantizer and the pack run on
    the whole latent, as the unsplit pipeline runs them: a stream encoded
    split decodes through any pipeline, split or not, to the same ŷ. The
    ŷ carry and x̂ come back ``Sharded``; ``spatial_axis`` must be the
    mesh's axis.
    """

    def __init__(self, i_model, stem, transport_mode: str = "sparse",
                 spatial_mesh=None, spatial_axis: str = SP_AXIS):
        if stem.use_spm:
            raise ValueError(
                "StemVideoPipeline drives the parallel (non-SPM) codec path; "
                "use WavefrontVideoPipeline for SPM variants"
            )
        if transport_mode not in ("sparse", "dense"):
            raise ValueError(f"unknown transport {transport_mode!r}")
        _require_deterministic(stem)
        stem._require_tables()
        self.i_model = i_model
        self.stem = stem
        self.transport_mode = transport_mode
        if spatial_mesh is not None:
            check_axis(spatial_mesh, spatial_axis)
            if spatial_mesh.devices[0] != canonical_device(stem.device):
                raise ValueError(f"the spatial mesh starts at "
                                 f"{spatial_mesh.devices[0]}, the models "
                                 f"are on {stem.device}")
        self._sp_mesh = spatial_mesh
        self._sp_axis = spatial_axis
        self._he = (None if spatial_mesh is None
                    else _SplitHyperAnalysis(stem, spatial_mesh))

    # -- device stages ---------------------------------------------------------

    def _sp_place(self, t):
        """t W-split over the spatial mesh (as it is without one)."""
        if self._sp_mesh is None:
            return t
        return shard_frame(t, self._sp_mesh, self._sp_axis)

    def _apply(self, method, t):
        """An I-model transform, W-split over the spatial mesh if any."""
        if self._sp_mesh is None:
            return getattr(self.i_model, method)(t)
        return spatial_apply(self.i_model, method, t, self._sp_mesh,
                             axis_name=self._sp_axis)

    def analysis(self, x):
        """g_a only, in the I-model's compute dtype."""
        return self._apply("analysis", x)

    @torch.no_grad()
    def _encode(self, x, y_cond):
        y_cur = self.analysis(x)
        return y_cur, self.stem.fused_encode_expr(y_cur, y_cond, self._he)

    @torch.no_grad()
    def _encode_sparse(self, x, y_cond):
        y_cur = self.analysis(x)
        packed, y_hat = self.stem.fused_encode_sparse_carry_expr(
            y_cur, y_cond, self._he)
        return y_cur, self._sp_place(y_hat), packed

    @torch.no_grad()
    def _synthesis(self, y_hat, frame=None):
        """g_s of ŷ (W-split over the spatial mesh if any), dispatched."""
        with trace.span("serve.gs_dispatch", frame=frame):
            return self._apply("get_x", y_hat)

    # -- encoder side ---------------------------------------------------------

    def _code_dense_buffer(self, packed, shape4):
        b, hgt, wid, m = shape4
        zh, zw = -(-hgt // 4), -(-wid // 4)
        zt = self.stem.tables["entropy_bottleneck"]
        zc = zt.rows
        ny = b * hgt * wid * m
        nz = b * zh * zw * zc
        y_sym = packed[: 2 * ny].view(np.int16).reshape(b, hgt, wid, m)
        z_sym = packed[2 * ny : 2 * (ny + nz)].view(np.int16).reshape(
            b, zh, zw, zc
        )
        idx = packed[2 * (ny + nz) :].reshape(b, hgt, wid, m).astype(np.int32)

        z_idx = entropy_base.bottleneck_indexes(z_sym.shape, zc)
        z_strings = entropy_base.compress(
            z_sym.astype(np.int32), z_idx, zt, self.stem.coder, stream="z"
        )
        y_strings = entropy_base.compress(
            y_sym.astype(np.int32), idx,
            self.stem.tables["gaussian_conditional"], self.stem.coder,
        )
        trace.count("transport.dense")
        return {
            "strings": [y_strings, z_strings],
            "shape": (zh, zw),
            "transport": "dense",
        }

    def _sparse_layout(self, shape4) -> transport.SparseLayout:
        b, hgt, wid, m = shape4
        zt = self.stem.tables["entropy_bottleneck"]
        gc = self.stem.tables["gaussian_conditional"]
        return transport.SparseLayout(
            b=b,
            n=hgt * wid * m,
            zn=(-(-hgt // 4)) * (-(-wid // 4)) * zt.rows,
            levels=int(gc.scale_table.shape[0]),
        )

    def code_sparse_buffer(self, packed, shape4):
        """Host half of the sparse encode (span ``transport.encode``):
        buffer → enc dict (or None on int8/capacity overflow — caller
        re-encodes dense)."""
        with trace.span("transport.encode"):
            layout = self._sparse_layout(shape4)
            planes = transport.unpack_encode(packed, layout)
            if planes.overflow:
                return None
            b, hgt, wid, m = shape4
            zh, zw = -(-hgt // 4), -(-wid // 4)
            zt = self.stem.tables["entropy_bottleneck"]
            z_idx = entropy_base.bottleneck_indexes((b, zh, zw, zt.rows),
                                                    zt.rows)
            z_strings = entropy_base.compress(
                planes.z_sym.reshape(b, zh, zw, zt.rows), z_idx, zt,
                self.stem.coder, stream="z",
            )
            y_strings = transport.encode_grouped(
                planes.y_sorted, planes.counts,
                self.stem.tables["gaussian_conditional"], self.stem.coder,
            )
        trace.count("transport.sparse")
        return {
            "strings": [y_strings, z_strings],
            "shape": (zh, zw),
            "transport": "sparse",
            # the 64 CDF-row counts ride in the container, so the decoder
            # runs host rANS with no device→host fetch per frame
            "counts": planes.counts,
        }

    def encode_frame(self, x, y_cond,
                     frame=None) -> Tuple[dict, torch.Tensor]:
        """x (B, 3, H, W) image, y_cond device-resident conditioning latent.

        Returns (enc dict with strings/shape/transport, carry latent). In
        sparse mode the carry is the decoder-consistent ŷ; the dense path
        returns the raw y_cur (the JAX package's contract for it).
        """
        with trace.span("serve.encode", frame=frame):
            if self.transport_mode == "sparse":
                y_cur, y_hat, packed = self._encode_sparse(x, y_cond)
                enc = self.code_sparse_buffer(_Download(packed).result(),
                                              _shape4(y_cur))
                if enc is not None:
                    return enc, y_hat
                # overflow → dense fallback (diverged/untrained models)
            y_cur, packed = self._encode(x, y_cond)
            return (self._code_dense_buffer(_Download(packed).result(),
                                            _shape4(y_cur)), y_cur)

    def encode_frames(self, frames, y_cond):
        """Encode a GOP of P-frames with the host coder of frame k overlapping
        the device work of frame k+1. `frames` is an iterable of (B, 3, H, W)
        images; yields enc dicts in order. The conditioning carry is the
        decoder-consistent ŷ, device-resident throughout."""
        if self.transport_mode != "sparse":
            for k, x in enumerate(frames):
                enc, y_cond = self.encode_frame(x, y_cond, frame=k)
                yield enc
            return
        pending = None  # (download, y_cur, x, y_cond_before, frame)
        for k, x in enumerate(frames):
            y_cond_before = y_cond
            with trace.span("serve.encode", frame=k):
                y_cur, y_hat, packed = self._encode_sparse(x, y_cond)
                download = _Download(packed)
            y_cond = y_hat  # device-resident carry
            if pending is not None:
                yield self._finish_encode(*pending)
            pending = (download, y_cur, x, y_cond_before, k)
        if pending is not None:
            yield self._finish_encode(*pending)

    def _finish_encode(self, download, y_cur, x, y_cond_before, frame=None):
        with trace.span("serve.encode.host", frame=frame):
            enc = self.code_sparse_buffer(download.result(), _shape4(y_cur))
            if enc is None:
                # int8 overflow → re-encode this frame densely. The sparse
                # carry clips at the dense int16 band, so frames already
                # dispatched against it stay decodable.
                _, packed = self._encode(x, y_cond_before)
                enc = self._code_dense_buffer(_Download(packed).result(),
                                              _shape4(y_cur))
        return enc

    # -- decoder side ---------------------------------------------------------

    def decode_frames(self, encs, y_cond):
        """Decode a sequence of enc dicts, carrying ŷ on device; yields
        (x_hat, y_hat) per frame."""
        for k, enc in enumerate(encs):
            x_hat, y_cond = self.decode_frame(enc, y_cond=y_cond, frame=k)
            yield x_hat, y_cond

    def _host_decode_sparse(self, enc):
        """Host half of the fetch-free sparse decode (span
        ``transport.decode``): rANS of z and of the grouped y (row counts
        from the container) → the packed payload [maskbits][values i8]
        [z_sym i8] and its layout."""
        with trace.span("transport.decode"):
            strings = enc["strings"]
            zh, zw = enc["shape"]
            b = len(strings[1])
            shape4 = (b, zh * 4, zw * 4, self.stem.in_channels)
            layout = self._sparse_layout(shape4)
            zt = self.stem.tables["entropy_bottleneck"]
            z_idx = entropy_base.bottleneck_indexes((b, zh, zw, zt.rows),
                                                    zt.rows)
            z_sym = entropy_base.decompress(strings[1], z_idx, zt,
                                            self.stem.coder, stream="z")
            counts = np.asarray(enc["counts"], np.int32)
            gc_tables = self.stem.tables["gaussian_conditional"]
            coder = self.stem.coder
            packed = transport.decode_grouped_packed(
                strings[0], counts, layout.cap, gc_tables, coder
            )
            if packed is not None:  # fused rANS → payload (native coders)
                maskbits, values = packed
            elif coder.supports_runs:  # the encoder never ships past cap
                raise ValueError("corrupt sparse frame: more nonzero "
                                 "symbols than the values capacity")
            else:
                maskbits, values = transport.pack_decode_payload(
                    transport.decode_grouped(strings[0], counts, gc_tables,
                                             coder), layout.cap)
            payload = np.concatenate([
                maskbits.reshape(-1),
                values.view(np.uint8).reshape(-1),
                np.ascontiguousarray(z_sym.astype(np.int8)).view(np.uint8)
                .reshape(-1),
            ])
            return payload, shape4, layout

    @torch.no_grad()
    def _sparse_latent(self, payload, shape4, layout, y_cond):
        """Device half up to ŷ: one upload, then params-from-ẑ, sparse
        unpack and reconstruct."""
        b, hgt, wid, m = shape4
        n, cap = layout.n, layout.cap
        zh, zw = -(-hgt // 4), -(-wid // 4)
        zc = self.stem.tables["entropy_bottleneck"].rows
        nbm, nval, nz = b * n // 8, b * cap, b * zh * zw * zc
        dev = trace.upload(torch.from_numpy(payload), self.stem.device,
                           non_blocking=True)
        maskbits = dev[:nbm].view(b, n // 8)
        values = dev[nbm:nbm + nval].view(torch.int8).view(b, cap)
        z_sym = (dev[nbm + nval:nbm + nval + nz].view(torch.int8)
                 .view(b, zh, zw, zc).permute(0, 3, 1, 2))
        y_cond = whole(y_cond)
        order, means = self.stem.fused_params_sparse_expr(z_sym, y_cond)
        return self._sp_place(self.stem.fused_reconstruct_sparse_expr(
            maskbits, values, order, means, y_cond
        ))

    def _device_decode_sparse(self, payload, shape4, layout, y_cond):
        """Device half: ``_sparse_latent``, then g_s. Returns (x_hat,
        y_hat)."""
        y_hat = self._sparse_latent(payload, shape4, layout, y_cond)
        return self._synthesis(y_hat), y_hat

    @torch.no_grad()
    def decode_frame(self, enc_or_strings, shape=None, y_cond=None,
                     frame=None):
        """decode_frame(enc, y_cond=...) or decode_frame(strings, shape,
        y_cond). Returns (x_hat, y_hat); y_hat is the next frame's
        conditioning. Sparse containers (which carry their row counts)
        decode with no device→host fetch; dense ones decode through the
        CDF-row index plane. ``frame`` names the frame in the spans.
        """
        with trace.span("serve.decode", frame=frame):
            y_hat = self._decode_latent(enc_or_strings, shape, y_cond)
        return self._synthesis(y_hat, frame), y_hat

    def _decode_latent(self, enc_or_strings, shape, y_cond):
        if isinstance(enc_or_strings, dict):
            if enc_or_strings.get("transport", "dense") == "sparse":
                return self._sparse_latent(
                    *self._host_decode_sparse(enc_or_strings), y_cond)
            strings = enc_or_strings["strings"]
            shape = enc_or_strings["shape"]
        else:
            strings = enc_or_strings
        zt = self.stem.tables["entropy_bottleneck"]
        z_idx = entropy_base.bottleneck_indexes(
            (len(strings[1]), *shape, zt.rows), zt.rows
        )
        z_sym = entropy_base.decompress(strings[1], z_idx, zt,
                                        self.stem.coder, stream="z")
        z_dev = _to_nchw(z_sym, self.stem.device)
        gc_tables = self.stem.tables["gaussian_conditional"]
        y_cond = whole(y_cond)
        means, idx = self.stem.fused_params_expr(z_dev, y_cond)
        idx_np = trace.fetch(idx.permute(0, 2, 3, 1)).astype(np.int32)
        y_sym = entropy_base.decompress(strings[0], idx_np, gc_tables,
                                        self.stem.coder)
        return self._sp_place(self.stem.fused_reconstruct_expr(
            _to_nchw(y_sym, self.stem.device), means, y_cond))

    # -- device-only GOP evaluation -------------------------------------------

    @torch.no_grad()
    def gop_forward(self, frames, y_cond):
        """The GOP's rate-estimation forward, with no host coding
        (eval/pipeline.py:413-443 of the JAX package): per frame g_a, the
        STEM forward (rounding), g_s of its ŷ, and bpp from the
        likelihoods, the ŷ carry on the device. frames (T, B, 3, H, W);
        returns (x̂ (T, B, 3, H, W), bpp_est (T, B) f64). The JAX package
        runs the loop as one scan; here it is a loop over T."""
        n_pix = frames.shape[-2] * frames.shape[-1]
        scale = -1.0 / (np.log(2.0) * n_pix)
        x_hats, bpps = [], []
        for x in frames:
            y_cur = self.i_model.analysis(x)
            out = self.stem.forward(y_cur, y_cond)
            y_cond = out["y_hat"]
            x_hats.append(self.i_model.get_x(y_cond))
            bpps.append(sum(
                torch.log(lk.float()).sum(dim=(1, 2, 3), dtype=torch.float64)
                for lk in out["likelihoods"].values()) * scale)
        return torch.stack(x_hats), torch.stack(bpps)

    def _replica(self, device):
        """This pipeline with its models on ``device`` (itself where they
        are there already), for a shard of ``gop_forward_sharded``."""
        if device == canonical_device(self.stem.device):
            return self
        return StemVideoPipeline(replica_on(self.i_model, device),
                                 replica_on(self.stem, device),
                                 self.transport_mode)

    def gop_forward_sharded(self, frames, y_cond, mesh,
                            axis_name: str = DATA_AXIS):
        """``gop_forward`` batch-split over a mesh (eval/pipeline.py:445-460
        of the JAX package): frames (T, B, 3, H, W) and the carry
        (B, M, h, w) split along B into equal shards, each shard's
        ``gop_forward`` on its device (through a copy of the models where
        that is not theirs) with its card current, the results concatenated
        along B on the first device. Raises where B does not divide the mesh
        size."""
        check_axis(mesh, axis_name)
        n = mesh.size
        if frames.shape[1] % n or y_cond.shape[0] % n:
            raise ValueError(f"batch {frames.shape[1]} does not split into "
                             f"{n} equal shards")
        outs = []
        for d, f, y in zip(mesh.devices, frames.chunk(n, dim=1),
                           y_cond.chunk(n, dim=0)):
            pipe = self._replica(d)
            with on_device(d):
                outs.append(pipe.gop_forward(f.to(d), y.to(d)))
        first = mesh.devices[0]
        return (torch.cat([o[0].to(first) for o in outs], dim=1),
                torch.cat([o[1].to(first) for o in outs], dim=1))


class WavefrontVideoPipeline:
    """Pipelined GOP server for the SPM variants' AR codec, the flagship
    tiled ``res`` (eval/pipeline.py:463-563 of the JAX package).

    Per P-frame: the model's wavefront encode (device rounds, then host
    rANS), its decode (one device round and one host rANS call per stream a
    round), then g_s of the decoded ŷ queued on the device, where the host
    does not wait for it. ŷ is the recurrence carry (evalSTEM.py:144-153),
    so x̂ never serializes the GOP on the host. g_s stays on the current
    stream: on a side stream it served no more frames/s on the H100
    (PERF.md §6, PR 10).

    Multi-stream serving: the batch axis is S independent GOP streams; the
    rounds stack every stream's tiles along the tile-batch axis and host rANS
    codes the streams one after another. Bitstreams are the model API's
    ``compress`` (the pipeline calls it).

    On CUDA, encoder and decoder must compute bit-identical (σ, μ): set
    ``torch.backends.cudnn.deterministic`` first.
    """

    def __init__(self, i_model, stem):
        if not stem.use_spm or stem.ar_mode != "wavefront":
            raise ValueError(
                "WavefrontVideoPipeline drives the wavefront-AR codec path; "
                "use StemVideoPipeline for parallel (non-SPM) variants"
            )
        _require_deterministic(stem)
        stem._require_tables()
        self.i_model = i_model
        self.stem = stem

    # -- single-frame pieces ----------------------------------------------

    def analysis(self, x):
        """g_a only (I-frame conditioning bootstrap / encode side)."""
        return self.i_model.analysis(x)

    def synthesis_async(self, y_hat):
        """g_s of ŷ, queued on the current stream; on the card it returns
        before x̂ is computed, and whatever reads x̂ there waits for it."""
        return self.i_model.get_x(y_hat)

    def encode_frame(self, y_cur, y_cond) -> dict:
        """The model API's wavefront encode. y_cur, y_cond: (S, M, h, w)
        latents, S = streams."""
        return self.stem.compress(y_cur, y_cond)

    def decode_frame(self, enc: dict, y_cond):
        """Wavefront decode; returns ŷ, the next frame's conditioning carry,
        on the device."""
        return self.stem.decompress(enc["strings"], tuple(enc["shape"]),
                                    y_cond)["y_hat"]

    # -- the pipelined GOP loop --------------------------------------------

    def serve_latent(self, y_cur, y_cond, frame: int = 0):
        """Codec round trip of one P-frame latent with the async-g_s
        schedule. Returns (enc, ŷ, x̂), x̂ possibly still in flight."""
        with trace.span("serve.encode", frame=frame):
            enc = self.encode_frame(y_cur, y_cond)
        with trace.span("serve.decode", frame=frame):
            y_hat = self.decode_frame(enc, y_cond)
        with trace.span("serve.gs_dispatch", frame=frame):
            return enc, y_hat, self.synthesis_async(y_hat)

    def serve_gop(self, frames, y_cond, latents: bool = False):
        """Serve a GOP of P-frames (pixels, or latents with latents=True)
        through the pipelined loop. Returns (encs, x̂ per frame, final ŷ);
        waits only for the last frame's x̂, the last work queued."""
        encs, x_hats = [], []
        for k, x in enumerate(frames):
            y_cur = x if latents else self.analysis(x)
            enc, y_cond, x_hat = self.serve_latent(y_cur, y_cond, frame=k)
            encs.append(enc)
            x_hats.append(x_hat)
        if x_hats and y_cond.device.type == "cuda":
            torch.cuda.current_stream(y_cond.device).synchronize()
        return encs, x_hats, y_cond
