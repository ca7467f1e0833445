"""P-frame serving pipeline: I-model transforms + STEM codec + host rANS.

Counterpart of spatiotemporalentropymodel_tpu/eval/pipeline.py::
StemVideoPipeline, eager PyTorch on one device:

  encode: g_a → HE → EB-quantize → entropy params → quantize_and_index →
          packed transport buffer (one D2H copy) → host rANS
  decode: host rANS (z, then grouped y with the row counts the container
          carries) → one packed upload → params-from-ẑ + sparse unpack +
          reconstruct + g_s, with no device→host fetch

Frames and latents are NCHW tensors on the models' device; the conditioning
latent stays there across frames (GOP recurrence, stem/evalSTEM.py:93-153).
After ``set_compute_dtype(torch.bfloat16)`` on both models the transforms run
in bf16: the frame is cast at ``analysis``, x̂ comes back in bf16, and the ŷ
carry and the codec math stay f32. The JAX package's spatial-mesh serving
waits for the ``parallel`` slice.
"""

from typing import Tuple

import numpy as np
import torch

from ..entropy import base as entropy_base
from ..entropy import transport
from ..models.base import _to_nchw


def _shape4(y):
    """NCHW latent → the (b, h, w, m) shape the host side uses."""
    b, m, h, w = y.shape
    return (b, h, w, m)


class _Download:
    """A device→host copy of a packed buffer in flight: the copy is queued on
    the current stream into pinned memory, so the host can code the previous
    frame while the device works on this one."""

    def __init__(self, packed):
        if packed.device.type == "cuda":
            self._host = torch.empty(packed.shape, dtype=packed.dtype,
                                     pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = packed, None

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class StemVideoPipeline:
    """(i_model: MeanScaleHyperprior, stem: SpatioTemporalPriorModel).

    Construct AFTER the models' final weights and ``update()``.

    ``transport_mode="sparse"`` (default) ships symbols as bitmask +
    compacted int8 nonzeros in grouped-by-CDF-row order
    (entropy/transport.py) and falls back to the dense int16 format when a
    frame overflows int8 or the values capacity, as the JAX package does;
    each enc dict records the transport it took. ``"dense"`` keeps the
    dense format whose y/z streams are byte-identical to the model API's.
    """

    def __init__(self, i_model, stem, transport_mode: str = "sparse"):
        if transport_mode not in ("sparse", "dense"):
            raise ValueError(f"unknown transport {transport_mode!r}")
        cudnn = torch.backends.cudnn
        if stem.device.type == "cuda" and not cudnn.deterministic:
            # encoder and decoder must compute bit-identical (σ, μ) from ẑ;
            # a nondeterministic cuDNN algorithm breaks the decode
            raise RuntimeError("set torch.backends.cudnn.deterministic = True "
                               "before serving on CUDA")
        stem._require_tables()
        self.i_model = i_model
        self.stem = stem
        self.transport_mode = transport_mode

    # -- device stages ---------------------------------------------------------

    def analysis(self, x):
        """g_a only, in the I-model's compute dtype."""
        return self.i_model.analysis(x)

    @torch.no_grad()
    def _encode(self, x, y_cond):
        y_cur = self.analysis(x)
        return y_cur, self.stem.fused_encode_expr(y_cur, y_cond)

    @torch.no_grad()
    def _encode_sparse(self, x, y_cond):
        y_cur = self.analysis(x)
        packed, y_hat = self.stem.fused_encode_sparse_carry_expr(y_cur, y_cond)
        return y_cur, y_hat, packed

    @torch.no_grad()
    def _finish(self, y_sym, means, y_cond):
        y_hat = self.stem.fused_reconstruct_expr(y_sym, means, y_cond)
        return y_hat, self.i_model.get_x(y_hat)

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
            z_sym.astype(np.int32), z_idx, zt, self.stem.coder
        )
        y_strings = entropy_base.compress(
            y_sym.astype(np.int32), idx,
            self.stem.tables["gaussian_conditional"], self.stem.coder,
        )
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
        """Host half of the sparse encode: buffer → enc dict (or None on
        int8/capacity overflow — caller re-encodes dense)."""
        layout = self._sparse_layout(shape4)
        planes = transport.unpack_encode(packed, layout)
        if planes.overflow:
            return None
        b, hgt, wid, m = shape4
        zh, zw = -(-hgt // 4), -(-wid // 4)
        zt = self.stem.tables["entropy_bottleneck"]
        z_idx = entropy_base.bottleneck_indexes((b, zh, zw, zt.rows), zt.rows)
        z_strings = entropy_base.compress(
            planes.z_sym.reshape(b, zh, zw, zt.rows), z_idx, zt,
            self.stem.coder,
        )
        y_strings = transport.encode_grouped(
            planes.y_sorted, planes.counts,
            self.stem.tables["gaussian_conditional"], self.stem.coder,
        )
        return {
            "strings": [y_strings, z_strings],
            "shape": (zh, zw),
            "transport": "sparse",
            # the 64 CDF-row counts ride in the container, so the decoder
            # runs host rANS with no device→host fetch per frame
            "counts": planes.counts,
        }

    def encode_frame(self, x, y_cond) -> Tuple[dict, torch.Tensor]:
        """x (B, 3, H, W) image, y_cond device-resident conditioning latent.

        Returns (enc dict with strings/shape/transport, carry latent). In
        sparse mode the carry is the decoder-consistent ŷ; the dense path
        returns the raw y_cur (the JAX package's contract for it).
        """
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
            for x in frames:
                enc, y_cond = self.encode_frame(x, y_cond)
                yield enc
            return
        pending = None  # (download, y_cur, x, y_cond_before)
        for x in frames:
            y_cond_before = y_cond
            y_cur, y_hat, packed = self._encode_sparse(x, y_cond)
            y_cond = y_hat  # device-resident carry
            download = _Download(packed)
            if pending is not None:
                yield self._finish_encode(*pending)
            pending = (download, y_cur, x, y_cond_before)
        if pending is not None:
            yield self._finish_encode(*pending)

    def _finish_encode(self, download, y_cur, x, y_cond_before):
        enc = self.code_sparse_buffer(download.result(), _shape4(y_cur))
        if enc is None:
            # int8 overflow → re-encode this frame densely. The sparse carry
            # clips at the dense int16 band, so frames already dispatched
            # against it stay decodable.
            _, packed = self._encode(x, y_cond_before)
            enc = self._code_dense_buffer(_Download(packed).result(),
                                          _shape4(y_cur))
        return enc

    # -- decoder side ---------------------------------------------------------

    def decode_frames(self, encs, y_cond):
        """Decode a sequence of enc dicts, carrying ŷ on device; yields
        (x_hat, y_hat) per frame."""
        for enc in encs:
            x_hat, y_cond = self.decode_frame(enc, y_cond=y_cond)
            yield x_hat, y_cond

    def _host_decode_sparse(self, enc):
        """Host half of the fetch-free sparse decode: rANS of z and of the
        grouped y (row counts from the container) → the packed payload
        [maskbits][values i8][z_sym i8] and its layout."""
        strings = enc["strings"]
        zh, zw = enc["shape"]
        b = len(strings[1])
        shape4 = (b, zh * 4, zw * 4, self.stem.in_channels)
        layout = self._sparse_layout(shape4)
        zt = self.stem.tables["entropy_bottleneck"]
        z_idx = entropy_base.bottleneck_indexes((b, zh, zw, zt.rows), zt.rows)
        z_sym = entropy_base.decompress(strings[1], z_idx, zt, self.stem.coder)
        counts = np.asarray(enc["counts"], np.int32)
        gc_tables = self.stem.tables["gaussian_conditional"]
        packed = transport.decode_grouped_packed(
            strings[0], counts, layout.cap, gc_tables, self.stem.coder
        )
        if packed is None:  # the encoder never ships more nonzeros than cap
            raise ValueError("corrupt sparse frame: more nonzero symbols "
                             "than the values capacity")
        maskbits, values = packed
        payload = np.concatenate([
            maskbits.reshape(-1),
            values.view(np.uint8).reshape(-1),
            np.ascontiguousarray(z_sym.astype(np.int8)).view(np.uint8)
            .reshape(-1),
        ])
        return payload, shape4, layout

    @torch.no_grad()
    def _device_decode_sparse(self, payload, shape4, layout, y_cond):
        """Device half: one upload, then params-from-ẑ, sparse unpack,
        reconstruct and g_s. Returns (x_hat, y_hat)."""
        b, hgt, wid, m = shape4
        n, cap = layout.n, layout.cap
        zh, zw = -(-hgt // 4), -(-wid // 4)
        zc = self.stem.tables["entropy_bottleneck"].rows
        nbm, nval, nz = b * n // 8, b * cap, b * zh * zw * zc
        dev = torch.from_numpy(payload).to(self.stem.device, non_blocking=True)
        maskbits = dev[:nbm].view(b, n // 8)
        values = dev[nbm:nbm + nval].view(torch.int8).view(b, cap)
        z_sym = (dev[nbm + nval:nbm + nval + nz].view(torch.int8)
                 .view(b, zh, zw, zc).permute(0, 3, 1, 2))
        order, means = self.stem.fused_params_sparse_expr(z_sym, y_cond)
        y_hat = self.stem.fused_reconstruct_sparse_expr(
            maskbits, values, order, means, y_cond
        )
        return self.i_model.get_x(y_hat), y_hat

    def decode_frame(self, enc_or_strings, shape=None, y_cond=None):
        """decode_frame(enc, y_cond=...) or decode_frame(strings, shape,
        y_cond). Returns (x_hat, y_hat); y_hat is the next frame's
        conditioning. Sparse containers (which carry their row counts)
        decode with no device→host fetch; dense ones decode through the
        CDF-row index plane.
        """
        if isinstance(enc_or_strings, dict):
            if enc_or_strings.get("transport", "dense") == "sparse":
                return self._device_decode_sparse(
                    *self._host_decode_sparse(enc_or_strings), y_cond
                )
            strings = enc_or_strings["strings"]
            shape = enc_or_strings["shape"]
        else:
            strings = enc_or_strings
        zt = self.stem.tables["entropy_bottleneck"]
        z_idx = entropy_base.bottleneck_indexes(
            (len(strings[1]), *shape, zt.rows), zt.rows
        )
        z_sym = entropy_base.decompress(strings[1], z_idx, zt, self.stem.coder)
        z_dev = _to_nchw(z_sym, self.stem.device)
        gc_tables = self.stem.tables["gaussian_conditional"]
        means, idx = self.stem.fused_params_expr(z_dev, y_cond)
        idx_np = idx.permute(0, 2, 3, 1).cpu().numpy().astype(np.int32)
        y_sym = entropy_base.decompress(strings[0], idx_np, gc_tables,
                                        self.stem.coder)
        y_hat, x_hat = self._finish(_to_nchw(y_sym, self.stem.device), means,
                                    y_cond)
        return x_hat, y_hat
