"""The wavefront STEM's served step (res, tiled): ``g_a``, ``g_s`` and
``y_hat``, where per picture the reference decodes the program's z stream
and then its y stream round by round with its own (σ, μ) and CDF rows, and
``y_hat`` is the largest gap of the program's ŷ to what it decodes and of
each symbol from a rounding of what it codes, over max |μ_ref|."""

import numpy as np
import torch

from portbench import judge as J
from portbench import rans
from portbench import reference as R

NAMES = ("g_a", "g_s", "y_hat")


def _tile(t, th, tw):
    """NCHW (b, m, h, w) → NHWC tiles (b·nt, th, tw, m), raster order."""
    b, m, h, w = t.shape
    t = t.permute(0, 2, 3, 1).reshape(b, h // th, th, w // tw, tw, m)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(-1, th, tw, m)


def _untile(t, b, h, w):
    _, th, tw, m = t.shape
    t = t.reshape(b, h // th, w // tw, th, tw, m).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, h, w, m).permute(0, 3, 1, 2)


def _rounds(th, tw):
    """Pixels of a th×tw tile by wavefront round 3·row + column (the
    dependency set of a 5×5 raster-causal mask lies below that line)."""
    rounds = {}
    for i in range(th):
        for j in range(tw):
            rounds.setdefault(3 * i + j, []).append((i, j))
    return [rounds[t] for t in sorted(rounds)]


class _AR:
    """One picture's autoregressive pass over its tiles: per round the
    causal taps of each tile's pixel, the context, EPM on the rows, (σ, μ),
    the CDF rows; the caller supplies the round's symbols."""

    def __init__(self, ref, prior_tiles, p):
        self.ref, self.p = ref, p
        nt, th, tw, pc = prior_tiles.shape
        self.m = ref.cfg["in_channels"]
        self.priors = prior_tiles
        self.plane = torch.zeros((nt, th + 4, tw + 4, self.m),
                                 device=prior_tiles.device)

    def params(self, pixels):
        hh = torch.tensor([q[0] for q in pixels], device=self.plane.device)
        ww = torch.tensor([q[1] for q in pixels], device=self.plane.device)
        dh = torch.tensor([t[0] for t in R.TAPS], device=self.plane.device)
        dw = torch.tensor([t[1] for t in R.TAPS], device=self.plane.device)
        taps = self.plane[:, hh[:, None] + dh, ww[:, None] + dw, :]
        n = taps.shape[0] * taps.shape[1]
        ctx = R.context(self.ref.S, taps.reshape(n, -1), self.p)
        pv = self.priors[:, hh, ww, :].reshape(n, -1)
        sigma, mu = R.epm_rows(self.ref.S, torch.cat([pv, ctx], 1), self.p)
        return hh, ww, mu.float(), R.cdf_index(sigma.float(), self.ref.table)

    def write(self, hh, ww, sym, mu):
        nt = self.plane.shape[0]
        self.plane[:, hh + 2, ww + 2, :] = (sym + mu).view(nt, -1, self.m)


@torch.no_grad()
def wavefront_encode(ref, y_cur, y_cond, p=R.F32):
    """The encoder's quantities of one step: per picture ẑ's symbols (the
    host's f64 rounding around the medians), the y symbols and CDF rows in
    wire order (round, tile, channel), ŷ, and max |μ| over the step."""
    S, cfg = ref.S, ref.cfg
    th, tw = cfg["wavefront_tile"]
    b, m, h, w = y_cur.shape
    med64 = ref.zt.medians
    z_syms, y_wire, y_hat, mu_max = [], [], [], 1e-30
    for i in range(b):
        yc, yp = y_cur[i:i + 1], y_cond[i:i + 1]
        z = R.he(S, yc, yp, p).float().permute(0, 2, 3, 1).cpu().numpy()
        zs = np.clip(np.round(z.astype(np.float64) - med64), -(1 << 30),
                     1 << 30)
        z_hat = torch.from_numpy((zs + med64).astype(np.float32)).to(
            y_cur.device).permute(0, 3, 1, 2).contiguous()
        z_syms.append(zs.astype(np.int64)[0].transpose(2, 0, 1))
        pri = _tile(R.priors(S, z_hat, yp, p), th, tw)
        target = _tile(yc - yp, th, tw)
        ar = _AR(ref, pri, p)
        syms, rows = [], []
        for pixels in _rounds(th, tw):
            hh, ww, mu, idx = ar.params(pixels)
            centre = target[:, hh, ww, :].reshape(mu.shape)
            sym = torch.clamp(torch.round(centre - mu), -32768, 32767)
            ar.write(hh, ww, sym, mu)
            mu_max = max(mu_max, float(mu.abs().max()))
            syms.append(sym.reshape(-1))
            rows.append(idx.reshape(-1))
        t_hat = ar.plane[:, 2:-2, 2:-2, :]
        y_hat.append(_untile(t_hat, 1, h, w) + yp)
        y_wire.append((torch.cat(syms).to(torch.int64).cpu().numpy(),
                       torch.cat(rows).cpu().numpy()))
    return z_syms, y_wire, torch.cat(y_hat), mu_max


@torch.no_grad()
def wavefront_decode(ref, y_string, z_sym, y_cond1):
    """The reference's decode of one picture's y stream, the rows of each
    round from its own (σ, μ) on what it decoded before: (target ŷ, the
    largest |μ|)."""
    S, cfg = ref.S, ref.cfg
    th, tw = cfg["wavefront_tile"]
    z_hat = torch.from_numpy(((z_sym.transpose(1, 2, 0) + ref.zt.medians)
                              .astype(np.float32))[None]).to(
        y_cond1.device).permute(0, 3, 1, 2).contiguous()
    pri = _tile(R.priors(S, z_hat, y_cond1), th, tw)
    ar = _AR(ref, pri, R.F32)
    dec = rans.Decoder(y_string, ref.gt)
    mu_max = 1e-30
    for pixels in _rounds(th, tw):
        hh, ww, mu, idx = ar.params(pixels)
        mu_max = max(mu_max, float(mu.abs().max()))
        sym = dec.decode(idx.reshape(-1).cpu().numpy())
        ar.write(hh, ww, torch.from_numpy(sym).to(mu.device).float()
                 .view(mu.shape), mu)
    _, m, h, w = y_cond1.shape
    return _untile(ar.plane[:, 2:-2, 2:-2, :], 1, h, w), mu_max


@torch.no_grad()
def judge(ref, rec):
    """The wavefront step. Per picture the reference decodes the program's
    z stream (each symbol a rounding of the reference's z − median, on the
    host's f64 path), then its y stream round by round with its own rows,
    and holds the program's ŷ to the residual it decodes plus y_cond, each
    symbol a rounding of the target y_cur − y_cond less μ."""
    x, y_cur, y_cond = rec["x"], rec["y_cur"], rec["y_cond"]
    out = {"g_a": J.rel(rec["y_ga"], R.g_a(ref.I, x))}
    y_strings, z_strings = rec["strings"]
    b = y_cur.shape[0]
    bad = len(y_strings) != b or len(z_strings) != b
    gap, mu_max = 0.0, 1e-30
    med64 = ref.zt.medians
    for i in range(0 if bad else b):
        yc, yp = y_cur[i:i + 1], y_cond[i:i + 1]
        z = R.he(ref.S, yc, yp).float()[0].cpu().numpy().astype(np.float64)
        z = z - med64[:, None, None]
        z_sym = J.decode_z(ref, z_strings[i:i + 1], (1, *z.shape))[0]
        gap = max(gap, float(np.abs(z - z_sym).max()) - 0.5)
        t_hat, mu_i = wavefront_decode(ref, y_strings[i], z_sym, yp)
        mu_max = max(mu_max, mu_i)
        gap = max(gap, J.rounding_gap(yc - yp, t_hat),
                  float((rec["y_hat_dec"][i:i + 1] - (t_hat + yp))
                        .abs().max()))
    out["y_hat"] = (1.0 if bad else max(gap, 0.0)) / mu_max
    out["g_s"] = float((rec["x_hat"].float()
                        - R.g_s(ref.I, rec["y_hat_dec"].float()))
                       .abs().max())
    return out


@torch.no_grad()
def control(ref, st, k, y_cond, p):
    """The reference in the program's place at precision ``p`` on P-frame
    ``k`` (the loop's latent: the carry plus the GOP position's noise): the
    step's record with streams from the reference's own coder, and the
    carry it hands on."""
    x = st.frames[k]
    y_ga = R.g_a(ref.I, x, p)
    y_cur = y_cond + st.noise[k] + 1e-30 * y_ga.float().mean()
    z_syms, y_wire, y_hat, _ = wavefront_encode(ref, y_cur, y_cond, p)
    y_strings = [rans.encode(s, r, ref.gt) for s, r in y_wire]
    z_strings = []
    for zs in z_syms:
        rows = np.broadcast_to(np.arange(zs.shape[0])[:, None, None],
                               zs.shape).reshape(-1)
        z_strings.append(rans.encode(zs.reshape(-1), rows, ref.zt))
    return {"x": x, "y_cur": y_cur, "y_cond": y_cond, "y_ga": y_ga,
            "strings": [y_strings, z_strings], "y_hat_dec": y_hat,
            "x_hat": R.g_s(ref.I, y_hat, p)}, y_hat
