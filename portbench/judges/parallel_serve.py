"""The parallel STEM's served step (the sparse transport): ``g_a``,
``g_s`` and ``y_hat``, where the reference decodes the program's z and y
streams with its own tables, its own (σ, μ) and CDF rows; ``y_hat`` is the
largest of |ŷ − ŷ_ref| over the encoder's carry and the decoder's ŷ and of
how far each decoded symbol (ẑ's and y's) is from being a rounding of what
it codes, over max |μ_ref|. A row count that differs from the container's,
or a stream that does not parse, reads as a whole symbol (1 / max
|μ_ref|)."""

import numpy as np
import torch

from portbench import judge as J
from portbench import rans
from portbench import reference as R

NAMES = ("g_a", "g_s", "y_hat")


@torch.no_grad()
def parallel_encode(ref, y_cur, y_cond, p=R.F32):
    """The encoder's quantities of one step: ẑ's symbols, (σ, μ), the
    y symbols, their CDF rows and the ŷ they give."""
    S = ref.S
    z = R.he(S, y_cur, y_cond, p)
    z_sym = torch.clamp(torch.round(z.float() - ref.med32), -R.I16, R.I16)
    sigma, mu = R.epm(S, R.priors(S, z_sym + ref.med32, y_cond, p), p)
    sigma, mu = sigma.float(), mu.float()
    sym = torch.clamp(torch.round(y_cur.float() - mu), -R.I16, R.I16)
    idx = R.cdf_index(sigma, ref.table)
    return z_sym, mu, sym, idx, sym + mu


def _z_strings_np(ref, z_sym):
    """ẑ's symbols and rows per picture in the bottleneck's wire order
    (channel, row, column)."""
    z = z_sym.to(torch.int64).cpu().numpy()
    rows = np.broadcast_to(np.arange(z.shape[1])[:, None, None], z.shape[1:])
    return [(z[i].reshape(-1), rows.reshape(-1)) for i in range(z.shape[0])]


@torch.no_grad()
def judge(ref, rec):
    """The sparse transport's step. The reference decodes the program's z
    streams (each symbol must be a rounding of the reference's z − median),
    works out (σ, μ) and the CDF rows from that ẑ, its nets in the served
    dtype, checks the row counts the container carries, decodes the y
    streams in the rows' grouped order, and holds the program's carry and
    decoded ŷ to sym + μ, each symbol a rounding of y − μ."""
    x, y_cur, y_cond = rec["x"], rec["y_cur"].float(), rec["y_cond"]
    out = {"g_a": J.rel(y_cur, R.g_a(ref.I, x))}
    S, dt = ref.S_net, ref.net_dtype
    y_strings, z_strings = rec["strings"]
    b = y_cur.shape[0]
    y_cond_n = y_cond.to(dt)
    z = R.he(S, y_cur.to(dt), y_cond_n).float() - ref.med32
    bad = len(y_strings) != b or len(z_strings) != b
    gap, mu_max = 0.0, 1e-30
    if not bad:
        z_sym = torch.from_numpy(J.decode_z(ref, z_strings, z.shape)).to(
            z.device).float()
        gap = J.rounding_gap(z, z_sym)
        sigma, mu = R.epm(S, R.priors(S, (z_sym + ref.med32).to(dt),
                                      y_cond_n))
        sigma, mu = sigma.float(), mu.float()
        mu_max = float(mu.abs().max().clamp_min(1e-30))
        idx_flat = R.nhwc_flat(R.cdf_index(sigma, ref.table)).cpu().numpy()
        counts = np.stack([np.bincount(r, minlength=ref.levels)
                           for r in idx_flat])
        bad = not np.array_equal(counts, np.asarray(rec["counts"]))
    if not bad:
        sym = np.empty(idx_flat.shape, np.int64)
        for i in range(b):
            got = rans.decode_runs(y_strings[i], counts[i], ref.gt)
            if got is None:
                bad = True
                break
            sym[i, np.argsort(idx_flat[i], kind="stable")] = got
    if not bad:
        _, m, h, w = mu.shape
        y_hat = torch.from_numpy(sym).to(mu.device).float().view(
            b, h, w, m).permute(0, 3, 1, 2) + mu
        gap = max(gap, J.rounding_gap(y_cur, y_hat),
                  float((rec["carry"] - y_hat).abs().max()),
                  float((rec["y_hat_dec"] - y_hat).abs().max()))
    out["y_hat"] = (1.0 if bad else gap) / mu_max
    out["g_s"] = float((rec["x_hat"].float()
                        - R.g_s(ref.I, rec["y_hat_dec"].float()))
                       .abs().max())
    return out


@torch.no_grad()
def control(ref, st, k, y_cond, p):
    """The reference in the program's place at precision ``p`` on P-frame
    ``k``: the step's record, its bitstreams coded with the reference's own
    coder, and the carry it hands on."""
    x = st.frames[k]
    y_cur = R.g_a(ref.I, x, p)
    z_sym, mu, sym, idx, y_hat = parallel_encode(ref, y_cur, y_cond, p)
    idx_flat = R.nhwc_flat(idx).cpu().numpy()
    sym_flat = R.nhwc_flat(sym).to(torch.int64).cpu().numpy()
    counts = np.stack([np.bincount(r, minlength=ref.levels) for r in idx_flat])
    y_strings = []
    for i in range(len(idx_flat)):
        order = np.argsort(idx_flat[i], kind="stable")
        y_strings.append(rans.encode_runs(sym_flat[i][order], counts[i],
                                          ref.gt))
    z_strings = [rans.encode(s, r, ref.zt) for s, r in _z_strings_np(ref,
                                                                     z_sym)]
    return {"x": x, "y_cur": y_cur, "y_cond": y_cond, "carry": y_hat,
            "strings": [y_strings, z_strings], "counts": counts,
            "y_hat_dec": y_hat, "x_hat": R.g_s(ref.I, y_hat, p)}, y_hat
