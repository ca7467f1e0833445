"""Rate estimation's step (the STEM forward of one frame): ŷ, the
estimated bits per pixel from y's and z's likelihoods, and x̂."""

import numpy as np
import torch

from portbench import judge as J
from portbench import reference as R

NAMES = ("g_a", "g_s", "y_hat", "bpp")
# Where the program's latent counts for the rate: 3.8 × the largest gap of
# a sound f32 run's latent to the reference's (7.87e-6 of max |y_ref|), a
# 44th of the TF32 control's least (1.33e-3).
NEAR = 3e-5


@torch.no_grad()
def estimate(ref, y_cur, y_cond, p=R.F32):
    """The STEM forward of one frame: ŷ and the estimated bits per pixel of
    each picture (y and z likelihoods, H·W of the frame = 256·h·w)."""
    S = ref.S
    z = R.he(S, y_cur, y_cond, p).float()
    med = ref.med32
    z_hat = torch.round(z - med) + med
    c = z.shape[1]
    perm = z_hat.permute(1, 0, 2, 3).reshape(c, 1, -1)
    z_lk = R.eb_likelihood(ref.eb_params, perm, p)
    z_lk = z_lk.reshape(c, z.shape[0], *z.shape[2:]).permute(1, 0, 2, 3)
    sigma, mu = R.epm(S, R.priors(S, z_hat, y_cond, p), p)
    sigma, mu = sigma.float(), mu.float()
    y_hat = p.q(torch.round(y_cur.float() - mu) + mu)
    y_lk = R.gaussian_likelihood(y_hat - mu, sigma)
    n_pix = 256 * y_cur.shape[2] * y_cur.shape[3]
    bits = (torch.log(y_lk.double()).sum((1, 2, 3))
            + torch.log(z_lk.double()).sum((1, 2, 3)))
    return y_hat, -bits / (np.log(2.0) * n_pix)


@torch.no_grad()
def judge(ref, rec):
    """``g_a``; ``y_hat``: the gap over the elements whose symbol agrees
    and how far each symbol is from a rounding of y − μ (with the slack of
    ŷ's dtype), over max |ŷ_ref| (ŷ_ref from the program's latent);
    ``bpp``: the largest relative gap of a picture's estimated bits per
    pixel (y's and z's likelihoods) to the reference's rate of the same
    frame, through its own g_a except where the program's latent lies
    within ``NEAR`` · max |y_ref| of it; ``g_s``. The surgery leaves (σ, μ)
    all but independent of the nets' arithmetic, so the rate of the
    program's own latent does not tell TF32 from f32: only the symbols that
    g_a's rounding moves do. Through the reference's g_a alone, though, a
    sound run's symbol moved by g_a's last bits (1-2 a picture) costs up to
    9 bits on a channel of small σ."""
    x, y_cur, y_cond = rec["x"], rec["y_cur"], rec["y_cond"].float()
    y_ref = R.g_a(ref.I, x)
    out = {"g_a": J.rel(y_cur, y_ref)}
    y_cur = y_cur.float()
    y_hat, _ = estimate(ref, y_cur, y_cond)
    near = (y_cur - y_ref).abs() <= NEAR * y_ref.abs().max()
    _, bpp = estimate(ref, torch.where(near, y_cur, y_ref), y_cond)
    y_p = rec["y_hat"].float()
    d = (y_p - y_hat).abs()
    flip = d >= 0.5
    # a symbol may differ only where y − μ lies within the roundings (in
    # ŷ's dtype) of ŷ and of y − μ of a tie: each must still be a rounding
    # of y − μ
    slack = torch.finfo(rec["y_hat"].dtype).eps * (y_p.abs() + 1.0)
    quant = float((((y_cur.float() - y_p).abs() - slack).max() - 0.5)
                  .clamp_min(0.0))
    out["y_hat"] = (max(float(torch.where(flip, 0.0, d).max()), quant)
                    / float(y_hat.abs().max().clamp_min(1e-30)))
    out["bpp"] = float(((rec["bpp"].double() - bpp).abs() / bpp).max())
    out["g_s"] = float((rec["x_hat"].float()
                        - R.g_s(ref.I, rec["y_hat"].float())).abs().max())
    return out


@torch.no_grad()
def control(ref, st, k, y_cond, p):
    """The reference in the program's place at precision ``p`` on P-frame
    ``k``: the step's record and the ŷ it hands on."""
    x = st.frames[k]
    y_cur = R.g_a(ref.I, x, p)
    y_hat, bpp = estimate(ref, y_cur, y_cond, p)
    return {"x": x, "y_cur": y_cur, "y_cond": y_cond, "y_hat": y_hat,
            "bpp": bpp, "x_hat": R.g_s(ref.I, y_hat, p)}, y_hat
