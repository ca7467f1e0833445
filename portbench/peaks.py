"""The chip's peaks and the work of the codec's layers, from their shapes.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W.
``bound``, ``gdn_bound`` and ``fused_bound`` are copies of the program's
``chip_smoke.py`` bound functions, kept for per-kernel readers (a file of
the benchmark is not edited once it is in); ``transform_bound_s`` applies
their rule to a whole transform. Operations count the products of every
convolution and of each (I)GDN's norm (2 per multiply-add), as
``torch.utils.flop_counter`` counts them; the norms' elementwise work is
added where a bound needs it (``norm_ops``).
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # CUDA cores, TF32 off
BF16_TC_FLOPS_PER_S = 989e12  # tensor cores, dense
PEAK = {"float32": F32_FLOPS_PER_S, "bfloat16": BF16_TC_FLOPS_PER_S}
BYTES = {"float32": 4, "bfloat16": 2}


def norm_ops(pixels, c):
    """f32 operations of a (I)GDN over ``pixels`` pixels of c channels."""
    return 2 * pixels * c * c + 4 * pixels * c


def bound(bytes_moved, ops):
    """Least ms: bytes over the memory rate or f32 operations over the CUDA
    cores' peak, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gdn_bound(bytes_moved, pixels, c, products):
    """Least ms of a lone (I)GDN: its norm in f32 on the CUDA cores (a) or
    as ``products`` bf16 products on the tensor cores (b), split so that
    both finish together (a·b/(a + b)), against the bytes."""
    a = norm_ops(pixels, c) / F32_FLOPS_PER_S
    b = products * 2 * pixels * c * c / BF16_TC_FLOPS_PER_S
    t_ops = a * b / (a + b) * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_bound(bytes_moved, norm_pixels, c, conv_ops):
    """Least ms of a fused (I)GDN + conv: the conv on the bf16 tensor cores,
    the norm shared between the CUDA cores and three bf16 products on the
    tensor cores, against the bytes."""
    a = norm_ops(norm_pixels, c) / F32_FLOPS_PER_S
    b = 3 * 2 * norm_pixels * c * c / BF16_TC_FLOPS_PER_S
    cc = conv_ops / BF16_TC_FLOPS_PER_S
    t_ops = (cc if a <= cc else a * (b + cc) / (a + b)) * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- layer work ---------------------------------------------------------------


def conv(cin, cout, k, h_out, w_out):
    return 2 * cin * cout * k * k * h_out * w_out


def deconv(cin, cout, k, h_in, w_in):
    return 2 * cin * cout * k * k * h_in * w_in


def g_a_layers(n, m, h, w):
    """(conv operations, [(pixels, C) of each GDN], weights) of g_a on one
    h×w picture."""
    ops, norms, weights = 0, [], 0
    chans = [3, n, n, n, m]
    for j in range(4):
        h, w = (h + 1) // 2, (w + 1) // 2
        ops += conv(chans[j], chans[j + 1], 5, h, w)
        weights += 25 * chans[j] * chans[j + 1] + chans[j + 1]
        if j < 3:
            norms.append((h * w, n))
            weights += n * n + n
    return ops, norms, weights


def g_s_layers(n, m, h, w):
    """The same of g_s from an h×w latent."""
    ops, norms, weights = 0, [], 0
    chans = [m, n, n, n, 3]
    for j in range(4):
        ops += deconv(chans[j], chans[j + 1], 5, h, w)
        weights += 25 * chans[j] * chans[j + 1] + chans[j + 1]
        h, w = 2 * h, 2 * w
        if j < 3:
            norms.append((h * w, n))
            weights += n * n + n
    return ops, norms, weights


def transform_ops(layers):
    """Model operations: the convs' and the norms' products."""
    ops, norms, _ = layers
    return ops + sum(2 * p * c * c for p, c in norms)


def transform_bound_s(layers, pictures, io_elems, dtype):
    """Least seconds for a transform on ``pictures`` pictures: the convs on
    the dtype's unit (f32: the CUDA cores, TF32 off; bf16: the tensor
    cores), each norm shared between the CUDA cores and bf16 products on the
    tensor cores (6 keep an f32 x² and γ, 3 a bf16 x²) so that both units
    finish together, against the bytes of its input, output and weights read
    or written once."""
    ops, norms, weights = layers
    cc_work = ops * pictures / F32_FLOPS_PER_S if dtype == "float32" else 0.0
    tc_work = ops * pictures / BF16_TC_FLOPS_PER_S if dtype == "bfloat16" \
        else 0.0
    products = 6 if dtype == "float32" else 3
    a = sum(norm_ops(p, c) for p, c in norms) * pictures / F32_FLOPS_PER_S
    b = sum(products * 2 * p * c * c for p, c in norms) * pictures \
        / BF16_TC_FLOPS_PER_S
    # the norm's share s on the tensor cores: both units finish together
    s = min(1.0, max(0.0, (cc_work + a - tc_work) / (a + b)))
    t_ops = max(cc_work + (1 - s) * a, tc_work + s * b)
    t_bytes = (io_elems * pictures * BYTES[dtype] + 4 * weights) \
        / HBM_BYTES_PER_S
    return max(t_ops, t_bytes)


def stem_ops(cfg, h, w, served: bool):
    """Model operations of the STEM on one h×w latent: HE, then the priors
    (TPM, HD) and EPM, once for the encoder and once more for the decoder
    where the picture is served; on the spatial-prior path EPM runs on rows
    with the masked context's 12 causal taps."""
    m, ebc = cfg["in_channels"], cfg["entropy_bottleneck_channels"]
    spm = cfg["variant"] == "res"
    h2, w2, h4, w4 = (h + 1) // 2, (w + 1) // 2, (h + 3) // 4, (w + 3) // 4
    he = (conv(2 * m, 256, 3, h, w) + conv(256, 256, 5, h2, w2)
          + conv(256, ebc, 5, h4, w4))
    hd = (deconv(ebc, 256, 5, h4, w4) + deconv(256, 256, 5, h2, w2)
          + conv(256, 2 * m, 3, h, w))
    tpm = (conv(m, 256, 5, h, w) + conv(256, 320, 5, h, w)
           + conv(320, 2 * m, 5, h, w))
    epm_in = 2 * m * (3 if spm else 2)
    epm = (conv(epm_in, 768, 1, h, w) + conv(768, 576, 1, h, w)
           + conv(576, 2 * m, 1, h, w))
    ctx = 2 * 12 * m * 2 * m * h * w if spm else 0
    per_side = tpm + hd + epm + ctx
    return he + per_side * (2 if served else 1)


def picture_ops(cfg, hw, served: bool):
    """Model operations per picture: g_a, the STEM and g_s."""
    n, m = cfg["N"], cfg["M"]
    hh, ww = hw[0] // 16, hw[1] // 16
    return (transform_ops(g_a_layers(n, m, *hw))
            + stem_ops(cfg, hh, ww, served)
            + transform_ops(g_s_layers(n, m, hh, ww)))
