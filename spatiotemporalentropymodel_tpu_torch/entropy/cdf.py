"""PMF → quantized-CDF conversion.

Behavioral parity with the reference's C++ quantizer
(compressai/cpp_exts/ops/ops.cpp:24-81): round pmf to integer frequencies
(half-away-from-zero, like std::round), renormalize to sum 2^precision with
integer floor arithmetic, prefix-sum, pin cdf[0]=0 and cdf[-1]=2^precision,
then repair zero-width symbols by stealing one count from the currently
smallest frequency > 1. Determinism of this function defines bitstream
compatibility, so the NumPy and C++ (coders/csrc/rans.cpp) implementations are
cross-checked in tests. A copy of spatiotemporalentropymodel_tpu/entropy/cdf.py.
"""

import numpy as np


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """Quantize one pmf row (already including its tail-mass bucket).

    Args:
      pmf: 1-D array of probabilities (any float dtype; used as float64).
      precision: CDF precision in bits; frequencies sum to 2**precision.

    Returns:
      int32 array of length len(pmf)+1: [0, c1, ..., 2**precision], strictly
      increasing.
    """
    pmf = np.asarray(pmf, dtype=np.float64)
    n = pmf.shape[0]
    scale = 1 << precision

    cdf = np.zeros(n + 1, dtype=np.int64)
    # std::round = half away from zero (np.round would be half-to-even)
    cdf[1:] = np.floor(pmf * scale + 0.5).astype(np.int64)

    total = int(cdf.sum())
    if total <= 0:
        raise ValueError("pmf must have positive mass")
    cdf = (scale * cdf) // total
    cdf = np.cumsum(cdf)
    cdf[-1] = scale

    # Frequency-stealing repair pass (ops.cpp:46-72).
    cdf = cdf.astype(np.int64)
    for i in range(n):
        if cdf[i] == cdf[i + 1]:
            freqs = cdf[1:] - cdf[:-1]
            candidates = np.where(freqs > 1)[0]
            if candidates.size == 0:
                raise ValueError("cannot repair cdf: no stealable frequency")
            best_steal = candidates[np.argmin(freqs[candidates])]
            if best_steal < i:
                cdf[best_steal + 1 : i + 1] -= 1
            else:
                cdf[i + 1 : best_steal + 1] += 1

    assert cdf[0] == 0 and cdf[-1] == scale
    assert np.all(cdf[1:] > cdf[:-1]), "cdf must be strictly increasing"
    return cdf.astype(np.int32)


def build_table_rows(pmfs, tail_masses, pmf_lengths, max_length, precision=16):
    """Assemble the padded 2-D CDF matrix the coder consumes.

    Mirrors EntropyModel._pmf_to_cdf (entropy_models.py:170-178): each row i is
    pmf_to_quantized_cdf(concat(pmf[i, :len_i], tail_mass[i])) left-aligned in a
    (rows, max_length + 2) int32 matrix. Uses the native C++ quantizer
    (bit-identical to the NumPy spec above, which is O(n²) and too slow for
    the 64×~3000-entry Gaussian tables); a failed coder build raises.
    """
    from ..coders import rans

    pmfs = np.asarray(pmfs, dtype=np.float64)
    tail_masses = np.asarray(tail_masses, dtype=np.float64).reshape(-1)
    pmf_lengths = np.asarray(pmf_lengths, dtype=np.int64).reshape(-1)
    rows = pmf_lengths.shape[0]
    out = np.zeros((rows, int(max_length) + 2), dtype=np.int32)
    for i in range(rows):
        n = int(pmf_lengths[i])
        prob = np.concatenate([pmfs[i, :n], tail_masses[i : i + 1]])
        row = rans.pmf_to_quantized_cdf(prob, precision)
        out[i, : row.shape[0]] = row
    return out
