"""Published rate-distortion reference points.

Counterpart of spatiotemporalentropymodel_tpu/eval/rd_data.py: the same
numbers.

Data source: the reference's README table and results/draw_stem_rdcurve.py
(see BASELINE.md) — published benchmark numbers used to draw comparison
curves and to check parity of retrained models.
"""

UVG = {
    "stem_paper": {
        "bpp": [0.046, 0.062, 0.078, 0.100, 0.120, 0.170],
        "psnr": [34.15, 35.21, 36.0, 36.60, 37.124, 37.90],
    },
    "stem_baseline": {  # λ ∈ {0.004, 0.010, 0.016, 0.031}
        "bpp": [0.047, 0.083, 0.105, 0.161],
        "psnr": [34.384, 36.162, 37.103, 38.314],
    },
    "stem_roi": {
        "bpp": [0.041, 0.052, 0.065, 0.082, 0.102, 0.126, 0.153, 0.182, 0.208],
        "psnr": [33.480, 34.363, 35.178, 35.969, 36.694, 37.331, 37.858,
                 38.271, 38.488],
    },
}

HEVC_B = {
    "stem_paper": {
        "bpp": [0.038, 0.069, 0.112, 0.166, 0.24, 0.32, 0.39, 0.45, 0.51],
        "psnr": [29.5, 31.1, 32.4, 33.5, 34.4, 35.1, 35.6, 36.0, 36.3],
    },
    "stem_baseline": {  # GOP 12
        "bpp": [0.076, 0.137, 0.181, 0.282],
        "psnr": [31.993, 33.678, 34.539, 35.636],
    },
    "stem_roi": {
        "bpp": [0.063, 0.080, 0.101, 0.127, 0.159, 0.197, 0.241, 0.289, 0.337,
                0.368, 0.384],
        "psnr": [31.135, 31.830, 32.519, 33.197, 33.855, 34.460, 34.990,
                 35.396, 35.616, 35.657, 35.664],
    },
}

# headline single-point results (reference README.md:115-119)
UVG_HEADLINE = {
    "SpatioTemporalPriorModel_Res": {"psnr": 36.104, "bpp": 0.087},
    "SpatioTemporalPriorModel": {"psnr": 36.053, "bpp": 0.080},
    "SpatioTemporalPriorModelWithoutSPM": {"psnr": 36.066, "bpp": 0.080},
    "SpatioTemporalPriorModelWithoutSPMTPM": {"psnr": 36.021, "bpp": 0.141},
}
