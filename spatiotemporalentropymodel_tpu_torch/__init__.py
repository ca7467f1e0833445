"""PyTorch/CUDA port of spatiotemporalentropymodel_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. Sub-package
names mirror the JAX package's:

- ``ops``     : lower_bound, non-negative parametrization, quantizers, and
                the hand-written CUDA kernels (``ops/kernels.py``,
                ``ops/csrc/kernels.cu``) with their plain PyTorch versions
- ``layers``  : GDN/IGDN, Conv/Deconv, Sequential, MaskedConv2d (NCHW)
- ``entropy`` : EntropyBottleneck / GaussianConditional, CDF tables, host
                compress/decompress, the sparse-grouped transport
- ``coders``  : the entropy coders: the native C++ rANS (ctypes), its
                interleaved 8-lane container, and a pure NumPy coder
- ``models``  : FactorizedPrior, ScaleHyperprior, MeanScaleHyperprior, the
                five STEM P-frame variants and the wavefront AR codec of the
                SPM ones, the channel-autoregressive STEM (charm), the
                autoregressive image models and the ROI family
- ``zoo``     : the model registry and quality configurations
- ``data``    : PNG files (no PIL) and GOP sequences
- ``eval``    : the P-frame serving pipelines (parallel and wavefront), the
                file codecs (``.bin`` images, ``.stemv`` video), the image
                and GOP evaluations, and the benchmark workload
- ``convert`` : loads the JAX package's parameter trees (NumPy) into the port

It imports torch and NumPy, never jax. Kernels and the coder build at first
use (nvcc, g++) into ``_build/``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, where the kernels' plain versions run.
"""

__version__ = "0.1.0"

_entropy_coder = "rans"
_available_coders = ["rans", "rans_interleaved", "numpy"]


def available_entropy_coders():
    """Names of the entropy coders (``__init__.py:56-82`` of the JAX
    package): the native C++ rANS ("rans", bitstream-compatible with the
    reference's ``compressai.ans``), its interleaved multi-lane container
    ("rans_interleaved") and the pure NumPy coder ("numpy")."""
    return list(_available_coders)


def set_entropy_coder(name: str) -> None:
    """Set the default entropy coder by name."""
    global _entropy_coder
    if name not in _available_coders:
        raise ValueError(
            f'Invalid entropy coder "{name}", choose from {_available_coders}'
        )
    _entropy_coder = name


def get_entropy_coder() -> str:
    """The current default entropy coder's name."""
    return _entropy_coder
