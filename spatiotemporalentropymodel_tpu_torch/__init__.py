"""PyTorch/CUDA port of spatiotemporalentropymodel_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. Sub-package
names mirror the JAX package's:

- ``ops``     : lower_bound, non-negative parametrization, quantizers, and
                the hand-written CUDA kernels (``ops/kernels.py``,
                ``ops/csrc/kernels.cu``) with their plain PyTorch versions
- ``layers``  : GDN/IGDN, Conv/Deconv, Sequential (NCHW)
- ``entropy`` : EntropyBottleneck / GaussianConditional, CDF tables, host
                compress/decompress, the sparse-grouped transport
- ``coders``  : the native C++ rANS coder (ctypes)
- ``models``  : MeanScaleHyperprior, the parallel STEM P-frame model
- ``eval``    : the P-frame serving pipeline and the benchmark workload
- ``convert`` : loads the JAX package's parameter trees (NumPy) into the port

It imports torch and NumPy, never jax. Kernels and the coder build at first
use (nvcc, g++) into ``_build/``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, where the kernels' plain versions run.
"""

__version__ = "0.1.0"
