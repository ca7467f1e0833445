"""Build the CUDA kernels (nvcc, cached by source hash).

``csrc/kernels.cu`` exports ``extern "C"`` launchers and includes no PyTorch
header, so ``nvcc`` turns it into a plain shared library in seconds and
ctypes loads it: no ninja, no ``torch.utils.cpp_extension``. The library goes
to ``spatiotemporalentropymodel_tpu_torch/_build/`` (git-ignored), named after
a hash of the source and the flags, at first use. A missing ``nvcc`` or a
failed build raises and names the command.
"""

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc" / "kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-O3", "-arch=sm_90a", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC")


def nvcc() -> str:
    """Path of nvcc: $PATH first, then the CUDA toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (searched $PATH and /usr/local/cuda/bin); the CUDA "
        f"kernels in {_CSRC} cannot be built"
    )


def lib_path() -> Path:
    h = hashlib.sha256(_CSRC.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libstem_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/kernels.cu → cached .so; returns its path."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, str(_CSRC), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"CUDA kernel build failed (exit {res.returncode}): "
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out
