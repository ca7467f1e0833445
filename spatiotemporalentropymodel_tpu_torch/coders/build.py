"""Build the native rANS shared library (g++, cached by source hash).

The port's own copy of spatiotemporalentropymodel_tpu/coders/build.py: a
plain C-ABI shared object loaded via ctypes, rebuilt only when csrc/rans.cpp
changes, written to ``spatiotemporalentropymodel_tpu_torch/_build/``
(git-ignored). A failed build raises and names the command; there is no
NumPy fallback.
"""

import hashlib
import os
import subprocess
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc" / "rans.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def lib_path() -> Path:
    tag = hashlib.sha256(_CSRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"librans_{tag}.so"


def build() -> Path:
    """Compile csrc/rans.cpp → cached .so; returns its path."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), "-std=c++17", "-O3", "-fPIC",
           "-shared", "-pthread", str(_CSRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"rANS coder build failed: {' '.join(cmd)}: {e}")
    if res.returncode != 0:
        raise RuntimeError(
            f"rANS coder build failed (exit {res.returncode}): "
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out
