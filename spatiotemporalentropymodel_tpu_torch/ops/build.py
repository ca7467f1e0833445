"""Build the CUDA kernels (nvcc, cached by source hash).

The sources under ``csrc/`` export ``extern "C"`` launchers and include no
PyTorch header, so ``nvcc`` compiles each ``.cu`` into an object in seconds
(all at once, one process each) and links them into one plain shared
library that ctypes loads: no ninja, no ``torch.utils.cpp_extension``. The
library goes to ``spatiotemporalentropymodel_tpu_torch/_build/``
(git-ignored), named after a hash of every source, header and flag, at
first use. A missing ``nvcc`` or a failed build raises and names the
command.
"""

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
SOURCES = ("kernels.cu", "gdn_conv.cu", "igdn_deconv.cu", "deconv_f32.cu",
           "conv_f32.cu")
HEADERS = ("gdn_window_tc.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# -gencode names the sm_90a PTX target, which wgmma needs; "-arch=sm_90a"
# alone gave ptxas a plain sm_90 target
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-Xcompiler", "-fPIC")


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
        f"kernels in {CSRC} cannot be built"
    )


def _sources(csrc: Path):
    """The sources to build: all of SOURCES here; of another tree's
    ``csrc`` those it has (an older tree lacks the newer files)."""
    if csrc == CSRC:
        return SOURCES
    return tuple(s for s in SOURCES if (csrc / s).exists())


def lib_path(csrc: Path = CSRC) -> Path:
    h = hashlib.sha256()
    for name in _sources(csrc) + HEADERS:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libstem_kernels_{h.hexdigest()[:16]}.so"


def _check(res, cmd):
    if res.returncode != 0:
        raise RuntimeError(
            f"CUDA kernel build failed (exit {res.returncode}): "
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )


def build(csrc: Path = CSRC) -> Path:
    """Compile csrc/*.cu → cached .so; returns its path. ``csrc`` may be
    another tree's sources of the same files (ops/kernel_ab.py)."""
    out = lib_path(csrc)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = _sources(csrc)
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in sources]
    cmds = [[nvcc(), *NVCC_FLAGS, "-c", str(csrc / s), "-o", str(o)]
            for s, o in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        for cmd, proc in zip(cmds, procs):
            stdout, stderr = proc.communicate()
            _check(subprocess.CompletedProcess(cmd, proc.returncode, stdout,
                                               stderr), cmd)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), "-arch=sm_90a", "-shared", *map(str, objs), "-o",
               str(tmp)]
        _check(subprocess.run(cmd, capture_output=True, text=True), cmd)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for o in objs:
            o.unlink(missing_ok=True)
    return out
