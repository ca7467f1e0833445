"""Where a fused (I)GDN + conv block spends its time: window load, norm,
convolution.

    python3 -m spatiotemporalentropymodel_tpu_torch.ops.phase_probe \
        [--csrc DIR] [--out FILE]

Needs one CUDA card and nvcc. It copies ``gdn_conv.cu`` and
``igdn_deconv.cu`` with their headers from ``--csrc`` (default: this
package's ``csrc/``) into ``_build/probe/``, builds each with
``-DSTEM_PHASE_PROBE`` into a library of its own, and runs
``gdn_conv_fused`` at g_a's first stage (4 × 192 × 544 × 960) and the wide
g_s kernel at 272 × 480 → 544 × 960. Thread 0 of every 16th block stamps
``clock64()`` at the block's start and at three boundaries, each behind a
``__syncthreads()``: the window is loaded, the window is normalised, the
convolution and its stores are done. The kernels mark those points with
``STEM_PHASE(i)``. A source without the marks (the design before the
tensor-core norm) gets them inserted at its ``load_window`` /
``gdn_window`` calls, and its own argument layout. The probe's barriers and
stores add a little to each block, so the split is read as shares, beside
the kernel's time without the probe (``chip_smoke.py``).

Prints one JSON line per kernel: median cycles of each phase over the
sampled blocks, their shares, and the SM clock ``nvidia-smi`` reports.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import torch

from . import kernels
from .build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc

EVERY, MAX_SAMPLES = 16, 4096
PROBE_DEFS = f"-DSTEM_PHASE_PROBE -DSTEM_PHASE_EVERY={EVERY} " \
             f"-DSTEM_PHASE_MAX={MAX_SAMPLES}"
# the stamp and the reader, for a source that predates STEM_PHASE
OLD_PRELUDE = """
static __device__ unsigned long long stem_phase_clock[4 * STEM_PHASE_MAX];
#define STEM_PHASE(i) do { __syncthreads(); if (threadIdx.x == 0) { \\
  const unsigned lin = blockIdx.y * gridDim.x + blockIdx.x; \\
  if (lin % STEM_PHASE_EVERY == 0 && lin / STEM_PHASE_EVERY < STEM_PHASE_MAX) \\
    stem_phase_clock[(lin / STEM_PHASE_EVERY) * 4 + (i)] = clock64(); } \\
} while (0)
"""
READER = """
extern "C" int stem_phase_read(void* dst, unsigned long long n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, stem::stem_phase_clock, n));
}
"""


def _mark_old(src: str, kernel: str) -> str:
    """Insert the four stamps into ``kernel``'s body of a source without
    them: before and after load_window, after gdn_window, at the end."""
    start = src.index(kernel + "(")
    body = src.index("{", src.index(")", start))
    end = src.index("\n}\n", body)
    part = src[body:end]
    part = re.sub(r"(\n\s*)(load_window<C>\()", r"\1STEM_PHASE(0);\1\2", part,
                  count=1)
    part = re.sub(r"(gdn_window<C, (?:false|true)>\([^;]*;)",
                  r"STEM_PHASE(1);\n  \1\n  STEM_PHASE(2);", part, count=1)
    part += "\n  STEM_PHASE(3);"
    return src[:body] + part + src[end:]


def _prepare(csrc: Path, work: Path):
    """Copy the sources, add stamps where missing, build one .so each.
    Returns {source: (library, new_layout)}."""
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    for h in csrc.glob("*.cuh"):
        shutil.copy(h, work / h.name)
    libs = {}
    procs = []
    for name, kernel in (("gdn_conv.cu", "gdn_conv_kernel"),
                         ("igdn_deconv.cu", "igdn_deconv_wide_kernel")):
        src = (csrc / name).read_text()
        new = "STEM_PHASE(" in src
        if not new:
            src = src.replace('#include "gdn_window.cuh"\n',
                              '#include "gdn_window.cuh"\nnamespace stem {'
                              + OLD_PRELUDE + "}\n", 1)
            src = _mark_old(src, kernel)
        (work / name).write_text(src + READER)
        lib = work / f"libprobe_{Path(name).stem}.so"
        cmd = [nvcc(), *NVCC_FLAGS, *PROBE_DEFS.split(), "-shared",
               str(work / name), "-o", str(lib)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True)))
        libs[name] = (lib, new)
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"probe build failed: {' '.join(cmd)}\n{out}"
                               f"{err}")
    return libs


def _sm_clock_mhz():
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return [float(v) for v in res.stdout.strip().splitlines()[0].split(",")]


def _inputs(gen, c, h, w):
    dev = "cuda"
    x = torch.randn((4, c, h, w), generator=gen, device=dev).to(torch.bfloat16)
    gamma = (0.02 * torch.rand((c, c), generator=gen, device=dev)
             + 0.1 * torch.eye(c, device=dev))
    beta = 1.0 + torch.rand((c,), generator=gen, device=dev)
    shape = (c, c, 5, 5)
    weight = (torch.randn(shape, generator=gen, device=dev)
              * (2.0 / (25 * c)) ** 0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn((c,), generator=gen, device=dev)
    return x, gamma.t().contiguous(), beta, weight, bias


def _args(name, new, x, gamma_t, beta, weight):
    """(γ argument, packed weight, output shape) in the source's layout."""
    b, c, h, w = x.shape
    if name == "gdn_conv.cu":
        shape = (b, c, (h + 1) // 2, (w + 1) // 2)
        if new:
            return (kernels.split_gamma(gamma_t),
                    kernels.pack_conv_weight(weight), shape)
        return gamma_t, weight.permute(2, 3, 0, 1).contiguous(), shape
    shape = (b, c, 2 * h, 2 * w)
    if new:
        return (kernels.split_gamma(gamma_t),
                kernels.pack_wide_weight(weight), shape)
    ky, kx = kernels._tap_index(x.device)
    return gamma_t, kernels._padded_taps(weight)[ky, kx].contiguous(), shape


def run(csrc: Path):
    libs = _prepare(csrc, BUILD_DIR / "probe")
    gen = torch.Generator(device="cuda").manual_seed(21)
    results = []
    for name, entry, (h, w) in (
            ("gdn_conv.cu", "stem_gdn_conv_fused_bf16", (544, 960)),
            ("igdn_deconv.cu", "stem_igdn_deconv_wide_bf16", (272, 480))):
        path, new = libs[name]
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, entry)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.restype = i32
        fn.argtypes = [vp] * 6 + [i64, i32, i32, i32, i32, vp]
        lib.stem_phase_read.restype = i32
        lib.stem_phase_read.argtypes = [vp, ctypes.c_ulonglong]
        c = 192
        x, gamma_t, beta, weight, bias = _inputs(gen, c, h, w)
        gamma_arg, wp, shape = _args(name, new, x, gamma_t, beta, weight)
        out = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            rc = fn(x.data_ptr(), gamma_arg.data_ptr(), beta.data_ptr(),
                    wp.data_ptr(), bias.data_ptr(), out.data_ptr(), 4, c, c,
                    h, w, stream)
            if rc != 0:
                raise RuntimeError(f"{entry}: launch failed with {rc}")

        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            launch()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 5
        clocks = torch.zeros((MAX_SAMPLES, 4), dtype=torch.int64)
        rc = lib.stem_phase_read(clocks.data_ptr(), clocks.numel() * 8)
        if rc != 0:
            raise RuntimeError(f"stem_phase_read failed with {rc}")
        stamps = clocks[(clocks > 0).all(dim=1)].double()
        if stamps.shape[0] == 0:
            raise RuntimeError(f"{name}: no block stamped its phases")
        phases = stamps[:, 1:] - stamps[:, :-1]
        total = stamps[:, 3] - stamps[:, 0]
        med = [float(v) for v in phases.median(dim=0).values]
        mhz, max_mhz = _sm_clock_mhz()
        row = dict(
            source=str(csrc / name), layout="new" if new else "old",
            shape=[4, c, h, w], ms_with_probe=ms, blocks=int(stamps.shape[0]),
            block_cycles_median=float(total.median()),
            phase_cycles_median=dict(zip(("load", "norm", "conv"), med)),
            phase_share=dict(zip(("load", "norm", "conv"),
                                 [float(v) for v in
                                  (phases.sum(0) / total.sum())])),
            sm_clock_mhz=mhz, sm_clock_max_mhz=max_mhz,
            block_us_at_max_clock=float(total.median()) / max_mhz)
        print(json.dumps(row), flush=True)
        results.append(row)
        del x, out, wp, gamma_arg
        torch.cuda.empty_cache()
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=CSRC)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the rows to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_probe needs a CUDA card")
    rows = run(args.csrc.resolve())
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
