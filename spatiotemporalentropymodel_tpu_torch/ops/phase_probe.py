"""Where a fused (I)GDN + conv block spends its time: window load, norm,
convolution.

    python3 -m spatiotemporalentropymodel_tpu_torch.ops.phase_probe \
        [--csrc DIR] [--out FILE]

Needs one CUDA card and nvcc. It copies ``gdn_conv.cu`` and
``igdn_deconv.cu`` with their headers from ``--csrc`` (default: this
package's ``csrc/``) into ``_build/probe/``, builds each with
``-DSTEM_PHASE_PROBE`` into a library of its own, and runs
``gdn_conv_fused`` at g_a's first stage (4 × 192 × 544 × 960), the wide
g_s kernel at 272 × 480 → 544 × 960 and the narrow g_s kernel at 544 × 960
→ 1088 × 1920, F = 3. Thread 0 of every 16th block stamps ``clock64()`` at
the block's start and at three boundaries, each behind a
``__syncthreads()``: the window is loaded, the window is normalised, the
convolution and its stores are done. The kernels mark those points with
``STEM_PHASE(i)``, which ``gdn_window_tc.cuh`` defines. A kernel without
the marks (the narrow kernel of a tree that still has ``gdn_window.cuh``)
gets them inserted at its ``load_window`` / ``gdn_window`` calls and takes
its own argument layout. The probe's barriers and stores add a little to
each block, so the split is read as shares, beside the kernel's time
without the probe (``chip_smoke.py``).

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
READER = """
extern "C" int stem_phase_read(void* dst, unsigned long long n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, stem::stem_phase_clock, n));
}
extern "C" int stem_phase_clear() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, stem::stem_phase_clock);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemset(p, 0, sizeof(stem::stem_phase_clock)));
}
"""
# (source, kernel, entry, input H × W, outputs): the blocks probed
PROBES = (
    ("gdn_conv.cu", "gdn_conv_kernel", "stem_gdn_conv_fused_bf16",
     (544, 960), 192),
    ("igdn_deconv.cu", "igdn_deconv_wide_kernel",
     "stem_igdn_deconv_wide_bf16", (272, 480), 192),
    ("igdn_deconv.cu", "igdn_deconv_narrow_kernel",
     "stem_igdn_deconv_narrow_bf16", (544, 960), 3),
)


def _body(src: str, kernel: str):
    """(start, end) of ``kernel``'s body in src: its definition's ``{`` up
    to the ``}`` that closes it at the start of a line."""
    start = re.search(rf"^{kernel}\(", src, re.M).start()
    body = src.index("{", src.index(")", start))
    return body, src.index("\n}\n", body)


def _mark_old(src: str, kernel: str) -> str:
    """Insert the four stamps into ``kernel``'s body of a source without
    them: before and after load_window, after gdn_window, at the end."""
    body, end = _body(src, kernel)
    part = src[body:end]
    part = re.sub(r"(\n\s*)(load_window<C>\()", r"\1STEM_PHASE(0);\1\2", part,
                  count=1)
    part = re.sub(r"(gdn_window<C, (?:false|true)>\([^;]*;)",
                  r"STEM_PHASE(1);\n  \1\n  STEM_PHASE(2);", part, count=1)
    part += "\n  STEM_PHASE(3);"
    return src[:body] + part + src[end:]


def _prepare(csrc: Path, work: Path):
    """Copy the sources, add stamps where missing, build one .so per
    source. Returns ({source: library}, {kernel: new_layout})."""
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    for h in csrc.glob("*.cuh"):
        shutil.copy(h, work / h.name)
    sources = {name: (csrc / name).read_text() for name, *_ in PROBES}
    new = {}
    for name, kernel, *_ in PROBES:
        body, end = _body(sources[name], kernel)
        new[kernel] = "STEM_PHASE(" in sources[name][body:end]
        if not new[kernel]:
            sources[name] = _mark_old(sources[name], kernel)
    libs, procs = {}, []
    for name, src in sources.items():
        (work / name).write_text(src + READER)
        lib = work / f"libprobe_{Path(name).stem}.so"
        cmd = [nvcc(), *NVCC_FLAGS, *PROBE_DEFS.split(), "-shared",
               str(work / name), "-o", str(lib)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True)))
        libs[name] = lib
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"probe build failed: {' '.join(cmd)}\n{out}"
                               f"{err}")
    return libs, new


def _sm_clock_mhz():
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return [float(v) for v in res.stdout.strip().splitlines()[0].split(",")]


def _inputs(gen, c, h, w, f):
    dev = "cuda"
    x = torch.randn((4, c, h, w), generator=gen, device=dev).to(torch.bfloat16)
    gamma = (0.02 * torch.rand((c, c), generator=gen, device=dev)
             + 0.1 * torch.eye(c, device=dev))
    beta = 1.0 + torch.rand((c,), generator=gen, device=dev)
    shape = (c, f, 5, 5)
    weight = (torch.randn(shape, generator=gen, device=dev)
              * (2.0 / (25 * c)) ** 0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn((f,), generator=gen, device=dev)
    return x, gamma.t().contiguous(), beta, weight, bias


def _args(kernel, new, x, gamma_t, weight, bias):
    """(γ argument, packed weight, bias argument, output shape) in the
    kernel's layout."""
    b, c, h, w = x.shape
    f = weight.shape[1]
    gamma_arg = kernels.split_gamma(gamma_t) if new else gamma_t
    if kernel == "gdn_conv_kernel":
        shape = (b, c, (h + 1) // 2, (w + 1) // 2)
        if new:
            return gamma_arg, kernels.pack_conv_weight(weight), bias, shape
        return (gamma_arg, weight.permute(2, 3, 0, 1).contiguous(), bias,
                shape)
    shape = (b, f, 2 * h, 2 * w)
    if kernel == "igdn_deconv_wide_kernel":
        if new:
            return gamma_arg, kernels.pack_wide_weight(weight), bias, shape
        ky, kx = kernels._tap_index(x.device)
        return (gamma_arg, kernels._padded_taps(weight)[ky, kx].contiguous(),
                bias, shape)
    _, _, rows_o, live = kernels._narrow_index(x.device, f)
    bias_m = torch.where(live, bias[rows_o], 0.0)
    wp = (kernels.pack_narrow_weight(weight) if new
          else kernels._narrow_taps(weight).contiguous())
    return gamma_arg, wp, bias_m, shape


def run(csrc: Path):
    libs, layouts = _prepare(csrc, BUILD_DIR / "probe")
    gen = torch.Generator(device="cuda").manual_seed(21)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    results = []
    for name, kernel, entry, (h, w), f in PROBES:
        new = layouts[kernel]
        lib = ctypes.CDLL(str(libs[name]))
        fn = getattr(lib, entry)
        fn.restype = i32
        narrow = kernel == "igdn_deconv_narrow_kernel"
        fn.argtypes = [vp] * 6 + [i64] + [i32] * (5 if narrow else 4) + [vp]
        lib.stem_phase_read.restype = i32
        lib.stem_phase_read.argtypes = [vp, ctypes.c_ulonglong]
        lib.stem_phase_clear.restype = i32
        c = 192
        x, gamma_t, beta, weight, bias = _inputs(gen, c, h, w, f)
        gamma_arg, wp, bias_arg, shape = _args(kernel, new, x, gamma_t,
                                               weight, bias)
        out = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        sizes = ((c, f, kernels.narrow_rows(f), h, w) if narrow
                 else (c, c, h, w))

        def launch():
            rc = fn(x.data_ptr(), gamma_arg.data_ptr(), beta.data_ptr(),
                    wp.data_ptr(), bias_arg.data_ptr(), out.data_ptr(), 4,
                    *sizes, stream)
            if rc != 0:
                raise RuntimeError(f"{entry}: launch failed with {rc}")

        torch.cuda.synchronize()
        if lib.stem_phase_clear() != 0:
            raise RuntimeError("stem_phase_clear failed")
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
            raise RuntimeError(f"{kernel}: no block stamped its phases")
        phases = stamps[:, 1:] - stamps[:, :-1]
        total = stamps[:, 3] - stamps[:, 0]
        med = [float(v) for v in phases.median(dim=0).values]
        mhz, max_mhz = _sm_clock_mhz()
        row = dict(
            source=str(csrc / name), kernel=kernel,
            layout="new" if new else "old", shape=[4, c, h, w], outputs=f,
            ms_with_probe=ms, blocks=int(stamps.shape[0]),
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
