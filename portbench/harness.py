"""One run of one cell: set-up, the measured window, the check.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
the configuration file it names and, under ``portbench/``,
``traffic/<traffic>.json``, ``limits/<cell>.json``, ``metrics/<metric>.py``
for each per-layer metric it reports, and the modules its files name:

- the configuration's ``weights``: ``weights/<name>.py``, whose ``make``
  gives both models' weights (and the latent's noise, where the
  configuration draws one) from the seed;
- the traffic's ``loop``: ``loops/<name>.py``, whose ``make`` builds the
  closed loop that the window drives (``KEYS`` lists the traffic keys it
  reads besides the common ones, ``VARIANTS`` the STEMs it drives);
- the traffic's ``judge``: ``judges/<name>.py``, which holds what a
  sampled step produced to the plain reference (``judge``), names the
  numbers it reads (``NAMES``) and puts the reference in the program's
  place for the control (``control``).

A traffic file with a key that neither the harness nor its loop reads, or
a loop asked to drive a STEM variant it does not drive, is refused.
"""

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import judge as J
from . import reference as R
from . import tracing
from . import workload as WL

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spatiotemporalentropymodel_tpu")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TRAFFIC_KEYS = {"loop", "judge", "dtype", "streams", "height", "width", "gop",
                "sample", "why"}


def forbidden_modules():
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def find(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind} module {name!r} ({path})")
    mod_name = f"portbench_{kind}_" + name.replace(".", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str):
    """A per-layer metric's reader: ``metrics/<metric>.py``, or, for a
    metric split by cells (``<base>.<cells>``), the reader of its base."""
    if not (HERE / "metrics" / f"{metric}.py").is_file():
        metric = metric.split(".")[0]
    return find("metrics", metric).read


def load_cell(name: str, root: Path = ROOT):
    """The cell's entry, configuration, traffic, limits, loop, judge and
    metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())

    def applies(m):
        return name in m.get("workloads", [name])

    cell = SimpleNamespace(
        name=name, chips=w["chips"], cfg=cfg, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])
    check_cell(cell)
    return cell


def check_cell(cell):
    """Refuses traffic the cell's loop does not read, a STEM its loop does
    not drive, and limits on numbers its judge does not read."""
    loop, judge = find("loops", cell.traffic["loop"]), \
        find("judges", cell.traffic["judge"])
    unread = set(cell.traffic) - TRAFFIC_KEYS - set(loop.KEYS)
    if unread:
        raise SystemExit(f"{cell.name}: traffic keys {sorted(unread)} are "
                         f"read by no part of loop {cell.traffic['loop']!r}")
    if cell.cfg["variant"] not in loop.VARIANTS:
        raise SystemExit(f"{cell.name}: loop {cell.traffic['loop']!r} does "
                         f"not drive the {cell.cfg['variant']!r} STEM")
    unjudged = set(cell.limits) - set(judge.NAMES)
    if unjudged:
        raise SystemExit(f"{cell.name}: judge {cell.traffic['judge']!r} "
                         f"reads no {sorted(unjudged)}")


class Clock:
    """Marks of when the device finished the work queued so far, read on
    the host's clock after the window: a CUDA event against one recorded
    when the device was idle at the window's start. On the CPU the work is
    done when the call returns."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def start(self):
        if self.cuda:
            torch.cuda.synchronize()
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter()
        return self.t0

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def time(self, mark):
        if not self.cuda:
            return mark
        return self.t0 + self.ev0.elapsed_time(mark) / 1e3


# ---- set-up --------------------------------------------------------------------


def build(cell, seed: int, device: str):
    """Inputs, weights and the program's models, from ``seed``."""
    from spatiotemporalentropymodel_tpu_torch.models import (
        MeanScaleHyperprior, SpatioTemporalPriorModel,
    )

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tr = cell.cfg, cell.traffic
    m = cfg["M"]
    b, gop = tr["streams"], tr["gop"]
    hw = (tr["height"], tr["width"])
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = WL.gop_frames(seed, b, gop, hw, device)
    W = find("weights", cfg["weights"]).make(cfg, frames, seed, gen, device)
    with torch.no_grad():
        y_i = torch.round(R.g_a(W.I, frames[0])).contiguous()
    i_model = MeanScaleHyperprior(cfg["N"], m, device=device)
    i_model.module.load_state_dict(W.I, strict=True)
    tile = cfg.get("wavefront_tile")
    stem = SpatioTemporalPriorModel(
        variant=cfg["variant"],
        entropy_bottleneck_channels=cfg["entropy_bottleneck_channels"],
        in_channels=m, wavefront_tile=tuple(tile) if tile else None,
        device=device)
    stem.module.load_state_dict(W.S, strict=True)
    stem.update(force=True)
    if tr["dtype"] != "float32":
        i_model.set_compute_dtype(DTYPES[tr["dtype"]])
        stem.set_compute_dtype(DTYPES[tr["dtype"]])
    return SimpleNamespace(I=W.I, S=W.S, frames=frames, y_i=y_i,
                           noise=W.noise, i_model=i_model, stem=stem, hw=hw,
                           b=b, gop=gop, device=device)


class Loop:
    """A closed loop of steps; ``step`` returns the (hand-off, end mark,
    pictures) of the step and the records it produced for the check.
    ``warmup_steps`` steps come before the window; ``served``: whether a
    picture is encoded and decoded (or only forwarded)."""

    warmup_steps = 1
    served = True

    def drive(self, t0, seconds, offer, steps=1):
        """Steps until ``seconds`` past t0 and at least ``steps`` steps,
        offering every record; returns every step's marks."""
        marks, n = [], 0
        while n < steps or time.perf_counter() - t0 < seconds:
            m, items = self.step()
            marks += m
            for it in items:
                offer(it)
            n += 1
        self.close()
        return marks

    def close(self):
        pass

    def before_window(self, trace: bool):
        pass

    def host_coder_s(self, spans):
        """Host seconds of the host coder in the window, or None."""
        return spans.host_s.get("pb.host_coder")


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from the seed."""

    def __init__(self, k, seed):
        self.k, self.n, self.items = k, 0, []
        self.rng = np.random.default_rng([seed, 7])

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.items[j] = item
        self.n += 1


def launches_by_width():
    from spatiotemporalentropymodel_tpu_torch.ops import kernels

    return {"/".join(str(p) for p in k): v
            for k, v in sorted(kernels.LAUNCHES_BY_WIDTH.items(),
                               key=lambda kv: str(kv[0]))}


def reset_launches():
    from spatiotemporalentropymodel_tpu_torch.ops import kernels

    kernels.reset_launch_counts()


def coded_bits(items):
    """Mean bits per picture of the y and z streams in the sampled
    records, where the loop codes streams."""
    ys = [len(s) for it in items if "strings" in it for s in it["strings"][0]]
    zs = [len(s) for it in items if "strings" in it for s in it["strings"][1]]
    if not ys:
        return None
    return 8.0 * sum(ys) / len(ys), 8.0 * sum(zs) / len(zs)


# ---- a run ----------------------------------------------------------------------------


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float = None, log=print, fault=None):
    """One run; returns the result object the last line prints."""
    t_start = time.perf_counter() if t_start is None else t_start
    spans = tracing.Spans(record=trace)
    clock = Clock(device)
    st = build(cell, seed, device)
    if fault is not None:  # a test's broken program, under the loop's spans
        fault(st)
    loop = find("loops", cell.traffic["loop"]).make(st, spans, clock)
    # warm-up: every shape of the window, the kernels built
    loop.drive(time.perf_counter(), 0.0, lambda item: None, loop.warmup_steps)
    if clock.cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spans.reset()
    reset_launches()
    loop.before_window(trace)
    sample = Reservoir(cell.traffic["sample"], seed)
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    t0 = clock.start()
    with torch.profiler.record_function(tracing.WINDOW) if trace else \
            contextlib.nullcontext():
        timeline = loop.drive(t0, seconds, sample.offer)
        if clock.cuda:
            torch.cuda.synchronize()
    t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
    window = t1 - t0
    setup_s = t0 - t_start
    steps = len(timeline)
    pictures = sum(p for _, _, p in timeline)
    latencies = [clock.time(end) - start for start, end, _ in timeline]
    peak = torch.cuda.max_memory_allocated() if clock.cuda else 0
    launches = launches_by_width()
    log("launches per step: " + json.dumps(
        {k: v / steps for k, v in launches.items()}))
    log(f"window {window:.3f} s, {steps} steps, {pictures} pictures, "
        f"set-up {setup_s:.3f} s")
    summary = None
    if prof is not None:
        summary = tracing.summarize(prof, spans.intervals)
        del prof
    host_coder_s = loop.host_coder_s(spans)
    calls = dict(spans.calls)
    served = loop.served
    # the check, once the window has closed and the peak has been read
    items = sample.items
    bits = coded_bits(items)
    if bits is not None:
        log(f"coded bits per picture (sampled steps): y {bits[0]:.1f}, "
            f"z {bits[1]:.1f}")
    st.i_model = st.stem = loop = None
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = J.Ref(st.I, st.S, cell.cfg, DTYPES[cell.traffic["dtype"]])
    judge = find("judges", cell.traffic["judge"]).judge
    readings = [judge(ref, it) for it in items]
    ok, worst = J.verdict(readings, cell.limits)
    log(f"check: {len(items)} sampled steps in "
        f"{time.perf_counter() - t_check:.3f} s; every reading "
        + json.dumps(worst))
    checks = {k: {"value": worst.get(k, float("nan")), "limit": v}
              for k, v in cell.limits.items()}
    metrics = {}
    if not trace:
        values = {
            "frames_per_s": pictures / window,
            "frame_ms_p90": float(np.percentile(latencies, 90)) * 1e3,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:  # a metric split by cells: its base's value
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(
            trace=summary, steps=steps, pictures=pictures, window_s=window,
            cfg=cell.cfg, traffic=cell.traffic, hw=st.hw, b=st.b,
            calls=calls, host_coder_s=host_coder_s, served=served)
        for m in cell.per_layer:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if clock.cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if clock.cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": ok, "attempted": pictures,
           "failed": 0 if ok else st.b * len(items),
           "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
        log(f"trace: {summary['n_device_ops']} device operations, span "
            f"device s {summary['span_device_s']}, host coder s "
            f"{host_coder_s}")
    out["checks"] = checks  # last: each compared number beside its limit
    return out
