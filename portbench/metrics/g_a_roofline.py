"""g_a's share of its roofline: the least time its own operations and bytes
need on the chip (``peaks.transform_bound_s`` at the cell's dtype), times
its calls, over the device time of the operations launched in its spans."""

from portbench import peaks


def read(run):
    dev = None if run.trace is None else run.trace["span_device_s"].get(
        "pb.g_a")
    calls = run.calls.get("pb.g_a", 0)
    if not dev or not calls:
        return None
    layers, io = run.program.transforms(run.cfg, run.hw)["g_a"]
    least = peaks.transform_bound_s(layers, run.b, io, run.traffic["dtype"])
    return 100.0 * least * calls / dev
