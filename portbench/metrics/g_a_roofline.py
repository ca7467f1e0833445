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
    n, m = run.cfg["N"], run.cfg["M"]
    h, w = run.hw
    io = 3 * h * w + m * (h // 16) * (w // 16)
    least = peaks.transform_bound_s(peaks.g_a_layers(n, m, h, w), run.b, io,
                                    run.traffic["dtype"])
    return 100.0 * least * calls / dev
