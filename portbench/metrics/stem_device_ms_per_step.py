"""Device ms per step of the operations launched inside the spans around
the STEM codec's calls (its encode, parameter and reconstruction
expressions, its compress/decompress, or its forward)."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    s = run.trace["span_device_s"].get("pb.stem")
    return None if not s else s * 1e3 / run.steps
