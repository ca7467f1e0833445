"""Device ms per step of the operations launched inside the spans around
the autoregressive codec's encode and decode (``pb.ar``: the wavefront
rounds' gathers, context and entropy-parameters products and writes)."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    s = run.trace["span_device_s"].get("pb.ar")
    return None if not s else s * 1e3 / run.steps
