"""Device kernels launched per traced ``fit_scene`` step (forward, backward,
Adam and the accel refresh)."""


def read(span):
    steps = span.work.get("steps") if span is not None else None
    if not steps:
        return None
    return span.kernels / steps
