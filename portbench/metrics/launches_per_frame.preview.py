"""Device kernels launched per traced preview frame."""


def read(span):
    frames = span.work.get("frames") if span is not None else None
    if not frames:
        return None
    return span.kernels / frames
