"""Device kernels launched in the traced frames per million traced rays."""


def read(span):
    rays = span.work.get("rays") if span is not None else None
    if not rays:
        return None
    return span.kernels / (rays / 1e6)
