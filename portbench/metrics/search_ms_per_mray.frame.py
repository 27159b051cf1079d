"""Device time of the closest-hit search kernels (names holding
``search_``) in the traced frames, in ms per million traced rays."""


def read(span):
    rays = span.work.get("rays") if span is not None else None
    if not rays or span.search_s <= 0:
        return None
    return span.search_s * 1e3 / (rays / 1e6)
