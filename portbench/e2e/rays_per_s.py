"""Logical traced rays of every frame of the window over the window's time
(one ray a live lane a bounce, the exact count ``render()`` returns)."""


def read(record):
    if "frames" not in record:
        return None
    return sum(f["rays"] for f in record["frames"]) / record["window_s"]
