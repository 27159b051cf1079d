"""95th percentile of the wall time of every frame of the window, each
ending in a synchronize, in milliseconds."""

from portbench.lib.stats import percentile


def read(record):
    if "frames" not in record:
        return None
    return percentile([f["wall_s"] for f in record["frames"]], 95) * 1e3
