"""Blocks of 128 triangles that each 8-ray packet handed to the culling
prelude leaves for the bitmask search to walk (of the scene's 128): the
program's counters ``search.bitmask_blocks`` over ``search.cull_packets``,
read from ``counters()`` once the window has closed (the whole process:
the warm-up frame and the window). How well the slab tests cull; ``None``
where the program has no such counters.
"""


def read(span, counts=None):
    if counts is None:
        from raytracingc_tpu_torch.utils.profiling import counters

        counts = counters()
    blocks, packets = counts.get("search.bitmask_blocks"), counts.get("search.cull_packets")
    if not blocks or not packets:
        return None
    return blocks / packets
