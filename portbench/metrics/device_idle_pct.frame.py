"""Share of the traced span in which no kernel, copy or fill ran on the
device: 100 * (1 - busy / span), busy the union of their intervals."""


def read(span):
    if span is None or span.window_s <= 0:
        return None
    return 100.0 * (1.0 - span.busy_s / span.window_s)
