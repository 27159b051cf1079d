"""Cross-cutting utilities: checkpointing, profiling, failure supervision.

Counterpart of ``raytracingc_tpu/utils``: long renders and optimization runs
checkpoint and resume (:mod:`checkpoint`), trace their layers' spans and
count their work (:mod:`profiling`), and survive transient device failures
(:mod:`resilient`).
"""

from raytracingc_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_pytree,
    save_pytree,
)
from raytracingc_tpu_torch.utils.profiling import (  # noqa: F401
    counters,
    start_trace,
    stop_trace,
    trace_annotation,
)
from raytracingc_tpu_torch.utils.resilient import (  # noqa: F401
    RenderFailure,
    render_resilient,
)
