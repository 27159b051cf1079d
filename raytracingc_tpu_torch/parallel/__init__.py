"""Multi-rank execution over ``torch.distributed``: the ``(px, spp)`` mesh,
sharded renders (replicated or block-sharded scenes) and the sharded
training step.

Counterpart of ``raytracingc_tpu/parallel/``; see ``mesh.py`` and
``sharded.py``. ``dryrun.py`` runs one tiny sharded training step and
renders inside an initialised world.
"""

from raytracingc_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: F401
from raytracingc_tpu_torch.parallel.mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
)
from raytracingc_tpu_torch.parallel.sharded import (  # noqa: F401
    make_train_step,
    mesh_for_strategy,
    pad_scene_for_blocks,
    render_sharded,
    render_sharded_blocks,
    strategy_spp_dim,
)
