"""Multi-device rendering on torch.distributed (the port of
``bendy_tpu/parallel``): a (tiles, samples) mesh of ranks, the sharded
pass through the CUDA tracer and its plain version, the process-group
bootstrap with its backend rule, and the film gather."""

from bendy_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_kernel_pass_sharded,
    make_mesh,
    render_film_sharded,
    render_pass_sharded,
    render_scene_pass,
    spawn,
)
from bendy_tpu_torch.parallel.multihost import (  # noqa: F401
    choose_backend,
    film_to_host0,
    initialize,
)
