"""bendy_tpu_torch: the bendy-tpu path tracer on PyTorch and CUDA (H100).

The port of ``bendy_tpu`` (JAX on a TPU), which stays beside it as the
reference each module is tested against. It imports torch and numpy,
never jax. Each file mirrors the ``bendy_tpu`` file of the same path:

    utils/       color transfer, vector math, counter-based RNG, image IO
    scene/       scene graph + (de)serialization (copies) + SoA scene compiler
    models/      scene builders (copies): cornell, blackhole, binary_blackhole,
                 blackhole_cloud, dense_cloud, cloud_field, mass_cluster,
                 prim_grid (with light_field and cuboid_light)
    ops/         samplers, camera rays, intersection, materials, media, the
                 wavefront integrator (plain PyTorch) and trace_kernel.py,
                 the launch glue of the CUDA tracer kernel
    csrc/        hand-written CUDA C++ kernels for sm_90a (built by _build.py
                 with nvcc at first use)
    geodesic.py  Schwarzschild null-geodesic RK4 propagation
    film.py      progressive accumulation buffer + checkpointing
    render.py    Renderer / Config / RenderConfig front-end
    parallel/    the sharded pass over a (tiles, samples) mesh of ranks
                 (torch.distributed), the bootstrap and the film gather
    cli.py       the command-line renderer (python3 -m bendy_tpu_torch.cli)
    preview.py   the live preview + control server of --serve
    tools/       the FP32 and tensor-core ceiling probes

Ported so far: the surface main path (spheres, rects, boxes; all five
materials; AOVs), geodesic lensing with up to 8 unrolled masses
(blackhole, binary_blackhole), and participating media on sparse and
dense density grids, also under geodesics (volume, cloud, dense_cloud,
blackhole_cloud), and the looped table sweeps: any primitive and light
count the shared-memory table holds (cloud_field, prim_grid_256, many
lights) and more than 8 masses (mass_cluster); passes split over a mesh of
ranks, the CLI, the preview server and the two ceiling probes.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); without a card the default raises.
"""

__version__ = "0.1.0"

from bendy_tpu_torch.render import Config, Output, RenderConfig, Renderer, Status, Subsample  # noqa: F401,E402
from bendy_tpu_torch.film import DeviceFilm, Film  # noqa: F401,E402
from bendy_tpu_torch.geodesic import GeoParams  # noqa: F401,E402
from bendy_tpu_torch.models import (  # noqa: F401,E402
    build_binary_blackhole,
    build_blackhole,
    build_blackhole_cloud,
    build_cloud_field,
    build_cornell,
    build_cuboid_light,
    build_dense_cloud,
    build_light_field,
    build_mass_cluster,
    build_prim_grid,
)
from bendy_tpu_torch.scene.graph import (  # noqa: F401
    Camera,
    Cuboid,
    Data,
    DensityMap,
    Material,
    Object,
    ObjectFlags,
    Rect,
    Scene,
    Sphere,
    Transform,
    Update,
    UpdateQueue,
)
from bendy_tpu_torch.scene.io import load_scene, loads_scene, save_scene, dumps_scene  # noqa: F401
from bendy_tpu_torch.scene.compiler import SceneArrays, compile_scene, scene_arrays_from_numpy  # noqa: F401
from bendy_tpu_torch.utils import color, image, rng, v3  # noqa: F401
