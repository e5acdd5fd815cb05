"""bendy_tpu_torch: the bendy-tpu path tracer on PyTorch and CUDA (H100).

The port of ``bendy_tpu`` (JAX on a TPU), which stays beside it as the
reference each module is tested against. It imports torch and numpy,
never jax. Each file mirrors the ``bendy_tpu`` file of the same path:

    utils/     color transfer, vector math, counter-based RNG, image IO
    scene/     scene graph + (de)serialization (copies) + SoA scene compiler
    ops/       samplers, camera rays, intersection, materials, the
               wavefront integrator (plain PyTorch) and trace_kernel.py,
               the launch glue of the CUDA tracer kernel
    csrc/      hand-written CUDA C++ kernels for sm_90a (built by _build.py
               with nvcc at first use)
    film.py    progressive accumulation buffer + checkpointing
    render.py  Renderer / Config / RenderConfig front-end

Ported so far: the surface main path (spheres, rects, boxes; all five
materials; AOVs). Volumes, dense grids, geodesics, the looped table
sweeps, multi-device passes, the CLI and the preview server are not.
"""

__version__ = "0.1.0"

from bendy_tpu_torch.render import Config, Output, RenderConfig, Renderer, Status, Subsample  # noqa: F401,E402
from bendy_tpu_torch.film import DeviceFilm, Film  # noqa: F401,E402
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
