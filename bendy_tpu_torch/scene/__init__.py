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
from bendy_tpu_torch.scene.compiler import SceneArrays, compile_scene  # noqa: F401
