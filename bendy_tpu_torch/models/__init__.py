"""Ready-made scene constructions (copies of ``bendy_tpu/models``).

- :func:`bendy_tpu_torch.models.cornell.build_cornell` — the reference
  app's built-in default scene (``src/main.rs:108-213``).
- :func:`bendy_tpu_torch.models.blackhole.build_blackhole` — the lensed
  showcase (Schwarzschild mass, emissive stars, accretion ring).
- :func:`bendy_tpu_torch.models.binary_blackhole.build_binary_blackhole` —
  two-mass lensing.
- :func:`bendy_tpu_torch.models.blackhole_cloud.build_blackhole_cloud` —
  volumetric accretion disk (geodesic × participating media).
- :func:`bendy_tpu_torch.models.dense_cloud.build_dense_cloud` — a dense
  32³ density grid.
- :func:`bendy_tpu_torch.models.cloud_field.build_cloud_field` — 256
  volume puffs sharing one sparse grid (the looped primitive sweep).
- :func:`bendy_tpu_torch.models.mass_cluster.build_mass_cluster` — cluster
  lensing by 64 masses (the looped mass sweep).
- :func:`bendy_tpu_torch.models.prim_grid.build_prim_grid`,
  :func:`~bendy_tpu_torch.models.prim_grid.build_light_field`,
  :func:`~bendy_tpu_torch.models.prim_grid.build_cuboid_light` — generated
  primitive-count, light-count and cuboid-light scenes.
"""

from bendy_tpu_torch.models.blackhole import build_blackhole  # noqa: F401
from bendy_tpu_torch.models.binary_blackhole import build_binary_blackhole  # noqa: F401
from bendy_tpu_torch.models.blackhole_cloud import build_blackhole_cloud  # noqa: F401
from bendy_tpu_torch.models.cloud_field import build_cloud_field, puff_density  # noqa: F401
from bendy_tpu_torch.models.cornell import build_cornell  # noqa: F401
from bendy_tpu_torch.models.dense_cloud import build_dense_cloud  # noqa: F401
from bendy_tpu_torch.models.mass_cluster import build_mass_cluster  # noqa: F401
from bendy_tpu_torch.models.prim_grid import (  # noqa: F401
    build_cuboid_light,
    build_light_field,
    build_prim_grid,
)
