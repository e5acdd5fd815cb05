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

The other builders (``cloud_field``, ``mass_cluster``, ``prim_grid``) come
with the slice that can trace them (the looped sweeps).
"""

from bendy_tpu_torch.models.blackhole import build_blackhole  # noqa: F401
from bendy_tpu_torch.models.binary_blackhole import build_binary_blackhole  # noqa: F401
from bendy_tpu_torch.models.blackhole_cloud import build_blackhole_cloud  # noqa: F401
from bendy_tpu_torch.models.cornell import build_cornell  # noqa: F401
from bendy_tpu_torch.models.dense_cloud import build_dense_cloud  # noqa: F401
