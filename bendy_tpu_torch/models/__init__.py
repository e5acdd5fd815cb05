"""Ready-made scene constructions (copies of ``bendy_tpu/models``).

- :func:`bendy_tpu_torch.models.cornell.build_cornell` — the reference
  app's built-in default scene (``src/main.rs:108-213``).
- :func:`bendy_tpu_torch.models.blackhole.build_blackhole` — the lensed
  showcase (Schwarzschild mass, emissive stars, accretion ring).
- :func:`bendy_tpu_torch.models.binary_blackhole.build_binary_blackhole` —
  two-mass lensing.

The other builders (``blackhole_cloud``, ``cloud_field``, ``dense_cloud``,
``mass_cluster``, ``prim_grid``) come with the slices that can trace them.
"""

from bendy_tpu_torch.models.blackhole import build_blackhole  # noqa: F401
from bendy_tpu_torch.models.binary_blackhole import build_binary_blackhole  # noqa: F401
from bendy_tpu_torch.models.cornell import build_cornell  # noqa: F401
