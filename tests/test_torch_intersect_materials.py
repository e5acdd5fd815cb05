"""Port parity: nearest hit, light sampling/pdf and surface shading, per lane.

Seeded random rays and uniforms (numpy) go through the reference's
functions (run eagerly on the CPU) and the port's, against the compiled
cornell, cornell2 and scene tables. Tolerance: rtol 5e-4, atol 1e-5 (the
reference's own kernel contract, tests/test_pallas.py); discrete fields
(valid, face, material, scatter) must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bendy_tpu.ops import intersect as ref_isect
from bendy_tpu.ops import materials as ref_mat
from bendy_tpu.render import Renderer as RefRenderer
from bendy_tpu.scene import load_scene as ref_load
from bendy_tpu.utils.v3 import V3 as JV3
from bendy_tpu_torch import Renderer, load_scene
from bendy_tpu_torch.ops import intersect, materials
from bendy_tpu_torch.utils.v3 import V3
from torch_threads import one_intra_op_thread  # noqa: F401

SCENES = ["cornell", "cornell2", "scene"]
B = 2048
RTOL, ATOL = 5e-4, 1e-5
CLIP = (0.01, 1000.0)


@pytest.fixture(scope="module", params=SCENES)
def setup(request):
    path = f"scenes/{request.param}.json.gz"
    ref_r = RefRenderer(ref_load(path), use_pallas=False)
    port_r = Renderer(load_scene(path), device="cpu")
    g = np.random.default_rng(11 + SCENES.index(request.param))
    host = port_r.arrays.host_copy()
    cam_pos = port_r.scene.get_object(port_r.scene.find_by_tag("camera")).transform.world[:, 3]
    small = host.sph_center[host.sph_radius < 10.0]  # not scene.json's ground
    centers = np.concatenate([host.rct_center, small, host.light_sph_center, [cam_pos]])
    lo, hi = centers.min(0), centers.max(0)
    mid, half = (lo + hi) / 2, np.maximum((hi - lo) / 2, 1.0)
    org = (mid + g.uniform(-0.8, 0.8, (4 * B, 3)) * half).astype(np.float32)
    # no path starts inside a solid sphere: from inside scene.json's ground
    # sphere every shadow ray grazes the light from ~90 units away, where a
    # 1-ulp direction difference (jax's rsqrt is not 1/sqrt) flips the hit
    gap = np.linalg.norm(org[:, None] - host.sph_center[None], axis=2) - host.sph_radius
    org = org[(gap > 1e-2).all(axis=1)][:B]
    assert len(org) == B
    d = g.normal(size=(B, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    u = g.uniform(0, 1, (6, B)).astype(np.float32)
    return ref_r, port_r, org, d, u, g


def jv3(a):
    return JV3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def tv3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def close(port, ref, mask=None, name=""):
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    if mask is not None:
        p, r = p[mask], r[mask]
    np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL, err_msg=name)


def close3(port, ref, mask=None, name=""):
    for c in "xyz":
        close(getattr(port, c), getattr(ref, c), mask, f"{name}.{c}")


def hits(setup):
    ref_r, port_r, org, d, _, _ = setup
    full = lambda v: jnp.full(B, v, jnp.float32)  # noqa: E731
    ref = ref_isect.nearest_hit(jv3(org), jv3(d), full(CLIP[0]), full(CLIP[1]), ref_r.arrays)
    port = intersect.nearest_hit(tv3(org), tv3(d), CLIP[0], CLIP[1], port_r.arrays)
    return ref, port


def test_nearest_hit(setup):
    ref, port = hits(setup)
    valid = np.asarray(ref.valid)
    assert valid.mean() > 0.25  # a good share of the rays hit something
    np.testing.assert_array_equal(port.valid.numpy(), valid)
    np.testing.assert_array_equal(port.face.numpy(), np.asarray(ref.face))
    np.testing.assert_array_equal(port.mtype.numpy()[valid], np.asarray(ref.mtype)[valid])
    close(port.t, ref.t, valid, "t")
    for f in ("position", "normal", "albedo", "emitted"):
        close3(getattr(port, f), getattr(ref, f), valid, f)
    close(port.rough, ref.rough, valid, "rough")
    close(port.ior, ref.ior, valid, "ior")


def test_light_pdf_and_sample(setup):
    ref_r, port_r, org, d, u, g = setup
    nl = port_r.arrays.n_lights
    li = g.integers(0, nl, B).astype(np.int32)
    full = lambda v: jnp.full(B, v, jnp.float32)  # noqa: E731
    ref_pdf = ref_isect.light_pdf(jv3(org), jv3(d), full(CLIP[0]), full(CLIP[1]),
                                  ref_r.arrays, jnp.asarray(li))
    port_pdf = intersect.light_pdf(tv3(org), tv3(d), CLIP[0], CLIP[1], port_r.arrays,
                                   torch.from_numpy(li))
    close(port_pdf, ref_pdf, name="pdf")
    ref_p = ref_mat.sample_light_point(ref_r.arrays, jnp.asarray(li), jnp.asarray(u[0]),
                                       jnp.asarray(u[1]), jnp.asarray(u[2]))
    port_p = materials.sample_light_point(port_r.arrays, torch.from_numpy(li),
                                          *(torch.from_numpy(u[i]) for i in range(3)))
    close3(port_p, ref_p, name="light point")
    # rays aimed at the sampled points hit the light: a nonzero pdf to hold
    to = np.stack([np.asarray(c) for c in ref_p], 1) - org
    to = (to / np.linalg.norm(to, axis=1, keepdims=True)).astype(np.float32)
    ref_pdf = ref_isect.light_pdf(jv3(org), jv3(to), full(CLIP[0]), full(CLIP[1]),
                                  ref_r.arrays, jnp.asarray(li))
    port_pdf = intersect.light_pdf(tv3(org), tv3(to), CLIP[0], CLIP[1], port_r.arrays,
                                   torch.from_numpy(li))
    assert (np.asarray(ref_pdf) > 0).mean() > 0.9
    close(port_pdf, ref_pdf, name="pdf toward light")


def test_shade_surface(setup):
    ref_r, port_r, org, d, u, _ = setup
    ref_hit, port_hit = hits(setup)
    cam = ref_r.scene.find_by_tag("camera")
    cfg = port_r.trace_config(port_r.config, cam)
    flags = dict(has_diffuse=cfg.has_diffuse, has_metallic=cfg.has_metallic,
                 has_glass=cfg.has_glass)
    ref = ref_mat.shade_surface(jv3(d), ref_hit, ref_r.arrays,
                                [jnp.asarray(x) for x in u], *CLIP, **flags)
    port = materials.shade_surface(tv3(d), port_hit, port_r.arrays,
                                   [torch.from_numpy(x) for x in u], *CLIP, **flags)
    valid = np.asarray(ref_hit.valid)
    np.testing.assert_array_equal(port.scatter.numpy()[valid], np.asarray(ref.scatter)[valid])
    for f in ("emitted", "direction", "weight", "aov_albedo", "aov_normal"):
        close3(getattr(port, f), getattr(ref, f), valid, f)
    close(port.aov_depth, ref.aov_depth, valid, "aov_depth")
