"""ctypes binding for the native C++ CPU oracle (``native/oracle.cpp``).

Counterpart of ``bendy_tpu/native.py`` over the port's :class:`SceneArrays`:
packs the compiled scene into the flat strided layout the C side expects
and exposes :func:`oracle_render`. The oracle is an independent
multithreaded C++ implementation of the reference algorithm, the ground
truth of the image-level gates (``tests/test_torch_native.py``,
``tools/fidelity.py``). It runs on the CPU by design: it is not a device
route, and nothing here renders on the card.

The library is the tracked ``native/liboracle.so``. Where that file is
missing or does not load on this host, ``native/oracle.cpp`` is built with
the reference's g++ line into the package's git-ignored ``_build/`` (never
into ``native/``), keyed by a hash of the source.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from bendy_tpu_torch.scene.compiler import SceneArrays

_SPH_STRIDE = 18
_RCT_STRIDE = 32  # 0:3 center, 3:6 inv-T x, 6:9 inv-T y, 9:12 unit normal,
#   12 hw, 13 hh, 14 mtype, 15:18 albedo, 18 rough, 19 ior, 20:23 emitted,
#   24:27 forward x (M·x̂), 27:30 forward y — affine-aware light sampling

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB_PATH = os.path.join(_REPO, "native", "liboracle.so")
SRC_PATH = os.path.join(_REPO, "native", "oracle.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
GXX = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]  # bendy_tpu/native.py:40-41

_f, _i, _p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
# native/oracle.cpp:543-564
_ARGTYPES = (
    [_p, _i, _p, _i, _p, _p, _p, _p, _i, _p, _i, _i, _i, _i, _i, _p, _p, _p, _i]
    + [_f, _f, _f, _f, _f, _i]  # GeoParams: eta, min_step, max_step, far, growth, max_steps
    + [_i, _i, _f, _f, _f]  # max_bounces, max_volume_bounces, clip_min, clip_max, volume_step
    + [_f, _f, _f, _f, _f, _p, _p]  # sensor, focal, aspect, fstop, focus, rot, trans
    + [_i, _i, _i, _i, ctypes.c_uint64, _p]  # width, height, spp, subsample, seed, out
)


def _build() -> str:
    """Compile ``native/oracle.cpp`` into ``_build/liboracle-<hash>.so``
    (written to a temporary name, then renamed, so that concurrent
    builds never load half a file); returns its path."""
    with open(SRC_PATH, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"liboracle-{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(GXX + ["-o", tmp, SRC_PATH], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC_PATH}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.cache
def _load() -> ctypes.CDLL:
    """The oracle library: the tracked ``native/liboracle.so``, else a
    build of ``native/oracle.cpp`` under ``_build/``; raises, saying why,
    when neither loads."""
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError as tracked:
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, RuntimeError, subprocess.SubprocessError) as built:
            raise RuntimeError(f"the native oracle does not load: {LIB_PATH}: {tracked}; "
                               f"building {SRC_PATH}: {built}") from built
    lib.oracle_render.argtypes = _ARGTYPES
    lib.oracle_render.restype = None
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def pack_scene(scn: SceneArrays):
    """SceneArrays -> (spheres [Ns,18] f32, rects [Nr,32] f32, light kinds,
    light sphere rows, light face rows, light face counts), the layout of
    ``bendy_tpu.native.pack_scene``, from the host copy."""
    scn = scn.host_copy()
    ns = scn.n_spheres
    nr = scn.n_rects
    sph = np.zeros((max(ns, 1), _SPH_STRIDE), np.float32)
    if ns:
        sph[:ns, 0:3] = np.asarray(scn.sph_center)
        sph[:ns, 3] = np.asarray(scn.sph_radius)
        sph[:ns, 4] = np.asarray(scn.sph_mtype)
        sph[:ns, 5:8] = np.asarray(scn.sph_albedo)
        sph[:ns, 8] = np.asarray(scn.sph_rough)
        sph[:ns, 9] = np.asarray(scn.sph_ior)
        sph[:ns, 10:13] = np.asarray(scn.sph_emitted)
        sph[:ns, 13] = np.asarray(scn.sph_vol_grid)
        sph[:ns, 14:17] = np.asarray(scn.sph_vol_size)
    rct = np.zeros((max(nr, 1), _RCT_STRIDE), np.float32)
    if nr:
        rct[:nr, 0:3] = np.asarray(scn.rct_center)
        rct[:nr, 3:6] = np.asarray(scn.rct_x)
        rct[:nr, 6:9] = np.asarray(scn.rct_y)
        rct[:nr, 9:12] = np.asarray(scn.rct_z)
        rct[:nr, 12] = np.asarray(scn.rct_hw)
        rct[:nr, 13] = np.asarray(scn.rct_hh)
        rct[:nr, 14] = np.asarray(scn.rct_mtype)
        rct[:nr, 15:18] = np.asarray(scn.rct_albedo)
        rct[:nr, 18] = np.asarray(scn.rct_rough)
        rct[:nr, 19] = np.asarray(scn.rct_ior)
        rct[:nr, 20:23] = np.asarray(scn.rct_emitted)
        rct[:nr, 24:27] = np.asarray(scn.rct_fx)
        rct[:nr, 27:30] = np.asarray(scn.rct_fy)

    kinds = np.asarray(scn.light_kind, np.int32)
    srows = np.asarray(scn.light_sph_row, np.int32)
    rrows = np.asarray(scn.light_rct_rows, np.int32)
    face_rows, face_counts = [], []
    for li in range(scn.n_lights):
        rows = [int(r) for r in rrows[li] if r >= 0]
        face_rows.extend(rows)
        face_counts.append(len(rows))
    return (
        sph, rct, kinds, srows,
        np.asarray(face_rows or [0], np.int32),
        np.asarray(face_counts, np.int32),
    )


def oracle_render(
    scn: SceneArrays,
    cam_rot: np.ndarray,
    cam_trans: np.ndarray,
    sensor: float,
    focal: float,
    aspect: float,
    fstop: float,
    focus: float | None,
    width: int,
    height: int,
    spp: int,
    subsample: int = 1,
    seed: int = 0,
    max_bounces: int = 8,
    max_volume_bounces: int = 32,
    clip_min: float = 0.01,
    clip_max: float = 1000.0,
    volume_step: float = 0.1,
    geo=None,
) -> np.ndarray:
    """Render the linear mean image [H,W,3] with the native oracle.

    Scenes with ``mass:<rs>`` objects propagate along RK4 geodesic chords
    (same semantics as ``bendy_tpu_torch.geodesic``; ``geo`` overrides
    GeoParams).
    """
    from bendy_tpu_torch.geodesic import GeoParams

    lib = _load()
    geo = geo or GeoParams()
    scn = scn.host_copy()
    sph, rct, kinds, srows, frows, fcounts = pack_scene(scn)
    grids = np.ascontiguousarray(np.asarray(scn.vol_grid), np.float32)
    g, gd, gh, gw = grids.shape
    root_albedo = np.ascontiguousarray(scn.root_albedo, np.float32)
    root_emitted = np.ascontiguousarray(scn.root_emitted, np.float32)
    n_masses = scn.n_masses
    masses = np.zeros((max(n_masses, 1), 4), np.float32)
    if n_masses:
        masses[:n_masses, :3] = np.asarray(scn.mass_center)
        masses[:n_masses, 3] = np.asarray(scn.mass_rs)
    out = np.zeros((height, width, 3), np.float32)
    # every buffer the C side reads, kept referenced until the call returns
    bufs = [np.ascontiguousarray(a, np.float32) for a in (sph, rct)]
    ints = [np.ascontiguousarray(a, np.int32) for a in (kinds, srows, frows, fcounts)]
    rotm = np.ascontiguousarray(cam_rot, np.float32)
    trans = np.ascontiguousarray(cam_trans, np.float32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.oracle_render(
        ptr(bufs[0]), scn.n_spheres,
        ptr(bufs[1]), scn.n_rects,
        *(ptr(a) for a in ints), scn.n_lights,
        ptr(grids), g, gd, gh, gw,
        int(scn.root_mtype), ptr(root_albedo), ptr(root_emitted),
        ptr(masses), n_masses,
        geo.eta, geo.min_step, geo.max_step, geo.far, geo.growth, geo.max_steps,
        max_bounces, max_volume_bounces, clip_min, clip_max, volume_step,
        sensor, focal, aspect, fstop, -1.0 if focus is None else focus,
        ptr(rotm), ptr(trans),
        width, height, spp, subsample, seed,
        ptr(out),
    )
    return out


def oracle_render_scene(scene, width, height, spp, subsample=1, seed=0, **cfg) -> np.ndarray:
    """Convenience: host Scene -> native oracle image (the scene compiled
    on the CPU)."""
    from bendy_tpu_torch.scene.compiler import compile_scene, find_camera

    scn = compile_scene(scene, device="cpu")
    cam, world = find_camera(scene)
    return oracle_render(
        scn,
        world[:, :3],
        world[:, 3],
        cam.sensor_size,
        cam.focal_length,
        cam.aspect_ratio,
        cam.fstop,
        cam.focus,
        width,
        height,
        spp,
        subsample=subsample,
        seed=seed,
        **cfg,
    )
