"""Port parity: scene IO and the scene compiler (bendy_tpu_torch vs bendy_tpu).

The compiled tables are the port's state in place of weights, so they are
held bit-equal to the reference on every bundled scene; the wire format is
held byte-equal.
"""

import glob
from dataclasses import fields

import numpy as np
import pytest
import torch

import bendy_tpu.scene as ref_scene
import bendy_tpu_torch.scene as port_scene
from bendy_tpu_torch.scene.compiler import SceneArrays, scene_arrays_from_numpy
from torch_threads import one_intra_op_thread  # noqa: F401

SCENES = sorted(glob.glob("scenes/*.json.gz"))


def test_all_bundled_scenes_listed():
    assert len(SCENES) == 12


@pytest.mark.parametrize("path", SCENES)
def test_load_and_dump_byte_equal(path):
    text = ref_scene.dumps_scene(ref_scene.load_scene(path))
    port = port_scene.load_scene(path)
    assert port_scene.dumps_scene(port) == text
    # and the port's own round trip is stable
    assert port_scene.dumps_scene(port_scene.loads_scene(text)) == text


@pytest.mark.parametrize("path", SCENES)
def test_compile_bit_equal(path):
    ref = ref_scene.compile_scene(ref_scene.load_scene(path)).host_copy()
    port = port_scene.compile_scene(port_scene.load_scene(path), device="cpu")
    host = port.host_copy()
    for f in fields(SceneArrays):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(host, f.name)
        t = getattr(port, f.name)
        assert b.dtype == a.dtype and b.shape == a.shape, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu", f.name
        np.testing.assert_array_equal(t.numpy(), a, err_msg=f.name)
    assert (port.n_spheres, port.n_trace_rects, port.n_boxes, port.n_lights) == (
        ref.sph_radius.shape[0], ref.rct_traced.shape[0], ref.box_rough.shape[0],
        ref.light_kind.shape[0])


def _diffuse_without_light(pkg):
    scene = pkg.Scene()
    mat = scene.add_data(pkg.Data(pkg.Material.diffuse((0.5, 0.5, 0.5), 1.0)))
    scene.add_object(pkg.Object(pkg.Sphere(material=mat, radius=1.0)).with_tag("ball"))
    return scene


def _singular_rect(pkg):
    scene = pkg.Scene()
    mat = scene.add_data(pkg.Data(pkg.Material.flat((1.0, 1.0, 1.0))))
    rect = pkg.Rect.from_edges(mat, [1.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    world = np.zeros((3, 4))
    world[:, :3] = np.diag([1.0, 1.0, 0.0])
    scene.add_object(pkg.Object(rect).with_transform(world).with_tag("flat"))
    return scene


@pytest.mark.parametrize("build", [_diffuse_without_light, _singular_rect])
def test_validate_scene_same_errors(build):
    with pytest.raises(ValueError) as ref_err:
        ref_scene.compile_scene(build(ref_scene))
    with pytest.raises(ValueError) as port_err:
        port_scene.compile_scene(build(port_scene), device="cpu")
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("name", ["cornell", "scene", "volume"])
def test_scene_arrays_from_numpy_round_trip(name):
    path = f"scenes/{name}.json.gz"
    ref = ref_scene.compile_scene(ref_scene.load_scene(path)).host_copy()
    port = scene_arrays_from_numpy(ref, device="cpu")
    for f in fields(SceneArrays):
        a = np.asarray(getattr(ref, f.name))
        t = getattr(port, f.name)
        assert str(t.dtype) == "torch." + {"float32": "float32", "int32": "int32",
                                           "bool": "bool"}[a.dtype.name], f.name
        np.testing.assert_array_equal(t.numpy(), a, err_msg=f.name)
        np.testing.assert_array_equal(getattr(port.host_copy(), f.name), a)
    # and back through the port's own converter
    again = scene_arrays_from_numpy(port.host_copy(), device="cpu")
    for f in fields(SceneArrays):
        assert torch.equal(getattr(again, f.name), getattr(port, f.name)), f.name


def test_find_camera_matches():
    ref_cam, ref_world = ref_scene.compiler.find_camera(ref_scene.load_scene(SCENES[0]))
    port_cam, port_world = port_scene.compiler.find_camera(port_scene.load_scene(SCENES[0]))
    assert vars(port_cam) == vars(ref_cam)
    np.testing.assert_array_equal(port_world, ref_world)
    with pytest.raises(ValueError, match="no object tagged"):
        port_scene.compiler.find_camera(port_scene.Scene())


def test_geodesic_block_rejects_unknown_keys():
    scene = port_scene.Scene()
    scene.geodesic = {"etaa": 0.1}
    with pytest.raises(ValueError, match="etaa"):
        port_scene.loads_scene(port_scene.dumps_scene(scene))
