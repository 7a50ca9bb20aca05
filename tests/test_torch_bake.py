"""The port's host bake (``ops/bake.py``) against the JAX package's bake
helpers and intersect closures, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.models import fused as jfused
from wavefront_path_tracer_tpu.ops import pallas_kernels as jpk
from wavefront_path_tracer_tpu_torch.convert import scene_arrays_to_torch
from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import bake
from wavefront_path_tracer_tpu_torch.scene import CameraController, get_scene

torch.set_num_threads(2)

KEYS = ("centers", "radii", "albedo", "fuzz", "refract_idx", "mat_type")


def _arrays(scene):
    return {k: np.asarray(getattr(scene, k)) for k in KEYS}


def _random_scene(seed=5, n=80):
    """Seeded spheres with every material: glass, fuzzy and sharp metal,
    Lambertian; some overlapping, one inside-out."""
    rng = np.random.default_rng(seed)
    radii = rng.uniform(0.1, 0.6, n).astype(np.float32)
    radii[3] = -0.3
    return {
        "centers": (rng.normal(size=(n, 3)) * 3).astype(np.float32),
        "radii": radii,
        "albedo": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "fuzz": np.where(rng.uniform(size=n) < 0.5, 0.0,
                         rng.uniform(0, 0.5, n)).astype(np.float32),
        "refract_idx": rng.uniform(1.3, 1.7, n).astype(np.float32),
        "mat_type": rng.integers(0, 3, n).astype(np.int32),
    }


SCENES = {
    "book_one_final": lambda: _arrays(get_scene("book_one_final")),
    "book_bubble": lambda: _arrays(get_scene("book_bubble")),
    "procedural96": lambda: _arrays(get_scene("procedural", n=96, seed=3)),
    "random": _random_scene,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_morton_order_bit_exact(name):
    a = SCENES[name]()
    for centers in (a["centers"], a["centers"][::3]):
        port = bake._morton_order(centers)
        ref = jpk._morton_order(centers)
        np.testing.assert_array_equal(port, ref)
        assert port.dtype == ref.dtype


@pytest.mark.parametrize("name", sorted(SCENES))
def test_t2_elidable_equal(name):
    a = SCENES[name]()
    port = bake._t2_elidable(a["centers"], a["radii"], a["mat_type"],
                             a["fuzz"])
    ref = jpk._t2_elidable(a["centers"], a["radii"], a["mat_type"],
                           a["fuzz"])
    np.testing.assert_array_equal(port, ref)
    if name in ("book_bubble", "random"):
        assert not port[np.asarray(a["radii"]) < 0].any()


def test_pack_decode_equal():
    a = _random_scene(seed=9)
    albedo = a["albedo"]
    albedo[:4] = [[0.0, 1.0, 0.5], [1.0, 1.0, 1.0], [0.25, 0.75, 1e-6],
                  [0.99999, 2e-5, 0.5]]
    port = bake.decoded_attributes(albedo, a["mat_type"], packed=True)
    words = [jpk._pack_albedo_mat(*albedo[i], a["mat_type"][i], "16")
             for i in range(albedo.shape[0])]
    for i, w in enumerate(words):
        assert bake._pack_albedo_mat(*albedo[i], a["mat_type"][i]) == w
    pks = [jnp.asarray(np.array([w[k] for w in words], np.int32))
           for k in range(2)]
    ref = np.stack([np.asarray(v) for v in jpk._unpack_albedo_mat(pks,
                                                                   "16")],
                   axis=1)
    np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32))
    # The packed decode differs from the exact albedo by at most 1/131070.
    exact = bake.decoded_attributes(albedo, a["mat_type"], packed=False)
    assert np.abs(port - exact).max() <= 1.0 / 131070 + 1e-7


def test_pack_refused_outside_unit_albedo():
    a = _random_scene(seed=2)
    a["albedo"][7, 1] = 1.5          # emissive-style: exact floats kept
    assert bake._resolve_pack(a["albedo"]) is None
    assert jpk._resolve_pack(True, a["albedo"]) == (None, 0)
    baked = bake.bake_culled(a, 8)
    fn = jpk.baked_culled_intersect(*(a[k] for k in KEYS), cluster_size=8)
    assert baked.pack_attrs is None and fn.pack_attrs is None
    items = baked.items.numpy()
    row = np.nonzero((items[:, 8:11] == a["centers"][7]).all(axis=1))[0]
    np.testing.assert_array_equal(items[row[0], 12:15], a["albedo"][7])
    a["albedo"][7, 1] = 0.5
    assert bake.bake_culled(a, 8).pack_attrs == "16"


def _check_meta(port, ref):
    assert port.n_globals == ref.n_globals
    assert port.n_clusters == ref.n_clusters
    assert port.n_supers == ref.n_supers
    assert port.n_clustered_items == ref.n_clustered_items
    assert port.pack_attrs == ref.pack_attrs
    assert len(port.cluster_aabbs) == len(ref.cluster_aabbs)
    for (plo, phi), (rlo, rhi) in zip(port.cluster_aabbs, ref.cluster_aabbs):
        assert plo == list(rlo) and phi == list(rhi)


HINTS = {
    "none": None,
    "reference": np.array([13.0, 2.0, 3.0]),
    "cover": np.array([-2.0, 2.0, 1.0]),
}


@pytest.mark.parametrize("hint", sorted(HINTS))
@pytest.mark.parametrize("clusters", [16, 8])
def test_bake_culled_metadata_book_one_final(clusters, hint):
    a = _arrays(get_scene("book_one_final"))
    port = bake.bake_culled(a, clusters, camera_hint=HINTS[hint])
    ref = jpk.baked_culled_intersect(*(a[k] for k in KEYS),
                                     cluster_size=clusters,
                                     camera_hint=HINTS[hint])
    _check_meta(port, ref)
    assert port.n_globals == 1            # the r=1000 ground
    # Table rows agree with the metadata: globals, then every cluster's
    # spheres once, each cluster inside its box.
    ranges = port.cluster_ranges.numpy()
    assert ranges[0, 0] == port.n_globals
    assert (ranges[1:, 0] == np.cumsum(ranges[:-1, 1]) + port.n_globals).all()
    assert port.n_items == port.n_globals + port.n_clustered_items
    boxes = port.cluster_boxes.numpy()
    items = port.items.numpy()
    for (first, count), box in zip(ranges, boxes):
        c = items[first:first + count, 8:11]
        assert (c >= box[0:3]).all() and (c <= box[4:7]).all()
    # Columns 5-7 are the reference's folded constant 2.0 * cxp: the
    # float64 2 (c - shift) rounded once to float32.
    rest = a["radii"] <= 10 * float(np.median(a["radii"]))
    shift = np.median(a["centers"][rest].astype(np.float64), axis=0)
    np.testing.assert_array_equal(
        items[:, 5:8],
        (2.0 * (items[:, 8:11].astype(np.float64) - shift)).astype(np.float32))


def test_bake_culled_two_level():
    a = _arrays(get_scene("procedural", n=120, seed=3))
    hint = np.array([-2.0, 2.0, 1.0])
    port = bake.bake_culled(a, 2, camera_hint=hint)
    ref = jpk.baked_culled_intersect(*(a[k] for k in KEYS), cluster_size=2,
                                     camera_hint=hint)
    _check_meta(port, ref)
    assert port.n_clusters > bake.SUPER_GATE
    sup = port.super_ranges.numpy()
    assert sup.shape[0] == port.n_supers
    assert sup[:, 1].sum() == port.n_clusters


def test_bake_unculled_table():
    a = _arrays(get_scene("book_bubble"))
    port = bake.bake_unculled(a)
    items = port.items.numpy()
    np.testing.assert_array_equal(items[:, 0:3], a["centers"])
    np.testing.assert_array_equal(
        items[:, 3], (a["radii"].astype(np.float64) ** 2).astype(np.float32))
    np.testing.assert_array_equal(
        items[:, 4].astype(bool),
        jpk._t2_elidable(a["centers"], a["radii"], a["mat_type"],
                         a["fuzz"]))
    np.testing.assert_array_equal(items[:, 16],
                                  np.where(a["radii"] > 0, 1.0, -1.0))
    assert port.n_clusters == 0 and port.cluster_boxes.shape == (0, 8)
    assert (items[:, 5:8] == 0).all()


def test_tiny_scene_is_all_globals():
    a = _arrays(get_scene("book_cover"))
    port = bake.bake_culled(a, 16)
    ref = jpk.baked_culled_intersect(*(a[k] for k in KEYS), cluster_size=16)
    _check_meta(port, ref)
    assert port.n_globals == len(a["radii"]) and port.n_clusters == 0


def test_shift_subtracts_float32():
    """The JAX closure subtracts its float64 shift from float32 rays with
    x64 off, i.e. in float32 after rounding the shift; the port's consts
    carry float32(shift)."""
    a = _arrays(get_scene("book_one_final"))
    port = bake.bake_culled(a, 16)
    rest = a["radii"] <= 10 * float(np.median(a["radii"]))
    shift = np.median(a["centers"][rest].astype(np.float64), axis=0)
    np.testing.assert_array_equal(port.consts[0:3].numpy(),
                                  shift.astype(np.float32))
    ox = np.random.default_rng(0).normal(size=256).astype(np.float32) * 9
    ref = np.asarray(jnp.asarray(ox) - np.float64(shift[0]))
    port_sub = (torch.from_numpy(ox) - port.consts[0]).numpy()
    np.testing.assert_array_equal(port_sub, ref)


@pytest.mark.parametrize("view", ["reference", "cover"])
def test_camera_hint_quantized_as_reference(view):
    """The render path's bake (hint quantized to 1/8 of the scene
    diagonal) orders clusters as the JAX package's ``_baked_fn``."""
    a = _arrays(get_scene("book_one_final"))
    cc = CameraController.book_one_final()
    if view == "cover":
        cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    eye = jfused._concrete_eye(cc.view_matrix())
    ref = jfused._baked_fn(a, 16, camera_pos=eye)
    port = tfused._baked_scene(scene_arrays_to_torch(a, "cpu"), 16,
                               camera_pos=tfused._concrete_eye(
                                   cc.view_matrix()))
    _check_meta(port, ref)
