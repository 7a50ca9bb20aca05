"""The port's BVH against the JAX package's, on the CPU:
``ops/compact.py``, ``scene/bvh.py``, ``native/bvh_native.py``,
``ops/bvh_traverse.py`` and the BVH tables of ``renderer.prepare_scene``.

The builders run on the host in numpy (and C++) and are held byte for
byte.  The traversal's winners (index and hit) are held exactly.  XLA on
the CPU contracts multiply-adds, so ``t`` differs by roundings: within
1e-5 relative on all but five of the 8,192 sphere and triangle hits
below, which are ill-conditioned (a quadratic's root where the centre is
far beside the radius, a triangle hit just past T_MIN) and reach 1.4e-5
and 1.8e-5; so ``t`` is held to 2e-5 relative.  On the ground spheres
(radius 100 and 1000) the quadratic rounds at ulps of the radius squared,
and ``t`` is held to 1e-6 of the radius.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.native import bvh_native as jnative
from wavefront_path_tracer_tpu.ops import bvh_traverse as jtrav
from wavefront_path_tracer_tpu.ops.compact import compaction_order as jorder
from wavefront_path_tracer_tpu.renderer import prepare_scene as jprepare
from wavefront_path_tracer_tpu.scene import bvh as jbvh
from wavefront_path_tracer_tpu.scene import book_cover, book_one_final
from wavefront_path_tracer_tpu.scene import procedural_spheres
from wavefront_path_tracer_tpu.scene.mesh import mesh_terrain_scene
from wavefront_path_tracer_tpu.utils.config import RenderConfig as JConfig
from wavefront_path_tracer_tpu_torch.convert import scene_arrays_to_torch
from wavefront_path_tracer_tpu_torch.native import bvh_native as tnative
from wavefront_path_tracer_tpu_torch.ops import bvh_traverse as ttrav
from wavefront_path_tracer_tpu_torch.ops.compact import compact
from wavefront_path_tracer_tpu_torch.ops.compact import (
    compaction_order as torder,
)
from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
from wavefront_path_tracer_tpu_torch.scene import bvh as tbvh
from wavefront_path_tracer_tpu_torch.scene import get_scene
from wavefront_path_tracer_tpu_torch.scene import (
    mesh_terrain_scene as tterrain,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

N = 4096
T_RTOL = 2e-5
GROUND_RADIUS = 100.0


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --- ops/compact.py ------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "sparse", "all", "none", "one"])
def test_compaction_order_equals_jax(case):
    rng = np.random.default_rng(11)
    n = 1000
    keep = {"random": rng.random(n) < 0.5, "sparse": rng.random(n) < 0.03,
            "all": np.ones(n, bool), "none": np.zeros(n, bool),
            "one": np.arange(n) == 517}[case]
    order, count = torder(_t(keep))
    j_order, j_count = jorder(jnp.asarray(keep))
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    assert int(count) == int(j_count) == keep.sum()
    assert order.dtype == torch.int64


def test_compact_moves_every_array_alike():
    rng = np.random.default_rng(12)
    keep = _t(rng.random(300) < 0.4)
    a = torch.arange(300)
    b = torch.arange(300 * 3, dtype=torch.float32).reshape(300, 3)
    count, ca, cb = compact(keep, a, b)
    count = int(count)
    np.testing.assert_array_equal(ca[:count].numpy(),
                                  np.flatnonzero(keep.numpy()))
    assert torch.equal(cb, b[ca])
    assert sorted(ca.tolist()) == list(range(300))    # a permutation


# --- scene/bvh.py and native/ ---------------------------------------------

def _scenes():
    return {"book_cover": book_cover(), "book_one_final": book_one_final(42),
            "procedural": procedural_spheres(n=2000, seed=9)}


@pytest.fixture(scope="module")
def scenes():
    return _scenes()


def _same_tree(a, b, perm_a, perm_b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    np.testing.assert_array_equal(perm_a, perm_b)


@pytest.mark.parametrize("name", ["book_cover", "book_one_final",
                                  "procedural"])
def test_builders_byte_identical(scenes, name):
    """The numpy builder, its AABB form and the native builder give the
    JAX package's tables and permutation byte for byte, and equal
    depths."""
    s = scenes[name]
    jtree, jperm = jbvh.build_flat_bvh(s.centers, s.radii)
    ttree, tperm = tbvh.build_flat_bvh(s.centers, s.radii)
    _same_tree(ttree, jtree, tperm, jperm)
    lo, hi = s.aabbs()
    (ta, tp), (ja, jp) = (b.build_flat_bvh_aabb(lo, hi) for b in (tbvh, jbvh))
    _same_tree(ta, ja, tp, jp)
    ntree, nperm = tnative.build_flat_bvh(s.centers, s.radii)
    _same_tree(ntree, jtree, nperm, jperm)
    jn_tree, jn_perm = jnative.build_flat_bvh(s.centers, s.radii)
    _same_tree(ntree, jn_tree, nperm, jn_perm)
    assert tbvh.bvh_depth(ttree) == jbvh.bvh_depth(jtree)
    assert ttrav._flat_depth(ttree.left_first, ttree.prim_count) == \
        jbvh.bvh_depth(jtree)


@pytest.mark.parametrize("backend", ["numpy", "native", "auto"])
def test_build_bvh_reorders_scene_as_jax(backend):
    s = get_scene("book_one_final")
    ttree, tscene = tbvh.build_bvh(s, backend=backend)
    jtree, jscene = jbvh.build_bvh(book_one_final(42), backend="native")
    _same_tree(ttree, jtree, [], [])
    for key in ("centers", "radii", "mat_type", "albedo", "fuzz",
                "refract_idx", "mat_idx"):
        np.testing.assert_array_equal(getattr(tscene, key),
                                      getattr(jscene, key))


def test_native_library_lands_in_build_dir():
    path = tnative.library_path()
    tnative._load()
    assert path.exists() and path.parent.parent.name == "native"
    assert path.parents[2].name == "build"


# --- ops/bvh_traverse.py -------------------------------------------------

def _rays(seed, n=N, lo=-6.0, hi=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _hold(port, ref, radius=None):
    """Winners exactly, t as the module docstring says."""
    t, idx, hit = (x.numpy() for x in port)
    jt, jidx, jhit = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_array_equal(idx[hit], jidx[hit])
    assert idx.dtype == np.int64
    ground = (np.abs(radius[idx]) >= GROUND_RADIUS if radius is not None
              else np.zeros_like(hit))
    fine = hit & ~ground
    np.testing.assert_allclose(t[fine], jt[fine], rtol=T_RTOL, atol=0)
    if ground.any():
        np.testing.assert_allclose(t[hit & ground], jt[hit & ground],
                                   rtol=0, atol=1e-6 * 1000.0)
    assert (t[~hit] == 1e30).all()


@pytest.fixture(scope="module")
def final_tree():
    tree, scene = jbvh.build_bvh(book_one_final(42))
    return tree, scene


def test_traversal_winners_equal_jax(final_tree):
    tree, s = final_tree
    o, d = _rays(1313)
    ref = jtrav.intersect_bvh(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(s.centers), jnp.asarray(s.radii),
                              *(jnp.asarray(x) for x in tree))
    port = ttrav.intersect_bvh(_t(o), _t(d), _t(s.centers), _t(s.radii),
                               *(_t(x) for x in tree))
    assert 0.5 < port[2].numpy().mean() < 1.0
    _hold(port, ref, s.radii)


@pytest.mark.parametrize("every", [1, 3, 100])
def test_check_interval_changes_nothing(final_tree, monkeypatch, every):
    """Done lanes change no state, so reading the unfinished lanes back
    every step, every 3 or every 100 steps gives the same bits."""
    tree, s = final_tree
    o, d = _rays(5, n=512)
    args = (_t(o), _t(d), _t(s.centers), _t(s.radii),
            *(_t(x) for x in tree))
    base = ttrav.intersect_bvh(*args)
    monkeypatch.setattr(ttrav, "CHECK_EVERY", every)
    for a, b in zip(ttrav.intersect_bvh(*args), base):
        assert torch.equal(a, b)


def test_triangle_traversal_winners_equal_jax():
    scene, tris = mesh_terrain_scene(n_quads=12, seed=3)
    v0, e1, e2 = (np.asarray(x) for x in (tris.v0, tris.e1, tris.e2))
    verts = np.stack([v0, v0 + e1, v0 + e2], axis=1)
    tree, perm = jbvh.build_flat_bvh_aabb(verts.min(axis=1),
                                          verts.max(axis=1))
    v0, e1, e2 = v0[perm], e1[perm], e2[perm]
    o, d = _rays(77, lo=-3.0, hi=3.0)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    ref = jtrav.intersect_bvh_triangles(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0), jnp.asarray(e1),
        jnp.asarray(e2), *(jnp.asarray(x) for x in tree))
    port = ttrav.intersect_bvh_triangles(_t(o), _t(d), _t(v0), _t(e1),
                                         _t(e2), *(_t(x) for x in tree))
    assert 0.2 < port[2].numpy().mean()
    _hold(port, ref)


def test_clamp_trap():
    """Internal nodes' left_first + k runs past the primitive tables (a
    plain gather would raise on the CPU and fault on the card); the
    traversal clamps, as XLA does, and finds the JAX package's winners."""
    rng = np.random.default_rng(21)
    n = 7
    centers = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.2, 0.6, n).astype(np.float32)
    tree, perm = jbvh.build_flat_bvh(centers, radii)
    centers, radii = centers[perm], radii[perm]
    internal = tree.prim_count == 0
    internal[1] = False                                  # the dummy node
    assert (tree.left_first[internal] + 3 >= n).any()
    with pytest.raises(IndexError):
        _t(radii)[_t(tree.left_first[internal].astype(np.int64) + 3)]
    o, d = _rays(22, n=1024, lo=-4.0, hi=4.0)
    ref = jtrav.intersect_bvh(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(centers), jnp.asarray(radii),
                              *(jnp.asarray(x) for x in tree))
    port = ttrav.intersect_bvh(_t(o), _t(d), _t(centers), _t(radii),
                               *(_t(x) for x in tree))
    assert port[2].numpy().any()
    _hold(port, ref)


def test_axis_parallel_rays_on_face_planes_as_jax(final_tree):
    """A direction component of 0 on a face plane makes the slab test's
    (lo - origin) / direction NaN; torch.minimum/amax propagate it as
    jnp.minimum/max do, so the same boxes are missed."""
    tree, s = final_tree
    rng = np.random.default_rng(9)
    nodes = rng.integers(2, tree.num_nodes, 1024)
    o = tree.aabb_min[nodes].copy()
    o[:, 0] = rng.uniform(-8.0, 8.0, 1024)
    o[:, 2] = rng.uniform(-8.0, 8.0, 1024)
    d = np.zeros((1024, 3), np.float32)
    d[:, 0] = 1.0
    d[1::2, 0] = -1.0                        # y stays on the face plane
    ref = jtrav.intersect_bvh(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(s.centers), jnp.asarray(s.radii),
                              *(jnp.asarray(x) for x in tree))
    port = ttrav.intersect_bvh(_t(o), _t(d), _t(s.centers), _t(s.radii),
                               *(_t(x) for x in tree))
    _hold(port, ref, s.radii)


def test_slab_test_propagates_nan():
    o = torch.tensor([[0.0, 1.0, 0.0]])
    inv = 1.0 / torch.tensor([[1.0, 0.0, 0.0]])
    lo = torch.tensor([[-1.0, 1.0, -1.0]])
    hi = torch.tensor([[1.0, 2.0, 1.0]])
    port = ttrav._slab_test(o, inv, lo, hi, torch.tensor([1e30]))
    ref = jtrav._slab_test(jnp.asarray(o.numpy()), jnp.asarray(inv.numpy()),
                           jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
                           jnp.asarray([1e30], jnp.float32))
    assert float(port[0]) == float(ref[0]) == float(np.float32(1e30))


def test_depth_check_refuses_deep_tree():
    """A chain deeper than STACK_DEPTH is refused, as by the reference."""
    depth = ttrav.STACK_DEPTH + 2
    k = 2 * depth
    lf = np.zeros(k, np.int32)
    pc = np.zeros(k, np.int32)
    node = 0
    for level in range(depth - 1):
        left = 2 + 2 * level
        lf[node] = left
        lf[left + 1], pc[left + 1] = 0, 1                # a leaf
        node = left
    lf[node], pc[node] = 0, 1
    assert ttrav._flat_depth(lf, pc) == jtrav._flat_depth(lf, pc) == depth
    with pytest.raises(ValueError, match="STACK_DEPTH"):
        ttrav.check_depth(_t(lf), _t(pc))
    with pytest.raises(ValueError, match="STACK_DEPTH"):
        ttrav.intersect_bvh(torch.zeros(1, 3), torch.ones(1, 3),
                            torch.zeros(1, 3), torch.ones(1),
                            torch.zeros(k, 3), torch.ones(k, 3),
                            _t(lf), _t(pc))


# --- renderer.prepare_scene and convert ------------------------------------

@pytest.mark.parametrize("name", ["book_one_final", "terrain"])
def test_prepared_bvh_tables_equal_jax(name):
    """A JAX-prepared scene carried across by ``scene_arrays_to_torch``
    and a port-prepared one hold the same tables, BVH order included."""
    cfg = RenderConfig(width=8, height=8, intersector="bvh",
                       engine="wavefront")
    jcfg = JConfig(width=8, height=8, intersector="bvh", engine="wavefront")
    if name == "terrain":
        jscene, jtris = mesh_terrain_scene(n_quads=5)
        scene, tris = tterrain(n_quads=5)
    else:
        jscene, jtris = book_one_final(42), None
        scene, tris = get_scene("book_one_final"), None
    carried = scene_arrays_to_torch(jprepare(jscene, jcfg, jtris), "cpu")
    port = prepare_scene(scene, cfg, "cpu", tris)
    keys = {k for k in port if k not in ("scene_packed", "host_scene")}
    assert keys == {k for k in carried
                    if k not in ("scene_packed", "host_scene")}
    assert {"bvh_min", "bvh_max", "bvh_left_first",
            "bvh_prim_count"} <= keys
    if name == "terrain":
        assert {"tri_bvh_min", "tri_bvh_left_first"} <= keys
    for key in sorted(keys - {"tri_normal"}):
        assert port[key].dtype == carried[key].dtype, key
        assert torch.equal(port[key], carried[key]), key
    if "tri_normal" in keys:
        torch.testing.assert_close(port["tri_normal"], carried["tri_normal"],
                                   rtol=1e-6, atol=1e-7)
    assert port["host_scene"]["key"] == carried["host_scene"]["key"]
