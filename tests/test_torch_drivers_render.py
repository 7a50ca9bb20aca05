"""The clamp's bias, the material-split A/B, the texture-LUT sweep and the
bounce-0 shortlist of ``probes/`` on the CPU, against the reference's
``exp/`` scripts and the JAX megakernel."""

import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import torch

from wavefront_path_tracer_tpu.ops import pallas_kernels as jpk
from wavefront_path_tracer_tpu.renderer import render as jax_render
from wavefront_path_tracer_tpu_torch.probes import (
    bounce0,
    clamp_bias,
    matsplit_ab,
    texlut,
)
from wavefront_path_tracer_tpu_torch.scene import book_cover
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import MEAN_TOL

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _load_reference(name):
    spec = importlib.util.spec_from_file_location(
        f"exp_{name}_reference", ROOT / "exp" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = fn(*args)
    return result, out.getvalue()


def test_clamp_bias_matches_jax_megakernel():
    """The mean drop at each clamp level against the JAX megakernel's on
    the same streams (16x8, 8 spp, 50 bounces), within the parity rule's
    mean tolerance; the printed table has the reference's header."""
    args = clamp_bias.build_parser().parse_args(
        ["--spp", "8", "--width", "16", "--height", "8", "--device", "cpu"])
    rows, text = _quiet(clamp_bias.run, args)
    assert text.splitlines()[0] == f"{'clamp':>7} {'mean drop':>10} " \
                                   f"{'display RMSE':>13}"
    assert [r["clamp"] for r in rows] == [4.0, 2.0, 1.0, 0.5, 0.25]
    cc = clamp_bias.camera()
    assert (cc.vfov_deg, cc.defocus_angle_deg) == (35.0, 0.0)
    scene = book_cover()
    base = RenderConfig(width=16, height=8, samples_per_pixel=8,
                        samples_per_frame=8, max_bounces=50,
                        engine="megakernel", intersector="bruteforce")
    ref = jax_render(scene, cc, base).accumulated.mean()
    for row in rows:
        mean = jax_render(scene, cc, base.replace(
            clamp=row["clamp"])).accumulated.mean()
        assert abs(row["mean_drop"] - (1.0 - mean / ref)) < MEAN_TOL, row
    assert rows[-1]["mean_drop"] > rows[0]["mean_drop"] >= 0.0


def _position_free_pow(monkeypatch):
    """``torch.pow`` on float32 evaluated in float64 and rounded.  On the
    CPU, PyTorch's float32 pow gives some inputs a result one ulp apart
    in a vector body and in its scalar tail (19 of 1,000 random inputs
    differ between a call over the whole vector and calls of one element
    each), so a sort that moves a lane between the two can change a
    Schlick term or a unit-sphere radius by an ulp; on the card every
    element takes the same path.  Rounded from float64, the result no
    longer depends on the element's position."""
    pow_ = torch.pow

    def position_free(x, e, *args, **kwargs):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            e = e.double() if isinstance(e, torch.Tensor) else e
            return pow_(x.double(), e, *args, **kwargs).float()
        return pow_(x, e, *args, **kwargs)

    monkeypatch.setattr(torch, "pow", position_free)


def test_matsplit_ab_is_bit_identical(monkeypatch):
    _position_free_pow(monkeypatch)
    args = matsplit_ab.build_parser().parse_args(
        ["16", "8", "2", "1", "--device", "cpu"])
    assert (args.width, args.height, args.spp, args.reps) == (16, 8, 2, 1)
    rows, text = _quiet(matsplit_ab.run, args)
    assert [r["scene"] for r in rows] == ["cornell_spheres",
                                          "book_one_final"]
    for row in rows:
        assert row["rmse"] == 0.0, row
        assert row["mrays_per_s"]["True"] > 0 and row["ratio"] > 0
    assert text.count("A/B rmse 0.00e+00 (must be 0.0") == 2
    defaults = matsplit_ab.build_parser().parse_args([])
    assert (defaults.width, defaults.height, defaults.spp, defaults.reps,
            defaults.device) == (400, 224, 16, 3, "cuda")


def test_texlut_texture_and_scene_match_reference():
    ref = _load_reference("texlut")
    np.testing.assert_array_equal(texlut.test_texture(), ref.test_texture())
    np.testing.assert_array_equal(texlut.test_texture(32, 16),
                                  ref.test_texture(32, 16))
    port, jscene = texlut.build_scene(), ref.build_scene()
    for field in port._fields:
        a, b = getattr(port, field), getattr(jscene, field)
        if a is None or b is None:
            assert a is None and b is None, field
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=field)
    cc = texlut.camera()
    assert (cc.vfov_deg, cc.focus_distance) == (20.0, 3.4)
    args = texlut.build_parser().parse_args(
        ["512", "2048", "--width", "16", "--height", "8", "--spp", "2",
         "--device", "cpu"])
    out, text = _quiet(texlut.run, args)
    assert [r["budget"] for r in out["rows"]] == [512, 2048]
    assert all(np.isfinite(r["rmse"]) and r["rmse"] < 0.1
               for r in out["rows"])
    assert text.startswith("oracle mean ")
    assert texlut.build_parser().parse_args([]).budgets == [
        512, 2048, 8192, 32768]


def _rays(rng, n):
    o = rng.normal(0.0, 0.3, (n, 3)) + [0.0, 0.5, 6.0]
    d = rng.normal(0.0, 0.35, (n, 3)) + [0.0, 0.0, -1.0]
    d[::97, 0] = 0.0                      # rays parallel to a slab
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def test_bounce0_slab_entries_and_shortlists_match_reference():
    ref = _load_reference("bounce0")
    assert bounce0.T_MIN == ref.T_MIN == jpk.T_MIN
    rng = np.random.default_rng(3)
    lo = rng.uniform(-3.0, 3.0, (23, 3))
    boxes = np.stack([lo, lo + rng.uniform(0.1, 2.0, (23, 3))],
                     axis=1).astype(np.float32)
    spp, n = 3, 2048 + 64                 # two whole blocks and a part
    samples = [_rays(rng, n) for _ in range(spp)]
    for o, d in samples:
        port, jref = bounce0.slab_entries(o, d, boxes), ref.slab_entries(
            o, d, boxes)
        np.testing.assert_array_equal(port, jref)
        assert 0 < port.sum() < port.size
    # The reference's block loop, on whole 1024-lane tiles.
    tiles = n // 1024
    union = np.zeros((tiles, boxes.shape[0]), bool)
    per_sample = np.zeros(tiles)
    for o, d in samples:
        for t in range(tiles):
            blk = ref.slab_entries(o[t * 1024:(t + 1) * 1024],
                                   d[t * 1024:(t + 1) * 1024], boxes).any(0)
            union[t] |= blk
            per_sample[t] += blk.sum() / spp
    for lanes in (1024, 32):
        got_union, got_visible = bounce0.shortlist(samples, boxes, lanes)
        assert got_union.shape == (-(-n // lanes), boxes.shape[0])
        whole = (n // lanes)
        expect = np.zeros_like(got_union)
        visible = np.zeros(got_union.shape[0])
        for o, d in samples:
            hit = ref.slab_entries(o, d, boxes)
            for g in range(got_union.shape[0]):
                blk = hit[g * lanes:(g + 1) * lanes].any(0)
                expect[g] |= blk
                visible[g] += blk.sum() / spp
        np.testing.assert_array_equal(got_union, expect)
        np.testing.assert_array_equal(got_visible, visible)
        if lanes == 1024:
            np.testing.assert_array_equal(got_union[:whole], union)
            np.testing.assert_array_equal(got_visible[:whole], per_sample)


def test_bounce0_runs_on_the_cpu():
    args = bounce0.build_parser().parse_args(
        ["--width", "64", "--height", "32", "--spp", "2", "--device",
         "cpu"])
    rec, text = _quiet(bounce0.run, args)
    assert rec["rays"] == 64 * 32 * 2 and rec["warps"] == 64
    assert rec["entries"] == rec["stats"][3] > 0 and rec["blocks"] == 2
    assert rec["stats"][:2] == [rec["rays"], rec["trips"]]
    assert rec["shortlist_blocks"] <= rec["blocks"] * rec["clusters"]
    assert rec["visible_per_sample_warps"] <= rec["shortlist_warps"]
    assert rec["launches"] == 0            # the plain version, on the CPU
    assert "32x32 blocks" in text and "per-lane cull" in text
