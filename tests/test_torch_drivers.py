"""The gate sweep and the golden maker of ``probes/`` on the CPU, against
the reference's ``exp/gate_sweep.py`` and the JAX megakernel.

The sweep's rows run the port's ``validate`` in processes of their own;
the orchestration is checked with ``run_row`` (or the child process)
replaced, and one real row runs at 16x8."""

import hashlib
import importlib.util
import json
import math
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.renderer import render as jax_render
from wavefront_path_tracer_tpu_torch import renderer as trenderer
from wavefront_path_tracer_tpu_torch.probes import gate_sweep, make_golden
from wavefront_path_tracer_tpu_torch.scene import CameraController, get_scene
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _load_reference(name):
    spec = importlib.util.spec_from_file_location(
        f"exp_{name}_reference", ROOT / "exp" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _golden_digest():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((ROOT / "golden").iterdir())}


# --- gate_sweep ---------------------------------------------------------

def test_gate_sweep_rows_and_list_match_reference(capsys, monkeypatch):
    ref = _load_reference("gate_sweep")
    assert gate_sweep.SAME_STREAM == ref.SAME_STREAM
    assert gate_sweep.GOLDEN_ROWS == ref.GOLDEN_ROWS
    assert (gate_sweep.SS_W, gate_sweep.SS_H, gate_sweep.SS_SPP) == (
        ref.SS_W, ref.SS_H, ref.SS_SPP)
    assert gate_sweep.main(["--list"]) == 0
    port = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["gate_sweep.py", "--list"])
    assert ref.main() == 0
    assert port == capsys.readouterr().out
    assert len(port.splitlines()) == 16
    # The defaults write nothing under golden/.
    args = gate_sweep.build_parser().parse_args([])
    for path in (args.out, args.cache_dir):
        assert not gate_sweep._under_golden(path)
    assert gate_sweep._under_golden(str(ROOT / "golden" / "x.json"))
    with pytest.raises(SystemExit):
        gate_sweep.main(["--out", str(ROOT / "golden" / "GATE_SWEEP.json")])
    with pytest.raises(SystemExit):
        gate_sweep.main(["--only", "no_such_row"])


def _fake_rows(calls, failing=()):
    def fake(name, args, gate, **kw):
        calls.append((name, args, gate, kw))
        return {"name": name, "ok": True, "pass": name not in failing,
                "rmse": 1e-4, "gate": gate}
    return fake


def test_gate_sweep_only_merges_and_caches_outside_golden(tmp_path,
                                                         monkeypatch):
    out = tmp_path / "sweep.json"
    kept = {"name": "baked_cull16", "ok": True, "pass": True, "rmse": 5e-4}
    stale = {"name": "dynculled", "ok": True, "pass": False, "rmse": 9.0}
    out.write_text(json.dumps({"rows": [kept, stale]}))
    calls = []
    monkeypatch.setattr(gate_sweep, "run_row", _fake_rows(calls))
    rc = gate_sweep.main(["--only", "dynculled,textures_dyn", "--out",
                          str(out), "--cache-dir", str(tmp_path / "cache"),
                          "--spp", "8", "--device", "cpu"])
    assert rc == 0
    summary = json.loads(out.read_text())
    assert [r["name"] for r in summary["rows"]] == [
        "baked_cull16", "dynculled", "textures_dyn"]
    assert summary["rows"][0] == kept
    assert summary["rows"][1]["pass"] and summary["all_pass"]
    assert not summary["complete"] and summary["device"] == "cpu"
    (name, _a, gate, kw), (name2, _a2, gate2, kw2) = calls
    assert (name, gate, name2, gate2) == ("dynculled", 2e-3,
                                          "textures_dyn", 3e-3)
    assert (kw["spp"], kw["width"], kw["height"], kw["device"]) == (
        8, 400, 224, "cpu")
    # The default scene's row shares the cached oracle, named by its size,
    # samples and device, in the cache directory; the texture row renders
    # its own.
    cache = kw["oracle"][kw["oracle"].index("--oracle-cache") + 1]
    assert cache == str(tmp_path / "cache" /
                        "megakernel_book_one_final_400x224_8spp_cpu.npz")
    assert "--oracle-cache" not in kw2["oracle"]
    assert kw["oracle"][:2] == kw2["oracle"][:2] == ["--oracle-spf", "8"]


def test_gate_sweep_skips_absent_golden_and_sets_exit_code(tmp_path,
                                                          monkeypatch):
    out = tmp_path / "sweep.json"
    calls = []
    monkeypatch.setattr(gate_sweep, "run_row", _fake_rows(calls))
    monkeypatch.setattr(gate_sweep, "GOLDEN", str(tmp_path / "absent.npz"))
    assert gate_sweep.main(["--only", "golden_rr5,rotate_cols2", "--out",
                            str(out), "--cache-dir", str(tmp_path)]) == 0
    summary = json.loads(out.read_text())
    skipped = summary["rows"][1]
    assert skipped["name"] == "golden_rr5" and skipped["skipped"]
    assert not skipped["pass"] and "absent" in skipped["error"]
    assert (summary["passed"], summary["skipped"], summary["all_pass"]) == (
        1, 1, True)
    assert [c[0] for c in calls] == ["rotate_cols2"]
    # With the golden present, a golden row reads it at the full spec.
    monkeypatch.setattr(gate_sweep, "GOLDEN", str(tmp_path / "g.npz"))
    (tmp_path / "g.npz").write_bytes(b"")
    calls.clear()
    monkeypatch.setattr(gate_sweep, "run_row",
                        _fake_rows(calls, failing={"golden_rr5"}))
    assert gate_sweep.main(["--only", "golden_rr5", "--out", str(out),
                            "--cache-dir", str(tmp_path)]) == 1
    (name, args, gate, kw), = calls
    assert (name, gate, kw["spp"], kw["width"], kw["height"]) == (
        "golden_rr5", 1e-3, 1000, 400, 225)
    assert kw["oracle"] == ["--oracle-cache", str(tmp_path / "g.npz")]
    assert args == ["--intersector", "baked", "--clusters", "16",
                    "--rr", "5"]
    assert not json.loads(out.read_text())["all_pass"]


def test_gate_sweep_timeout_row(tmp_path, monkeypatch):
    seen = {}

    def timeout(cmd, **kw):
        seen.update(cmd=cmd, **kw)
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(gate_sweep.child, "run", timeout)
    out = tmp_path / "sweep.json"
    assert gate_sweep.main(["--only", "winner_hint", "--timeout", "7",
                            "--out", str(out), "--cache-dir",
                            str(tmp_path)]) == 1
    row, = json.loads(out.read_text())["rows"]
    assert row == {"name": "winner_hint", "ok": False, "pass": False,
                   "error": "timeout after 7s"}
    cmd = seen["cmd"]
    assert cmd[1:3] == ["-m", "wavefront_path_tracer_tpu_torch.validate"]
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert "--winner-hint" in cmd and seen["cwd"] == gate_sweep.ROOT
    # A process that prints no JSON line is a failed row too.
    monkeypatch.setattr(gate_sweep.child, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 3, "", "boom"))
    row = gate_sweep.run_row("x", [], 1e-3, spp=1, width=8, height=8,
                             oracle=[], timeout=5, device="cpu")
    assert row == {"name": "x", "ok": False, "pass": False,
                   "error": "rc=3: boom"}


def test_gate_sweep_real_row_on_cpu(tmp_path, monkeypatch):
    """baked_cull16 through the port's validate in its own process at
    16x8@2 spp on the CPU; the oracle is cached in the cache directory
    and nothing under golden/ changes."""
    before = _golden_digest()
    monkeypatch.setattr(gate_sweep, "SS_W", 16)
    monkeypatch.setattr(gate_sweep, "SS_H", 8)
    out = tmp_path / "sweep.json"
    rc = gate_sweep.main(["--only", "baked_cull16", "--spp", "2",
                          "--device", "cpu", "--timeout", "300", "--out",
                          str(out), "--cache-dir", str(tmp_path)])
    row, = json.loads(out.read_text())["rows"]
    assert row["ok"], row
    assert row["config"] == "16x8@2spp" and row["gate"] == 2e-3
    assert row["engine"] == "fused/baked/cull16"
    assert row["oracle"] == "megakernel/bruteforce@cpu"
    assert math.isfinite(row["rmse"]) and row["pass"] and rc == 0
    assert (tmp_path / "megakernel_book_one_final_16x8_2spp_cpu.npz").exists()
    assert _golden_digest() == before


# --- make_golden --------------------------------------------------------

def _small_golden(monkeypatch, tmp_path):
    monkeypatch.setattr(make_golden, "SPP", 6)
    monkeypatch.setattr(make_golden, "BATCH", 2)
    monkeypatch.setattr(make_golden, "SCENE", "book_cover")
    monkeypatch.setattr(make_golden, "WIDTH", 16)
    monkeypatch.setattr(make_golden, "HEIGHT", 8)
    monkeypatch.setattr(make_golden, "BOUNCES", 8)
    monkeypatch.setattr(make_golden, "CKPT_DIR", str(tmp_path / "ckpt"))


def test_make_golden_resume_is_bit_for_bit(tmp_path, monkeypatch):
    _small_golden(monkeypatch, tmp_path)
    before = _golden_digest()
    whole, parted = tmp_path / "whole.npz", tmp_path / "parted.npz"
    assert make_golden.main([str(whole), "--device", "cpu"]) == 0

    class Interrupted(trenderer.Renderer):
        frames = 0

        def render_frame(self):
            if Interrupted.frames == 1:
                raise KeyboardInterrupt
            Interrupted.frames += 1
            return super().render_frame()

    monkeypatch.setattr(trenderer, "Renderer", Interrupted)
    with pytest.raises(KeyboardInterrupt):
        make_golden.main([str(parted), "--device", "cpu"])
    monkeypatch.undo()
    _small_golden(monkeypatch, tmp_path)
    ckpt = Path(make_golden.checkpoint_path(str(parted)))
    assert ckpt.parent == tmp_path / "ckpt" and ckpt.exists()
    assert not parted.exists()
    z = np.load(ckpt)
    assert int(z["samples"]) == 2 and int(z["frame"]) == 1
    rec = make_golden.run(make_golden.build_parser().parse_args(
        [str(parted), "--device", "cpu"]))
    assert rec["resumed_at"] == 2 and not ckpt.exists()
    a, b = np.load(whole), np.load(parted)
    assert np.array_equal(a["image"], b["image"])
    assert str(a["meta"]) == str(b["meta"]) and str(a["platform"]) == "cpu"
    assert json.loads(str(a["meta"])) == {
        "scene": "book_cover", "width": 16, "height": 8, "spp": 6,
        "max_bounces": 8, "engine": "megakernel",
        "intersector": "bruteforce"}
    # The JAX megakernel on the same streams, by the parity rule (on the
    # averaged radiance the display image squares back to).
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=6,
                       samples_per_frame=2, max_bounces=8,
                       engine="megakernel", intersector="bruteforce")
    j = jax_render(get_scene("book_cover"),
                   CameraController.book_one_final(), cfg)
    check_parity(a["image"].astype(np.float64) ** 2,
                 np.asarray(j.accumulated, np.float64) / 6)
    assert _golden_digest() == before
    # The golden directory is refused as an output.
    with pytest.raises(SystemExit, match="golden"):
        make_golden.main([str(ROOT / "golden" / "x.npz"), "--device",
                          "cpu"])
    # The default output and its checkpoint are outside golden/.
    default = make_golden.build_parser().parse_args([]).out
    assert Path(default).parent == ROOT / "build" / "golden"
    monkeypatch.undo()
    assert Path(make_golden.checkpoint_path(default)).parent == (
        ROOT / "build" / "make_golden")
