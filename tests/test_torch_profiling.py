"""The port's ``utils/profiling.py`` against the JAX package's on the same
inputs, ``trace_to``, and the command line's ``--stage-timing`` and
``--profile-dir`` on the CPU."""

import json
import os
import re

import pytest
import torch

from wavefront_path_tracer_tpu.utils import profiling as jprof
from wavefront_path_tracer_tpu_torch import cli
from wavefront_path_tracer_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--scene", "book_cover", "--width", "16",
        "--height", "8", "--spp", "2", "--spf", "1", "--max-bounces", "6"]


class _Clock:
    """A perf_counter stand-in that steps by the given intervals."""

    def __init__(self, steps):
        self.now = 0.0
        self.steps = list(steps)

    def __call__(self):
        value = self.now
        if self.steps:
            self.now += self.steps.pop(0)
        return value


def test_kernel_timer_equals_jax():
    """Recorded stages (more than the 10-deep window) average and report
    as the JAX package's timer does."""
    samples = [("extend", 1e-3 * (k + 1)) for k in range(13)] + [
        ("shade", 2.5e-4), ("shade", 7.5e-4), ("generate", 3e-5)]
    port, ref = tprof.KernelTimer(), jprof.KernelTimer()
    for name, seconds in samples:
        port.record(name, seconds)
        ref.record(name, seconds)
    assert port.averages_us() == ref.averages_us()
    assert port.report() == ref.report()
    assert port.averages_us()["extend"] == pytest.approx(8500.0)


def test_kernel_timer_time_blocks_and_records(monkeypatch):
    """``time`` measures the block and, with ``block_on``, waits for the
    tensor's device (a no-op on the CPU) before it stops the clock, as
    the JAX package's waits with block_until_ready."""
    timer = tprof.KernelTimer()
    waited = []
    monkeypatch.setattr(tprof, "block_until_ready", waited.append)
    monkeypatch.setattr(tprof.time, "perf_counter", _Clock([0.004, 0.0]))
    x = torch.ones(3)
    with timer.time("miss", block_on=x):
        pass
    assert waited == [x]
    assert timer.averages_us() == {"miss": pytest.approx(4000.0)}
    tprof.block_until_ready((x, 1))            # CPU tensors: nothing waits


def test_frames_per_second_equals_jax(monkeypatch):
    """The same frame intervals (more than the window) give the same
    average; both modules read the one ``time.perf_counter``, so each
    runs on its own copy of the clock in turn."""
    steps = [0.02, 0.03, 0.05, 0.01] * 4
    fps = []
    for module in (tprof, jprof):
        monkeypatch.setattr(module.time, "perf_counter", _Clock(steps))
        meter = module.FramesPerSecond()
        assert meter.get_avg_fps() == 0.0
        for _ in range(16):
            meter.update()
        fps.append(meter.get_avg_fps())
    assert fps[0] == fps[1] > 0.0


@pytest.mark.parametrize("fields", [
    dict(rays_traced=3.5e6, seconds=0.25, samples=4, pixels=1000),
    dict(),
    dict(rays_traced=1e3, seconds=0.0, samples=0, pixels=10),
])
def test_render_stats_equals_jax(fields):
    port, ref = tprof.RenderStats(**fields), jprof.RenderStats(**fields)
    assert port.mrays_per_s == ref.mrays_per_s
    assert port.avg_bounces == ref.avg_bounces
    assert port.report() == ref.report()


def test_trace_to_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.trace_to(str(log_dir)):
        torch.ones(64).cumsum(0).sum()
    path = log_dir / tprof.TRACE_FILE
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::cumsum" in names


def test_cli_stage_timing_wavefront(tmp_path, capsys):
    renderer, result = cli.run(TINY + [
        "--engine", "wavefront", "--intersector", "bvh", "--stage-timing",
        "--out", str(tmp_path / "w.png")])
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if "kernels:" in ln]
    assert len(lines) == 2                       # one a frame
    for stage in ("generate", "extend", "shade", "miss", "compact"):
        assert f"{stage}: " in lines[-1]
    assert set(renderer.stage_timer.averages_us()) == {
        "generate", "extend", "shade", "miss", "compact"}
    assert result.kernel_stats is None


def _stage_rows(err: str) -> dict:
    """{label: (ms, share, marked below the drift)} of the stage table in
    ``err``."""
    rows = {}
    for line in err.splitlines():
        m = re.match(r"  (.+?)\s+(-?[\d.]+) ms(?:\s+(-?[\d.]+)%( \*)?)?$",
                     line)
        if m:
            rows[m[1]] = (float(m[2]),
                          float(m[3]) if m[3] is not None else None,
                          m[4] is not None)
    return rows


def test_cli_stage_timing_fused(tmp_path, capsys):
    """The fused engine's per-frame counters, then the differential
    stage table after the render (the reference CLI's, its cli.py:527-547)."""
    _renderer, result = cli.run(TINY + [
        "--intersector", "baked", "--clusters", "2", "--stage-timing",
        "--out", str(tmp_path / "f.png")])
    err = capsys.readouterr().err
    assert err.count("fused: ") == 2 and "lane-occupancy" in err
    assert "fused stage timing (differential probes, 2 spp):" in err
    rows = _stage_rows(err)
    assert list(rows) == [
        "generate (raygen)", "extend: primitive tests", "extend: cull conds",
        "shade (BSDF)", "miss (sky accumulate)", "loop bookkeeping",
        "other (winner selects, unprobed)", "base render"]
    assert rows["base render"][0] > 0 and rows["base render"][1] is None
    *probed, (residual, residual_marked) = [
        (share, marked) for label, (_ms, share, marked) in rows.items()
        if label != "base render"]
    assert all(share >= 0 for share, _m in probed) and residual >= 0
    # The residual closes the budget: 100% less the probed shares, at
    # least 0 (each share printed to 0.05%).
    assert abs(residual - max(0.0, 100.0 - sum(s for s, _m in probed))) \
        <= 0.05 * (len(probed) + 1)
    # A probed share below the 6% drift is marked and footnoted; the
    # residual is never marked.
    for share, marked in probed:
        assert share <= 6.0 if marked else share >= 6.0
    assert not residual_marked
    assert (any(m for _s, m in probed)
            == ("* below the 6% between-call drift" in err))
    assert result.kernel_stats["iterations"] > 0


@pytest.mark.parametrize("argv", [
    ["--intersector", "bruteforce", "--clusters", "8"],
    ["--intersector", "bruteforce", "--clusters", "0"]])
def test_cli_stage_timing_fused_bruteforce_note(tmp_path, capsys, argv):
    """Without --intersector baked the fused engine prints the
    reference's note, not the table."""
    cli.run(TINY + argv + ["--stage-timing", "--out",
                           str(tmp_path / "b.png")])
    err = capsys.readouterr().err
    assert "needs --intersector baked" in err
    assert "fused stage timing" not in err and "base render" not in err


def test_cli_stage_timing_megakernel_notes(tmp_path, capsys):
    renderer, _ = cli.run(TINY + ["--engine", "megakernel",
                                  "--stage-timing",
                                  "--out", str(tmp_path / "m.png")])
    assert renderer.stage_timer is None
    err = capsys.readouterr().err
    assert "wavefront and fused engines only" in err
    assert "fused stage timing" not in err


def test_cli_profile_dir(tmp_path, capsys):
    log_dir = tmp_path / "prof"
    cli.run(TINY + ["--engine", "wavefront", "--profile-dir", str(log_dir),
                    "--out", str(tmp_path / "p.png")])
    assert os.path.getsize(log_dir / tprof.TRACE_FILE) > 0
    assert "torch.profiler trace" in capsys.readouterr().err
