"""The port's ``validate`` on the CPU, at tiny sizes: the three tests of
the JAX package's ``tests/test_validate.py`` with both sides on the
port's megakernel, the wavefront engine's flags, the committed golden artifacts read as
they are, and the default device."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu_torch import validate

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--width", "64", "--height", "32", "--spp", "4",
        "--max-bounces", "4",
        "--engine", "megakernel", "--intersector", "bruteforce",
        "--oracle-engine", "megakernel",
        "--oracle-intersector", "bruteforce", "--device", "cpu"]


def _run(argv, capsys):
    rc = validate.main(argv)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, json.loads(out)


def test_same_stream_oracle_follows_test_sampler(capsys):
    """With the same engine on both sides and --sampler stratified, the
    oracle runs stratified too: RMSE exactly 0."""
    rc, row = _run(TINY + ["--sampler", "stratified", "--gate", "1e-6"],
                   capsys)
    assert rc == 0 and row["pass"]
    assert row["rmse"] == 0.0
    assert row["engine"] == "megakernel/bruteforce/stratified"
    assert row["oracle"] == "megakernel/bruteforce@cpu"


def test_oracle_sampler_override_changes_quadrature(capsys):
    """--oracle-sampler random against --sampler stratified compares two
    independent quadratures: RMSE at the Monte Carlo noise, far above
    the same-stream 0."""
    rc, row = _run(TINY + ["--sampler", "stratified",
                           "--oracle-sampler", "random",
                           "--gate", "1e-6"], capsys)
    assert rc == 1 and not row["pass"]
    assert row["rmse"] > 1e-4


def test_oracle_cache_roundtrip_and_meta_guard(tmp_path, capsys):
    """The artifact records its oracle's configuration; a gate whose
    oracle differs (a stratified oracle against a random-sampler
    artifact) refuses to load it."""
    cache = str(tmp_path / "golden.npz")
    rc, row = _run(TINY + ["--oracle-cache", cache, "--gate", "1e-6"],
                   capsys)
    assert rc == 0 and row["rmse"] == 0.0
    z = np.load(cache, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    assert meta["spp"] == 4 and "sampler" not in meta
    assert str(z["platform"]) == "cpu"

    rc, row = _run(TINY + ["--oracle-cache", cache, "--gate", "1e-6"],
                   capsys)
    assert rc == 0 and row["rmse"] == 0.0

    with pytest.raises(ValueError, match="rendered with"):
        validate.main(TINY + ["--oracle-cache", cache,
                              "--sampler", "stratified"])


@pytest.mark.parametrize("argv,shape", [
    (["--spp", "1000", "--oracle-cache",
      "golden/oracle_book_400x225_1000spp.npz"], (225, 400, 3)),
    (["--width", "400", "--height", "224", "--spp", "64", "--oracle-cache",
      "golden/oracle_tpu_same_stream.npz"], (224, 400, 3)),
], ids=["cpu-1000spp", "tpu-same-stream"])
def test_committed_artifacts_load(argv, shape):
    """The committed artifacts' metadata is what the port's flags
    describe: --oracle-only loads them, renders nothing and exits 0; a
    flag that changes the oracle makes the guard refuse them."""
    argv = [str(ROOT / a) if a.startswith("golden/") else a for a in argv]
    out = validate.run(argv + ["--oracle-only", "--device", "cpu"])
    assert out["row"] is None and out["oracle_image"].shape == shape
    assert np.isfinite(out["oracle_image"]).all()
    with pytest.raises(ValueError, match="rendered with"):
        validate.run(argv + ["--oracle-only", "--max-bounces", "8",
                             "--device", "cpu"])


TINY8 = ["--width", "8", "--height", "8", "--spp", "1", "--max-bounces",
         "8", "--intersector", "bruteforce", "--oracle-intersector",
         "bruteforce", "--device", "cpu", "--gate", "1e-9"]


# The flags once refused (the wavefront engine), now run at 8x8@1 spp:
# the wavefront engine and the megakernel are bit-identical, so each
# gate reads 0.0.  The ids are the refusal cases' ids.
@pytest.mark.parametrize("extra,tag", [
    pytest.param(["--engine", "wavefront"], "wavefront/bruteforce",
                 id="extra0-item 8"),
    pytest.param(["--engine", "megakernel", "--oracle-engine", "wavefront"],
                 "megakernel/bruteforce", id="extra1-item 8"),
    pytest.param(["--engine", "wavefront", "--material-split"],
                 "wavefront/bruteforce/matsplit", id="extra2-item 8"),
])
def test_refusals(extra, tag, capsys):
    rc, row = _run(TINY8 + extra, capsys)
    assert rc == 0 and row["pass"] and row["rmse"] == 0.0
    assert row["engine"] == tag and row["config"] == "8x8@1spp"
    assert row["oracle"].startswith(
        "wavefront/" if "--oracle-engine" in extra else "megakernel/")


def test_platform_flags_are_not_accepted():
    with pytest.raises(SystemExit):
        validate.build_parser().parse_args(["--platform", "cpu"])


def test_default_device_is_the_card():
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    assert validate.build_parser().parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            validate.main(argv)


def test_fused_against_megakernel(capsys):
    """The fused engine (plain versions on the CPU) against the oracle:
    one row at a loose gate, the JSON line's fields as the reference's."""
    rc, row = _run(TINY + ["--engine", "fused", "--intersector", "baked",
                           "--clusters", "16", "--gate", "0.05"], capsys)
    assert rc == 0 and row["pass"] and row["rmse"] > 0.0
    assert set(row) == {"scene", "config", "engine", "oracle", "rmse",
                        "gate", "pass", "test_mrays_per_s"}
    assert row["engine"] == "fused/baked/cull16"
    assert row["config"] == "64x32@4spp"
