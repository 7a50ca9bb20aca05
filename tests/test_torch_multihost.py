"""The port's multi-process rendering (``parallel/multihost.py``) on the
CPU over gloo: two worker processes, each holding its band of the image
bit for bit to a one-device render, as the JAX package's
``tests/test_sharding.py::test_multihost_dryrun`` holds its two
processes; a world of one in this process; and the refusals (a
``sample_axis`` that does not divide a process's devices, NCCL where it
cannot run).  Every process here has a timeout and one thread."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from wavefront_path_tracer_tpu_torch.parallel import multihost
from wavefront_path_tracer_tpu_torch.renderer import render
from wavefront_path_tracer_tpu_torch.scene import CameraController, book_cover
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 300
CFG = RenderConfig(width=64, height=32, samples_per_pixel=2,
                   samples_per_frame=2, max_bounces=6, engine="megakernel")


def _camera():
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.defocus_angle_deg = 0.0
    return cc


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone (file:// init under
    tmp_path, so parallel workers never share a port)."""
    assert multihost.initialize(f"file://{tmp_path / 'init'}", 1, 0,
                                "gloo") == "gloo"
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_two_gloo_workers(tmp_path):
    init = f"file://{tmp_path / 'init'}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "wavefront_path_tracer_tpu_torch.parallel."
         "dryrun", "--worker", str(rank), init, "--backend", "gloo",
         "--device", "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out}"
        assert f"process {rank}: OK (1024 pixels" in out
        assert out.count("bit for bit, gathered image bit for bit") == 2
        assert f"process {rank}: default mesh on cpu, fused/baked band " \
               "bit for bit" in out


def test_world_of_one_renders_the_image(world_of_one):
    """One process owns every tile (a mesh of four copies of the CPU): its
    rows are the whole image in linear order, bit for bit."""
    mesh = multihost.make_global_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"tiles": 4, "samples": 1}
    assert mesh.ranks == [[0]] * 4
    rad, ids = multihost.render_sharded_global(book_cover(), _camera(), CFG,
                                               mesh)
    np.testing.assert_array_equal(ids, np.arange(CFG.num_pixels))
    one = render(book_cover(), _camera(), CFG, device="cpu")
    np.testing.assert_array_equal(rad, one.accumulated.reshape(-1, 3))


def test_global_mesh_sample_axis_refused(world_of_one):
    with pytest.raises(AssertionError, match="must divide the per-process "
                                             "device count 4"):
        multihost.make_global_mesh(sample_axis=3, devices=["cpu"] * 4)
    mesh = multihost.make_global_mesh(sample_axis=2, devices=["cpu"] * 4)
    assert mesh.shape == {"tiles": 2, "samples": 2}


def test_default_mesh_takes_the_card_under_gloo(world_of_one, monkeypatch):
    """The backend carries the exchange between ranks; the device comes
    from the hardware: under gloo the default mesh takes the card
    (LOCAL_RANK, else the rank, modulo the cards) where CUDA is present,
    and the CPU only where it is absent."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert multihost.rank_device() == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dist.get_backend() == "gloo"
    assert multihost.rank_device() == torch.device("cuda", 0)
    mesh = multihost.make_global_mesh()
    assert mesh.devices == [[torch.device("cuda", 0)]]
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert multihost.make_global_mesh().devices == [[torch.device("cuda",
                                                                  1)]]


def test_nccl_refused_where_it_cannot_run(tmp_path):
    """More ranks asking for NCCL than there are cards (two, here, where
    NCCL is absent) raise, naming the cause, before any rendezvous; there
    is no silent switch to gloo."""
    cuda = torch.cuda.is_available() and dist.is_nccl_available()
    ranks = max(2, torch.cuda.device_count() + 1)
    match = ("NCCL refuses two ranks on one card" if cuda
             else "needs CUDA and a torch built with NCCL")
    with pytest.raises(RuntimeError, match=match):
        multihost.initialize(f"file://{tmp_path / 'init'}", ranks, 0, "nccl")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="use 'nccl' or 'gloo'"):
        multihost.initialize(f"file://{tmp_path / 'init'}", 2, 0, "mpi")
