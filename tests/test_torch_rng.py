"""Port RNG streams are bit-exact with the JAX package's ops/rng.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.ops import rng as jrng
from wavefront_path_tracer_tpu_torch.ops import rng as trng

torch.set_num_threads(2)

N = 4096


def _u32(rng, lo=0, hi=2**32):
    return rng.integers(lo, hi, N, dtype=np.uint64).astype(np.uint32)


@pytest.fixture(scope="module")
def words():
    rng = np.random.default_rng(1234)
    return {
        "state": _u32(rng),
        "pixel": _u32(rng, 0, 1920 * 1080),
        "frame": _u32(rng, 0, 1 << 16),
        # Samples near 2**32 exercise the wrap of sample * 0x9E3779B9.
        "sample": np.concatenate([_u32(rng, 0, 1 << 12)[: N // 2],
                                  _u32(rng, 2**32 - 4096)[: N // 2]]),
        "bounce": _u32(rng, 0, 64),
    }


def _t(x):
    return torch.from_numpy(x.astype(np.int64))


def _same(j, t):
    np.testing.assert_array_equal(np.asarray(j, np.uint32),
                                  t.numpy().astype(np.uint32))


@pytest.mark.parametrize("name", ["jenkins_hash", "pcg_output"])
def test_word_functions_bit_exact(words, name):
    s = words["state"]
    _same(getattr(jrng, name)(jnp.asarray(s)), getattr(trng, name)(_t(s)))


def test_next_u32_and_f32_bit_exact(words):
    s = words["state"]
    js, jw = jrng.next_u32(jnp.asarray(s))
    ts, tw = trng.next_u32(_t(s))
    _same(js, ts)
    _same(jw, tw)
    js, jf = jrng.next_f32(jnp.asarray(s))
    ts, tf = trng.next_f32(_t(s))
    _same(js, ts)
    assert tf.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jf).view(np.uint32),
                                  tf.numpy().view(np.uint32))


def test_pixel_seed_bit_exact(words):
    for frame in (0, 7, int(words["frame"][0])):
        _same(jrng.pixel_seed(jnp.asarray(words["pixel"]), frame),
              trng.pixel_seed(_t(words["pixel"]), frame))


@pytest.mark.parametrize("name", ["stream_state", "rr_state"])
def test_event_streams_bit_exact(words, name):
    p, f, s, b = (words[k] for k in ("pixel", "frame", "sample", "bounce"))
    j = getattr(jrng, name)(jnp.asarray(p), jnp.asarray(f), jnp.asarray(s),
                            jnp.asarray(b))
    t = getattr(trng, name)(_t(p), _t(f), _t(s), _t(b))
    _same(j, t)
    # Scalar frame / bounce, as the kernels pass them.
    _same(getattr(jrng, name)(jnp.asarray(p), 3, jnp.asarray(s), 5),
          getattr(trng, name)(_t(p), 3, _t(s), 5))


def test_mul32_matches_python_ints(words):
    a = words["state"][:256]
    for b in (trng.SAMPLE_STRIDE, trng.BOUNCE_STRIDE, 0xFFFFFFFF, 1):
        want = np.array([(int(x) * b) & 0xFFFFFFFF for x in a], np.int64)
        np.testing.assert_array_equal(trng.mul32(_t(a), b).numpy(), want)


def test_sample_unit_disk_matches_jax(words):
    """The disk sampler of the segment path's raygen: the same stream
    state bit for bit, the point to 2 ulps at 1.0 (sqrt, cos and sin of
    XLA:CPU and of PyTorch need not round alike)."""
    st_j, xj, yj = jrng.sample_unit_disk(jnp.asarray(words["state"]))
    st_t, xt, yt = trng.sample_unit_disk(_t(words["state"]))
    _same(st_j, st_t)
    assert xt.dtype == yt.dtype == torch.float32
    for j, t in ((xj, xt), (yj, yt)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=2.4e-7)
    assert float((xt * xt + yt * yt).max()) <= 1.0
