"""Counter-based PCG-RXS-M-XS streams on tensors, bit-exact with the
reference package's ``ops/rng.py``.

PyTorch on the CPU has no uint32 add, shift or compare, so a 32-bit word
lives in an int64 tensor holding a value in [0, 2**32) and every
operation that can leave that range is masked back into it.  Products
with a 32-bit constant can exceed 63 bits, so they go through
:func:`mul32`, which splits the constant into 16-bit halves.  The CUDA
kernel computes the same streams in ``uint32_t`` (``csrc/persistent.cu``).

One stream per (pixel, frame, sample, bounce) event: slot 0 is camera
ray generation, slot ``b + 1`` the shading event after the b-th hit, and
roulette draws from a separately salted stream (:func:`rr_state`).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

PCG_MULT = 747796405
PCG_INC = 2891336453
RXS_M = 277803737
U32_TO_F32 = 2.3283064365387e-10   # 1 / 2**32, as the f32 literal
SAMPLE_STRIDE = 0x9E3779B9
BOUNCE_STRIDE = 0x85EBCA6B
RR_SALT = 0x52455252


def as_u32(x) -> torch.Tensor:
    """A tensor or Python int as an int64 tensor of 32-bit words.  An int
    becomes a 0-d CPU tensor, which PyTorch takes as a scalar beside a
    tensor on any device: no copy to the card, which would wait for it."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.tensor(int(x) & MASK32, dtype=torch.int64)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``(a * b) mod 2**32`` for 32-bit words, without int64 overflow."""
    if isinstance(b, torch.Tensor):
        b = as_u32(b)
        lo, hi = b & 0xFFFF, b >> 16
    else:
        b = int(b) & MASK32
        lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def jenkins_hash(x) -> torch.Tensor:
    """Jenkins one-at-a-time finalizer."""
    x = as_u32(x)
    x = (x + (x << 10)) & MASK32
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & MASK32
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & MASK32
    return x


def pcg_output(state) -> torch.Tensor:
    """RXS-M-XS output permutation of an LCG state."""
    state = as_u32(state)
    word = mul32(torch.bitwise_right_shift(state, (state >> 28) + 4) ^ state,
                 RXS_M)
    return (word >> 22) ^ word


def next_u32(state) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance the LCG; (new_state, random 32-bit word)."""
    new_state = (mul32(as_u32(state), PCG_MULT) + PCG_INC) & MASK32
    return new_state, pcg_output(new_state)


def next_f32(state) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance; (new_state, float32 in [0, 1)).  ``float(w) * 2**-32``
    with one rounding at the conversion, as the kernels compute it."""
    state, word = next_u32(state)
    return state, word.to(torch.float32) * U32_TO_F32


def pixel_seed(pixel_idx, frame) -> torch.Tensor:
    """Per-pixel base seed: ``jenkins(pixel ^ jenkins(frame))``."""
    pixel_idx = as_u32(pixel_idx)
    return jenkins_hash(pixel_idx ^ jenkins_hash(as_u32(frame)))


def _event(base, sample, bounce) -> torch.Tensor:
    return (base + mul32(as_u32(sample), SAMPLE_STRIDE)
            + mul32(as_u32(bounce), BOUNCE_STRIDE)) & MASK32


def stream_state(pixel_idx, frame, sample, bounce) -> torch.Tensor:
    """Initial LCG state of the (pixel, frame, sample, bounce) stream."""
    return jenkins_hash(_event(pixel_seed(pixel_idx, frame), sample, bounce))


def rr_state(pixel_idx, frame, sample, bounce) -> torch.Tensor:
    """Russian-roulette stream for the same event coordinates, salted
    apart from :func:`stream_state`."""
    return jenkins_hash(
        _event(pixel_seed(pixel_idx, frame), sample, bounce) ^ RR_SALT)


TWO_PI = 2.0 * 3.1415927   # rounds to f32 as the reference's 2 * f32(pi)


def sample_unit_disk(state) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Uniform point in the unit disk from two draws; (state, x, y)."""
    state, u1 = next_f32(state)
    state, u2 = next_f32(state)
    r = torch.sqrt(u1)
    alpha = TWO_PI * u2
    return state, r * torch.cos(alpha), r * torch.sin(alpha)


def advance(state, delta: int) -> torch.Tensor:
    """Jump the LCG ahead by ``delta`` draws in O(log delta): Brown's
    power-of-two advance, as the reference's ``advance`` (not the WGSL
    original's off-by-condition form)."""
    delta = int(delta) & MASK32
    acc_mult, acc_plus = 1, 0
    cur_mult, cur_plus = PCG_MULT, PCG_INC
    while delta > 0:
        if delta & 1:
            acc_mult = (acc_mult * cur_mult) & MASK32
            acc_plus = (acc_plus * cur_mult + cur_plus) & MASK32
        cur_plus = ((cur_mult + 1) * cur_plus) & MASK32
        cur_mult = (cur_mult * cur_mult) & MASK32
        delta >>= 1
    return (mul32(as_u32(state), acc_mult) + acc_plus) & MASK32


def roulette(pixel_idx, frame, sample, bounce, throughput, alive,
             start_bounce: int, floor: float = 0.05):
    """Unbiased Russian roulette at one surface event; (throughput,
    alive).  From surface event ``start_bounce`` on, a path continues with
    ``p = clip(max(throughput), floor, 1)`` and a survivor's throughput is
    divided by ``p``; the draw comes from :func:`rr_state`, so a render
    where roulette never starts is untouched.  ``bounce`` is an int or a
    tensor of the lanes' events."""
    _, u = next_f32(rr_state(pixel_idx, frame, sample, bounce))
    keep_p = torch.clamp(torch.amax(throughput, dim=-1), floor, 1.0)
    if isinstance(bounce, torch.Tensor):
        active = alive & (as_u32(bounce) >= int(start_bounce))
    else:
        active = alive & (int(bounce) >= int(start_bounce))
    survive = ~active | (u < keep_p)
    throughput = torch.where((active & survive)[:, None],
                             throughput / keep_p[:, None], throughput)
    return throughput, alive & survive


def sample_unit_sphere(state) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """Uniform point in the unit ball from three draws; (state, x, y,
    z), the reference's f32 operations in its order."""
    state, u1 = next_f32(state)
    state, u2 = next_f32(state)
    state, u3 = next_f32(state)
    r = torch.pow(u1, 0.33333)
    cos_theta = 1.0 - 2.0 * u2
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta,
                                           0.0))
    phi = TWO_PI * u3
    x = r * sin_theta * torch.cos(phi)
    y = r * sin_theta * torch.sin(phi)
    z = r * cos_theta
    return state, x, y, z
