"""Counter-based RNG: one independent uint32 stream per (seed, ray, sample).

Counterpart of ``raytracingc_tpu/rng.py``, bit for bit: the same LCG advance,
xorshift-multiply output mix and splitmix stream derivation. Torch has no
general uint32 arithmetic, so a state is an ``int64`` tensor holding a value
in ``[0, 2**32)``; every step is masked back to 32 bits. A product of two
such values may wrap past 2**63 in int64, which leaves its low 32 bits — the
only ones kept — equal to the uint32 product. Right shifts of a non-negative
int64 are logical, as the uint32 shifts they stand for.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_LCG_MUL = 747796405
_LCG_INC = 2891336453
_MIX_MUL = 277803737
_INV_U32_MAX = float(np.float32(1.0 / 4294967295.0))

# splitmix32 constants for stream derivation.
_SM_GAMMA = 0x9E3779B9
_SM_M1 = 0x85EBCA6B
_SM_M2 = 0xC2B2AE35
_RAY_MUL = 0x68BC21EB
_SAMPLE_MUL = 0x2C1B3C6D

TWO_PI = 6.2831853071795864769

# torch's CPU kernels round some functions (log, cos, pow) differently in
# their vectorised loop and in the scalar loop over a tensor's last few
# elements, so a lane's value would depend on its position; on the CPU
# every lane goes through the vector loop. A multiple of two vectors of 16
# floats (the vectorised loop's step); one torch thread (a thread's share of
# a larger tensor can end inside a vector).
_CPU_VEC_PAD = 64


def lanewise(fn, x: torch.Tensor, fill: float = 1.0) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``, each element's value independent
    of its position in ``x``: on the CPU ``x`` is padded with ``fill`` to
    whole vectors first. On a card ``fn(x)`` as it is."""
    if x.device.type != "cpu":
        return fn(x)
    flat = x.reshape(-1)
    pad = -flat.numel() % _CPU_VEC_PAD
    out = fn(torch.cat([flat, flat.new_full((pad,), fill)]))
    return out[:flat.numel()].reshape(x.shape)


def _advance(state: torch.Tensor) -> torch.Tensor:
    return (state * _LCG_MUL + _LCG_INC) & _M32


def _output_mix(state: torch.Tensor) -> torch.Tensor:
    r = (((state >> ((state >> 28) + 4)) ^ state) * _MIX_MUL) & _M32
    return (r >> 22) ^ r


def next_uniform(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance the stream; return ``(new_state, U[0, 1] float32)``.

    The uint32 → float32 conversion rounds to nearest even, as
    ``astype(float32)`` does; the int64 → float32 conversion of the same value
    rounds the same way.
    """
    state = _advance(state)
    r = _output_mix(state)
    return state, r.to(torch.float32) * _INV_U32_MAX


def _splitmix(x):
    """splitmix32 finalizer on an int64 tensor or a Python int in [0, 2**32)."""
    x = ((x ^ (x >> 16)) * _SM_M1) & _M32
    x = ((x ^ (x >> 13)) * _SM_M2) & _M32
    return x ^ (x >> 16)


def stream_init(seed: int, ray_id: torch.Tensor, sample_id) -> torch.Tensor:
    """Independent stream state per (seed, ray, sample), as int64 in [0, 2**32).

    ``ray_id`` is an integer tensor (its low 32 bits are used, as the uint32
    cast of the JAX package does); ``sample_id`` an int or integer tensor.
    """
    ray_id = ray_id.to(torch.int64) & _M32
    s = _splitmix((int(seed) + _SM_GAMMA) & _M32)
    s = _splitmix(s ^ ((ray_id * _RAY_MUL + _SM_GAMMA) & _M32))
    if isinstance(sample_id, torch.Tensor):
        sample_id = sample_id.to(torch.int64)
    return _splitmix(s ^ (((sample_id & _M32) * _SAMPLE_MUL + _SM_GAMMA) & _M32))


def next_normal(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One standard normal by Box–Muller from two uniforms (``u2`` clamped
    away from 0, as in the JAX package)."""
    state, u1 = next_uniform(state)
    state, u2 = next_uniform(state)
    u2 = torch.clamp_min(u2, 1e-10)
    z = (torch.sqrt(-2.0 * lanewise(torch.log, u2))
         * lanewise(torch.cos, TWO_PI * u1))
    return state, z


def next_unit_vector(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform random unit vector ``[..., 3]`` from three normals (six draws)."""
    state, x = next_normal(state)
    state, y = next_normal(state)
    state, z = next_normal(state)
    norm = torch.sqrt(x * x + y * y + z * z)
    v = torch.stack([x, y, z], dim=-1)
    return state, v / torch.clamp_min(norm, 1e-12).unsqueeze(-1)

