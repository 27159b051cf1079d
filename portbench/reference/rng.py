"""Counter-based RNG of the renderer, restated in plain torch.

One independent uint32 stream per (seed, ray, sample): an LCG advance, an
xorshift-multiply output mix, and splitmix32 to derive the stream's start
from the seed, the ray id and the sample id. Torch has no general uint32
arithmetic, so a state is an int64 tensor holding a value in [0, 2**32),
masked back to 32 bits after every product (the low 32 bits of an int64
product that wraps are those of the uint32 product).

The draws of one bounce are six uniforms for a unit vector (three normals by
Box-Muller) and one for Russian roulette.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
LCG_MUL = 747796405
LCG_INC = 2891336453
MIX_MUL = 277803737
INV_U32_MAX = float(np.float32(1.0 / 4294967295.0))
SM_GAMMA = 0x9E3779B9
SM_M1 = 0x85EBCA6B
SM_M2 = 0xC2B2AE35
RAY_MUL = 0x68BC21EB
SAMPLE_MUL = 0x2C1B3C6D
TWO_PI = 6.2831853071795864769

# On the CPU torch rounds log, cos and pow differently in its vector loop and
# in the scalar loop over a tensor's tail, so a lane's value would depend on
# its position: there every elementwise transcendental runs on whole vectors.
CPU_VEC_PAD = 64


def lanewise(fn, x: torch.Tensor, fill: float = 1.0) -> torch.Tensor:
    """``fn(x)`` with each element's value independent of its position."""
    if x.device.type != "cpu":
        return fn(x)
    flat = x.reshape(-1)
    pad = -flat.numel() % CPU_VEC_PAD
    out = fn(torch.cat([flat, flat.new_full((pad,), fill)]))
    return out[:flat.numel()].reshape(x.shape)


def _splitmix(x):
    x = ((x ^ (x >> 16)) * SM_M1) & M32
    x = ((x ^ (x >> 13)) * SM_M2) & M32
    return x ^ (x >> 16)


def stream_init(seed: int, ray_id: torch.Tensor, sample_id) -> torch.Tensor:
    """Stream state per (seed, ray, sample) as int64 in [0, 2**32)."""
    ray_id = ray_id.to(torch.int64) & M32
    s = _splitmix((int(seed) + SM_GAMMA) & M32)
    s = _splitmix(s ^ ((ray_id * RAY_MUL + SM_GAMMA) & M32))
    if isinstance(sample_id, torch.Tensor):
        sample_id = sample_id.to(torch.int64)
    return _splitmix(s ^ (((sample_id & M32) * SAMPLE_MUL + SM_GAMMA) & M32))


def next_uniform(state: torch.Tensor, dtype=torch.float32):
    """Advance; return ``(state, U[0, 1])`` (rounded to float32, then to
    ``dtype``)."""
    state = (state * LCG_MUL + LCG_INC) & M32
    r = (((state >> ((state >> 28) + 4)) ^ state) * MIX_MUL) & M32
    r = (r >> 22) ^ r
    u = r.to(torch.float32) * INV_U32_MAX
    return state, u.to(dtype)


def _next_normal(state, dtype):
    state, u1 = next_uniform(state, dtype)
    state, u2 = next_uniform(state, dtype)
    u2 = torch.clamp_min(u2, 1e-10)
    z = torch.sqrt(-2.0 * lanewise(torch.log, u2)) * lanewise(torch.cos, TWO_PI * u1)
    return state, z


def next_unit_vector(state: torch.Tensor, dtype=torch.float32):
    """A uniform unit vector ``[R, 3]`` from three normals (six draws)."""
    state, x = _next_normal(state, dtype)
    state, y = _next_normal(state, dtype)
    state, z = _next_normal(state, dtype)
    norm = torch.sqrt(x * x + y * y + z * z)
    v = torch.stack([x, y, z], dim=-1)
    return state, v / torch.clamp_min(norm, 1e-12).unsqueeze(-1)
