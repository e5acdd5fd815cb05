"""Deterministic counter-based RNG, word for word with ``bendy_tpu``.

Counterpart of ``bendy_tpu/utils/rng.py``: the same two hash tiers, so the
port renders the *same* image as the reference for the same seed:

- ``threefry2x32`` (20 rounds) hashes (seed, pass) into the per-pass key
  (``render_key``, the same rounds on Python ints),
- ``pcg4d`` (Jarzynski & Olano, JCGT 2020) generates the per-iteration
  uniforms from (stream id, tag·16 + block, key0, key1).

torch has no add, shift or compare for ``torch.uint32`` on the CPU, and
int32 ``>>`` is arithmetic, so these plain versions carry u32 words in
int64 tensors masked to 32 bits. Products are split into 16-bit halves so
no int64 product overflows. The CUDA tracer uses native ``uint32_t``.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA

CAMERA_TAG = 0x100000  # wavefront iterations use tags < 2^20


def as_words(x, device="cpu") -> torch.Tensor:
    """Python int / numpy u32 / torch tensor -> int64 tensor of u32 words."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a·b) mod 2^32 for u32 words held in int64."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on u32 words; returns 2 words."""
    k0, k1, x0, x1 = (as_words(v) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for g in range(1, 6):
        rots = _ROT_A if g % 2 == 1 else _ROT_B
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = (x0 + ks[g % 3]) & MASK32
        x1 = (x1 + ks[(g + 1) % 3] + g) & MASK32
    return x0, x1


def to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """u32 word -> f32 in [0, 1): top 24 bits scaled by 2^-24 (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def render_key(seed, pass_idx) -> tuple[int, int]:
    """Hash (seed, pass) into a per-pass key pair of Python ints.

    :func:`threefry2x32` on plain Python ints masked to 32 bits, bit-equal
    to it: a pass derives its key on the host in microseconds and runs no
    torch op (the tensor form costs one op per step of the 20 rounds)."""
    ks = (0x9E3779B9, 0xBB67AE85, 0x9E3779B9 ^ 0xBB67AE85 ^ _PARITY)
    x0 = (int(seed) + ks[0]) & MASK32
    x1 = (int(pass_idx) + ks[1]) & MASK32
    for g in range(1, 6):
        for r in _ROT_A if g % 2 == 1 else _ROT_B:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) & MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[g % 3]) & MASK32
        x1 = (x1 + ks[(g + 1) % 3] + g) & MASK32
    return x0, x1


def pcg4d(a, b, c, d):
    """PCG4D hash: 4 u32 words in -> 4 decorrelated u32 words out
    (Jarzynski & Olano, JCGT 2020, listing 19)."""
    m = 1664525
    inc = 1013904223
    a, b, c, d = ((_mul32(as_words(v), m) + inc) & MASK32 for v in (a, b, c, d))
    a = (a + _mul32(b, d)) & MASK32
    b = (b + _mul32(c, a)) & MASK32
    c = (c + _mul32(a, b)) & MASK32
    d = (d + _mul32(b, c)) & MASK32
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + _mul32(b, d)) & MASK32
    b = (b + _mul32(c, a)) & MASK32
    c = (c + _mul32(a, b)) & MASK32
    d = (d + _mul32(b, c)) & MASK32
    return a, b, c, d


def lane_uniforms(key: tuple, lane: torch.Tensor, tag, n: int) -> list[torch.Tensor]:
    """``n`` independent U[0,1) floats per lane for stream ``tag``.

    ``lane`` holds u32 stream ids (any integer dtype), ``tag`` is an int or
    a per-lane integer tensor; the hash input (lane, tag·16 + block, key)
    is unique per draw for n <= 64.
    """
    k0, k1 = key
    lane = as_words(lane)
    base = _mul32(as_words(tag, lane.device), 16)
    out = []
    for block in range((n + 3) // 4):
        words = pcg4d(lane, (base + block) & MASK32, k0, k1)
        out.extend(to_unit_float(w) for w in words)
    return out[:n]
