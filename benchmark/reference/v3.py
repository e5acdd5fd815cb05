"""V3: structure-of-arrays 3-vectors on torch tensors.

Counterpart of ``bendy_tpu/utils/v3.py``. Three ``[B]`` tensors instead of
one ``[B,3]`` keeps the layout of the reference's public functions, so the
tests compare like with like, and it broadcasts against 0-d scene scalars.
Also used for RGB colors (x=r, y=g, z=b).

The reference's host-constant folding helpers (``host_const``, ``cmul``,
``cdot``, ``csub``, ``caxpy``) are not ported: they exist because Pallas
bakes the scene as constants, and the generic ops give the same values.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

Scalar = Union[float, torch.Tensor]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device, as the CUDA
    tracer's ``sqrtf`` and the reference's ``jnp.sqrt`` round it: the
    square root of the f64 value, rounded once to f32 (exact for sqrt,
    since 53 >= 2·24 + 2). ``torch.sqrt`` on the CPU is not always
    correctly rounded: with AVX-512 kernels about 0.7 % of random f32
    inputs come out one ulp off."""
    return torch.sqrt(x.double()).to(x.dtype)


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- constructors -------------------------------------------------------

    @staticmethod
    def zeros(shape=(), device="cpu", dtype=None) -> "V3":
        z = torch.zeros(shape, dtype=dtype or torch.get_default_dtype(), device=device)
        return V3(z, z, z)

    @staticmethod
    def from_array(a: torch.Tensor) -> "V3":
        """[...,3] -> V3 of [...] components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    # -- arithmetic ----------------------------------------------------------

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- geometry ------------------------------------------------------------

    def dot(self, o: "V3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_squared(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return sqrt_rn(self.length_squared())

    def normalize(self) -> "V3":
        # 1/sqrt, both correctly rounded: what the CUDA tracer computes
        # (torch.rsqrt on a card is the approximate rsqrtf)
        return self * (1.0 / sqrt_rn(self.length_squared()))

    # -- selection -----------------------------------------------------------

    @staticmethod
    def where(mask: torch.Tensor, a: "V3", b: "V3") -> "V3":
        return V3(
            torch.where(mask, a.x, b.x),
            torch.where(mask, a.y, b.y),
            torch.where(mask, a.z, b.z),
        )

    # -- reference BSDF math (``src/math/mod.rs:27-63``) ---------------------

    def reflect(self, n: "V3") -> "V3":
        return self - n * (2.0 * self.dot(n))

    def refract(self, n: "V3", ior: Scalar) -> "V3":
        cos_theta = torch.clamp_max((-self).dot(n), 1.0)
        perp = (n * cos_theta + self) * ior
        parallel = n * -sqrt_rn(torch.abs(1.0 - perp.length_squared()))
        return perp + parallel

    def fresnel(self, n: "V3", ior: Scalar) -> torch.Tensor:
        cos_theta = torch.clamp_max((-self).dot(n), 1.0)
        r0 = (1.0 - ior) / (1.0 + ior)
        r0 = r0 * r0
        c = 1.0 - cos_theta
        c2 = c * c
        # c**5 as jax's integer_pow computes it: c · (c²)²
        return r0 + (1.0 - r0) * (c * (c2 * c2))

    def orthonormal_frame(self) -> tuple["V3", "V3"]:
        """Branchless tangent frame for a unit vector (Duff et al. 2017)."""
        sign = torch.where(self.z >= 0.0, 1.0, -1.0)
        a = -1.0 / (sign + self.z)
        b = self.x * self.y * a
        t = V3(1.0 + sign * self.x * self.x * a, sign * b, -sign * self.x)
        bt = V3(b, sign + self.y * self.y * a, -self.y)
        return t, bt
