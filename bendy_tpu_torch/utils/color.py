"""Color space transfer functions.

Parity notes (reference: ``src/color.rs``):
- sRGB encode/decode use the exact piecewise IEC 61966-2-1 transfer with
  breakpoints 0.04045 / 0.0031308 (``color.rs:6-20``).
- u8 quantization truncates (``color.rs:22-24``): ``(x * 255) as u8``.
- ``ColorSpace::Normal`` maps a normal n to ``(normalize(n) + 1) / 2``
  (``src/tracer/buffer.rs:23-26``).

Counterpart of ``bendy_tpu/utils/color.py``. Host-side numpy: the film
is tonemapped on the host, so nothing here needs a tensor.
"""

from __future__ import annotations

import numpy as np


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    """Piecewise sRGB -> linear transfer (``src/color.rs:6-12``)."""
    x = np.asarray(x)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    """Piecewise linear -> sRGB transfer (``src/color.rs:14-20``)."""
    x = np.asarray(x)
    return np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1.0 / 2.4) - 0.055)


def f32_to_u8(x: np.ndarray) -> np.ndarray:
    """Truncating quantization, matching ``src/color.rs:22-24``.

    The reference casts ``x * 255.0`` straight to u8 (truncation toward
    zero, with Rust's saturating float->int cast). Host-side only.
    """
    return np.clip(np.asarray(x) * 255.0, 0.0, 255.0).astype(np.uint8)


def normal_to_color(n: np.ndarray) -> np.ndarray:
    """Map a (possibly unnormalized) normal to [0,1] RGB.

    Matches ``ColorSpace::Normal`` (``src/tracer/buffer.rs:23-26``):
    normalize then (n+1)/2. A zero normal normalizes to NaN in glam;
    we reproduce IEEE semantics (0/0 -> NaN) so tests can assert the
    same downstream clamping behaviour explicitly.
    """
    n = np.asarray(n)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / norm + 1.0) * 0.5
