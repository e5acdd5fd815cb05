"""Host-side image IO: tonemapped previews and PNG screenshots.

Mirrors the reference's preview pipeline (``src/tracer/buffer.rs:117-138``):
divide the accumulated film by the global sample count, convert through the
configured color space, truncate-quantize to u8 (``src/color.rs:22-24``)
and write RGBA.

Counterpart of ``bendy_tpu/utils/image.py``. PIL is imported only when a
PNG is written.
"""

from __future__ import annotations

import numpy as np

from bendy_tpu_torch.utils.color import f32_to_u8, linear_to_srgb, normal_to_color


def tonemap(film_sum: np.ndarray, samples: int, color_space: str = "srgb") -> np.ndarray:
    """Film sums [H,W,3] + sample count -> u8 RGB [H,W,3].

    color_space: 'srgb' | 'linear' | 'none' | 'normal', matching
    ``ColorSpace`` (``src/tracer/buffer.rs:11-30``).
    """
    mean = np.asarray(film_sum, dtype=np.float32) / max(samples, 1)
    if color_space == "srgb":
        mean = np.asarray(linear_to_srgb(mean))
    elif color_space == "normal":
        mean = np.nan_to_num(np.asarray(normal_to_color(mean)))
    elif color_space in ("linear", "none"):
        pass
    else:
        raise ValueError(f"unknown color space {color_space!r}")
    return f32_to_u8(mean)


def save_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write an RGB(A) u8 image to ``path`` (PNG via PIL)."""
    from PIL import Image

    Image.fromarray(np.asarray(rgb_u8)).save(path)
