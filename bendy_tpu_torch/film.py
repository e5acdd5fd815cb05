"""Progressive film accumulation + exact-resume checkpointing.

Counterpart of ``bendy_tpu/film.py`` (the reference's ``Buffer``,
``src/tracer/buffer.rs``): a raw f32 sum image plus one global sample
counter; ``preview`` divides by the count and converts color space. The
raw film state persists to ``.npz`` in the reference's layout (sum,
samples, passes, seed, color_space), so either package resumes the
other's checkpoint.

Two accumulators:
- :class:`Film` — host numpy sums; every pass is copied to the host.
- :class:`DeviceFilm` — the sums stay a tensor on the render device (the
  card) and passes add in place there, with no host synchronization; the
  image crosses to the host only for preview/PNG/checkpoint.
"""

from __future__ import annotations

import numpy as np
import torch

from bendy_tpu_torch.utils.device import resolve_device
from bendy_tpu_torch.utils.image import save_png, tonemap


class Film:
    def __init__(self, width: int, height: int, color_space: str = "srgb") -> None:
        self.width = width
        self.height = height
        self.color_space = color_space
        self.clear()

    def clear(self) -> None:
        self.sum = np.zeros((self.height, self.width, 3), np.float32)
        self.samples = 0
        self.passes = 0

    def resize(self, width: int, height: int) -> None:
        self.width = width
        self.height = height
        self.clear()

    def add_pass(self, sums, samples: int) -> None:
        """Accumulate one pass of per-pixel sums carrying ``samples`` spp."""
        if isinstance(sums, torch.Tensor):
            sums = sums.detach().cpu().numpy()
        self.sum = self.sum + np.asarray(sums, np.float32)
        self.count_pass(samples)

    def count_pass(self, samples: int) -> None:
        """Count one pass of ``samples`` spp whose sums were already added
        into ``sum`` in place (the renderer's accumulate kernel)."""
        self.samples += samples
        self.passes += 1

    def _host_sum(self) -> np.ndarray:
        return self.sum

    def preview(self) -> np.ndarray:
        """Tonemapped u8 image (mean over samples, color-space converted)."""
        return tonemap(self._host_sum(), self.samples, self.color_space)

    def mean(self) -> np.ndarray:
        """Linear mean image (float), for gates and tests."""
        return self._host_sum() / max(self.samples, 1)

    def save_png(self, path: str) -> None:
        save_png(path, self.preview())

    # -- exact resume ------------------------------------------------------

    def save_checkpoint(self, path: str, seed: int = 0) -> None:
        np.savez(
            path,
            sum=self._host_sum(),
            samples=self.samples,
            passes=self.passes,
            seed=seed,
            color_space=self.color_space,
        )

    @staticmethod
    def load_checkpoint(path: str) -> tuple["Film", int]:
        z = np.load(path, allow_pickle=False)
        s = z["sum"]
        film = Film(s.shape[1], s.shape[0], str(z["color_space"]))
        film.sum = s.astype(np.float32)
        film.samples = int(z["samples"])
        film.passes = int(z["passes"])
        return film, int(z["seed"])


class DeviceFilm(Film):
    """Film whose running sum is a tensor on ``device``.

    ``add_pass`` adds the pass sums in place on the device, with no
    transfer and no sync; a renderer on the same device adds each pass into
    ``sum`` itself (``Renderer.render``) and calls ``count_pass``.
    ``synchronize`` waits for all queued passes (the honest timing point);
    ``mean``/``preview``/``save_*`` fetch once. The host API (counters,
    checkpoint format, preview) is that of :class:`Film`.
    """

    def __init__(self, width: int, height: int, color_space: str = "srgb",
                 device="cuda") -> None:
        self.device = resolve_device(device)
        super().__init__(width, height, color_space)

    @staticmethod
    def from_film(film: Film, device="cuda") -> "DeviceFilm":
        """Move a host film's accumulated state onto ``device``."""
        out = DeviceFilm(film.width, film.height, film.color_space, device)
        out.sum = torch.as_tensor(np.asarray(film._host_sum(), np.float32)).to(out.device)
        out.samples = film.samples
        out.passes = film.passes
        return out

    def clear(self) -> None:
        self.sum = torch.zeros((self.height, self.width, 3), dtype=torch.float32,
                               device=self.device)
        self.samples = 0
        self.passes = 0

    def add_pass(self, sums, samples: int) -> None:
        self.sum += torch.as_tensor(sums).to(self.device)  # in place, async
        self.count_pass(samples)

    def synchronize(self) -> "DeviceFilm":
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _host_sum(self) -> np.ndarray:
        return self.sum.detach().cpu().numpy().astype(np.float32, copy=False)
