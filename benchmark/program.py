"""The system under test, reached only through the port's public API:
``bendy_tpu_torch.scene.load_scene``, ``bendy_tpu_torch.render`` (``Renderer``,
``Config``, ``RenderConfig``, ``Subsample``) and
``bendy_tpu_torch.film.DeviceFilm``, and the device counter behind
``Renderer.rays_traced``, which the window copies without waiting.

Nothing else of the program is imported, so its benches, tools and smoke
script may change without moving the yardstick.
"""

from __future__ import annotations

import torch


class Program:
    """One renderer of one configuration's scene on ``device``."""

    def __init__(self, scene_path: str, config: dict, device) -> None:
        from bendy_tpu_torch.film import DeviceFilm
        from bendy_tpu_torch.render import Config, Output, Renderer, RenderConfig, Subsample
        from bendy_tpu_torch.scene import load_scene

        self._film_cls, self._rc_cls, self._sub_cls = DeviceFilm, RenderConfig, Subsample
        self.device = torch.device(device)
        self.scene = load_scene(scene_path)
        self.camera = self.scene.find_by_tag("camera")
        knobs = {k: v for k, v in config.items() if k != "output"}
        self.renderer = Renderer(self.scene, Config(output=Output(config["output"]), **knobs),
                                 device=self.device)

    def set_aspect(self, aspect: float) -> None:
        """The app's W/H sync of the camera."""
        self.scene.get_object(self.camera).inner.aspect_ratio = aspect

    def film(self, width: int, height: int):
        return self._film_cls(width, height, device=self.device)

    def render_config(self, spp: int, subsample: int):
        return self._rc_cls(samples=spp, subsample=self._sub_cls(subsample))

    def render(self, film, rc, seed: int) -> None:
        self.renderer.render(self.camera, rc, film, seed=seed)

    def ray_counter(self) -> torch.Tensor:
        """The rays traced so far, as a tensor: a copy of the renderer's
        device counter queued behind the passes (no wait), or, where the
        renderer keeps none, its count read at once (which waits)."""
        counter = getattr(self.renderer, "_rays", None)
        if isinstance(counter, torch.Tensor):
            return counter.clone()
        return torch.tensor([self.renderer.rays_traced])
