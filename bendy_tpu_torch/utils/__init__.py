from bendy_tpu_torch.utils import color, image, rng, v3  # noqa: F401
