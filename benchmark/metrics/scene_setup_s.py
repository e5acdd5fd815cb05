"""The benchmark's span around the scene's load and the Renderer's
construction (the scene compile and, where the program builds one, its
acceleration structure). The CUDA context is made before the span."""


def read(r):
    return r.scene_setup_s
