"""The benchmark's plain reference: a frozen copy of the port's plain
integrator (scene loader and compiler, RNG, camera, intersection, shading,
media, geodesics and the wavefront loop), in plain PyTorch and numpy. It
imports nothing of the program, so a later change to the program cannot
move the yardstick that decides ``correct``."""
