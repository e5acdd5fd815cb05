"""The program's scene load and compile (its ``scene.load`` and
``scene.compile`` spans: the scene file's parse, the compile to device
tables, their host copy and the material facts), in s: the part of
``scene_setup_s`` that is not the first import of the program's modules."""

from benchmark import program_spans


def read(r):
    return program_spans.one_off_s(program_spans.recorded(), ("scene.load", "scene.compile"))
