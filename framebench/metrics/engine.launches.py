"""Kernel launch calls a frame in the traced stretch (the host loop)."""


def read(s):
    return s.launches / s.frames if s.frames else None
