from . import build, mesh, render  # noqa: F401
