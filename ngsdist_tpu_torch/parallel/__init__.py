"""Sharded execution: a site x pair mesh of devices driven by one process
(mesh.py) and its site rounds (multihost.py)."""

from .mesh import Mesh, make_mesh, pairs_size, sites_size  # noqa: F401
