"""Data and model parallelism over processes (parallel/mesh.py)."""

from .mesh import Mesh, make_mesh, mesh_from_env, mesh_session

__all__ = ["Mesh", "make_mesh", "mesh_from_env", "mesh_session"]
