"""HTTP server layer (reference http/ + server/) — the port of the JAX
package's ``server/`` package for a single node."""

from .server import Config, Server  # noqa: F401
