"""TOML loading with a py3.10 fallback.

``tomllib`` entered the stdlib in 3.11; on 3.10 the same parser exists
as the third-party ``tomli`` package (tomllib IS tomli, vendored).
Config loading (server.Config.from_toml, the CLI round-trip tests) goes
through this module so TOML support doesn't depend on the interpreter
minor version.

Port copy of the JAX package's ``utils/toml.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

try:
    import tomllib as _toml
except ModuleNotFoundError:  # Python < 3.11
    try:
        import tomli as _toml  # same parser, pre-stdlib packaging
    except ModuleNotFoundError:
        _toml = None


def load(fp) -> dict:
    """Parse a binary file object (tomllib.load signature)."""
    if _toml is None:
        raise ModuleNotFoundError(
            "TOML support needs Python >= 3.11 (tomllib) or the 'tomli' "
            "package on older interpreters")
    return _toml.load(fp)


def loads(text: str) -> dict:
    """Parse a TOML string (tomllib.loads signature)."""
    if _toml is None:
        raise ModuleNotFoundError(
            "TOML support needs Python >= 3.11 (tomllib) or the 'tomli' "
            "package on older interpreters")
    return _toml.loads(text)
