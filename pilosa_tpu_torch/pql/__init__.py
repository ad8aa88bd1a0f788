"""PQL: query language AST + parser (reference pql/).

Port copy of the JAX package's ``pql/__init__.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from .ast import (  # noqa: F401
    BETWEEN, Call, Condition, EQ, GT, GTE, LT, LTE, NEQ, Query, WRITE_CALLS,
)
from .parser import ParseError, parse  # noqa: F401
