"""Query executor of the PyTorch port (the JAX package's ``executor/``)."""

from .executor import ExecutionError, Executor  # noqa: F401
from .plan import PlanError  # noqa: F401
from .results import (  # noqa: F401
    FieldRow, GroupCount, Pair, RowIdentifiers, RowResult, ValCount,
)
