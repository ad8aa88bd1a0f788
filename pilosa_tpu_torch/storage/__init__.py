"""Storage tree: Holder > Index > Field > View > Fragment (reference
holder.go/index.go/field.go/view.go/fragment.go).

Port copy of the JAX package's ``storage/__init__.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from .fragment import Fragment  # noqa: F401
from .view import View  # noqa: F401
from .field import Field, FieldOptions  # noqa: F401
from .index import Index  # noqa: F401
from .holder import Holder  # noqa: F401
