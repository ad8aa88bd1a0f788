"""The plain reference of this configuration: its joint histogram from
the generated columns (``histogram.py``), answered by the PQL reader
(``pql.py``)."""

from __future__ import annotations

import torch

from portbench.reference.histogram import build
from portbench.reference.pql import Evaluator


def evaluator(cfg: dict, blocks, dtype=torch.int64) -> Evaluator:
    return Evaluator(build(cfg, blocks, dtype))
