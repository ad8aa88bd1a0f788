"""The plain reference: a table's joint histogram, from the generated
columns themselves.

Every fact of a configuration holds exactly one row of each set field
and at most one value of each int field, so the count of facts in every
combination of set-field rows (a cell), with each int field's sum and
count of values per cell, answers every count, TopN, GroupBy and Sum
over intersections and unions of rows exactly (``pql.py``).  The
histogram is built block by block with ``bincount`` and ``index_add_``
in int64, on whatever device the columns were drawn on.

``dtype=torch.float32`` builds the control: the same histogram counted
and summed in float32, the precision below the configuration's exact
integers.

Imports torch and numpy only: nothing of the port or of JAX.
"""

from __future__ import annotations

import numpy as np
import torch


class Histogram:
    def __init__(self, cfg: dict, dtype=torch.int64):
        self.set_fields = [f for f in cfg["fields"] if f["type"] == "set"]
        self.int_fields = [f for f in cfg["fields"] if f["type"] == "int"]
        self.shape = tuple(f["rows"] for f in self.set_fields)
        self.axis = {f["name"]: i for i, f in enumerate(self.set_fields)}
        self.dtype = dtype
        self.n_cells = int(np.prod(self.shape))
        self.counts = None
        self.sums = {f["name"]: None for f in self.int_fields}
        self.valued = {f["name"]: None for f in self.int_fields}

    def _acc(self, have, add):
        add = add.to(self.dtype)
        return add if have is None else have + add

    def add(self, columns: dict):
        """Fold one block of columns in."""
        cell = None
        for f in self.set_fields:
            c = columns[f["name"]]
            cell = c if cell is None else cell * f["rows"] + c
        dev = cell.device
        self.counts = self._acc(self.counts, torch.bincount(
            cell, minlength=self.n_cells).to(dev))
        for f in self.int_fields:
            v = columns[f["name"]]
            s = torch.zeros(self.n_cells, dtype=self.dtype, device=dev)
            s.index_add_(0, cell, v.to(self.dtype))
            self.sums[f["name"]] = self._acc(self.sums[f["name"]], s)
            self.valued[f["name"]] = self._acc(
                self.valued[f["name"]],
                torch.bincount(cell, minlength=self.n_cells))

    def finish(self) -> "Histogram":
        """Move the totals to numpy arrays of ``shape``."""
        self.counts = self.counts.cpu().numpy().reshape(self.shape)
        for name in self.sums:
            self.sums[name] = self.sums[name].cpu().numpy() \
                .reshape(self.shape)
            self.valued[name] = self.valued[name].cpu().numpy() \
                .reshape(self.shape)
        return self


def build(cfg: dict, blocks, dtype=torch.int64) -> Histogram:
    h = Histogram(cfg, dtype)
    for b in blocks:
        h.add(b.columns)
    return h.finish()
