"""What a call needs of the device, from its shape and the config's
sizes alone, and the peaks it is held against.

Each input row a call reads is counted once, over the words that hold
facts (``ceil(facts / 32)`` 32-bit words a row), whatever the program
re-reads or pads: ``Row(f=v)`` one row; ``Rows(f)`` and ``TopN``'s field
every row of ``f``; ``Sum`` its filter, the field's exists row and one
row a magnitude bit (and the sign row where the field holds negative
values).  The operations are one 32-bit operation an input word, a
lower bound on any evaluation.  So the least device time of a call,
the larger of bytes over the peak bandwidth and operations over the
peak 32-bit rate, stays the same whatever implements it.
"""

from __future__ import annotations

from portbench.encode import bit_depth
from portbench.reference.pql import Call, parse

# Published peaks, dense, at the full 700 W (NVIDIA H100 SXM data sheet):
# 3.35 TB/s of HBM3 and 67 T 32-bit operations a second outside the tensor
# cores.  Keyed by a word of torch.cuda.get_device_name().
PEAKS = {"H100": {"bytes_per_s": 3.35e12, "ops_per_s": 67e12}}


def peaks(device_name: str) -> dict | None:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def _rows(c, cfg: dict, out: set):
    fields = {f["name"]: f for f in cfg["fields"]}
    if not isinstance(c, Call):
        return
    if c.name == "Row":
        (f, v), = c.kwargs.items()
        out.add((f, v))
        return
    if c.name == "Rows":
        f = c.args[0]
        out.update((f, r) for r in range(fields[f]["rows"]))
        return
    if c.name == "TopN":
        f = c.args[0]
        out.update((f, r) for r in range(fields[f]["rows"]))
    if c.name == "Sum":
        f = fields[c.kwargs["field"]]
        out.add((f["name"], "exists"))
        out.update((f["name"], f"bit{i}")
                   for i in range(bit_depth(f["max"])))
        if f.get("min", 0) < 0:
            out.add((f["name"], "sign"))
    for a in c.args:
        _rows(a, cfg, out)


def rows_read(pql: str, cfg: dict) -> int:
    out: set = set()
    for c in parse(pql):
        _rows(c, cfg, out)
    return len(out)


def least_seconds(pql: str, cfg: dict, pk: dict) -> float:
    words = rows_read(pql, cfg) * -(-cfg["facts"] // 32)
    return max(4 * words / pk["bytes_per_s"], words / pk["ops_per_s"])
