"""The catalogs that ``metrics-docs``, ``event-names`` and
``alert-names`` hold the port's call sites to.

``docs/observability.md`` is the operator's catalog of the system; the
port's supplement ``pilosa_tpu_torch/analysis/catalog.md`` lists what
only the port has (series of the ragged packed stacks, the launch
counters).  Both carry the same ``<!-- <name>-catalog:begin -->`` /
``<!-- <name>-catalog:end -->`` markers.  A call site must match a row
of either file, and every row of either file must match a port call
site: the port emits every series, event and alert the system
documents.
"""

from __future__ import annotations

import re

from ..astlint import Finding

CATALOG_FILES = ("docs/observability.md",
                 "pilosa_tpu_torch/analysis/catalog.md")
NAMED = " or ".join(CATALOG_FILES)


def sections(root, rule_id: str, name: str):
    """(sections, problems): ``sections`` holds (rel, marker line, body)
    per catalog file; ``problems`` a Finding per missing file or marker
    pair — the caller stops when there is any."""
    marker = re.compile(rf"<!-- {name}-catalog:begin -->(.*?)"
                        rf"<!-- {name}-catalog:end -->", re.S)
    out, problems = [], []
    for rel in CATALOG_FILES:
        path = root / rel
        if not path.is_file():
            problems.append(Finding(rule_id, rel, 1, f"{rel} is missing"))
            continue
        text = path.read_text()
        m = marker.search(text)
        if m is None:
            problems.append(Finding(rule_id, rel, 1,
                                    f"missing the {name}-catalog markers"))
            continue
        out.append((rel, text.count("\n", 0, m.start()) + 1, m.group(1)))
    return out, problems


def rows(body: str):
    """(name, rest of the line) of every ``| `name` ... |`` table row."""
    for row in re.finditer(r"^\| `([^`]+)`(.*)$", body, re.M):
        yield row.group(1), row.group(2)
