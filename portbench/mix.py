"""Traffic mixes: ``traffic/<mix>.json`` read into request decks.

A mix file holds its ``clients``, a ``deck`` of query templates and
``shuffle``, and nothing else: every mix runs as a closed loop, and a
file with any other key (an open loop, say) is refused until the harness
can run it.  A template's ``{field}`` slots take row ids of the
configuration's set fields: with ``"draw": "uniform"`` each of its
``copies`` cards draws them uniformly from the seed, with ``"draw":
"each"`` the template is expanded over every combination of rows,
``copies`` times.  With ``"shuffle": true`` the deck is shuffled from
the seed.  Every client cycles through the whole deck from an offset of
its own drawn from the seed, so every seed sends the same mix of shapes,
in another order and with other rows.
"""

from __future__ import annotations

import itertools
import json
import string
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


KEYS = {"clients", "deck", "shuffle"}
TEMPLATE_KEYS = {"name", "pql", "draw", "copies"}


def load(name: str) -> dict:
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    if set(mix) - KEYS:
        raise ValueError(f"traffic {name}: keys {sorted(set(mix) - KEYS)} "
                         f"are not read by this harness")
    return mix


def _slots(pql: str) -> list[str]:
    return [f for _, f, _, _ in string.Formatter().parse(pql) if f]


def deck(mix: dict, cfg: dict, seed: int) -> list[tuple[str, str]]:
    """``[(template name, pql)]`` of the mix over ``cfg``."""
    rows = {f["name"]: f["rows"] for f in cfg["fields"]
            if f["type"] == "set"}
    rng = np.random.default_rng([seed, 0x6D6978])
    cards = []
    for t in mix["deck"]:
        draw = t.get("draw", "uniform")
        if set(t) - TEMPLATE_KEYS or draw not in ("uniform", "each"):
            raise ValueError(f"template {t.get('name')!r}: only "
                             f"{sorted(TEMPLATE_KEYS)} are read, and "
                             f"draw is uniform or each")
        slots = _slots(t["pql"])
        for _ in range(t.get("copies", 1)):
            if draw == "each":
                for combo in itertools.product(
                        *(range(rows[s]) for s in slots)):
                    cards.append((t["name"], t["pql"].format(
                        **dict(zip(slots, combo)))))
            else:
                cards.append((t["name"], t["pql"].format(
                    **{s: int(rng.integers(rows[s])) for s in slots})))
    if mix.get("shuffle"):
        order = rng.permutation(len(cards))
        cards = [cards[i] for i in order]
    return cards


def offsets(mix: dict, n_cards: int, seed: int) -> list[int]:
    rng = np.random.default_rng([seed, 0x6F6666])
    return [int(x) for x in rng.integers(0, n_cards, size=mix["clients"])]
