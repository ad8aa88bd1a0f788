"""NYC taxi rides (Litwintschik's 1.1 billion rides): cab type, passenger
count, pickup year, trip distance in rounded miles and the total amount
in cents, with the skews the config's ``assumed`` lists: categorical
draws for the set fields, a geometric distance with mean 3 miles (50
and over in row 50) and a lognormal amount tied to the distance."""

from __future__ import annotations

import torch

from portbench.blocks import Block, categorical, generator, spans


def blocks(cfg: dict, seed: int, device, facts: int | None = None):
    facts = cfg["facts"] if facts is None else facts
    d = cfg["draws"]
    amount_max = next(f["max"] for f in cfg["fields"]
                      if f["name"] == "total_amount")
    for s0, k, n in spans(facts, cfg["block_shards"]):
        g = generator(seed, s0, device)
        cols = {name: categorical(d[name], n, g, device)
                for name in ("cab_type", "passenger_count", "pickup_year")}
        u = 1.0 - torch.rand(n, generator=g, device=device)   # (0, 1]
        miles = torch.floor(torch.log(u) / torch.log(
            torch.tensor(1.0 - d["dist_p"], device=device)))
        cols["dist_miles"] = miles.clamp_(max=50).to(torch.int64)
        frac = torch.rand(n, generator=g, device=device)
        z = torch.randn(n, generator=g, device=device)
        cents = (d["fare_base"] + d["fare_per_mile"] * (miles + frac)) \
            * torch.exp(d["amount_sigma"] * z)
        cols["total_amount"] = torch.round(cents).clamp_(0, amount_max) \
            .to(torch.int64)
        yield Block(s0, k, n, torch.device(device), cols)
