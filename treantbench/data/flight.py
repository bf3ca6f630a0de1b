"""Frozen generator of the flights deployment: one year of the BTS
On-Time Performance table, normalized into a star.

The fact ``Flights`` holds, per flight, the reporting carrier, the origin
and destination airports, the flight date, BTS's departure delay group
(``DepartureDelayGroups``: 15 groups of 15 minutes from "< -15" to
">= 180") and distance group (``DistanceGroup``: 11 groups of 250 miles),
and the measure ``dep_delay_minutes`` (BTS ``DepDelayMinutes``: the
departure delay with early departures set to 0).  ``Origin`` and ``Dest``
carry each airport's state and hub class, ``Dates`` each day's month and
weekday (BTS ``DayOfWeek``, Monday first) in the year the config names.

What the table's columns do not state is drawn under the config's
``assumed`` entries: carriers and airports Zipf (one popularity order for
origins and destinations, never both the same airport), dates uniformly,
the signed departure delay from a mixture of early and late departures,
the distance from a gamma law, each airport's state uniformly and its hub
class by its popularity rank.
"""

from __future__ import annotations

import datetime

import numpy as np

from .tables import Table, Tables, zipf_p


def generate(config: dict, seed: int) -> Tables:
    n = config["rows"]["Flights"]
    w = config["widths"]
    a = config["assumed_parameters"]
    rng = np.random.default_rng([seed, 1])
    n_air = w["origin_id"]

    carrier = rng.permutation(w["carrier_id"]).astype(np.int32)[
        rng.choice(w["carrier_id"], n, p=zipf_p(w["carrier_id"], a["carrier_zipf"]))]
    popularity = rng.permutation(n_air).astype(np.int32)   # rank -> airport
    p = zipf_p(n_air, a["airport_zipf"])
    r_origin = rng.choice(n_air, n, p=p)
    r_dest = rng.choice(n_air, n, p=p)
    r_dest = np.where(r_dest == r_origin, (r_dest + 1) % n_air, r_dest)
    date = rng.integers(0, w["date_id"], n, dtype=np.int32)

    early = rng.random(n) < a["early_share"]
    delay = np.where(early, -rng.gamma(*a["early_gamma"], n), rng.gamma(*a["late_gamma"], n))
    delay_group = np.clip(np.floor(delay / 15.0), -2, w["dep_delay_group"] - 3) + 2
    miles = a["distance_min_miles"] + rng.gamma(*a["distance_gamma"], n)
    distance_group = np.minimum(miles // 250, w["distance_group"] - 1)

    flights = Table(
        "Flights",
        ("carrier_id", "origin_id", "dest_id", "date_id", "dep_delay_group", "distance_group"),
        {"carrier_id": carrier, "origin_id": popularity[r_origin],
         "dest_id": popularity[r_dest], "date_id": date,
         "dep_delay_group": delay_group.astype(np.int32),
         "distance_group": distance_group.astype(np.int32)},
        {"dep_delay_minutes": np.maximum(delay, 0.0).astype(np.float32)})

    # per airport: a state drawn uniformly, a hub class by popularity rank
    # (3 large, 2 medium, 1 small, 0 non-hub)
    state = rng.integers(0, w["origin_state"], n_air, dtype=np.int32)
    rank = np.empty(n_air, np.int64)
    rank[popularity] = np.arange(n_air)
    hubs = np.cumsum(a["hubs_large_medium_small"])
    size = (3 - np.searchsorted(hubs, rank, side="right")).clip(0).astype(np.int32)
    airports = np.arange(n_air, dtype=np.int32)
    origin = Table("Origin", ("origin_id", "origin_state", "origin_size"),
                   {"origin_id": airports, "origin_state": state, "origin_size": size})
    dest = Table("Dest", ("dest_id", "dest_state", "dest_size"),
                 {"dest_id": airports.copy(), "dest_state": state.copy(),
                  "dest_size": size.copy()})

    first = datetime.date(a["year"], 1, 1)
    days = [first + datetime.timedelta(days=int(d)) for d in range(w["date_id"])]
    dates = Table("Dates", ("date_id", "month", "dow"), {
        "date_id": np.arange(w["date_id"], dtype=np.int32),
        "month": np.array([d.month - 1 for d in days], np.int32),
        "dow": np.array([d.weekday() for d in days], np.int32),
    })
    return Tables(
        tables={t.name: t for t in (flights, origin, dest, dates)},
        domains=dict(w), fact="Flights",
        joins={"Origin": ("origin_id", "Flights"), "Dest": ("dest_id", "Flights"),
               "Dates": ("date_id", "Flights")},
    )
