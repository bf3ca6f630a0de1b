"""Frozen generator of the TPC-H deployment: the order-to-cash snowflake
of the TPC-H Standard Specification (rev. 3.0.1) at the configuration's
scale, with dbgen's value rules (§4.2.3) drawn vectorised in numpy.

Relations and join keys (each key a dense 0-based code, the spec's key
minus one; ``O_ORDERKEY``'s sparse numbering is not kept):

- ``Lineitem`` (the fact): ``orderkey`` → ``Orders``, ``partkey`` →
  ``Part``, ``suppkey`` → ``Supplier``; ship month, ship mode, return flag
  and line status; the measure ``revenue`` = ``L_EXTENDEDPRICE`` ×
  (1 − ``L_DISCOUNT``) in float32;
- ``Orders``: ``custkey`` → ``Customer``, order month, priority, status;
- ``Customer``: ``c_nationkey`` → ``CNation``, market segment;
- ``Supplier``: ``s_nationkey`` → ``SNation``;
- ``Part``: manufacturer, brand, type, container, size;
- ``CNation`` and ``SNation``: NATION twice (customer side and supplier
  side, as Q7 joins it), each with its region's key: REGION holds only its
  name, so it is folded into each copy.

dbgen's rules kept: 1 to 7 lines an order; ``O_CUSTKEY`` only on keys not
divisible by 3; ``L_SUPPKEY`` one of the 4 suppliers of ``PARTSUPP``'s
formula; ``P_RETAILPRICE``'s formula; ship date = order date + 1..121
days, receipt date = ship date + 1..30; ``L_LINESTATUS`` O when shipped
after CURRENTDATE (1995-06-17), else F; ``L_RETURNFLAG`` R or A when
received by CURRENTDATE, else N; ``O_ORDERSTATUS`` F or O when all its
lines are, else P.  What dbgen leaves open is under the configuration's
``assumed``: the last orders' line counts are moved so that ``Lineitem``
holds exactly its configured rows.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .tables import Table, Tables

# §4.2.3: N_REGIONKEY of nations 0-24 (ALGERIA ... UNITED STATES)
NATION_REGION = (0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3, 4, 2, 3, 3, 1)
START = np.datetime64("1992-01-01")
CURRENT = np.datetime64("1995-06-17")
ORDER_DAYS = int((np.datetime64("1998-12-31") - 151 - START).astype(int)) + 1  # to 1998-08-02
CHUNK_ORDERS = 1 << 20   # orders whose lines one stream draws


def month_of(days: np.ndarray) -> np.ndarray:
    """Months since January 1992 of day numbers since 1 January 1992."""
    calendar = START + np.arange(int(days.max()) + 1).astype("timedelta64[D]")
    month = (calendar.astype("datetime64[M]") - START.astype("datetime64[M]")).astype(np.int32)
    return month[days]


def line_counts(rng, orders: int, lines: int, most: int = 7) -> np.ndarray:
    """1..``most`` lines per order, uniform, then the last orders' counts
    moved one line at a time (down to 1, up to ``most``) until they sum to
    ``lines``."""
    counts = rng.integers(1, most + 1, orders).astype(np.int64)
    if not orders <= lines <= most * orders:
        raise ValueError(f"{lines} lines do not fit {orders} orders of 1-{most} lines")
    diff = int(counts.sum()) - lines
    room = (counts - 1) if diff > 0 else (most - counts)
    # take from the last orders first: whole orders' room, then the rest
    from_end = np.cumsum(room[::-1])
    k = int(np.searchsorted(from_end, abs(diff)))   # orders touched, minus one
    step = np.zeros(orders, np.int64)
    step[orders - k:] = room[orders - k:]
    step[orders - k - 1] = abs(diff) - (int(from_end[k - 1]) if k else 0)
    counts -= np.sign(diff) * step
    return counts


def generate(config: dict, seed: int) -> Tables:
    rows = config["rows"]
    w = dict(config["widths"])
    n_l, n_o, n_c = rows["Lineitem"], rows["Orders"], rows["Customer"]
    n_p, n_s = rows["Part"], rows["Supplier"]
    rng = np.random.default_rng([seed, 1])
    i32 = np.int32

    # PART
    partkey = np.arange(n_p, dtype=np.int64) + 1
    mfgr = rng.integers(0, w["p_mfgr"], n_p, dtype=i32)
    part = Table("Part", ("partkey", "p_mfgr", "p_brand", "p_type", "p_container", "p_size"), {
        "partkey": np.arange(n_p, dtype=i32), "p_mfgr": mfgr,
        "p_brand": mfgr * 5 + rng.integers(0, 5, n_p, dtype=i32),
        "p_type": rng.integers(0, w["p_type"], n_p, dtype=i32),
        "p_container": rng.integers(0, w["p_container"], n_p, dtype=i32),
        "p_size": rng.integers(0, w["p_size"], n_p, dtype=i32)})
    retail = (90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)) / 100.0

    # SUPPLIER, CUSTOMER, the two NATION copies
    supplier = Table("Supplier", ("suppkey", "s_nationkey"), {
        "suppkey": np.arange(n_s, dtype=i32),
        "s_nationkey": rng.integers(0, w["s_nationkey"], n_s, dtype=i32)})
    customer = Table("Customer", ("custkey", "c_nationkey", "c_mktsegment"), {
        "custkey": np.arange(n_c, dtype=i32),
        "c_nationkey": rng.integers(0, w["c_nationkey"], n_c, dtype=i32),
        "c_mktsegment": rng.integers(0, w["c_mktsegment"], n_c, dtype=i32)})
    nations = np.arange(len(NATION_REGION), dtype=i32)
    region = np.asarray(NATION_REGION, i32)
    cnation = Table("CNation", ("c_nationkey", "c_regionkey"),
                    {"c_nationkey": nations, "c_regionkey": region})
    snation = Table("SNation", ("s_nationkey", "s_regionkey"),
                    {"s_nationkey": nations.copy(), "s_regionkey": region.copy()})

    # ORDERS: custkey from the keys (1-based) not divisible by 3
    k = rng.integers(0, n_c - n_c // 3, n_o)
    custkey = ((k // 2) * 3 + k % 2).astype(i32)
    order_day = rng.integers(0, ORDER_DAYS, n_o, dtype=np.int16)
    priority = rng.integers(0, w["o_orderpriority"], n_o, dtype=i32)
    counts = line_counts(rng, n_o, n_l)
    ends = np.cumsum(counts)

    # LINEITEM, in order of orderkey as dbgen writes it, drawn in blocks of
    # CHUNK_ORDERS orders, each from its own stream, on several threads
    four = ((partkey[:, None] + np.arange(4) * (n_s // 4 + (partkey[:, None] - 1) // n_s))
            % n_s).astype(i32).reshape(-1)     # each part's 4 suppliers (PARTSUPP's formula)
    pairs = np.arange(50 * 11)                 # quantity 1-50 × discount 0.00-0.10
    per_unit = (pairs // 11 + 1) * (1.0 - pairs % 11 / 100.0)
    current = int((CURRENT - START).astype(int))
    cols = {a: np.empty(n_l, i32) for a in ("orderkey", "partkey", "suppkey", "l_shipmonth",
                                           "l_shipmode", "l_returnflag", "l_linestatus")}
    revenue = np.empty(n_l, np.float32)
    orderstatus = np.empty(n_o, i32)
    ship_month = month_of(np.arange(ORDER_DAYS + 121))

    def block(b: int) -> None:
        o0, o1 = b * CHUNK_ORDERS, min((b + 1) * CHUNK_ORDERS, n_o)
        l0, l1 = (int(ends[o0 - 1]) if o0 else 0), int(ends[o1 - 1])
        r = np.random.default_rng([seed, 2, b])
        n, c = l1 - l0, counts[o0:o1]
        part = r.integers(0, n_p, n, dtype=i32)
        cols["orderkey"][l0:l1] = np.repeat(np.arange(o0, o1, dtype=i32), c)
        cols["partkey"][l0:l1] = part
        cols["suppkey"][l0:l1] = four[part.astype(np.int64) * 4 + r.integers(0, 4, n,
                                                                          dtype=np.int8)]
        revenue[l0:l1] = retail[part] * per_unit[r.integers(0, pairs.size, n, dtype=np.int16)]
        ship = np.repeat(order_day[o0:o1], c) + r.integers(1, 122, n, dtype=np.int16)
        status = (ship > current).astype(i32)                              # F 0, O 1
        received = ship + r.integers(1, 31, n, dtype=np.int16) <= current
        returned = r.integers(0, 2, n, dtype=i32) * 2                      # A 0, R 2
        cols["l_returnflag"][l0:l1] = np.where(received, returned, 1)      # N 1
        cols["l_linestatus"][l0:l1] = status
        cols["l_shipmonth"][l0:l1] = ship_month[ship]
        cols["l_shipmode"][l0:l1] = r.integers(0, w["l_shipmode"], n, dtype=i32)
        first = np.concatenate(([0], np.cumsum(c)[:-1]))
        all_o = np.minimum.reduceat(status, first) == 1
        all_f = np.maximum.reduceat(status, first) == 0
        orderstatus[o0:o1] = np.where(all_f, 0, np.where(all_o, 1, 2))    # F 0, O 1, P 2

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(block, range(-(-n_o // CHUNK_ORDERS))))

    lineitem = Table("Lineitem", tuple(cols), cols, {"revenue": revenue})
    orders = Table(
        "Orders", ("orderkey", "custkey", "o_ordermonth", "o_orderpriority", "o_orderstatus"),
        {"orderkey": np.arange(n_o, dtype=i32), "custkey": custkey,
         "o_ordermonth": month_of(order_day), "o_orderpriority": priority,
         "o_orderstatus": orderstatus})
    w.update(orderkey=n_o, custkey=n_c, partkey=n_p, suppkey=n_s)
    return Tables(
        tables={t.name: t for t in (lineitem, orders, customer, cnation, supplier, snation,
                                    part)},
        domains=w, fact="Lineitem",
        joins={"Orders": ("orderkey", "Lineitem"), "Part": ("partkey", "Lineitem"),
               "Supplier": ("suppkey", "Lineitem"), "Customer": ("custkey", "Orders"),
               "CNation": ("c_nationkey", "Customer"), "SNation": ("s_nationkey", "Supplier")},
    )
