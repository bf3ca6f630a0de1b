"""Synthetic datasets mirroring the paper's experimental schemas.

- ``chain``       Appendix D.3: R1(A1,A2)…Rr(Ar,Ar+1), fanout f, domain d.
- ``salesforce``  Fig 12-style star/snowflake: Opp fact + User→Role chain,
                  Camp, Acc dimensions (Sigma Computing dashboard, §5.1.1).
- ``flight``      §5.1.2 IDEBench-style: Flights fact + Carrier/Airport/Date.
- ``favorita``    §5.1.3 factorized-ML: Sales fact + Stores/Items/Trans/Dates
                  plus synthetic augmentation relations of varying correlation.
- ``tpch``        §5.2.1: mini customer/orders/lineitem/nation/region.
- ``tpcds_star``  §5.2.2 empty-bag experiment: Store_Sales + Time/Stores/Item.

Default row counts are small; the join-graph shapes and relative size
imbalances (large fact, small dims) match the paper.  Every generator emits
the same arrays as its counterpart in the JAX package for the same arguments.
"""

from __future__ import annotations

import numpy as np

from .relation import Catalog, Relation


def _rel(name, attrs, codes, domains, measures=None, weights=None):
    return Relation(
        name=name,
        attrs=tuple(attrs),
        codes={a: np.asarray(c, np.int32) for a, c in codes.items()},
        domains=dict(domains),
        measures={k: np.asarray(v, np.float32) for k, v in (measures or {}).items()},
        weights=weights,
    )


# ---------------------------------------------------------------------------
# Appendix D.3 chain schema
# ---------------------------------------------------------------------------

def chain(r: int, fanout: int, domain: int, seed: int = 0) -> Catalog:
    """R_i(A_i, A_{i+1}) with fanout f in both directions, domain d."""
    rels = []
    for i in range(r):
        a, b = f"A{i}", f"A{i + 1}"
        left = np.repeat(np.arange(domain), fanout)
        right = (left * fanout + np.tile(np.arange(fanout), domain)) % domain
        rels.append(
            _rel(f"R{i}", (a, b), {a: left, b: right}, {a: domain, b: domain})
        )
    return Catalog(rels)


# ---------------------------------------------------------------------------
# Salesforce-style dashboard schema (Fig 1 / Fig 12)
# ---------------------------------------------------------------------------

def salesforce(
    n_opp: int = 200_000,
    n_user: int = 2_000,
    n_camp: int = 500,
    n_acc: int = 1_000,
    n_role: int = 16,
    seed: int = 0,
) -> Catalog:
    rng = np.random.default_rng(seed)
    d = {
        "user_id": n_user, "camp_id": n_camp, "acc_id": n_acc, "role_id": n_role,
        "title": 12, "camp_type": 8, "start_q": 16, "state": 50, "stage": 6,
        "role_name": n_role,
    }
    opp = _rel(
        "Opp",
        ("user_id", "camp_id", "acc_id", "stage"),
        {
            "user_id": rng.integers(0, n_user, n_opp),
            "camp_id": rng.integers(0, n_camp, n_opp),
            "acc_id": rng.integers(0, n_acc, n_opp),
            "stage": rng.integers(0, d["stage"], n_opp),
        },
        d,
        measures={"amount": rng.gamma(2.0, 5_000.0, n_opp)},
    )
    user = _rel(
        "User",
        ("user_id", "role_id", "title"),
        {
            "user_id": np.arange(n_user),
            "role_id": rng.integers(0, n_role, n_user),
            "title": rng.integers(0, d["title"], n_user),
        },
        d,
    )
    role = _rel(
        "Role",
        ("role_id", "role_name"),
        {"role_id": np.arange(n_role), "role_name": np.arange(n_role)},
        d,
    )
    camp = _rel(
        "Camp",
        ("camp_id", "camp_type", "start_q"),
        {
            "camp_id": np.arange(n_camp),
            "camp_type": rng.integers(0, d["camp_type"], n_camp),
            "start_q": rng.integers(0, d["start_q"], n_camp),
        },
        d,
        measures={"budget": rng.gamma(2.0, 1_000.0, n_camp)},
    )
    acc = _rel(
        "Acc",
        ("acc_id", "state"),
        {"acc_id": np.arange(n_acc), "state": rng.integers(0, d["state"], n_acc)},
        d,
    )
    return Catalog([opp, user, role, camp, acc])


# ---------------------------------------------------------------------------
# Flight / IDEBench-style schema (§5.1.2)
# ---------------------------------------------------------------------------

def flight(
    n_flights: int = 300_000,
    n_airports: int = 400,
    n_carriers: int = 30,
    n_dates: int = 365,
    seed: int = 1,
) -> Catalog:
    rng = np.random.default_rng(seed)
    d = {
        "carrier_id": n_carriers, "airport_id": n_airports, "date_id": n_dates,
        "carrier_group": 6, "airport_state": 52, "airport_size": 4,
        "month": 12, "dow": 7, "delay_bucket": 10, "distance_bucket": 8,
    }
    flights = _rel(
        "Flights",
        ("carrier_id", "airport_id", "date_id", "delay_bucket", "distance_bucket"),
        {
            "carrier_id": rng.integers(0, n_carriers, n_flights),
            "airport_id": rng.integers(0, n_airports, n_flights),
            "date_id": rng.integers(0, n_dates, n_flights),
            "delay_bucket": rng.integers(0, d["delay_bucket"], n_flights),
            "distance_bucket": rng.integers(0, d["distance_bucket"], n_flights),
        },
        d,
        measures={"dep_delay": rng.gamma(1.5, 10.0, n_flights)},
    )
    carrier = _rel(
        "Carrier",
        ("carrier_id", "carrier_group"),
        {"carrier_id": np.arange(n_carriers),
         "carrier_group": rng.integers(0, d["carrier_group"], n_carriers)},
        d,
    )
    airport = _rel(
        "Airport",
        ("airport_id", "airport_state", "airport_size"),
        {"airport_id": np.arange(n_airports),
         "airport_state": rng.integers(0, d["airport_state"], n_airports),
         "airport_size": rng.integers(0, d["airport_size"], n_airports)},
        d,
    )
    dates = _rel(
        "Dates",
        ("date_id", "month", "dow"),
        {"date_id": np.arange(n_dates),
         "month": (np.arange(n_dates) // 31) % 12,
         "dow": np.arange(n_dates) % 7},
        d,
    )
    return Catalog([flights, carrier, airport, dates])


# ---------------------------------------------------------------------------
# Favorita-style ML-augmentation schema (§5.1.3, Fig 17)
# ---------------------------------------------------------------------------

def favorita(
    n_sales: int = 100_000,
    n_stores: int = 54,
    n_items: int = 400,
    n_dates: int = 120,
    seed: int = 2,
) -> Catalog:
    rng = np.random.default_rng(seed)
    d = {
        "store": n_stores, "item": n_items, "date": n_dates,
        "store_type": 5, "cluster": 17, "family": 12, "perishable": 2,
        "dow": 7, "month": 12,
    }
    sales = _rel(
        "Sales",
        ("store", "item", "date"),
        {
            "store": rng.integers(0, n_stores, n_sales),
            "item": rng.integers(0, n_items, n_sales),
            "date": rng.integers(0, n_dates, n_sales),
        },
        d,
        measures={"unit_sales": rng.gamma(2.0, 4.0, n_sales)},
    )
    stores = _rel(
        "Stores",
        ("store", "store_type", "cluster"),
        {"store": np.arange(n_stores),
         "store_type": rng.integers(0, d["store_type"], n_stores),
         "cluster": rng.integers(0, d["cluster"], n_stores)},
        d,
    )
    items = _rel(
        "Items",
        ("item", "family", "perishable"),
        {"item": np.arange(n_items),
         "family": rng.integers(0, d["family"], n_items),
         "perishable": rng.integers(0, 2, n_items)},
        d,
        measures={"item_weight": rng.gamma(2.0, 1.0, n_items)},
    )
    # transactions per (store, date) — the regression target's source
    st, dt = np.meshgrid(np.arange(n_stores), np.arange(n_dates), indexing="ij")
    base = rng.gamma(5.0, 300.0, n_stores)[st.ravel()]
    season = 1.0 + 0.3 * np.sin(2 * np.pi * dt.ravel() / 7.0)
    trans = _rel(
        "Trans",
        ("store", "date"),
        {"store": st.ravel(), "date": dt.ravel()},
        d,
        measures={"transactions": (base * season).astype(np.float32)},
    )
    dates = _rel(
        "Dates",
        ("date", "dow", "month"),
        {"date": np.arange(n_dates),
         "dow": np.arange(n_dates) % 7,
         "month": (np.arange(n_dates) // 31) % 12},
        d,
    )
    return Catalog([sales, stores, items, trans, dates])


def favorita_augmentations(
    cat: Catalog, n_per_key: int = 10, seed: int = 3
) -> list[Relation]:
    """Synthetic (k, v) augmentation relations with correlation φ to Ŷ (§5.1.3).

    φ ~ min(1, 1/Exp(10)); v = φ·Ŷ_norm + (1-φ)·noise.
    """
    rng = np.random.default_rng(seed)
    trans = cat.get("Trans")
    out: list[Relation] = []
    for key in ("store", "date", "item"):
        dom = cat.domains()[key]
        # Ŷ: mean target grouped by key (items get a synthetic proxy)
        if key in trans.attrs:
            y = np.zeros(dom)
            cnt = np.zeros(dom)
            np.add.at(y, trans.codes[key], trans.measures["transactions"])
            np.add.at(cnt, trans.codes[key], 1.0)
            yhat = y / np.maximum(cnt, 1.0)
        else:
            yhat = rng.gamma(5.0, 300.0, dom)
        yhat = (yhat - yhat.mean()) / (yhat.std() + 1e-6)
        for j in range(n_per_key):
            phi = min(1.0, 1.0 / rng.exponential(10.0))
            noise = rng.standard_normal(dom)
            v = phi * yhat + (1.0 - phi) * noise
            out.append(
                _rel(
                    f"Aug_{key}_{j}",
                    (key,),
                    {key: np.arange(dom)},
                    dict(cat.domains()),
                    measures={"v": v.astype(np.float32), "phi": np.full(dom, phi, np.float32)},
                )
            )
    return out


# ---------------------------------------------------------------------------
# TPC-H-style mini schema (§5.2.1)
# ---------------------------------------------------------------------------

def tpch(
    n_lineitem: int = 300_000,
    n_orders: int = 60_000,
    n_cust: int = 6_000,
    n_supp: int = 400,
    seed: int = 4,
) -> Catalog:
    rng = np.random.default_rng(seed)
    n_nation, n_region = 25, 5
    d = {
        "orderkey": n_orders, "custkey": n_cust, "suppkey": n_supp,
        "nationkey": n_nation, "regionkey": n_region, "s_nationkey": n_nation,
        "mktsegment": 5, "orderdate_b": 24, "shippriority": 2,
        "shipdate_b": 24, "returnflag": 3, "ptype": 10,
    }
    lineitem = _rel(
        "Lineitem",
        ("orderkey", "suppkey", "shipdate_b", "returnflag", "ptype"),
        {
            "orderkey": rng.integers(0, n_orders, n_lineitem),
            "suppkey": rng.integers(0, n_supp, n_lineitem),
            "shipdate_b": rng.integers(0, 24, n_lineitem),
            "returnflag": rng.integers(0, 3, n_lineitem),
            "ptype": rng.integers(0, 10, n_lineitem),
        },
        d,
        measures={"revenue": rng.gamma(2.0, 1_000.0, n_lineitem)},
    )
    orders = _rel(
        "Orders",
        ("orderkey", "custkey", "orderdate_b", "shippriority"),
        {
            "orderkey": np.arange(n_orders),
            "custkey": rng.integers(0, n_cust, n_orders),
            "orderdate_b": rng.integers(0, 24, n_orders),
            "shippriority": rng.integers(0, 2, n_orders),
        },
        d,
    )
    customer = _rel(
        "Customer",
        ("custkey", "mktsegment", "nationkey"),
        {
            "custkey": np.arange(n_cust),
            "mktsegment": rng.integers(0, 5, n_cust),
            "nationkey": rng.integers(0, n_nation, n_cust),
        },
        d,
    )
    # Customer and Supplier both referencing the SAME nation attribute would
    # make the join graph cyclic (the paper breaks exactly this Q5 cycle by
    # conditioning on the group-by attribute).  The default catalog keeps the
    # acyclic form: supplier nations are a separate attribute; Nation hangs
    # off Customer.
    supplier = _rel(
        "Supplier",
        ("suppkey", "s_nationkey"),
        {"suppkey": np.arange(n_supp), "s_nationkey": rng.integers(0, n_nation, n_supp)},
        d,
    )
    nation = _rel(
        "Nation",
        ("nationkey", "regionkey"),
        {"nationkey": np.arange(n_nation), "regionkey": np.arange(n_nation) % n_region},
        d,
    )
    return Catalog([lineitem, orders, customer, supplier, nation])


# ---------------------------------------------------------------------------
# TPC-DS-style star for the empty-bag experiment (§5.2.2, Fig 5)
# ---------------------------------------------------------------------------

def tpcds_star(
    n_sales: int = 400_000,
    n_stores: int = 60,
    n_times: int = 512,
    n_items: int = 2_000,
    seed: int = 5,
) -> Catalog:
    rng = np.random.default_rng(seed)
    d = {
        "store_key": n_stores, "time_key": n_times, "item_key": n_items,
        "store_size": 4, "hour": 24, "item_cat": 20,
    }
    sales = _rel(
        "Store_Sales",
        ("store_key", "time_key", "item_key"),
        {
            "store_key": rng.integers(0, n_stores, n_sales),
            "time_key": rng.integers(0, n_times, n_sales),
            "item_key": rng.integers(0, n_items, n_sales),
        },
        d,
        measures={"sales_price": rng.gamma(2.0, 20.0, n_sales)},
    )
    stores = _rel(
        "Stores",
        ("store_key", "store_size"),
        {"store_key": np.arange(n_stores),
         "store_size": rng.integers(0, 4, n_stores)},
        d,
    )
    times = _rel(
        "Time",
        ("time_key", "hour"),
        {"time_key": np.arange(n_times), "hour": np.arange(n_times) % 24},
        d,
    )
    items = _rel(
        "Item",
        ("item_key", "item_cat"),
        {"item_key": np.arange(n_items),
         "item_cat": rng.integers(0, 20, n_items)},
        d,
    )
    return Catalog([sales, stores, times, items])
