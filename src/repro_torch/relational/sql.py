"""Restricted SQL front-end → SPJA Query IR (the middleware face of Treant).

Grammar (the paper's §3.3 parameterized SPJA form; case-insensitive):

    SELECT [attr, ...,] AGG(measure|*) FROM rel [, rel ...]
    [WHERE attr IN (v, ...) [AND attr BETWEEN lo AND hi] ...]
    [GROUP BY attr, ...]

AGG ∈ {COUNT, SUM, MIN, MAX, AVG}.  Join conditions are implicit (natural
joins over the catalog's join graph, as in the paper's system).  Relations
not mentioned in FROM are treated as R̄-removed when ``strict_from=True``.
"""

from __future__ import annotations

import re

from repro_torch.core.query import Query
from .relation import Catalog, mask_in, mask_range

_AGG_RINGS = {
    "COUNT": "count", "SUM": "sum", "MIN": "tropical_min",
    "MAX": "tropical_max", "AVG": "moments",
}

_SELECT_RE = re.compile(
    r"^\s*SELECT\s+(?P<sel>.*?)\s+FROM\s+(?P<from>[\w\s,]+?)"
    r"(?:\s+WHERE\s+(?P<where>.*?))?"
    r"(?:\s+GROUP\s+BY\s+(?P<group>[\w\s,]+?))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)
_AGG_RE = re.compile(r"(COUNT|SUM|MIN|MAX|AVG)\s*\(\s*(\*|[\w.]+)\s*\)", re.IGNORECASE)
_IN_RE = re.compile(r"([\w]+)\s+IN\s*\(([^)]*)\)", re.IGNORECASE)
_BETWEEN_RE = re.compile(r"([\w]+)\s+BETWEEN\s+(\d+)\s+AND\s+(\d+)", re.IGNORECASE)
_EQ_RE = re.compile(r"([\w]+)\s*=\s*(\d+)")


class SqlError(ValueError):
    pass


def parse(sql: str, catalog: Catalog, strict_from: bool = False) -> Query:
    m = _SELECT_RE.match(sql)
    if not m:
        raise SqlError(f"unsupported SQL shape: {sql!r}")
    sel, frm = m.group("sel"), m.group("from")
    agg = _AGG_RE.search(sel)
    if not agg:
        raise SqlError("SELECT must contain one aggregate (semi-ring SPJA only)")
    fn, arg = agg.group(1).upper(), agg.group(2)
    ring = _AGG_RINGS[fn]
    measure = None
    if arg != "*":
        if "." in arg:
            rel, col = arg.split(".")
        else:
            rel, col = _find_measure(catalog, arg)
        measure = (rel, col)
    elif fn != "COUNT":
        raise SqlError(f"{fn}(*) is not meaningful")

    group_by: tuple[str, ...] = ()
    if m.group("group"):
        group_by = tuple(a.strip() for a in m.group("group").split(",") if a.strip())

    preds = parse_predicates(m.group("where") or "", catalog)

    removed: list[str] = []
    if strict_from:
        mentioned = {r.strip() for r in frm.split(",")}
        removed = [n for n in catalog.names() if n not in mentioned]

    return Query.make(
        catalog, ring=ring, measure=measure, group_by=group_by,
        predicates=preds, removed=removed,
    )


def parse_predicates(where: str, catalog: Catalog) -> list:
    """Parse a WHERE fragment into σ Predicates (IN / BETWEEN / =).

    Shared by ``parse`` and the dashboard session layer
    (``Session.sql``), so SQL-expressed filters and typed ``SetFilter``
    events produce digest-identical predicates.
    """
    preds = []
    consumed = ""
    doms = catalog.domains()
    for pm in _IN_RE.finditer(where):
        attr = pm.group(1)
        vals = [int(v) for v in pm.group(2).split(",") if v.strip()]
        preds.append(mask_in(doms[attr], vals, attr=attr))
        consumed += pm.group(0)
    for pm in _BETWEEN_RE.finditer(where):
        attr = pm.group(1)
        preds.append(mask_range(doms[attr], int(pm.group(2)), int(pm.group(3)) + 1, attr=attr))
        consumed += pm.group(0)
    for pm in _EQ_RE.finditer(where):
        if pm.group(0) in consumed:
            continue
        attr = pm.group(1)
        preds.append(mask_in(doms[attr], [int(pm.group(2))], attr=attr))
    return preds


def _find_measure(catalog: Catalog, col: str) -> tuple[str, str]:
    for n in catalog.names():
        if col in catalog.get(n).measures:
            return n, col
    raise SqlError(f"measure column {col!r} not found in catalog")
