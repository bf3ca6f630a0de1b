"""Relational substrate: sparse annotated relations, schemas, streaming, SQL."""

from .relation import (  # noqa: F401
    Catalog, Delta, Predicate, Relation, catalog_from_arrays, lift_rows, mask_in,
)
from .stream import StreamBuffer, StreamStats  # noqa: F401
from . import schema  # noqa: F401
