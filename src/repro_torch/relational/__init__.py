"""Relational substrate: sparse annotated relations, schemas, SQL."""

from .relation import Catalog, Predicate, Relation, catalog_from_arrays, lift_rows, mask_in  # noqa: F401
from . import schema  # noqa: F401
