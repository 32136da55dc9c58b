"""Filter algebra: predicate AST, ECQL text parsing, geometry/interval
extraction and vectorized evaluation.

The capability surface of the reference's ``geomesa-filter`` module
(FilterHelper extraction at geomesa-filter/.../FilterHelper.scala:102/151,
CNF/DNF rewrites at package.scala:52/171, FastFilterFactory optimized
evaluation) rebuilt for columnar data: filters evaluate as numpy masks
over whole FeatureBatches instead of per-row CQL interpretation.
"""

from .ast import (
    And,
    Attribute,
    BBox,
    Between,
    Contains,
    During,
    DWithin,
    Exclude,
    Filter,
    IdFilter,
    In,
    Include,
    Intersects,
    Like,
    Not,
    Or,
    PropertyCompare,
    Within,
)
from .ecql import parse_ecql
from .evaluate import evaluate_filter
from .extract import FilterValues, extract_geometries, extract_intervals, to_cnf

__all__ = [
    "And", "Attribute", "BBox", "Between", "Contains", "During", "DWithin",
    "Exclude", "Filter", "IdFilter", "In", "Include", "Intersects", "Like", "Not", "Or",
    "PropertyCompare", "Within", "parse_ecql", "evaluate_filter",
    "FilterValues", "extract_geometries", "extract_intervals", "to_cnf",
]
