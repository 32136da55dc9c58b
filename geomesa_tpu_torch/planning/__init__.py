"""Query planning: strategy selection, plan assembly, explain tracing.

The analog of the reference's planning stack
(geomesa-index-api/.../index/planning/): QueryPlanner, StrategyDecider,
Explainer.
"""

from .explain import ExplainLogging, ExplainNull, ExplainString, Explainer
from .planner import Query, QueryPlanner, QueryResult
from .strategy import FilterStrategy, StrategyDecider

__all__ = [
    "Explainer", "ExplainString", "ExplainLogging", "ExplainNull",
    "Query", "QueryPlanner", "QueryResult", "FilterStrategy",
    "StrategyDecider",
]
