"""Query planning: strategy selection, plan assembly, explain tracing.

The analog of the reference's planning stack
(geomesa-index-api/.../index/planning/): QueryPlanner, StrategyDecider,
Explainer, plus the sketch-fed cardinality estimator and adaptive
mid-query replanning.
"""

from .adaptive import ReplanSignal, check_replan, replan_scope
from .estimator import CardinalityEstimator
from .explain import ExplainLogging, ExplainNull, ExplainString, Explainer
from .planner import Query, QueryPlanner, QueryResult
from .strategy import FilterStrategy, StrategyDecider

__all__ = [
    "Explainer", "ExplainString", "ExplainLogging", "ExplainNull",
    "Query", "QueryPlanner", "QueryResult", "FilterStrategy",
    "StrategyDecider", "CardinalityEstimator", "ReplanSignal",
    "check_replan", "replan_scope",
]
