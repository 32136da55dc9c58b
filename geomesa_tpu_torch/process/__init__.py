"""Analytic processes over query results."""

from .density import density_process
from .stats_process import stats_process

__all__ = ["density_process", "stats_process"]
