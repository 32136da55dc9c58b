"""Analytic processes over query results."""

from .density import density_process

__all__ = ["density_process"]
