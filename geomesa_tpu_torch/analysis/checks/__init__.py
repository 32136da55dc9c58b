"""Check registry: the six invariant analyzers, in catalog order
(docs/static_analysis.md).  Each check exposes ``id``,
``description``, and ``run(module, project) -> iterator[Finding]``;
adding a check means adding a module here and a catalog row there.
"""

from __future__ import annotations

from .host_sync import HostSyncCheck
from .recompile_hazard import RecompileHazardCheck
from .lock_discipline import LockDisciplineCheck
from .config_options import ConfigOptionCheck
from .taxonomy import TaxonomyCheck
from .fault_points import FaultPointCheck

__all__ = ["CHECKS", "check_by_id"]

CHECKS = (HostSyncCheck(), RecompileHazardCheck(),
          LockDisciplineCheck(), ConfigOptionCheck(), TaxonomyCheck(),
          FaultPointCheck())


def check_by_id(check_id: str):
    for c in CHECKS:
        if c.id == check_id:
            return c
    raise KeyError(check_id)
