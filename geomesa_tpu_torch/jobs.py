"""Background maintenance jobs of the store.

The port's copy of the JAX package's ``jobs.py`` pyramid job.  The JAX
job runs inside its background-job registry (``/debug/jobs``), which the
port does not have: here the job calls ``build_pyramids`` directly.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["PyramidJob", "run_pyramid_build"]


@dataclass
class PyramidJob:
    """Build-behind density-pyramid maintenance over a lean schema: fold
    each sealed generation's whole-world density into its
    multi-resolution pyramid.  Idempotent and resumable — a generation
    that already has a pyramid is skipped, so an interrupted build picks
    up the missing generations on the next pass while queries keep
    serving exact results through the sweep.

    ``store`` — TpuDataStore; ``type_name`` — the lean schema."""

    store: object
    type_name: str

    def run(self) -> int:
        """One build pass; the number of pyramids built."""
        return self.store.build_pyramids(self.type_name)


def run_pyramid_build(store, type_name: str) -> int:
    return PyramidJob(store, type_name).run()
