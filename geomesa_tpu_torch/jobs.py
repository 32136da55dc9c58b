"""Background maintenance jobs of the store.

The port's copy of the JAX package's ``jobs.py`` compaction and pyramid
jobs.  Every run registers in the background-job registry
(:mod:`~geomesa_tpu_torch.obs.jobs`): a ``job.<kind>`` span with its
phase, progress counters and a terminal outcome, ``failed`` with the
error when the store raises.  ``IngestJob``, ``run_ingest`` and
``run_distributed_ingest`` need the converters of the I/O slice
(ROADMAP A9, A11).
"""

from __future__ import annotations

from dataclasses import dataclass

from .obs.jobs import jobs_registry

__all__ = ["CompactionJob", "run_compaction", "PyramidJob",
           "run_pyramid_build"]


@dataclass
class CompactionJob:
    """Explicit LSM maintenance over a lean schema's generational indexes
    (the reference's ``compact`` tool command): fold sealed same-tier
    sorted runs so query and density fan-out stops growing with ingest
    history.  ``budget_ms`` bounds each run; an interrupted job resumes
    where it stopped, so a scheduler can call it on a fixed cadence.

    ``store`` — TpuDataStore; ``budget_ms`` — wall-clock bound per
    ``run()`` (None = run to completion)."""

    store: object
    type_name: str
    budget_ms: float | None = None

    def run(self) -> dict:
        """One compaction pass, as a ``compaction`` job with a ``compact``
        phase and the merged groups as progress; the store's per-index
        result."""
        with jobs_registry.run("compaction", schema=self.type_name,
                               budget_ms=self.budget_ms) as job:
            with job.phase("compact"):
                out = self.store.compact(self.type_name,
                                         budget_ms=self.budget_ms)
            job.progress(
                merged_groups=sum(int(v.get("merged_groups", 0))
                                  for v in out.values()
                                  if isinstance(v, dict)),
                indexes=len(out))
            return out


def run_compaction(store, type_name: str,
                   budget_ms: float | None = None) -> dict:
    return CompactionJob(store, type_name, budget_ms).run()


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
        """One build pass, as a ``pyramid`` job with a ``build`` phase;
        the number of pyramids built."""
        with jobs_registry.run("pyramid", schema=self.type_name) as job:
            with job.phase("build"):
                built = self.store.build_pyramids(self.type_name)
            job.progress(built=built)
            return built


def run_pyramid_build(store, type_name: str) -> int:
    return PyramidJob(store, type_name).run()
