"""Bulk ingest and background maintenance jobs of the store.

The port's copy of the JAX package's ``jobs.py``.  Converter ingest runs
locally (a thread pool parses files into columnar batches while one
writer appends them to the store, the reference's
LocalConverterIngest) or over processes (each parses its round-robin
share of the files and feeds its own rows into
``ShardedZ3Index.build_multihost``, the reference's
DistributedConverterIngest).  Every ingest, compaction and pyramid run
registers in the background-job registry
(:mod:`~geomesa_tpu_torch.obs.jobs`): a ``job.<kind>`` span with its
phases, progress counters and a terminal outcome, ``failed`` with the
error when the store raises.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass, field

import numpy as np

from .io.converters import EvaluationContext, converter_from_config
from .obs.jobs import jobs_registry

__all__ = ["IngestJob", "IngestResult", "run_ingest",
           "local_paths_for_process", "run_distributed_ingest",
           "CompactionJob", "run_compaction",
           "PyramidJob", "run_pyramid_build"]


@dataclass
class IngestResult:
    """Counters the reference reports per ingest (EvaluationContext
    metrics and job counters)."""

    ingested: int = 0
    failed: int = 0
    files: int = 0
    errors: list = field(default_factory=list)


def _parse_file(conv, path: str):
    """One file through the converter: ``(batch, EvaluationContext)``."""
    ec = EvaluationContext()
    if conv.wants_path:
        return conv.convert(path, ec), ec
    with open(path, "rb") as f:
        return conv.convert(f.read(), ec), ec


def _parsed(conv, paths: list[str], workers: int, result: IngestResult):
    """Parse ``paths`` on a pool of ``workers`` threads; yields each
    parsed batch as its file completes (``as_completed`` order, so with
    more than one worker the order differs between runs) after counting
    the file into ``result``.  A file that fails to parse counts as one
    failure and is skipped."""
    # pyarrow's CSV reader imported first on a pool thread, with torch
    # loaded, crashes the process (SIGSEGV) in a later pool's parse:
    # import it on the thread that owns the pools
    with contextlib.suppress(ImportError):
        import pyarrow.csv  # noqa: F401
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = {pool.submit(_parse_file, conv, p): p for p in paths}
        for fut in as_completed(futures):
            path = futures[fut]
            result.files += 1
            try:
                batch, ec = fut.result()
            except Exception as e:  # noqa: BLE001 — count, keep going
                result.errors.append(f"{path}: {e!r}")
                result.failed += 1
                continue
            result.failed += ec.failure
            result.errors.extend(ec.errors)
            yield batch


@dataclass
class IngestJob:
    """Converter ingest over many files with parallel parse.

    ``store`` — TpuDataStore (or anything with ``get_schema(name)`` and
    ``write(name, batch)``); ``converter_config`` — converter definition
    dict; ``workers`` — parse parallelism (the mapper count)."""

    store: object
    type_name: str
    converter_config: dict
    workers: int = 4

    def run(self, paths: list[str]) -> IngestResult:
        """Run the ingest as an ``ingest`` job with ``setup`` and
        ``ingest`` phases and per-file progress; a failed setup or write
        marks the job ``failed`` (per-file parse errors only count)."""
        with jobs_registry.run("ingest", schema=self.type_name,
                               files=len(paths),
                               workers=self.workers) as job:
            result = IngestResult()
            with job.phase("setup"):
                sft = self.store.get_schema(self.type_name)
                # one converter for the whole job: construction loads the
                # enrichment caches, and convert() keeps no state between
                # calls, so the worker threads share it
                conv = converter_from_config(sft, self.converter_config)
            with job.phase("ingest", files=len(paths)):
                for batch in _parsed(conv, paths, self.workers, result):
                    if len(batch):
                        # single-writer append (the BatchWriter role)
                        result.ingested += self.store.write(self.type_name,
                                                            batch)
                    job.progress(files=result.files,
                                 ingested=result.ingested,
                                 failed=result.failed)
            return result


def run_ingest(store, type_name: str, converter_config: dict,
               paths: list[str], workers: int = 4) -> IngestResult:
    return IngestJob(store, type_name, converter_config, workers).run(paths)


def local_paths_for_process(paths: list[str], process_index: int,
                            process_count: int) -> list[str]:
    """Round-robin file split across processes (the MapReduce input split
    of DistributedConverterIngest: each mapper gets a file subset)."""
    return [p for i, p in enumerate(paths)
            if i % max(1, process_count) == process_index]


def run_distributed_ingest(sft, converter_config: dict, paths: list[str],
                           period="week", mesh=None, workers: int = 4):
    """Multi-process converter ingest into a global sharded Z3 index.
    Every process of the group (:mod:`~geomesa_tpu_torch.parallel.
    multihost`) runs this same function, parses its round-robin share of
    the files on a local thread pool and feeds only its own rows into
    ``ShardedZ3Index.build_multihost``, a collective; no process holds
    the whole dataset.  Without a process group it is a local parse and
    a sharded build.

    Returns ``(index, IngestResult)``; the result carries this process's
    counters (job counters are per mapper in the reference too)."""
    from .parallel.multihost import process_count, process_index
    from .parallel.scan import ShardedZ3Index

    my_paths = local_paths_for_process(paths, process_index(),
                                       max(1, process_count()))
    conv = converter_from_config(sft, converter_config)
    result = IngestResult()
    batches = [b for b in _parsed(conv, my_paths, workers, result)
               if len(b)]
    result.ingested = sum(len(b) for b in batches)
    if batches:
        local = batches[0]
        for b in batches[1:]:
            local = local.concat(b)
        x, y = local.geom_xy(sft.geom_field)
        dtg = local.column(sft.dtg_field)
    else:  # a process may hold no rows; it still joins the collective
        x = y = np.empty(0, dtype=np.float64)
        dtg = np.empty(0, dtype=np.int64)
    index = ShardedZ3Index.build_multihost(x, y, dtg, period=period,
                                           mesh=mesh)
    return index, result


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
