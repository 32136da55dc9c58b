#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--points 100000000]
                          [--facade-rows 16000000] [--places-rows 4000000]
                          [--mesh-rows 16000000] [--lean-rows 48000000]
                          [--lean-slots 8388608] [--attr-rows 8000000]
                          [--attr-mesh-rows 4000000]
                          [--lean-attr-rows 64000000]
                          [--lean-attr-slots 8388608]
                          [--mesh-lean-rows 32000000]
                          [--mesh-lean-slots 4194304]
                          [--poly-rows 6000000] [--poly-mesh-rows 6000000]
                          [--lean-poly-rows 16000000]
                          [--lean-poly3-rows 16000000]
                          [--lean-poly3-slots 2097152]
                          [--mesh-lean-poly-rows 8000000]
                          [--mesh-lean-poly3-rows 8000000]
                          [--mesh-lean-poly-slots 2097152]
                          [--life-rows 4000000]
                          [--life-mesh-rows 4000000]
                          [--fsds-rows 2000000] [--mh-rows 8000000]
                          [--mh-lean-rows 16000000]
                          [--mh-lean-slots 4194304] [--mh-timeout 400]
                          [--res-rows 8000000] [--res-slots 1048576]
                          [--ingest-files 8] [--ingest-rows 250000]
                          [--vessel-rows 2000000] [--raster-lat-tiles 90]
                          [--blob-count 10000] [--geojson-docs 200000]
                          [--view-rows 1000000]
                          [--stream-history-rows 4000000]
                          [--stream-default-rows 1000000]
                          [--stream-slots 1048576]
                          [--stream-messages 250000]
                          [--stream-vessels 100000] [--stream-queries 3]
                          [--native-inserts 10000] [--native-queries 50]
                          [--native-polys 1000] [--native-poly-queries 10]
                          [--profile] [--out FILE]

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit (``nvidia-smi``), torch/CUDA;
2. build: every kernel of ``geomesa_tpu_torch/csrc`` with ``nvcc``, one
   compiler per source, all started together, from this checkout, and
   the native range sweep (``geomesa_tpu_torch/native``, ``g++``), which
   must be available;
3. kernel: each kernel's wrapper on the card against its plain PyTorch
   version (z3_mask and z2_mask bit for bit at 2^22 and 2^22 + 37
   candidates, z2_mask also at 2^24, the capacity its scan reaches on the
   main path, R = 1 and 8; density_grid at 2^24 clustered and uniform
   points, 256x256 and 1024x1024 grids, ~50% masked in, and 256x256
   clustered with every point masked in, unit weights bit for bit and
   random weights within rtol 1e-6; hist1d at 16M rows, the mesh phase's
   per-shard slot count, and 2^22 + 37, 64, 1024 and 65,536 bins, ~50%
   masked in, and 16M rows at 64 bins every row masked in, ids past both
   ends, unit weights bit for bit and random weights within rtol 1e-5),
   timed with CUDA events beside the plain version and, where one exists,
   a PyTorch library call; the ``kernels`` line reads the ~50% rows;
3b. multihost: two worker processes of this script on the card (the
   kernels built in phase 2 are only loaded there), joined by
   ``torch.distributed`` over TCP on localhost — a gloo host group and a
   gloo device group, as both share the one card — each on
   ``global_device_mesh()`` over ``cuda:0``, under a subprocess timeout
   (``--mh-timeout``; a worker that fails, hangs or exits non-zero fails
   the run).  Each writes its own rows, worker 1 1% more than worker 0.
   Default profile: schema ``events``
   (``actor:String:index=true,score:Double,dtg:Date,*geom:Point``,
   GDELT-like rows, the attribute phases' Zipf actors with one rare
   code), ``--mh-rows`` rows in two writes; BBOX+DURING (sharded z3),
   BBOX (sharded z2), the rare actor (``attr:actor``) and ``IN ('p0.5',
   'p1.7')`` (``id``); ``stats`` of Count, MinMax, a 64-bin Histogram of
   ``score`` and ``Frequency(actor,4,1024)`` (pushed down: hist1d);
   ``density_process`` at 256x256, unit-weight and ``score``-weighted, and
   ``density_tile`` at z = 3 (pushed down: density_grid); a 512K-row
   append per worker through the built indexes and the queries again;
   ``get_count``, ``get_bounds`` and a delete of 0.1% of worker 0's
   rows, after which the count is agreed again.  Lean profile:
   ``--mh-lean-rows`` rows in 4 writes at ``--mh-lean-slots``-slot
   per-shard generations under 86 B a slot (the z3 index keys and host
   generations, the attribute index one device generation and the rest
   on the host), the tiers equal on both workers; 8 queries; ``flush`` to
   ``lean.lean.p0`` / ``.p1``, a drop, a reopen in both workers and the
   queries again (the first one's time plus the reopen's: the time to
   recover).  Each worker's local hits equal a numpy brute force over
   its own rows; the global counts, grids and stat tables equal an
   oracle over both workers' rows, assembled by allgather; each worker
   must launch z3_mask, z2_mask, density_grid and hist1d;
4. index: ``Z3PointIndex.build`` over ``--points`` GDELT-like points (70%
   Gaussian clusters around 50 cities, 30% uniform, dtg uniform over 2018,
   WEEK bins), a 1M-row append, and 20 BBOX+DURING queries (city, region,
   continent; at least one on the two-phase path), each hit set equal to
   a chunked numpy brute-force oracle;
5. z2 index: ``Z2PointIndex.build`` over the same points, the same 1M-row
   append, the 20 queries' boxes without their times, one ``query_many``
   of 4 box sets, each equal to the oracle, and ``density_world(1024,
   512)`` equal to a numpy histogram of every point;
6. facade: ``TpuDataStore(device="cuda")`` on schema ``gdelt``:
   ``--facade-rows`` rows written in 4 batches with a query after the
   first (later writes take the append path), then ECQL BBOX+DURING, an
   OR of two DURING windows, BBOX alone (z2), an OR of two BBOXes (one z2
   scan) and INCLUDE, positions equal to the oracle; ``density_process``
   over 256x256 for BBOX+DURING, BBOX alone and INCLUDE, and
   ``density_tile`` at z = 3, counts equal to a numpy oracle; a schema
   ``places`` without a dtg (``--places-rows`` rows) answering BBOX
   queries through z2;
6b. serving, on the facade's ``gdelt`` store: 64 tile-server-like
   windows (0.5-4 degree boxes around the cities, every fourth an OR of
   two; 48 with a 1-14 day interval, 16 untimed) through
   ``query_windows`` five times, each window equal to the oracle and to
   its own ``query_result``, and ``query.gdelt.windows`` counting every
   window; ``density_tile`` at z = 4 under a 60 s deadline, equal to the
   snap oracle; a query under an already spent deadline, which must
   raise ``QueryTimeout``, and the same with ``partial_results``, which
   must come back flagged ``timed_out`` with a subset of the oracle's
   hits; no admission token left in flight.  It prints the batches' p50
   beside the solo queries' sum and p50;
6c. trace, on the facade's ``gdelt`` store: the index phase's 20
   queries as BBOX+DURING ECQL in turns under ``sampler=never`` and
   ``sampler=always`` (each query's p50 of 3 of each), the spans a
   traced query records and the sum of its ``device_ms`` against its
   wall time, the audit's ``trace_id`` equal to the traced query's (""
   when unsampled), and one ``explain_analyze`` whose matched rows equal
   the query's hits;
6d. obs, on stores earlier phases built.  On the facade's ``gdelt``
   store: the 20 queries traced under ``geomesa.slo.objectives`` of 1 ms
   at 0.99 (every one misses it) and a burn alert at 1, folded into the
   SLO plane; the ``query`` class's stage ledger and its
   ``unattributed`` share, both windows' burn (> 1), exactly one alert
   fired; the registry's ``prometheus_text`` plus the plane's exposition
   parsed line by line; ``compile_count()`` (the kernel-build watch)
   unchanged across the warm queries.  Inside phase 8, after its
   ``compact`` and serving part: the lean queries with the heat tracker
   cleared, then ``heat_report`` ranks every z3 generation once, with
   as many touches as queries that reached it and the tier
   ``storage_report`` gives; the BBOX+DURING queries' p50 with
   ``geomesa.obs.heat.enabled`` on and off in turns (not gated); one
   ``CompactionJob`` and one ``PyramidJob``, each ``succeeded`` in
   ``jobs_registry`` with its phase span.  Inside phase 11b, after its
   ``compact``: the lean queries traced, their ``unattributed`` share,
   and one ``heat_report`` ranking every generation of its three
   indexes once;
6e. arrow, on stores earlier phases built.  On the facade's ``gdelt``
   store: the 20 queries through ``query_arrow`` with auto dictionaries
   (``actor`` dictionary-encoded), each drained as IPC and opened by
   ``pa.ipc.open_stream``, its ids, x, y and dtg equal to the oracle's
   rows; the largest result's ``ipc_chunks`` (16 KiB flushes) equal to
   its ``to_table``; a city query through ``query_arrow_table`` (sorted on
   dtg), ``arrow_conversion_process`` and ``bin_conversion_process``,
   each decoding to the oracle's rows, and with ``crs="EPSG:3857"``
   equal to a numpy Mercator of them (rtol 1e-12); it must launch
   z3_mask.  Inside phase 7, after the append: ``query_arrow_table``
   (``actor`` dictionary-encoded, sorted on dtg: the mesh reduce
   ``merged_arrow``) equal to one ``DeltaWriter`` over the oracle's rows,
   dictionary values decoded; it must launch z3_mask.  Inside phase 8,
   after 6d: the 8 BBOX+DURING queries through ``query_arrow``, x, y and
   dtg read by the index's device gather (its dispatch count moves, a
   ``query.materialize`` span has ``stage="gather"``) and equal to the
   host payload at the oracle's rows; its launches are reported (0
   expected: the lean scans run no kernel).  It prints the rows/s and
   IPC bytes/s of each part, scan included, beside the card's name and
   power limit;
7. mesh: ``TpuDataStore(mesh=device_mesh(1))`` on schema ``events``
   (``actor:String,score:Double,dtg:Date,*geom:Point``): ``--mesh-rows``
   rows in 4 writes with no query between (the sharded z3 index builds
   once, at that many slots per shard); ``stats`` of Count, MinMax and a
   64-bin Histogram of ``score``, ``Frequency(actor,4,1024)`` and
   ``Frequency(score,4,1024)`` on BBOX+DURING, the first spec again on
   INCLUDE, and TopK (the host-merge reducer); BBOX+DURING (sharded z3)
   and BBOX (sharded z2) positions; a heatmap through ``density_process``
   and a tile, both pushed down per shard; then a 1M-row append, which
   grows the shard to 2^25 slots, and the Histogram spec again, now on
   the int64 route.  Every result equals a numpy oracle over the rows,
   and ``hist1d`` launches once per kernel-route Histogram and ``depth``
   times per Frequency, and never on the int64 route.  Before the
   append, the BBOX+DURING query with a max-ranges hint of 65,536, whose
   plan holds more ranges than a device replicates (4096), takes the
   ring-parallel scan (``ShardedZ3Index.query_ring``), equal to the
   oracle and launching ``z3_mask``; ``range_counts_ring`` sums to
   ``range_count``;
8. lean: ``TpuDataStore(device="cuda")`` on schema ``scale``
   (``score:Double,dtg:Date,*geom:Point``, no profile set) with
   ``geomesa.lean.hbm.budget`` at 164 B a generation slot (one full and
   four keys generations beside the sentinel charges): ``--lean-rows``
   GDELT-like rows at ``--lean-slots``-slot generations in 4 writes, the
   first of which (``LEAN_AUTO_ROWS``, 32M rows) switches the schema to
   the lean profile, the rest splitting the others three ways, ending
   with generations in all three tiers
   (full, keys, host); 8 BBOX+DURING queries (3 city, 3 region, 2
   continent) and 2 BBOX-only ones, positions and implicit ids equal to
   the oracle, each plan costed by the cardinality estimator (source
   ``sketch``; its cold fold timed first); one city BBOX with the
   estimator off and a replan threshold of 2, which must replan exactly
   once (source ``observed``) and still equal the oracle; a 256x256
   world heatmap before any pyramid; ``build_pyramids``, which must
   build one per sealed generation; ``Count()`` on INCLUDE (the count
   push-down) and on BBOX+DURING (materialized) and a whole-extent
   ``Z3Histogram`` (the sketch push-down), equal to numpy oracles, with
   the route each took; ``density_process`` heatmaps over a BBOX+DURING
   and the world at 256 and 512 (pushed down, held to the per-tier
   contract: value-exact on full-tier rows, cell-inclusive on keys and
   host rows, binned at the z-cell centre), a ``score``-weighted heatmap
   (the query path and the density kernel, rtol 1e-5), ``density_tile``
   at z = 1 (a slice of the world grid) and z = 3 (a bbox scan), the
   world grids and the z = 1 tile served from every sealed generation's
   pyramid; then ``compact``, after which the generation count has
   fallen, every merged generation has inherited its parents' pyramid,
   and two queries and the pyramid-served world heatmap still equal the
   oracle.  Kernel launches of three queries are counted with
   ``torch.profiler``.  Last, ``age_off`` of the rows dated before
   2018-01-15 tombstones them (timed with the stats' re-observe over the
   live rows): ``get_count``, the estimator-costed queries (the oracle
   less the tombstoned rows), a region heatmap and the z = 3 tile (now
   the materializing path through the density kernel, exact grids) and
   ``Count()`` on INCLUDE, whose push-down must fall back.  Between
   ``compact`` and the ``age_off``, the serving part (8b): 32 threads
   over 4 tenants call ``query_fused`` at once (a barrier), each result
   equal to its solo ``query_result`` (the first four also to the
   oracle), more fused requests than batches, no token or rider left;
   it prints the fused p50 and the batches-to-requests ratio;
9. attr: ``TpuDataStore(device="cuda")`` on schema ``attrs``
   (``actor:String:index=true,score:Double:index=true,dtg:Date,
   *geom:Point``): ``--attr-rows`` GDELT-like rows in 4 writes, ``actor``
   drawn from 200 three-letter codes with Zipf(1.1) frequencies plus one
   rare code at 0.01%, ``score`` a multiple of 0.1 in [-10, 10]; the
   z3-tiered attribute indexes of both built and timed; the rare actor
   with a continent BBOX and a month (``attr:actor``), ``actor IN`` two
   mid-frequency codes, a score band (``attr:score``), ``actor LIKE
   'U%'`` and a city BBOX with a day (``z3``), each strategy as expected
   and each hit set equal to a numpy oracle; then a 1M-row append, which
   the kept indexes serve as their tail, and the queries again;
10. mesh attr: ``TpuDataStore(mesh=device_mesh(1))`` on the same schema,
   ``--attr-mesh-rows`` rows; an actor equality with a week (the sharded
   index's z3 tier) and a score range, each against the oracle;
11. lean attr: the same schema on the lean profile, ``--lean-attr-rows``
   rows in 4 writes at ``--lean-attr-slots`` generations, with a budget of
   208 B a slot: the z3 index (0.75 of it) keeps one full and three keys
   generations, each attribute index the device generations its budget
   floor holds (two class-default generations) and the rest on the host; the attribute queries above plus an actor with a day
   (the date-tier seek) and the most frequent actor with a city BBOX and
   a day (``z3``), estimator-costed (source ``sketch``; the estimator's
   cold attribute folds timed first); Count, MinMax, a 64-bin Histogram
   and a Frequency of ``score`` over a quarter's window and over
   INCLUDE, cold and warm, on the sketch route and equal to numpy
   oracles (the count-min table is the host hash over the hits), and a
   Count of ``score > 9.5`` (materialized through ``attr:score``); then
   ``compact``, which must merge a group of host runs in each attribute
   index (the LeanAttrIndex core the lean XZ indexes share), and two
   queries again;
11b. mesh lean: the same schema on the lean profile over
   ``device_mesh(1)`` (``ShardedLeanZ3Index``, two
   ``ShardedLeanAttrIndex``), ``--mesh-lean-rows`` rows in 4 writes at
   ``--mesh-lean-slots``-slot per-shard generations and 384 B a slot of
   budget (z3: full and keys generations; each attribute index one
   device generation, the rest on the host), the accounted device bytes
   within 2% of ``torch.cuda.memory_allocated``; the lean phase's 10
   queries estimator-costed and the city BBOX replanned once, the
   rare-actor and score-band queries, ``Count()`` on INCLUDE (the count
   push-down) and the whole-extent ``Z3Histogram`` (the sketch), the
   world heatmap and the z = 1 and z = 3 tiles before and after
   ``build_pyramids`` (the world grid then served from every sealed
   generation's pyramid), a ``score``-weighted heatmap (the density
   kernel); ``compact`` (fewer z3 generations, a group of host runs
   merged in each attribute index, inherited pyramids); a
   flush, a drop, a reopen over ``device_mesh(1)``, the first query
   (time to recover) and the rest; then a point schema at a sixteenth of
   the slots whose generations pass through the full, keys and host
   tiers, its queries equal to the oracle;
12. polys: ``TpuDataStore(device="cuda")`` on schema ``polys``
   (``kind:String:index=true,dtg:Date,*geom:Polygon``): ``--poly-rows``
   footprints in 4 writes, drawn as ``poly_scale_proof.py`` draws them
   (axis-aligned rectangles around four city hotspots, half-sides
   0.0005-0.01°, a kind of road/building/park/water/rare), packed
   object-free, dtg uniform over 2018, ``geomesa.xz.precision`` at its
   default 12; the host xz3, xz2 and kind indexes built and timed; a city
   triangle with a day and a region triangle with a week (``xz3``), a
   day alone (``xz3`` over the whole world), a city BBOX, a region
   triangle and a continent triangle (``xz2``), the rare kind with a
   continent BBOX (``attr:kind``) and five ids (``id``), each strategy as
   expected and each hit set equal to a numpy oracle (interval overlap
   for boxes, a separating-axis test for the convex triangles); each xz
   query's range plan timed with the native sweep and the numpy sweep,
   which must agree; a heatmap, which raises ``KeyError`` as the JAX
   store does (a polygon schema has no x/y columns); then a 1M-row
   append, which the kept indexes serve as their tail, and the queries
   again;
13. mesh polys: the same on ``TpuDataStore(mesh=device_mesh(1))``
   (``--poly-mesh-rows``; ``ShardedXZ3Index`` / ``ShardedXZ2Index`` on
   the card) and a Count and 64-bin dtg Histogram over the city BBOX;
14. lean polys: ``poly_scale_proof``'s lean schema
   (``kind:String:index=true,*geom:Polygon``), ``--lean-poly-rows`` rows
   in 4 writes at ``--lean-slots`` generations under 60 B a slot of
   budget (the xz2 index must hold device and host generations); the
   xz2 queries above plus a city triangle and a continent
   BBOX, the rare kind with a continent BBOX and five ids, against the
   oracles; tiers, accounted and allocated device bytes; then
   ``compact`` and a query again;
15. lean tracks: the same footprints with a dtg (``LeanXZ3Index``),
   ``--lean-poly3-rows`` rows at ``--lean-poly3-slots`` generations (8
   at the defaults; the xz3 index must hold device and host
   generations): the spatio-temporal and temporal-only queries of phase
   12 and the spatial-only ones, which run on ``xz3`` with an open
   interval clamped to the data's extent; then ``compact``, which must
   merge a group of host runs, and a query again;
15b. mesh lean polys: phases 14 and 15 over ``device_mesh(1)``
   (``ShardedLeanXZ2Index``, ``ShardedLeanXZ3Index``),
   ``--mesh-lean-poly-rows`` and ``--mesh-lean-poly3-rows`` footprints
   at ``--mesh-lean-poly-slots``-slot per-shard generations under 100 B
   a slot (device and host generations both), and ``compact``;
16. lifecycle: ``TpuDataStore(device="cuda", auth_provider=...)`` on the
   facade's schema, ``--life-rows`` GDELT-like rows in 4 writes labelled
   "", ``user``, ``admin`` and ``user&admin``, ``actor`` guarded by
   ``admin``, read by a caller authorized for ``user``: the index
   phase's 20 queries as BBOX+DURING (z3) and BBOX (z2), positions equal
   to the oracle restricted to the visible rows, ``max_features``, a
   filter on the guarded attribute (no hit), ``get_count``,
   ``get_bounds`` and a region heatmap (materialized: the density
   kernel, bit-equal to the snap oracle); then a delete of 1% of the
   rows by id (timed; the first query after it, which rebuilds the
   indexes, timed apart), the queries again, the same delete again
   (0 rows) and ``age_off`` of the rows before 2018-01-15;
17. legacy: the same rows on a schema pinned to the v1 key layouts
   (``geomesa.index.versions=z3:1,z2:1``): the 40 queries equal to the
   oracle, their candidates next to the current layout's; then
   ``migrate_schema`` and the queries again (now with the current
   layout's candidates);
18. mesh lifecycle: ``device_mesh(1)``, ``--life-mesh-rows`` rows in 2
   labelled writes, a delete of 1% of them: Count, MinMax and a 64-bin
   Histogram of ``score`` pushed down through hist1d over the sharded
   index rebuilt after the delete, equal to numpy, and the queries;
   then the same rows and delete read by a caller authorized for
   ``user``, the queries restricted to its rows;
19. persist (run right after phase 16, whose store keeps a catalog in a
   temporary directory from its creation and is flushed after its
   age_off; each phase that writes one first checks that the disk has
   room for twice what it writes): the store dropped (its device memory
   must fall), the catalog reopened with the same auth provider, the
   reopen and the first restricted query timed apart (the two together
   the time to recover), the 40 queries against the oracle (the visible
   rows less the deleted and aged-off ones), a restricted heatmap (one
   density_grid launch, bit-equal), a 1M-row write whose auto ids follow
   every id ever issued, an ``update_schema`` rename; the catalog
   reopened on ``device_mesh(1)`` (the renamed schema only): Count,
   MinMax and a 64-bin Histogram of ``dtg`` on a continent-month query
   and on INCLUDE, pushed down through hist1d, equal to numpy; then
   ``remove_schema``, after which no file of the schema is left;
20. lean persist (run right after phase 8, whose store keeps a catalog
   from its creation and is flushed after its tombstoning age_off, in
   2^22-row parts): the store dropped, the snapshot reopened, the lazy
   streaming index rebuild timed inside the first query, the
   estimator-costed queries against the oracle less the tombstones,
   ``get_count`` and ``Count()``, and the device bytes allocated since
   the reopen within 0.99-1.05x of the index's accounted bytes;
21. fsds: ``FileSystemDataStore`` with the daily datetime scheme,
   ``--fsds-rows`` GDELT-like rows over 2018 in 4 writes (365 partitions,
   4 files each); a city-week BBOX+DURING query pruned on the host,
   equal to the oracle, reading the week's days and a day of over-cover
   on each side; ``compact`` (one file a partition) and the query again;
   the store rediscovered from disk and the query again; then
   ``to_device_store(fs, name, device="cuda")``: the query (z3) and a
   BBOX-only one (z2) on the card, equal to the oracle and to
   ``fs.query``;
22. resilience (run right after phase 3b, on an allocator holding little
   else, so that its cap bites): a lean store of its own,
   ``--res-rows`` GDELT-like rows at ``--res-slots``-slot generations
   under a budget that leaves one full, three keys and the rest host
   generations: its ``storage_report`` (accounted device bytes equal to
   the actual tensor bytes, host within the tolerance,
   ``memory_allocated`` beside them) and the admission gate shedding with
   ``Backpressure`` at a headroom below the published gauge;
   ``device.dispatch:1=oom`` armed through ``set_property`` (the query
   equal to its oracle, ``resilience.degraded`` and
   ``resilience.retries`` counted, a flagged ``query.scan.degraded``
   span); ``device.dispatch=error`` (``FaultInjected`` reaches the
   caller); a breaker at threshold 1 (the generation answered from the
   host tier, ``resilience.breaker.open`` counted); one real
   ``torch.OutOfMemoryError`` (the caching allocator capped 4 MiB above
   what it reserves; the keys tier's gather degrades and the answer
   stays exact); then ``ingest.append``, ``host.spill``,
   ``pyramid.build`` and ``compaction.merge_step`` armed once each, the
   store equal to its oracle after each.  At the end every kernel gate
   must read ``ok`` with no failure;
23. ingest: ``--ingest-files`` GDELT 1.0 event files (a week at the
   defaults) of ``--ingest-rows`` rows each, 58 tab-separated fields
   written by pyarrow's CSV writer after the disk check, 0.1% of the
   rows bad (ragged, a point outside WGS84, a date before 1970), through
   ``run_ingest`` (the GDELT converter config, skip mode, the ``z-index``
   validator, 4 workers) into a default-profile ``gdelt`` store on the
   card: ``ingested`` and ``failed`` equal to the generator's counts,
   every stored row the generator's; the rows/s, the job's ``setup`` and
   ``ingest`` spans and the time of its writes; the index phase's 20
   queries as BBOX+DURING (z3) and BBOX (z2), each equal to the oracle
   over the good rows; ``spatial_rdd`` of a city query (the partitions'
   union equal to ``query_result``, ``to_arrow`` the same count) and
   ``save_rdd`` into a second store; the converter RDD provider over
   two of the files with a region filter, and ``run_distributed_ingest``
   over them on ``device_mesh(1)``, each equal to the oracle; the JSON,
   GeoJSON, XML, fixed-width, Avro, JDBC, shapefile and OSM converters
   on a small file each into a schema of its own, a continent query
   equal to the oracle; and the CSV, GeoJSON, GML, Leaflet and shapefile
   exports of the city query, CSV, GeoJSON and the shapefile read back
   equal;
24. processes, SQL and raster.  24a (after 6b, on the facade's stores):
   ``knn_process`` at five city centres with k = 10 and 1,000, each with
   and without a month, and k = 10 on ``places`` (the distances bit for
   bit, the positions but among ties at the k-th, against a haversine
   over every row); ``proximity_process`` of 50 ``places`` points at
   5 km, a LineString and a Polygon; ``tube_select`` of a 200-vertex
   track (20 km, 6 h) in the interpolated and ``nofill`` modes;
   ``route_search_process`` on the same track over a ``vessels`` schema
   of ``--vessel-rows`` rows with a heading; ``unique_process``,
   ``min_max_process``, ``join_process``, ``track_label_process``,
   ``point2point_process`` and the transform processes on a city
   filter; the ``SAMPLING`` and ``SAMPLE_BY`` hints on three of the 20
   queries; SQL: the 20 queries as ECQL, ``st_intersects`` and
   ``st_contains`` counts, a ``GROUP BY actor`` with ``HAVING``, global
   aggregates, an ``st_x``/``st_y``/``st_geoHash`` projection, a
   ``places``-``gdelt`` ``st_dwithin`` join and ``explain_analyze_sql``,
   each against a numpy oracle (the proximity and route oracles take the
   processes' candidate windows and report the rows within the distance
   outside them).  24b (inside phase 7): kNN and tube select on the
   mesh store.  24c (inside phase 8): kNN and a SQL ``count(*)`` on the
   lean store.  24d (inside each phase 3b worker): kNN, proximity and
   tube select on the ``events`` store, the same on both workers and
   equal to oracles over both workers' rows, and ``sql_join`` raising.
   24e (last): a raster store of its own at GTOPO30's published grid
   (43,200 x 21,600 cells, 30 arc-seconds, as ``--raster-lat-tiles``
   rows of 180 tiles of 240 x 240 float32, 3.73 GB on the card at 90),
   ``build_pyramid(3)`` (a sample of pooled tiles against numpy's mean),
   a 256 x 256 web-map tile, a 2,048 x 2,048 continent and the world at
   4,096 x 2,048 from the coarsest level, each bit for bit against a
   numpy float64 mosaic with NaN in the same places; ``get_tiles``,
   ``bounds``, ``grid_range`` and a ``save``/``load`` of 256 tiles.
25. the front ends.  25a (after 24a, on the facade's stores): the port's
   ``WebApp`` behind ``make_bounded_server`` on 127.0.0.1, driven over
   HTTP with urllib: the 20 queries through ``/api/data`` as CSV (ids
   and points in the oracle's order), three ``places`` BBOX queries,
   ``/api/stats`` count, bounds and minmax, 8 ``/tiles`` at z 2-8 over
   city centres (each grid equal to the snapped oracle hits, each PNG's
   pixels to the same grid), 4 ``/query`` Arrow streams, ``/explain`` by
   CQL and the 20 queries' ``COUNT(*)`` through ``/explain?sql=``,
   ``/metrics.prom``, ``/debug/storage`` (device bytes equal to the
   store's report), ``/debug/heat``, ``/debug/slo``, ``/traces``, a
   10,000-feature GeoJSON POST into a new schema read back by id, and a
   burst of 64 concurrent ``/api/data`` requests against 8 slots (each a
   200 equal to the oracle or a 503 with Retry-After; the gates ``ok``
   and no admission token held after).  25c (after 25a): a blob store of
   ``--blob-count`` 1 KB blobs (100 through ``POST /api/blob``) with its
   BBOX query and byte reads over HTTP, a ``GeoJsonIndex`` of
   ``--geojson-docs`` point documents with three mongo-style queries
   through ``/geojson/``, and a ``MergedDataStoreView`` over the facade's
   store and a ``--view-rows`` store with scope filters.  25b (inside
   24e): ``/wcs`` GetCapabilities, DescribeCoverage and GetCoverage of
   the web tile and the continent, the ``npy`` grids bit for bit equal to
   the store's mosaic and the oracle.  25d (last): the CLI's ``main`` on
   the card in two processes, one running ``create-schema`` and
   ``ingest`` of two of phase 23's files into a fresh catalog, the other
   ``stats-count``, a ``sql`` ``COUNT(*)``, a CSV ``export`` and
   ``explain`` over it, each against the generator's rows; each
   command's z3_mask/z2_mask/density_grid launches are counted in its
   process, and ``sql``, ``export`` and ``explain`` must launch z3_mask.
26. streaming, at the size of a global AIS feed (about 100,000 vessels
   live at once): 26a a ``LambdaDataStore`` over a lean ``TpuDataStore``
   on the card holding ``--stream-history-rows`` persisted rows, then
   over a default-profile one holding ``--stream-default-rows``; a
   ``StreamDataStore`` of 4 partitions takes ``--stream-messages``
   position messages over ``--stream-vessels`` ids through ``write``
   and ``consume`` in 4 rounds with a stepped clock, ``persist`` each
   round (vessels written again after they were persisted upsert: a
   tombstone and an append on the lean store, a delete and a write on
   the default one), and after each round ``--stream-queries`` merged
   BBOX+DURING reads and a ``count`` equal a numpy oracle of the history
   rows and each vessel's latest position, with no id twice; the
   rounds' persist ms and the merged reads' p50 and max are printed.
   26b the native API: a point ``NativeIndex`` on the card takes
   ``--native-inserts`` single-value inserts, a tenth as many updates and
   a twentieth as many deletes, then ``--native-queries`` ``within`` +
   ``during`` queries, each equal to a numpy oracle over the live
   values; a ``points=False`` index takes ``--native-polys`` rectangles
   and answers ``--native-poly-queries`` queries through the XZ indexes.
   26c one BBOX+DURING query of 26a's default-profile store under
   ``torch.profiler`` with CUDA activity: the planner's ``query.plan``
   and ``query.scan`` ranges, and a ``z3_mask`` kernel inside the scan's.
27. gm-lint on the card's machine (after 6c, on the facade's store).
   27a: ``python -m geomesa_tpu_torch.analysis --fail-on-new`` over the
   port's tree in a subprocess with a timeout; it prints the new
   findings, the baselined ones and the seconds taken, and a new finding
   or a stale baseline entry fails the run.  27b, a reading and not a
   gate: four of the index phase's queries as BBOX+DURING ECQL, each
   under the tracer with ``torch.cuda.set_sync_debug_mode("warn")``;
   the synchronizing calls torch reports are counted inside and outside
   an open ``device_span``, and each outside site's ``file:line`` is
   printed with whether the static host-sync check flags it, baselines
   it or misses it.

The kernel launch counts are set to 0 just before phase 4 and read just
after phase 6, and again just before and after phase 6b (which must
launch z3_mask, z2_mask and density_grid), phase 6c (z3_mask), phase 6d
(its facade part must launch z3_mask; its lean and mesh lean parts count
apart inside their phases, set to 0 and read around each, and are
reported), phase 6e (its facade part, and its mesh part counted apart
inside phase 7, must launch z3_mask; its lean part counts apart inside
phase 8 and is reported), phase 7, phase 8 (whose
serving part 8b counts apart, set to 0 and read around it, and
reported: the lean fused scan runs no kernel, as the JAX lean programs
reach none),
phases 9-10, phase 11 and phase 11b; a kernel of a path that was never
launched on it fails the run (on the lean path, density_grid; on the
attribute path, z3_mask, which the city query launches; the lean
attribute path runs no kernel; on the mesh lean path, density_grid).
They are set to 0 and read around each of phases 12-15b as
well, and reported: the JAX package runs no Pallas kernel on its xz
paths (host numpy and plain XLA), and the port none on them.  They are
set to 0 and read around each of phases 16-18, which must launch
z3_mask, z2_mask and density_grid (16), z3_mask and z2_mask (17), and
z3_mask, z2_mask and hist1d (18), and around each of phases 19-21,
which must launch every kernel (19) and z3_mask and z2_mask (21), and
around phase 23, which must launch z3_mask and z2_mask, and around
24a, which must launch z3_mask and z2_mask, 24b and 24c (each inside its
phase, set to 0 and read around it, the host phase's counts resuming
after) and 24e, which are reported, and around 25a, which must launch
z3_mask, z2_mask and density_grid, 25c and 25b (inside 24e), which are
reported; phase 20's and 22's are reported.  They are set to 0 and read
around each part of phase 26: 26a's default-profile part must launch
z3_mask at least once a merged read, 26b at least once a point query,
26c at least once; 26a's lean part is reported (the lean scans run no
kernel, as the JAX lean programs reach no Pallas kernel).  They are
set to 0 and read around 27b, which must launch z3_mask.  The
``kernels`` line's launches are the main path's (hist1d's the mesh
path's) and phase 26's.
Each multihost worker (phase 3b) sets its own counts to 0 just before
its run and reads them just after (24d reads them around itself as
well); the parent reports them as ``multihost_path_launches``.  The
z3 index phase's range plans are timed again there with the native and
the numpy sweep.  The last lines printed are one ``{"kernels": [...]}`` JSON object,
the ``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device":
...}``.  Without a CUDA device, or without the ``geomesa_tpu_torch``
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime as dt
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

MS_2018 = 1514764800000
MS_2019 = 1546300800000
DAY = 86_400_000
#: H100 SXM peaks at the 700 W limit: the memory rate (NVIDIA data sheet),
#: and the 32-bit integer rate, a quarter of the data sheet's 67e12/s
#: float32 rate (that counts a fused multiply-add of 128 lanes per SM per
#: clock as 2; the integer pipe does 64 operations per SM per clock, CUDA
#: C++ Programming Guide, arithmetic-instruction throughput, compute
#: capability 9.0)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
#: float64 instructions per second: the data sheet's 34e12 FP64 FLOP/s
#: outside the tensor cores counts a fused multiply-add as 2
FP64_OPS_PER_S = 34e12 / 2
WORLD = (-180.0, -90.0, 180.0, 90.0)
#: the mesh phase's ring query: a max-ranges hint whose plan over the
#: phase's 20-degree box and two weeks holds more than the 4096 ranges a
#: device replicates (the phase checks it)
RING_MAX_RANGES = 65536
#: the lean phase's Z3Histogram resolution (top bits of the z3 key)
Z3_BITS = 12
#: the lean phase's mispredicted plan: whole-store fractions only, and a
#: replan threshold the dense city box passes
REPLAN_ENV = {"GEOMESA_PLANNING_ESTIMATOR_ENABLED": "false",
              "GEOMESA_PLANNING_REPLAN_THRESHOLD": "2.0"}
#: the lean phase's fraction-costed plans (the estimator and replanning
#: off: what PR 5's port planned), timed in turns with the sketch-costed
FRACTION_ENV = {"GEOMESA_PLANNING_ESTIMATOR_ENABLED": "false",
                "GEOMESA_PLANNING_REPLAN_THRESHOLD": "0"}


@contextlib.contextmanager
def env_set(values: dict):
    """Set environment variables for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def gdelt_like(rng, n: int, centres):
    """``n`` GDELT-like points: 70% Gaussian clusters around the city
    ``centres``, 30% uniform over the world; dtg uniform over 2018."""
    import numpy as np
    n_c = int(n * 0.7)
    which = rng.integers(0, len(centres), n_c)
    sigma = rng.uniform(0.5, 3.0, len(centres))[which]
    x = np.empty(n)
    y = np.empty(n)
    x[:n_c] = centres[which, 0] + rng.standard_normal(n_c) * sigma
    y[:n_c] = centres[which, 1] + rng.standard_normal(n_c) * sigma
    x[n_c:] = rng.uniform(-180.0, 180.0, n - n_c)
    y[n_c:] = rng.uniform(-90.0, 90.0, n - n_c)
    np.clip(x, -180.0, 180.0, out=x)
    np.clip(y, -90.0, 90.0, out=y)
    t = rng.integers(MS_2018, MS_2019, n)
    return x, y, t


#: brute-force answers already computed: a phase asks the same window of
#: the same columns many times (the queries, their turns, after a
#: compaction, after a reopen), and at the lean phase's size each
#: answer costs most of a second of host time.  Keyed by the columns' identity and the window;
#: an entry holds weak references to its columns, so it never answers
#: for other arrays, and its positions are read-only
_ORACLE_MEMO: dict = {}


def _memo_oracle(fn):
    import weakref

    @functools.wraps(fn)
    def memo(*args):
        cols = [a for a in args if hasattr(a, "dtype")]
        rest = tuple(tuple(map(tuple, a)) if isinstance(a, list) else a
                     for a in args if not hasattr(a, "dtype"))
        key = (fn.__name__, tuple(id(c) for c in cols), rest)
        hit = _ORACLE_MEMO.get(key)
        if hit is not None and all(r() is c for r, c in zip(hit[0], cols)):
            return hit[1]
        out = fn(*args)
        out.setflags(write=False)
        for k in [k for k, (refs, _) in _ORACLE_MEMO.items()
                  if any(r() is None for r in refs)]:
            del _ORACLE_MEMO[k]      # the answers of freed columns
        _ORACLE_MEMO[key] = ([weakref.ref(c) for c in cols], out)
        return out
    return memo


@_memo_oracle
def oracle(x, y, t, boxes, lo, hi, chunk: int = 1 << 24):
    """Brute-force positions of rows inside any box and [lo, hi], in
    chunks of ``chunk`` rows."""
    import numpy as np
    out = []
    for s in range(0, len(x), chunk):
        tc = t[s:s + chunk]
        idx = np.flatnonzero((tc >= lo) & (tc <= hi))
        xc, yc = x[s:s + chunk][idx], y[s:s + chunk][idx]
        m = np.zeros(len(idx), dtype=bool)
        for b in boxes:
            m |= (xc >= b[0]) & (xc <= b[2]) & (yc >= b[1]) & (yc <= b[3])
        out.append(idx[m] + s)
    return np.concatenate(out)


@_memo_oracle
def box_oracle(x, y, boxes, chunk: int = 1 << 24):
    """Brute-force positions of points inside any box, in chunks."""
    import numpy as np
    out = []
    for s in range(0, len(x), chunk):
        xc, yc = x[s:s + chunk], y[s:s + chunk]
        m = np.zeros(len(xc), dtype=bool)
        for b in boxes:
            m |= (xc >= b[0]) & (xc <= b[2]) & (yc >= b[1]) & (yc <= b[3])
        out.append(np.flatnonzero(m) + s)
    return np.concatenate(out)


def snap_counts(x, y, env, width: int, height: int, chunk: int = 1 << 24):
    """numpy histogram of unit-weight points snapped as GridSnap snaps
    them (floor of the true quotient, clamped to the grid), float64."""
    import numpy as np
    xmin, ymin, xmax, ymax = env
    dx, dy = (xmax - xmin) / width, (ymax - ymin) / height
    counts = np.zeros(width * height, dtype=np.int64)
    for s in range(0, len(x), chunk):
        ix = np.clip(np.floor((x[s:s + chunk] - xmin) / dx), 0, width - 1)
        iy = np.clip(np.floor((y[s:s + chunk] - ymin) / dy), 0, height - 1)
        counts += np.bincount(iy.astype(np.int64) * width
                              + ix.astype(np.int64),
                              minlength=width * height)
    return counts.astype(np.float64).reshape(height, width)


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple:
    """The least time the card could take, in ms, and what sets it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def iso(ms: int) -> str:
    return dt.datetime.fromtimestamp(ms / 1000, dt.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


def random_boxes(rng, r_real: int, r: int, bits: int, span, dev):
    """``r_real`` random int-space boxes of ``bits``-bit dimensions, sides
    drawn from ``span``, padded to ``r`` with never-matching [1, 1, 0, 0]
    boxes."""
    import numpy as np
    import torch
    lo = rng.integers(0, 1 << bits, (r_real, 2))
    ixy = np.concatenate(
        [lo, np.minimum(lo + rng.integers(*span, (r_real, 2)),
                        (1 << bits) - 1)], axis=1)
    ixy = np.concatenate([ixy, np.tile([[1, 1, 0, 0]], (r - r_real, 1))])
    return torch.tensor(ixy.astype(np.int32), device=dev)


def mask_row(name: str, kernel, plain, args, n: int, r: int, nbytes: int,
             ops: int) -> dict:
    """Hold a candidate-mask kernel against its plain version bit for bit
    and time both (kernel, plain, kernel, plain)."""
    import torch
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(
            f"{name} kernel disagrees with its plain version at N={n} "
            f"R={r}: {int((got != want).sum())} mismatches")
    hits = int(want.sum())
    if not 0 < hits < n:
        raise AssertionError(f"degenerate {name} case: {hits} hits")
    k1 = cuda_ms(lambda: kernel(*args), 50)
    p1 = cuda_ms(lambda: plain(*args), 10)
    k2 = cuda_ms(lambda: kernel(*args), 50)
    p2 = cuda_ms(lambda: plain(*args), 10)
    b_ms, b_by = bound(nbytes, ops, INT32_OPS_PER_S)
    row = {"n": n, "r": r, "hits": hits, "max_abs_err": err,
           "ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": b_ms,
           "bound_by": b_by}
    log(f"kernel {name} N={n} R={r}: equal, {hits} hits, {row['ms']:.4f} ms "
        f"(plain {row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by})")
    return row


def kernel_phase(rng, dev):
    """The z3 mask kernel against its plain version at the main path's
    largest candidate buffers (2^22, and a ragged 2^22 + 37)."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.curve import z3_sfc
    from geomesa_tpu_torch.ops.z3_mask import z3_mask, z3_mask_reference

    sfc = z3_sfc("week")
    rows = []
    for n in (1 << 22, (1 << 22) + 37):
        x = torch.tensor(rng.uniform(-180, 180, n), device=dev)
        y = torch.tensor(rng.uniform(-90, 90, n), device=dev)
        t = torch.tensor(rng.uniform(0, 604800.0, n), device=dev)
        z = sfc.index(x, y, t)
        tlo = torch.tensor(rng.integers(0, 1 << 20, n, dtype=np.int32),
                           device=dev)
        thi = tlo + torch.tensor(rng.integers(0, 1 << 21, n, dtype=np.int32),
                                 device=dev)
        for r_real, r in ((1, 1), (5, 8)):
            ixy = random_boxes(rng, r_real, r, 21, (1 << 16, 1 << 20), dev)
            # 32-bit integer operations per candidate, counted low (the
            # card has no 64-bit integer pipe): each 64-bit shift is one
            # funnel shift per 32-bit half and each xor-then-and one
            # three-input logic op per half, so z >> 1 and z >> 2 take 4,
            # each of the 3 de-interleaves 2 + 5 * 4 = 22; each box 4
            # predicate-chained compares; the time test 2
            rows.append(mask_row("z3_mask", z3_mask, z3_mask_reference,
                                 (z, ixy, tlo, thi), n, r,
                                 n * (8 + 4 + 4 + 1) + r * 16,
                                 n * (4 + 3 * 22 + 4 * r + 2)))
    return rows


def z2_kernel_phase(rng, dev):
    """The z2 mask kernel against its plain version at 2^22 candidates, a
    ragged 2^22 + 37, and 2^24: the z2 scan's gather capacity starts at
    2^15, grows to the power of two above a query's candidates, and never
    shrinks, so after the continent boxes every z2 query on the main path
    masks 2^24 slots (R = 1 for one BBOX, 2 for the two-box query)."""
    import torch
    from geomesa_tpu_torch.curve import z2_sfc
    from geomesa_tpu_torch.ops.z2_mask import z2_mask, z2_mask_reference

    rows = []
    for n in (1 << 22, (1 << 22) + 37, 1 << 24):
        z = z2_sfc().index(torch.tensor(rng.uniform(-180, 180, n), device=dev),
                           torch.tensor(rng.uniform(-90, 90, n), device=dev))
        for r_real, r in ((1, 1), (5, 8)):
            ixy = random_boxes(rng, r_real, r, 31, (1 << 26, 1 << 30), dev)
            # 32-bit integer operations per candidate, counted low as in
            # csrc/z2_mask.cu: z >> 1 is 2, each de-interleave 2 + 5 * 4,
            # each box 4 compares (the dimensions are 32-bit values)
            rows.append(mask_row("z2_mask", z2_mask, z2_mask_reference,
                                 (z, ixy), n, r, n * (8 + 1) + r * 16,
                                 n * (46 + 4 * r)))
        del z
    return rows


def density_kernel_phase(rng, centres, dev):
    """The density kernel against its plain version at 2^24 points,
    clustered GDELT-like and uniform, over the world at 256x256 and
    1024x1024, ~50% of the points masked in; and clustered at 256x256
    with every point masked in (the mask process/density.py passes).
    Unit weights bit for bit, random float64 weights within rtol 1e-6
    (float64 sums in an order that changes from run to run, then rounded
    to float32)."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.ops.density_kernel import (
        density_grid_kernel, density_grid_kernel_reference,
    )

    n = 1 << 24
    rows = []

    def measure(xd, yd, w, mask, dist, weights, size, share):
        n_in = int(mask.sum())
        args = (xd, yd, w, mask, WORLD, size, size)
        got = density_grid_kernel(*args)
        want = density_grid_kernel_reference(*args)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        if weights == "unit":
            ok = torch.equal(got, want)
        else:
            ok = bool(torch.allclose(got, want, rtol=1e-6, atol=0))
        if not ok:
            raise AssertionError(
                f"density kernel disagrees with its plain version "
                f"({dist}, {weights}, {size}x{size}, {share:.0%} in): max "
                f"abs err {err}")
        total = float(got.double().sum())
        if weights == "unit" and total != n_in:
            raise AssertionError(f"density grid holds {total} points, not "
                                 f"{n_in}")
        # the library yardstick leaves the snap out: one torch.bincount
        # over cells snapped beforehand
        xmin, ymin, xmax, ymax = WORLD
        ix = torch.clamp(torch.floor((xd - xmin) / ((xmax - xmin) / size)),
                         0, size - 1).long()
        iy = torch.clamp(torch.floor((yd - ymin) / ((ymax - ymin) / size)),
                         0, size - 1).long()
        cells = (iy * size + ix)[mask]
        w_in = w[mask].float().double()
        k1 = cuda_ms(lambda: density_grid_kernel(*args), 20)
        p1 = cuda_ms(lambda: density_grid_kernel_reference(*args), 5)
        l1 = cuda_ms(lambda: torch.bincount(cells, w_in,
                                            minlength=size * size), 20)
        k2 = cuda_ms(lambda: density_grid_kernel(*args), 20)
        p2 = cuda_ms(lambda: density_grid_kernel_reference(*args), 5)
        l2 = cuda_ms(lambda: torch.bincount(cells, w_in,
                                            minlength=size * size), 20)
        del cells, w_in
        # this run's data: the mask byte of every point, x, y and w of the
        # masked-in ones, the float32 grid written once; ~30 float64
        # instructions per masked-in point (two subtract-divide-floor-
        # clamp chains, the division some 10)
        b_ms, b_by = bound(n + 24 * n_in + 4 * size * size, 30 * n_in,
                           FP64_OPS_PER_S)
        rows.append({"n": n, "dist": dist, "weights": weights,
                     "grid": size, "masked_in_share": share,
                     "masked_in": n_in, "max_abs_err": err, "total": total,
                     "ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "library_ms": min(l1, l2),
                     "bound_ms": b_ms, "bound_by": b_by})
        log(f"kernel density_grid {dist} {weights} {size}x{size} N={n} "
            f"{share:.0%} in: equal (max abs err {err:g}), "
            f"{rows[-1]['ms']:.4f} ms (plain {rows[-1]['plain_ms']:.4f} ms, "
            f"bincount {rows[-1]['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"by {b_by})")

    for dist in ("clustered", "uniform"):
        if dist == "clustered":
            x, y, _ = gdelt_like(rng, n, centres)
        else:
            x = rng.uniform(-180.0, 180.0, n)
            y = rng.uniform(-90.0, 90.0, n)
        xd, yd = (torch.tensor(a, device=dev) for a in (x, y))
        mask = torch.tensor(rng.random(n) < 0.5, device=dev)
        for weights in ("unit", "random"):
            w = (torch.ones(n, dtype=torch.float64, device=dev)
                 if weights == "unit" else
                 torch.tensor(rng.uniform(0.5, 2.0, n), device=dev))
            for size in (256, 1024):
                measure(xd, yd, w, mask, dist, weights, size, 0.5)
        if dist == "clustered":
            w = torch.ones(n, dtype=torch.float64, device=dev)
            measure(xd, yd, w, torch.ones(n, dtype=torch.bool, device=dev),
                    dist, "unit", 256, 1.0)
        del xd, yd, mask, w
    torch.cuda.empty_cache()
    return rows


def hist1d_kernel_phase(rng, dev):
    """The hist1d kernel against its plain version at 16M rows (the mesh
    phase's per-shard slot count) and a ragged 2^22 + 37, at 64 bins (a
    Histogram stat), 1024 (a Frequency width) and 65,536 (wider than a
    block's shared memory: a histogram spread over a cluster), ~50% of
    the rows masked in; and at 16M rows and 64 bins with every row masked
    in (the mesh phase's INCLUDE stats).  Ids run 16 past both ends of the
    bins; unit weights bit for bit, random weights within rtol 1e-5
    (float32 atomics sum in an order that changes from run to run)."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.ops.hist1d_kernel import hist1d, hist1d_reference

    rows = []

    def measure(bins, w, mask, n_bins, weights, share):
        n = int(bins.shape[0])
        n_in = int(mask.sum())
        keep = mask & (bins >= 0) & (bins < n_bins)
        n_kept = int(keep.sum())
        args = (bins, w, mask, n_bins)
        got = hist1d(*args)
        want = hist1d_reference(*args)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        ok = (torch.equal(got, want) if weights == "unit" else
              bool(torch.allclose(got, want, rtol=1e-5, atol=0)))
        if not ok:
            raise AssertionError(
                f"hist1d kernel disagrees with its plain version at N={n} "
                f"bins={n_bins} ({weights}, {share:.0%} in): max abs err "
                f"{err}")
        if weights == "unit" and float(got.double().sum()) != n_kept:
            raise AssertionError(f"hist1d counts {got.sum()} rows, not "
                                 f"{n_kept}")
        # the library yardstick leaves the mask and the range test out:
        # one torch.bincount over ids and weights prepared beforehand
        ids = torch.where(keep, bins, 0).long()
        w_in = torch.where(keep, w, 0.0)
        k1 = cuda_ms(lambda: hist1d(*args), 20)
        p1 = cuda_ms(lambda: hist1d_reference(*args), 3)
        l1 = cuda_ms(lambda: torch.bincount(ids, w_in, minlength=n_bins), 10)
        k2 = cuda_ms(lambda: hist1d(*args), 20)
        p2 = cuda_ms(lambda: hist1d_reference(*args), 3)
        l2 = cuda_ms(lambda: torch.bincount(ids, w_in, minlength=n_bins), 10)
        del ids, w_in, keep
        # this run's data: the mask byte of every row, the bin id and
        # weight of each masked-in row, the float32 output once; a range
        # test and an add per masked-in row
        b_ms, b_by = bound(n + 8 * n_in + 4 * n_bins, 3 * n_in,
                           INT32_OPS_PER_S)
        rows.append({"n": n, "bins": n_bins, "weights": weights,
                     "masked_in_share": share, "masked_in": n_in,
                     "max_abs_err": err, "ms": min(k1, k2),
                     "plain_ms": min(p1, p2), "library_ms": min(l1, l2),
                     "library": "torch.bincount, mask and range test left "
                                "out",
                     "bound_ms": b_ms, "bound_by": b_by})
        log(f"kernel hist1d N={n} bins={n_bins} {weights} {share:.0%} in: "
            f"equal (max abs err {err:g}), {rows[-1]['ms']:.4f} ms (plain "
            f"{rows[-1]['plain_ms']:.4f} ms, bincount "
            f"{rows[-1]['library_ms']:.4f} ms, bound {b_ms:.4f} ms by "
            f"{b_by})")

    for n in (16_000_000, (1 << 22) + 37):
        mask = torch.tensor(rng.random(n) < 0.5, device=dev)
        for n_bins in (64, 1024, 65_536):
            bins = torch.tensor(rng.integers(-16, n_bins + 16, n,
                                             dtype=np.int32), device=dev)
            for weights in ("unit", "random"):
                w = (torch.ones(n, dtype=torch.float32, device=dev)
                     if weights == "unit" else
                     torch.tensor(rng.uniform(0.0, 3.0, n).astype(np.float32),
                                  device=dev))
                measure(bins, w, mask, n_bins, weights, 0.5)
            if n == 16_000_000 and n_bins == 64:
                measure(bins, torch.ones(n, dtype=torch.float32, device=dev),
                        torch.ones(n, dtype=torch.bool, device=dev), n_bins,
                        "unit", 1.0)
            del bins, w
        del mask
    torch.cuda.empty_cache()
    return rows


def index_phase(rng, args, centres, dev, report):
    """The z3 index phase; returns the indexed points ``(x, y)`` (the
    appended ones last), the append's row count and the queries."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.index import z3 as z3mod

    n = args.points
    t0 = time.perf_counter()
    x, y, t = gdelt_like(rng, n, centres)
    report["index"] = {"points": n, "gen_s": time.perf_counter() - t0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = z3mod.Z3PointIndex.build(x, y, t, period="week", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    m = 1_000_000
    ax, ay, at = gdelt_like(rng, m, centres)
    t0 = time.perf_counter()
    idx.append(ax, ay, at)
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    x, y, t = (np.concatenate(p) for p in ((x, ax), (y, ay), (t, at)))
    if len(idx) != n + m:
        raise AssertionError(f"index holds {len(idx)} rows, not {n + m}")
    report["index"].update(
        build_s=build_s, build_keys_per_s=n / build_s, append_rows=m,
        append_s=append_s, append_keys_per_s=m / append_s,
        capacity=int(idx.z.shape[0]),
        resident_bytes=sum(int(c.numel() * c.element_size()) for c in
                           (idx.bins, idx.z, idx.pos, idx.x, idx.y,
                            idx.dtg)),
        peak_device_bytes=int(torch.cuda.max_memory_allocated()))
    log(f"index: built {n} keys in {build_s:.3f} s "
        f"({n / build_s:.4g} keys/s); appended {m} in {append_s:.3f} s "
        f"({m / append_s:.4g} keys/s); capacity {idx.z.shape[0]}")

    qs = []
    day_of = lambda: MS_2018 + int(rng.integers(0, 358)) * DAY
    for i in range(8):     # city: 1°×1°, 1 day
        cx, cy = centres[i]
        lo = day_of()
        qs.append(("city", [(cx - .5, cy - .5, cx + .5, cy + .5)],
                   lo, lo + DAY - 1))
    for i in range(8, 14):  # region: 10°×10°, 1 week
        cx, cy = centres[i]
        lo = day_of()
        qs.append(("region", [(cx - 5, cy - 5, cx + 5, cy + 5)],
                   lo, lo + 7 * DAY - 1))
    for box in ((-10, 35, 50, 75), (-125, 20, -65, 60), (70, 5, 130, 45),
                (-20, -35, 40, 5)):   # continent: 60°×40°, 1 month
        lo = day_of()
        qs.append(("continent", [box], lo, lo + 30 * DAY - 1))
    cx, cy = centres[14]
    lo = day_of()
    qs.append(("two-box", [(cx - .5, cy - .5, cx + .5, cy + .5),
                           (cx + 2, cy + 2, cx + 7, cy + 7)],
               lo, lo + 3 * DAY - 1))
    qs.append(("edge", [(170.0, 80.0, 180.0, 90.0)], MS_2018, MS_2019 - 1))

    per_query = []
    for kind, boxes, lo, hi in qs:
        two_phase = idx._capacity >= z3mod.TWO_PHASE_MIN_CAPACITY
        # the host planning alone, timed apart (the query plans again)
        t0 = time.perf_counter()
        z3mod.plan_z3_query(boxes, *idx._clamp_time(lo, hi), idx.period,
                            sfc=idx.sfc)
        plan_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got = idx.query(boxes, lo, hi)
        ms = (time.perf_counter() - t0) * 1e3
        want = oracle(x, y, t, boxes, lo, hi)
        if not np.array_equal(got, want):
            raise AssertionError(
                f"{kind} query {boxes} [{lo}, {hi}]: {len(got)} hits, "
                f"oracle {len(want)}")
        per_query.append({"kind": kind, "ms": ms, "plan_ms": plan_ms,
                          "hits": int(len(got)),
                          "two_phase": two_phase,
                          "capacity_after": idx._capacity})
    if not any(q["two_phase"] for q in per_query):
        raise AssertionError("no query took the two-phase path")
    lat = np.array([q["ms"] for q in per_query])
    report["index"]["queries"] = per_query
    report["index"]["query_ms_p50"] = float(np.median(lat))
    report["index"]["query_ms_max"] = float(lat.max())
    log(f"index: {len(qs)} queries equal to the oracle; p50 "
        f"{np.median(lat):.3f} ms, max {lat.max():.3f} ms; two-phase "
        f"{sum(q['two_phase'] for q in per_query)}; hits "
        f"{[q['hits'] for q in per_query]}")
    if args.profile:
        report["index"]["profile"] = profile_queries(
            "z3", lambda q: idx.query(q[1], q[2], q[3]), qs)
    del idx
    torch.cuda.empty_cache()
    return x, y, m, qs


def z2_index_phase(args, x, y, m, qs, dev, report):
    """``Z2PointIndex`` over the z3 phase's points: build, the same
    append, the queries' boxes without their times, one ``query_many``
    and the world density grid, each equal to a numpy oracle."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.index.z2 import Z2PointIndex

    n = len(x) - m
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = Z2PointIndex.build(x[:n], y[:n], device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.append(x[n:], y[n:])
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    if len(idx) != n + m:
        raise AssertionError(f"z2 index holds {len(idx)} rows, not {n + m}")
    rep = report["z2_index"] = {
        "points": n, "build_s": build_s, "build_keys_per_s": n / build_s,
        "append_rows": m, "append_s": append_s,
        "append_keys_per_s": m / append_s, "capacity": int(idx.z.shape[0]),
        "resident_bytes": sum(int(c.numel() * c.element_size())
                              for c in (idx.z, idx.pos, idx.x, idx.y)),
        "peak_device_bytes": int(torch.cuda.max_memory_allocated())}
    log(f"z2 index: built {n} keys in {build_s:.3f} s "
        f"({n / build_s:.4g} keys/s); appended {m} in {append_s:.3f} s "
        f"({m / append_s:.4g} keys/s); capacity {idx.z.shape[0]}")

    per_query = []
    for kind, boxes, _, _ in qs:
        t0 = time.perf_counter()
        got = idx.query(boxes)
        ms = (time.perf_counter() - t0) * 1e3
        want = box_oracle(x, y, boxes)
        if not np.array_equal(got, want):
            raise AssertionError(f"z2 {kind} query {boxes}: {len(got)} "
                                 f"hits, oracle {len(want)}")
        per_query.append({"kind": kind, "ms": ms, "hits": int(len(got)),
                          "capacity_after": idx._capacity})
    lat = np.array([q["ms"] for q in per_query])
    rep.update(queries=per_query, query_ms_p50=float(np.median(lat)),
               query_ms_max=float(lat.max()))
    log(f"z2 index: {len(qs)} BBOX queries equal to the oracle; p50 "
        f"{np.median(lat):.3f} ms, max {lat.max():.3f} ms; hits "
        f"{[q['hits'] for q in per_query]}")

    sets = [q[1] for q in qs[:2]] + [q[1] for q in qs[8:10]]
    t0 = time.perf_counter()
    many = idx.query_many(sets)
    many_ms = (time.perf_counter() - t0) * 1e3
    for boxes, got in zip(sets, many):
        if not np.array_equal(got, box_oracle(x, y, boxes)):
            raise AssertionError(f"z2 query_many set {boxes} disagrees "
                                 "with the oracle")
    t0 = time.perf_counter()
    grid = idx.density_world(1024, 512)
    world_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(grid, snap_counts(x, y, WORLD, 1024, 512)):
        raise AssertionError("z2 density_world disagrees with the numpy "
                             "histogram")
    rep.update(query_many_ms=many_ms, density_world_ms=world_ms)
    log(f"z2 index: query_many of {len(sets)} box sets {many_ms:.1f} ms "
        f"and density_world(1024, 512) {world_ms:.1f} ms, equal to the "
        "oracle")
    if args.profile:
        rep["profile"] = profile_queries("z2", lambda q: idx.query(q[1]), qs)
    del idx
    torch.cuda.empty_cache()


def profile_queries(label: str, run, qs) -> dict:
    """One more pass over the queries (``run(q)`` runs one) under
    ``torch.profiler``: wall time, device time (its sum and share of the
    wall), and the kernels that took the most device time.  These
    queries' launches count with the main path's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in qs:
            run(q)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): an aten op's own row
    # repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    out = {"queries": len(qs), "wall_ms": wall_ms, "device_ms": device_ms,
           "device_busy_share": device_ms / wall_ms,
           "top": [{"name": e.key[:80], "calls": e.count,
                    "device_ms": e.self_device_time_total / 1e3}
                   for e in top]}
    log(f"profile {label}: {len(qs)} queries, wall {wall_ms:.1f} ms, device "
        f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}% busy); top: "
        + ", ".join(f"{t['name'][:40]} {t['device_ms']:.2f} ms x{t['calls']}"
                    for t in out["top"][:5]))
    return out


def facade_phase(rng, args, centres, dev, report):
    import numpy as np
    from geomesa_tpu_torch import TpuDataStore, density_process
    from geomesa_tpu_torch.index.pyramid import tile_env
    from geomesa_tpu_torch.ops.density_kernel import density_grid_kernel
    from geomesa_tpu_torch.ops.z2_mask import z2_mask
    from geomesa_tpu_torch.ops.z3_mask import z3_mask

    ds = TpuDataStore(device=dev)
    ds.create_schema("gdelt", "actor:String,dtg:Date,*geom:Point")
    actors = np.array(["USA", "GBR", "FRA", "CHN", "IND", "BRA", "RUS"],
                      dtype=object)
    n = args.facade_rows
    per = n // 4
    xs, ys, ts = [], [], []
    cx, cy = centres[3]
    box = (cx - 5, cy - 5, cx + 5, cy + 5)
    bx2, by2 = centres[4]
    box2 = (bx2 - 2, by2 - 2, bx2 + 2, by2 + 2)
    w1 = (MS_2018 + 40 * DAY, MS_2018 + 47 * DAY - 1)
    w2 = (MS_2018 + 200 * DAY, MS_2018 + 203 * DAY - 1)

    def bbox(b):
        return f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"

    q_and = f"{bbox(box)} AND dtg DURING {iso(w1[0])}/{iso(w1[1])}"
    q_or = (f"{bbox(box)} AND (dtg DURING {iso(w1[0])}/{iso(w1[1])} OR dtg "
            f"DURING {iso(w2[0])}/{iso(w2[1])})")
    q_bbox = bbox(box)
    q_bbox_or = f"{bbox(box)} OR {bbox(box2)}"
    launches0 = (z3_mask.launches, z2_mask.launches)
    write_s = []
    for i in range(4):
        x, y, t = gdelt_like(rng, per, centres)
        xs.append(x), ys.append(y), ts.append(t)
        t0 = time.perf_counter()
        ds.write("gdelt", {"actor": actors[rng.integers(0, len(actors), per)],
                           "dtg": t, "geom": (x, y)})
        write_s.append(time.perf_counter() - t0)
        if i == 0:  # builds the z3 and z2 indexes: later writes append
            ds.query_result("gdelt", q_and)
            ds.query_result("gdelt", q_bbox)
    x, y, t = (np.concatenate(p) for p in (xs, ys, ts))
    store = ds._store("gdelt")
    if (store.build_counts != {"z3": 1, "z2": 1}
            or len(store.z3_index()) != 4 * per
            or len(store.z2_index()) != 4 * per):
        raise AssertionError(f"indexes not appended to: "
                             f"{store.build_counts}")
    checks = [
        ("bbox_during", q_and, "z3", oracle(x, y, t, [box], *w1)),
        ("bbox_or_during", q_or, "z3",
         np.union1d(oracle(x, y, t, [box], *w1),
                    oracle(x, y, t, [box], *w2))),
        ("bbox", q_bbox, "z2", box_oracle(x, y, [box])),
        ("bbox_or_bbox", q_bbox_or, "z2", box_oracle(x, y, [box, box2])),
        ("include", "INCLUDE", "full", np.arange(4 * per)),
    ]
    rows = []
    for name, ecql, strategy, want in checks:
        t0 = time.perf_counter()
        res = ds.query_result("gdelt", ecql)
        ms = (time.perf_counter() - t0) * 1e3
        if res.strategy.index != strategy:
            raise AssertionError(f"{name}: strategy {res.strategy.index}, "
                                 f"expected {strategy}")
        if name == "bbox_or_bbox" and len(res.strategy.geometries) != 2:
            raise AssertionError("the OR of two BBOXes is not one z2 scan")
        if not np.array_equal(res.positions, want):
            raise AssertionError(f"{name}: {len(res.positions)} hits, "
                                 f"oracle {len(want)}")
        rows.append({"query": name, "ms": ms, "hits": int(len(want)),
                     "plan_ms": res.plan_time_ms,
                     "scan_ms": res.scan_time_ms})
    grew = (z3_mask.launches - launches0[0], z2_mask.launches - launches0[1])
    if min(grew) <= 0:
        raise AssertionError(f"z3_mask/z2_mask launches in the facade phase: "
                             f"{grew}")

    # heatmaps through density_process and density_tile, each against a
    # numpy histogram of the oracle's hits
    d0 = density_grid_kernel.launches
    tx = int((cx + 180.0) // 45.0)
    ty = 7 - int((cy + 90.0) // 22.5)
    tenv = tile_env(3, tx, ty)
    dens = [
        ("bbox_during", lambda: density_process(ds, "gdelt", q_and, box),
         box, oracle(x, y, t, [box], *w1)),
        ("bbox", lambda: density_process(ds, "gdelt", q_bbox, box),
         box, box_oracle(x, y, [box])),
        ("include", lambda: density_process(ds, "gdelt", "INCLUDE", WORLD),
         WORLD, None),
        (f"tile_3_{tx}_{ty}", lambda: ds.density_tile("gdelt", 3, tx, ty),
         tenv, box_oracle(x, y, [tenv])),
    ]
    drows = []
    for name, run, env, hits in dens:
        t0 = time.perf_counter()
        grid = run()
        ms = (time.perf_counter() - t0) * 1e3
        want = (snap_counts(x, y, env, 256, 256) if hits is None
                else snap_counts(x[hits], y[hits], env, 256, 256))
        if grid.shape != (256, 256) or not np.array_equal(
                grid.astype(np.float64), want.astype(np.float32)):
            raise AssertionError(f"density {name}: grid disagrees with the "
                                 f"oracle ({float(grid.sum())} against "
                                 f"{float(want.sum())} points)")
        drows.append({"query": name, "ms": ms, "points": float(want.sum()),
                      "dtype": str(grid.dtype)})
    dgrew = density_grid_kernel.launches - d0
    if dgrew != len(dens):
        raise AssertionError(f"density_grid launched {dgrew} times for "
                             f"{len(dens)} heatmaps")
    report["facade"] = {"rows": 4 * per, "write_s": write_s,
                        "write_rows_per_s": [per / s for s in write_s],
                        "queries": rows, "density": drows,
                        "z3_mask_launches": grew[0],
                        "z2_mask_launches": grew[1],
                        "density_grid_launches": dgrew}
    log(f"facade: {4 * per} rows in 4 writes "
        f"({', '.join(f'{s:.2f}' for s in write_s)} s); queries equal to "
        f"the oracle: " + ", ".join(f"{r['query']} {r['hits']} hits "
                                    f"{r['ms']:.1f} ms" for r in rows)
        + "; heatmaps equal to the oracle: "
        + ", ".join(f"{r['query']} {r['points']:.0f} points {r['ms']:.1f} ms"
                    for r in drows)
        + f"; launches z3_mask {grew[0]}, z2_mask {grew[1]}, density_grid "
          f"{dgrew}")
    return ds


def places_phase(rng, args, centres, ds, report):
    """A point schema without a dtg: it stays on the default profile and
    answers BBOX queries (one box, an OR of two) through z2."""
    import numpy as np

    ds.create_schema("places", "name:String,*geom:Point")
    names = np.array(["cafe", "school", "park", "station"], dtype=object)
    n = args.places_rows
    xs, ys = [], []
    cx, cy = centres[5]
    box = (cx - 3, cy - 3, cx + 3, cy + 3)
    bx2, by2 = centres[6]
    box2 = (bx2 - 1, by2 - 1, bx2 + 1, by2 + 1)
    write_s = []
    for i in range(2):
        x, y, _ = gdelt_like(rng, n // 2, centres)
        xs.append(x), ys.append(y)
        t0 = time.perf_counter()
        ds.write("places", {"name": names[rng.integers(0, len(names),
                                                      n // 2)],
                            "geom": (x, y)})
        write_s.append(time.perf_counter() - t0)
        if i == 0:  # builds the z2 index: the second write appends
            ds.query_result("places", f"BBOX(geom, {box[0]}, {box[1]}, "
                                      f"{box[2]}, {box[3]})")
    x, y = np.concatenate(xs), np.concatenate(ys)
    if ds._store("places").build_counts != {"z2": 1}:
        raise AssertionError("places: the z2 index was rebuilt")
    rows = []
    for name, boxes in (("bbox", [box]), ("bbox_small", [box2]),
                        ("bbox_or_bbox", [box, box2])):
        ecql = " OR ".join(f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"
                           for b in boxes)
        t0 = time.perf_counter()
        res = ds.query_result("places", ecql)
        ms = (time.perf_counter() - t0) * 1e3
        want = box_oracle(x, y, boxes)
        if res.strategy.index != "z2":
            raise AssertionError(f"places {name}: strategy "
                                 f"{res.strategy.index}, expected z2")
        if not np.array_equal(res.positions, want):
            raise AssertionError(f"places {name}: {len(res.positions)} "
                                 f"hits, oracle {len(want)}")
        rows.append({"query": name, "ms": ms, "hits": int(len(want))})
    report["places"] = {"rows": len(x), "write_s": write_s, "queries": rows}
    log(f"places: {len(x)} rows without a dtg in 2 writes "
        f"({', '.join(f'{s:.2f}' for s in write_s)} s); z2 queries equal to "
        f"the oracle: " + ", ".join(f"{r['query']} {r['hits']} hits "
                                    f"{r['ms']:.1f} ms" for r in rows))


def serving_windows(rng, centres, n: int, n_untimed: int) -> list:
    """``n`` tile-server-like windows around the city ``centres``: boxes
    of 0.5-4 degrees (every fourth window an OR of two), the first
    ``n - n_untimed`` with a 1-14 day interval in 2018, the rest untimed.
    The order interleaves the two kinds."""
    wins = []
    for i in range(n):
        boxes = []
        for _ in range(2 if i % 4 == 3 else 1):
            cx, cy = centres[rng.integers(0, len(centres))]
            h = float(rng.uniform(0.25, 2.0))
            boxes.append((float(cx) - h, float(cy) - h, float(cx) + h,
                          float(cy) + h))
        if i < n - n_untimed:
            lo = MS_2018 + int(rng.integers(0, 350)) * DAY
            wins.append((boxes, lo,
                         lo + int(rng.integers(1, 15)) * DAY - 1))
        else:
            wins.append((boxes, None, None))
    order = rng.permutation(n)
    return [wins[i] for i in order]


def _window_filter(boxes, lo, hi):
    from geomesa_tpu_torch.filters.ast import And, BBox, During, Or
    parts = [BBox("geom", *b) for b in boxes]
    f = parts[0] if len(parts) == 1 else Or(tuple(parts))
    return f if lo is None else And((f, During("dtg", lo, hi)))


def _p50(values) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, np.float64), 50))


def serving_phase(args, centres, ds, report):
    """The serving plane on the facade's ``gdelt`` store: 64 batched
    windows (48 timed, 16 untimed) through ``query_windows``, each equal
    to the oracle and to its own ``query_result``; a tile under a
    deadline; an expired deadline that must raise and a partial one that
    must come back flagged."""
    import numpy as np
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.index.pyramid import tile_env
    from geomesa_tpu_torch.metrics import registry
    from geomesa_tpu_torch.resilience import QueryTimeout, admission_gate

    srng = np.random.default_rng(args.seed + 14)
    store = ds._store("gdelt")
    x, y = store.batch.geom_xy()
    t = store.batch.column("dtg")
    wins = serving_windows(srng, centres, 64, 16)
    w0 = registry.counter("query.gdelt.windows").count
    batch_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        hits = ds.query_windows("gdelt", wins)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    if registry.counter("query.gdelt.windows").count - w0 != 5 * len(wins):
        raise AssertionError("query.gdelt.windows did not count every "
                             "window")
    solo_ms = []
    n_hits = 0
    for i, (boxes, lo, hi) in enumerate(wins):
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        t0 = time.perf_counter()
        solo = ds.query_result("gdelt", Query.of(_window_filter(boxes, lo,
                                                                hi)))
        solo_ms.append((time.perf_counter() - t0) * 1e3)
        if not (np.array_equal(hits[i], want)
                and np.array_equal(solo.positions, want)):
            raise AssertionError(
                f"serving window {i}: {len(hits[i])} batched hits, "
                f"{len(solo.positions)} solo, oracle {len(want)}")
        n_hits += len(want)
    if admission_gate.inflight != 0:
        raise AssertionError("admission tokens leaked by query_windows")
    # a tile under a generous deadline, against the snap oracle
    cx, cy = centres[7]
    tx = int((cx + 180.0) // 22.5)
    ty = 15 - int((cy + 90.0) // 11.25)
    tenv = tile_env(4, tx, ty)
    t0 = time.perf_counter()
    grid = ds.density_tile("gdelt", 4, tx, ty, timeout_ms=60_000.0)
    tile_ms = (time.perf_counter() - t0) * 1e3
    tw = box_oracle(x, y, [tenv])
    want = snap_counts(x[tw], y[tw], tenv, 256, 256)
    if grid.shape != (256, 256) or not np.array_equal(
            grid.astype(np.float64), want.astype(np.float32)):
        raise AssertionError(f"serving tile: {float(grid.sum())} points "
                             f"against {float(want.sum())}")
    # an expired deadline raises; a partial one comes back flagged, its
    # hits a subset of the oracle's
    boxes, lo, hi = next(w for w in wins if w[1] is not None)
    q = Query.of(_window_filter(boxes, lo, hi))
    t0_timeouts = registry.counter("query.timeout").count
    try:
        ds.query_result("gdelt", q, timeout_ms=1e-6)
        raise AssertionError("an expired deadline did not raise")
    except QueryTimeout:
        pass
    part = ds.query_result("gdelt", q, timeout_ms=1e-6,
                           partial_results=True)
    if not part.timed_out or not np.isin(
            part.positions, oracle(x, y, t, boxes, lo, hi)).all():
        raise AssertionError(f"the partial result: timed_out "
                             f"{part.timed_out}, {len(part.positions)} hits")
    if registry.counter("query.timeout").count - t0_timeouts != 2:
        raise AssertionError("query.timeout did not count both expiries")
    if admission_gate.inflight != 0:
        raise AssertionError("admission tokens leaked by the deadlines")
    report["serving"] = {
        "windows": len(wins), "timed": 48, "untimed": 16, "hits": n_hits,
        "batch_ms": batch_ms, "batch_p50_ms": _p50(batch_ms),
        "solo_ms_sum": float(sum(solo_ms)),
        "solo_p50_ms": _p50(solo_ms), "tile_ms": tile_ms,
        "partial_hits": int(len(part.positions))}
    log(f"serving: 64 windows (48 timed, 16 untimed, {n_hits} hits) equal "
        f"to the oracle and to their solo queries; query_windows p50 "
        f"{_p50(batch_ms):.1f} ms a batch, solo sum "
        f"{sum(solo_ms):.1f} ms (p50 {_p50(solo_ms):.1f} ms a window); "
        f"tile under a deadline {tile_ms:.1f} ms; an expired deadline "
        f"raised, a partial one came back flagged "
        f"({len(part.positions)} hits)")


def serving_fused_part(args, centres, ds, name: str, cols, report):
    """32 threads over 4 tenants calling ``query_fused`` on the lean
    store at once: each result equal to its solo ``query_result``, more
    fused requests than batches, no token left in flight."""
    import threading

    import numpy as np
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.metrics import registry
    from geomesa_tpu_torch.resilience import admission_gate

    srng = np.random.default_rng(args.seed + 15)
    wins = serving_windows(srng, centres, 32, 8)
    queries = [Query.of(_window_filter(*w)) for w in wins]
    solo, solo_ms = [], []
    for q in queries:
        t0 = time.perf_counter()
        solo.append(ds.query_result(name, q).positions)
        solo_ms.append((time.perf_counter() - t0) * 1e3)
    x, y, t = cols
    for w, s in zip(wins, solo[:4]):
        want = (box_oracle(x, y, w[0]) if w[1] is None
                else oracle(x, y, t, *w))
        if not np.array_equal(s, want):
            raise AssertionError("lean solo query disagrees with the oracle")
    b0 = registry.counter("serving.fused.batches").count
    r0 = registry.counter("serving.fused.requests").count
    out = [None] * len(queries)
    ms = [0.0] * len(queries)
    errs = []
    gate = threading.Barrier(len(queries))

    def run(i):
        try:
            gate.wait()
            t0 = time.perf_counter()
            out[i] = ds.query_fused(name, queries[i], tenant=f"t{i % 4}")
            ms[i] = (time.perf_counter() - t0) * 1e3
        except BaseException as e:    # re-raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(queries))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if errs:
        raise errs[0]
    batches = registry.counter("serving.fused.batches").count - b0
    requests = registry.counter("serving.fused.requests").count - r0
    for i, (r, s) in enumerate(zip(out, solo)):
        if r.strategy.index != "fused" or not np.array_equal(r.positions,
                                                             s):
            raise AssertionError(f"fused request {i}: {r.strategy.index}, "
                                 f"{len(r.positions)} hits, solo {len(s)}")
    if requests != len(queries) or requests <= batches:
        raise AssertionError(f"fusion: {requests} requests in {batches} "
                             f"batches")
    if admission_gate.inflight != 0 or ds._fusion.queued != 0:
        raise AssertionError("fused requests left tokens or riders behind")
    report.setdefault("serving", {})["fused"] = {
        "requests": requests, "batches": batches,
        "batches_per_request": batches / requests,
        "p50_ms": _p50(ms), "max_ms": max(ms), "wall_ms": wall_ms,
        "solo_ms_sum": float(sum(solo_ms)), "solo_p50_ms": _p50(solo_ms),
        "hits": int(sum(len(s) for s in solo))}
    log(f"serving: 32 fused requests over 4 tenants on {len(t)} lean rows "
        f"equal to their solo queries; {batches} batches for {requests} "
        f"requests (ratio {batches / requests:.3f}); fused p50 "
        f"{_p50(ms):.1f} ms, all done in {wall_ms:.1f} ms; the 32 solo "
        f"one after another {sum(solo_ms):.1f} ms (p50 "
        f"{_p50(solo_ms):.1f} ms)")



def _bbox_ecql(boxes) -> str:
    """The ECQL of an OR of BBOXes."""
    parts = [f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})" for b in boxes]
    return parts[0] if len(parts) == 1 else "(" + " OR ".join(parts) + ")"


def _ecql(boxes, lo, hi) -> str:
    """The ECQL of a ``(boxes, lo, hi)`` window: an OR of BBOXes AND the
    inclusive DURING."""
    return f"{_bbox_ecql(boxes)} AND dtg DURING {iso(lo)}/{iso(hi)}"


def trace_reading(qs, ds, report, reps: int = 3):
    """The trace layer on the facade's ``gdelt`` store: the index phase's
    20 queries as BBOX+DURING ECQL, run in turns under
    ``sampler=always`` and ``sampler=never`` (never, always, always,
    never, ...), each query's p50 over ``reps`` turns of each; the spans
    a traced query records and the sum of its ``device_ms`` against its
    wall time; the audit's ``trace_id``; and one ``explain_analyze``
    whose actual rows equal the query's hits."""
    import numpy as np
    from geomesa_tpu_torch.audit import InMemoryAuditWriter
    from geomesa_tpu_torch.config import clear_property, set_property
    from geomesa_tpu_torch.obs import tracer

    qsql = [_ecql(boxes, lo, hi) for _, boxes, lo, hi in qs]
    audit = InMemoryAuditWriter()
    ds._audit_writer = audit
    wall = {"always": [[] for _ in qsql], "never": [[] for _ in qsql]}
    spans, dev_ms, root_ms, hits = [], [], [], []
    try:
        for turn in range(2 * reps):
            kind = ("never", "always")[(turn + turn // 2) % 2]
            set_property("geomesa.obs.sampler", kind)
            for i, q in enumerate(qsql):
                t0 = time.perf_counter()
                if kind == "always":
                    with tracer.capture() as cap:
                        res = ds.query_result("gdelt", q)
                else:
                    res = ds.query_result("gdelt", q)
                wall[kind][i].append((time.perf_counter() - t0) * 1e3)
                if kind == "always" and turn == 1:
                    tr = cap.traces()[-1]
                    spans.append(len(tr.spans))
                    dev_ms.append(tr.root_span.attributes.get("device_ms",
                                                              0.0))
                    root_ms.append(tr.duration_ms)
                    hits.append(int(len(res.positions)))
                    ev = audit.query_events("gdelt")[-1]
                    if not ev.trace_id or ev.trace_id != tr.trace_id:
                        raise AssertionError(
                            f"audit trace id {ev.trace_id!r} against the "
                            f"query's trace {tr.trace_id!r}")
                if kind == "never" and audit.query_events(
                        "gdelt")[-1].trace_id:
                    raise AssertionError("an unsampled query stamped a "
                                         "trace id")
        set_property("geomesa.obs.sampler", "never")
        # EXPLAIN ANALYZE records whatever the sampler says
        k = int(np.argmax(hits))
        ea = ds.explain_analyze("gdelt", qsql[k])
        s = ea.summary
        if not (s["actual_matched"] == s["hits"] == hits[k]):
            raise AssertionError(f"explain_analyze: {s['actual_matched']} "
                                 f"matched, {s['hits']} hits, the query "
                                 f"{hits[k]}")
    finally:
        clear_property("geomesa.obs.sampler")
        ds._audit_writer = None
    p50 = {kind: float(np.median([np.median(v) for v in w]))
           for kind, w in wall.items()}
    sums = {kind: float(sum(np.median(v) for v in w))
            for kind, w in wall.items()}
    rep = {"queries": len(qsql), "reps": reps, "p50_ms": p50,
           "sum_of_p50_ms": sums, "spans_per_query": spans,
           "device_ms": dev_ms, "root_ms": root_ms, "hits": hits,
           "device_share": float(sum(dev_ms) / max(sum(root_ms), 1e-9)),
           "explain_analyze": {"query": k, "strategy": s.get("strategy"),
                               "estimate_rows": s.get("estimate_rows"),
                               "actual_scanned": s.get("actual_scanned"),
                               "actual_matched": s.get("actual_matched"),
                               "device_ms": s.get("device_ms"),
                               "wall_ms": ea.wall_ms,
                               "tree_spans": len(ea.trace.spans)}}
    report["trace"] = rep
    log(f"trace: {len(qsql)} queries, p50 {p50['always']:.2f} ms traced "
        f"against {p50['never']:.2f} ms untraced (sums of the per-query "
        f"p50s {sums['always']:.1f} / {sums['never']:.1f} ms); "
        f"{min(spans)}-{max(spans)} spans a query; device_ms "
        f"{sum(dev_ms):.1f} of {sum(root_ms):.1f} ms of traced wall "
        f"({rep['device_share']:.1%}); audit trace ids set; "
        f"explain_analyze {s['actual_matched']} rows matched = hits, "
        f"{len(ea.trace.spans)} spans, {ea.wall_ms:.1f} ms")


def resilience_phase(rng, args, centres, dev, report):
    """Degraded execution, the fault catalog and storage accounting on a
    lean store of its own: ``--res-rows`` GDELT-like rows at
    ``--res-slots``-slot generations under a budget that leaves one full,
    three keys and the rest host generations.  In order, each answer
    against its numpy oracle: the storage report (accounted device bytes
    reconciled with the actual tensor bytes, ``memory_allocated`` beside
    them) and the admission gate shedding on the published gauge; an
    injected ``device.dispatch:1=oom`` (the full generation demoted and
    answered from the host tier, counted and flagged on its span); an
    injected ``device.dispatch=error`` raising ``FaultInjected``; a
    breaker at threshold 1 routing a generation to the host tier; one
    real ``torch.OutOfMemoryError`` (the caching allocator capped just
    above what it holds) classified transient and answered from the host
    tier (the western hemisphere over the year, pinned to z3); then
    ``ingest.append``, ``host.spill``, ``pyramid.build`` and
    ``compaction.merge_step`` armed once each, the store queryable and
    equal to its oracle after each."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore
    from geomesa_tpu_torch import metrics as tmetrics
    from geomesa_tpu_torch.config import clear_property, set_property
    from geomesa_tpu_torch.obs import publish_storage_gauges, tracer
    from geomesa_tpu_torch.planning import Query
    from geomesa_tpu_torch.resilience import (
        Backpressure, FaultInjected, admission_gate, breaker,
    )

    cuda = dev.type == "cuda"
    slots, n = args.res_slots, args.res_rows
    # one full generation (40 B a slot), three keys ones (16 B) and the
    # sentinel charges (16 + 40 B): 144 B a slot; a fourth keys one: 160
    budget = 148 * slots
    ds = TpuDataStore(device=dev)
    ds.create_schema("res", "dtg:Date,*geom:Point;geomesa.index.profile=lean,"
                     f"geomesa.lean.generation.slots={slots},"
                     f"geomesa.lean.hbm.budget={budget},"
                     "geomesa.lean.compaction.factor=0")
    store = ds._store("res")
    xs, ys, ts = [], [], []
    t0 = time.perf_counter()
    for lo in range(0, n, 1 << 21):
        x, y, t = gdelt_like(rng, min(1 << 21, n - lo), centres)
        ds.write("res", {"dtg": t, "geom": (x, y)})
        xs.append(x), ys.append(y), ts.append(t)
    idx = store.z3_index()
    idx.block()
    write_s = time.perf_counter() - t0
    x, y, t = (np.concatenate(p) for p in (xs, ys, ts))
    del xs, ys, ts
    tiers0 = idx.tier_counts()
    if tiers0.get("full") != 1 or tiers0.get("keys") != 3 \
            or not tiers0.get("host"):
        raise AssertionError(f"resilience store tiers {tiers0}")
    # a city box over two months (every generation holds every month)
    cx, cy = centres[5]
    box = (cx - 3.0, cy - 3.0, cx + 3.0, cy + 3.0)
    # whole seconds: the ECQL's DURING bounds carry no milliseconds
    lo_t, hi_t = MS_2018 + 60 * DAY, MS_2018 + 120 * DAY - 1000
    q = _ecql([box], lo_t, hi_t)
    want = oracle(x, y, t, [box], lo_t, hi_t)
    # the real OOM's query: the western hemisphere over the year, so each
    # keys generation's gather needs allocations of several MiB (a new
    # large segment of the caching allocator); pinned to the z3 index
    # (the estimator would cost a full scan cheaper)
    big = (-180.0, -90.0, 0.0, 90.0)
    big_lo, big_hi = MS_2018, MS_2019 - 1000
    q_big = Query.of(_ecql([big], big_lo, big_hi),
                     hints={"QUERY_INDEX": "z3"})
    want_big = oracle(x, y, t, [big], big_lo, big_hi)
    reg = tmetrics.registry
    names = ("resilience.degraded", "resilience.retries",
             "resilience.breaker.open", "resilience.faults.injected")

    def counts():
        return {k: reg.counter(k).count for k in names}

    def check(label, query=None, expect=None):
        if query is None:   # the city query, against its current oracle
            query, expect = q, want
        t0 = time.perf_counter()
        res = ds.query_result("res", query)
        ms = (time.perf_counter() - t0) * 1e3
        if res.strategy.index != "z3":
            raise AssertionError(f"resilience {label}: strategy "
                                 f"{res.strategy.index}, not z3")
        if not np.array_equal(res.positions, expect):
            raise AssertionError(f"resilience {label}: {len(res.positions)} "
                                 f"hits, oracle {len(expect)}")
        return ms

    rep = {"rows": n, "slots": slots, "budget_bytes": budget,
           "write_s": write_s, "tiers": tiers0, "hits": int(len(want)),
           "big_hits": int(len(want_big))}
    normal = [check("baseline") for _ in range(3)]
    rep["normal_ms"] = normal

    # the storage reading, and the admission gate shedding on its gauge
    sr = ds.storage_report()
    rec = sr["reconciliation"]
    if not rec["within_tolerance"]:
        raise AssertionError(f"storage report out of tolerance: {rec}")
    allocated = int(torch.cuda.memory_allocated(dev)) if cuda else None
    rep["storage"] = {"accounted_device_bytes": sr["totals"]["device_bytes"],
                      "actual_device_bytes":
                          sr["actual_totals"]["device_bytes"],
                      "accounted_host_bytes": sr["totals"]["host_bytes"],
                      "actual_host_bytes": sr["actual_totals"]["host_bytes"],
                      "batch_bytes": sr["totals"]["batch_bytes"],
                      "memory_allocated": allocated,
                      "device_delta_pct": rec["device"]["delta_pct"],
                      "host_delta_pct": rec["host"]["delta_pct"]}
    gauge = publish_storage_gauges(ds)["totals"]["device_bytes"]
    admission_gate.reset()
    set_property("geomesa.resilience.hbm.headroom", int(gauge) - 1)
    set_property("geomesa.resilience.admission.queue.ms", 1.0)
    try:
        ds.query_result("res", q)
        raise AssertionError("the admission gate admitted a query over "
                             "its device-bytes headroom")
    except Backpressure:
        pass
    finally:
        clear_property("geomesa.resilience.hbm.headroom")
        clear_property("geomesa.resilience.admission.queue.ms")
        admission_gate.reset()
    log(f"resilience: {n} rows at {slots}-slot generations in "
        f"{write_s:.2f} s, tiers {tiers0}; query {len(want)} hits p50 "
        f"{np.median(normal):.1f} ms; storage accounted device "
        f"{rep['storage']['accounted_device_bytes']} B, actual tensors "
        f"{rep['storage']['actual_device_bytes']} B, memory_allocated "
        f"{allocated} B (host {rep['storage']['accounted_host_bytes']} "
        f"accounted, {rep['storage']['actual_host_bytes']} actual); the "
        f"gate shed at a headroom below the {int(gauge)} B gauge")

    try:
        # an injected transient failure: the first device group (the
        # full generation) degrades to the host tier
        c0 = counts()
        set_property("geomesa.resilience.fault.points",
                     "device.dispatch:1=oom")
        with tracer.capture() as cap:
            rep["degraded_ms"] = check("injected oom")
        clear_property("geomesa.resilience.fault.points")
        d = {k: v - c0[k] for k, v in counts().items()}
        # flagged True, then counted: the JAX package's obs_count mirrors
        # the degraded-generation count onto the same attribute
        flagged = [s for tr in cap.traces() for s in tr.spans
                   if s.name == "query.scan.degraded"
                   and s.attributes.get("resilience.degraded")]
        if (d["resilience.degraded"] < 1 or d["resilience.retries"] < 1
                or not flagged):
            raise AssertionError(f"injected oom: counters {d}, "
                                 f"{len(flagged)} flagged spans")
        rep["degraded"] = {"counters": d, "tiers": idx.tier_counts(),
                           "span_ms": flagged[0].duration_ms}

        # poison propagates
        set_property("geomesa.resilience.fault.points",
                     "device.dispatch=error")
        try:
            ds.query_result("res", q)
            raise AssertionError("an injected poison fault did not reach "
                                 "the caller")
        except FaultInjected:
            pass
        clear_property("geomesa.resilience.fault.points")

        # the breaker at threshold 1: a generation with a recorded
        # failure goes to the host tier without a device attempt
        set_property("geomesa.resilience.breaker.threshold", 1)
        gen = next(g for g in idx.generations if g.tier == "keys")
        breaker.record_failure((id(idx), gen.gen_id))
        c0 = counts()
        rep["breaker_ms"] = check("breaker")
        d = {k: v - c0[k] for k, v in counts().items()}
        if d["resilience.breaker.open"] < 1 or gen.tier != "host":
            raise AssertionError(f"breaker: counters {d}, tier {gen.tier}")
        clear_property("geomesa.resilience.breaker.threshold")
        breaker.reset()
        rep["breaker"] = {"counters": d, "tiers": idx.tier_counts()}

        # one real device-memory failure: the caching allocator capped
        # just above what it holds, so the keys tier's gather cannot
        # reserve a new segment
        real = None
        if cuda:
            rep["big_ms"] = check("before the cap", q_big, want_big)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            total = torch.cuda.get_device_properties(dev).total_memory
            reserved = torch.cuda.memory_reserved(dev)
            torch.cuda.set_per_process_memory_fraction(
                (reserved + (4 << 20)) / total, dev)
            c0 = counts()
            keys_before = sum(1 for g in idx.generations
                              if g.tier == "keys")
            try:
                with tracer.capture() as cap:
                    real_ms = check("real oom", q_big, want_big)
            finally:
                torch.cuda.set_per_process_memory_fraction(1.0, dev)
            d = {k: v - c0[k] for k, v in counts().items()}
            flagged = [s for tr in cap.traces() for s in tr.spans
                       if s.name == "query.scan.degraded"]
            if d["resilience.degraded"] < 1 or not flagged:
                raise AssertionError(
                    f"real oom: no degraded generation (counters {d}); the "
                    f"cap at {reserved + (4 << 20)} B did not bite")
            real = {"ms": real_ms, "counters": d,
                    "keys_generations_demoted": keys_before - sum(
                        1 for g in idx.generations if g.tier == "keys"),
                    "reserved_bytes": int(reserved),
                    "reason": flagged[0].attributes.get("reason"),
                    "span_ms": flagged[0].duration_ms,
                    "tiers": idx.tier_counts()}
        rep["real_oom"] = real

        # the chaos arms, each once; the store equal to its oracle after
        chaos = {}
        m = 1 << 20
        ax, ay, at = gdelt_like(rng, m, centres)
        set_property("geomesa.resilience.fault.points", "ingest.append:1")
        try:
            ds.write("res", {"dtg": at, "geom": (ax, ay)})
            raise AssertionError("ingest.append did not fire")
        except FaultInjected:
            pass
        clear_property("geomesa.resilience.fault.points")
        check("after ingest.append")
        ds.write("res", {"dtg": at, "geom": (ax, ay)})
        x, y, t = (np.concatenate(p) for p in ((x, ax), (y, ay), (t, at)))
        want = oracle(x, y, t, [box], lo_t, hi_t)
        chaos["ingest.append"] = check("after the clean write")
        live = idx.generations[-1]
        set_property("geomesa.resilience.fault.points", "host.spill:1")
        try:
            idx._spill(live)
            raise AssertionError("host.spill did not fire")
        except FaultInjected:
            pass
        clear_property("geomesa.resilience.fault.points")
        if live.tier == "host":
            raise AssertionError("a faulted spill moved the generation")
        chaos["host.spill"] = check("after host.spill")
        set_property("geomesa.resilience.fault.points", "pyramid.build:1")
        try:
            ds.build_pyramids("res")
            raise AssertionError("pyramid.build did not fire")
        except FaultInjected:
            pass
        clear_property("geomesa.resilience.fault.points")
        chaos["pyramid.build"] = check("after pyramid.build")
        rep["pyramids_built"] = ds.build_pyramids("res")
        set_property("geomesa.resilience.fault.points",
                     "compaction.merge_step:1")
        n_gens = len(idx.generations)
        try:
            ds.compact("res")
            raise AssertionError("compaction.merge_step did not fire")
        except FaultInjected:
            pass
        clear_property("geomesa.resilience.fault.points")
        if len(idx.generations) != n_gens:
            raise AssertionError("a faulted merge step changed the runs")
        chaos["compaction.merge_step"] = check("after compaction.merge_step")
        merged = ds.compact("res")
        chaos["compacted"] = check("after compact")
        rep["chaos_ms"] = chaos
        rep["compacted"] = {"merged": merged, "tiers": idx.tier_counts()}
    finally:
        for k in ("geomesa.resilience.fault.points",
                  "geomesa.resilience.breaker.threshold"):
            clear_property(k)
        breaker.reset()
    report["resilience"] = rep
    log(f"resilience: injected oom answered exactly in "
        f"{rep['degraded_ms']:.1f} ms (the query {np.median(normal):.1f} ms; "
        f"counters {rep['degraded']['counters']}); poison raised; the "
        f"breaker's generation went to the host tier "
        f"({rep['breaker_ms']:.1f} ms); "
        + (f"real OOM answered exactly in {real['ms']:.1f} ms (uncapped "
           f"{rep['big_ms']:.1f} ms, {rep['big_hits']} hits), "
           f"{real['keys_generations_demoted']} keys generations demoted "
           f"(counters {real['counters']}); " if real else "")
        + "chaos arms: " + ", ".join(f"{k} {v:.1f} ms"
                                     for k, v in chaos.items())
        + f"; tiers now {idx.tier_counts()}")
    del ds


def mesh_phase(rng, args, centres, dev, report, arrow=None,
               analytics=None):
    """The mesh-backed store on a one-card mesh: writes, the stats
    push-down through the hist1d kernel, sharded z3/z2 queries, pushed-down
    heatmaps, and an append that moves the histograms to the int64
    route; every result against a numpy oracle over the rows.  After the
    append, ``arrow(ds, name, q, rows, hits)`` and then ``analytics(ds,
    name, rows, centre)`` run on the store."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, density_process, device_mesh
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.feature_type import parse_spec
    from geomesa_tpu_torch.index.pyramid import tile_env
    from geomesa_tpu_torch.ops.hist1d_kernel import hist1d
    from geomesa_tpu_torch.ops.z3_mask import z3_mask
    from geomesa_tpu_torch.parallel import stats as pstats
    from geomesa_tpu_torch.stats.stat import Frequency

    ds = TpuDataStore(device=dev, mesh=device_mesh(1))
    ds.create_schema("events", "actor:String,score:Double,dtg:Date,*geom:Point")
    actors = np.array(["USA", "GBR", "FRA", "CHN", "IND", "BRA", "RUS"],
                      dtype=object)
    n = args.mesh_rows
    per = n // 4
    cols = {"x": [], "y": [], "t": [], "score": [], "actor": []}
    write_s = []

    def write(m):
        x, y, t = gdelt_like(rng, m, centres)
        score = rng.uniform(0.0, 100.0, m)
        actor = actors[rng.integers(0, len(actors), m)]
        for k, v in zip(cols, (x, y, t, score, actor)):
            cols[k].append(v)
        t0 = time.perf_counter()
        ds.write("events", {"actor": actor, "score": score, "dtg": t,
                            "geom": (x, y)})
        return time.perf_counter() - t0

    for _ in range(4):  # no query between: the index builds once
        write_s.append(write(per))
    store = ds._store("events")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    z3 = store.z3_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if z3.capacity != per * 4 or not pstats._hist_kernel_ok(z3):
        raise AssertionError(f"sharded z3 built at {z3.capacity} slots")
    # the sharded z2, which the BBOX query below would build, built and
    # timed apart
    t0 = time.perf_counter()
    store.z2_index()
    torch.cuda.synchronize()
    z2_build_s = time.perf_counter() - t0

    def rows():
        return {k: np.concatenate(v) for k, v in cols.items()}

    cx, cy = centres[7]
    box = (cx - 10, cy - 10, cx + 10, cy + 10)
    w = (MS_2018 + 100 * DAY, MS_2018 + 114 * DAY - 1)
    q = (f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]}) AND dtg "
         f"DURING {iso(w[0])}/{iso(w[1])}")
    q_bbox = f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]})"
    spec = "Count();MinMax(score);Histogram(score,64,0,100)"

    def hist_oracle(score):
        b = np.clip((score - 0.0) / (100.0 / 64), 0, 63).astype(np.int64)
        return np.bincount(b, minlength=64)

    def freq_oracle(r, hits, attr):
        """The host sketch (``Frequency.observe``) over the hit rows."""
        kind = "String" if attr == "actor" else "Double"
        host = Frequency(attr, 4, 1024)
        host.observe(FeatureBatch.from_dict(
            parse_spec("f", f"{attr}:{kind},dtg:Date,*geom:Point"),
            {attr: r[attr][hits], "dtg": r["t"][hits],
             "geom": (r["x"][hits], r["y"][hits])}))
        return host.table

    stat_rows = []

    def run_stats(name, query, sp, check):
        idx = store.z3_index()
        route = "kernel" if pstats._hist_kernel_ok(idx) else "int64"
        h0 = hist1d.launches
        t0 = time.perf_counter()
        got = ds.stats("events", query, sp)
        ms = (time.perf_counter() - t0) * 1e3
        check(got)
        grew = hist1d.launches - h0
        kernel_hists = (sp.count("Histogram(") + 4 * sp.count("Frequency(")
                        if route == "kernel" else 0)
        if grew != kernel_hists:
            raise AssertionError(f"stats {name}: hist1d launched {grew} "
                                 f"times, expected {kernel_hists} ({route})")
        stat_rows.append({"stats": name, "ms": ms, "route": route,
                          "hist1d_launches": grew,
                          "slots_per_shard": idx.capacity})

    r = rows()
    hits = oracle(r["x"], r["y"], r["t"], [box], *w)

    def check_moments(hit_rows):
        def check(got):
            c, mm, h = got.stats
            sc = r["score"][hit_rows]
            if c.count != len(hit_rows) or (mm.min, mm.max) != (
                    sc.min(), sc.max()):
                raise AssertionError(f"stats: count {c.count} / minmax "
                                     f"{mm.min, mm.max}, oracle "
                                     f"{len(hit_rows)} / {sc.min(), sc.max()}")
            if not np.array_equal(h.counts, hist_oracle(sc)):
                raise AssertionError("stats: histogram disagrees with "
                                     "np.bincount")
        return check

    def check_freq(attr):
        want = freq_oracle(r, hits, attr)

        def check(got):
            if not np.array_equal(got.table, want):
                raise AssertionError(f"stats: Frequency({attr}) table "
                                     "disagrees with the host sketch")
        return check

    run_stats("bbox_during", q, spec, check_moments(hits))
    run_stats("frequency_actor", q, "Frequency(actor,4,1024)",
              check_freq("actor"))
    run_stats("frequency_score", q, "Frequency(score,4,1024)",
              check_freq("score"))
    run_stats("include", "INCLUDE", spec, check_moments(np.arange(n)))
    h0 = hist1d.launches
    t0 = time.perf_counter()
    top = ds.stats("events", q, "TopK(actor)")
    topk_ms = (time.perf_counter() - t0) * 1e3
    want_top = dict(zip(*np.unique(r["actor"][hits], return_counts=True)))
    if dict(top.topk(len(actors))) != want_top or hist1d.launches != h0:
        raise AssertionError("stats: TopK(actor) disagrees with the oracle")

    qrows = []
    for name, ecql, strategy, want in (
            ("bbox_during", q, "z3", hits),
            ("bbox", q_bbox, "z2", box_oracle(r["x"], r["y"], [box]))):
        t0 = time.perf_counter()
        res = ds.query_result("events", ecql)
        ms = (time.perf_counter() - t0) * 1e3
        if res.strategy.index != strategy or not np.array_equal(
                res.positions, want):
            raise AssertionError(f"mesh {name}: {res.strategy.index}, "
                                 f"{len(res.positions)} hits, oracle "
                                 f"{len(want)}")
        qrows.append({"query": name, "ms": ms, "hits": int(len(want))})

    # the ring-parallel scan: a max-ranges hint above 4096 plans more
    # ranges than one device replicates, so the sharded z3 query takes
    # the ring (the plan split and rotated, the data stationary; one
    # shard here), its hop through the z3 mask kernel
    z3 = store.z3_index()
    plan = z3._plan([box], *w, RING_MAX_RANGES)
    if plan.num_ranges <= z3.RING_MIN_RANGES_PER_DEVICE * z3.mesh.size:
        raise AssertionError(f"a {RING_MAX_RANGES}-range hint planned "
                             f"{plan.num_ranges} ranges: no ring")
    m0 = z3_mask.launches
    t0 = time.perf_counter()
    ring = z3.query([box], *w, max_ranges=RING_MAX_RANGES)
    ring_ms = (time.perf_counter() - t0) * 1e3
    ring_launches = z3_mask.launches - m0
    counts = z3.range_counts_ring([box], *w, max_ranges=RING_MAX_RANGES)
    total = z3.range_count([box], *w, max_ranges=RING_MAX_RANGES)
    if (not np.array_equal(ring, hits) or ring_launches <= 0
            or len(counts) != plan.num_ranges or int(counts.sum()) != total):
        raise AssertionError(f"mesh ring: {len(ring)} hits (oracle "
                             f"{len(hits)}), {ring_launches} z3_mask "
                             f"launches, ring counts {int(counts.sum())} "
                             f"against {total}")
    qrows.append({"query": "bbox_during_ring", "ms": ring_ms,
                  "hits": int(len(hits)), "ranges": int(plan.num_ranges),
                  "candidates": total, "z3_mask_launches": ring_launches})

    tx = int((cx + 180.0) // 45.0)
    ty = 7 - int((cy + 90.0) // 22.5)
    tenv = tile_env(3, tx, ty)
    drows = []
    for name, run, env, want_hits in (
            ("bbox_during", lambda: density_process(ds, "events", q, box),
             box, hits),
            (f"tile_3_{tx}_{ty}", lambda: ds.density_tile("events", 3, tx, ty),
             tenv, box_oracle(r["x"], r["y"], [tenv]))):
        t0 = time.perf_counter()
        grid = run()
        ms = (time.perf_counter() - t0) * 1e3
        want = snap_counts(r["x"][want_hits], r["y"][want_hits], env, 256,
                           256)
        if grid.shape != (256, 256) or not np.array_equal(
                grid.astype(np.float64), want.astype(np.float32)):
            raise AssertionError(f"mesh density {name}: {grid.sum()} "
                                 f"points, oracle {want.sum()}")
        drows.append({"query": name, "ms": ms, "points": float(want.sum())})

    profile = None
    if args.profile:
        profile = profile_queries("mesh", lambda call: call(), [
            lambda: ds.stats("events", q, spec),
            lambda: ds.stats("events", q, "Frequency(score,4,1024)"),
            lambda: ds.stats("events", "INCLUDE", spec),
            lambda: ds.query_result("events", q),
            lambda: density_process(ds, "events", q, box)])

    # the append lands in the built sharded z3 and z2 indexes
    append_s = write(1_000_000)
    r = rows()
    hits = oracle(r["x"], r["y"], r["t"], [box], *w)
    if pstats._hist_kernel_ok(store.z3_index()):
        raise AssertionError("the append did not move the shard past the "
                             "kernel's exactness bound")
    run_stats("bbox_during_after_append", q, spec, check_moments(hits))
    if arrow is not None:
        arrow(ds, "events", q, r, hits)
    if analytics is not None:
        analytics(ds, "events", r, (cx, cy))
    rep = report["mesh"] = {
        "rows": n, "write_s": write_s, "build_s": build_s,
        "build_keys_per_s": n / build_s, "z2_build_s": z2_build_s,
        "append_rows": 1_000_000,
        "append_write_s": append_s,
        "append_rows_per_s": 1_000_000 / append_s,
        "capacity_after_append": store.z3_index().capacity,
        "peak_device_bytes": int(torch.cuda.max_memory_allocated()),
        "stats": stat_rows, "topk_ms": topk_ms, "queries": qrows,
        "density": drows, "hits": int(len(hits))}
    if profile is not None:
        rep["profile"] = profile
    log(f"mesh: {n} rows in 4 writes ({', '.join(f'{s:.2f}' for s in write_s)}"
        f" s); sharded z3 build {build_s:.3f} s, z2 {z2_build_s:.3f} s; "
        "stats equal to the oracle: "
        + ", ".join(f"{s['stats']} {s['ms']:.1f} ms ({s['route']}, hist1d "
                    f"x{s['hist1d_launches']})" for s in stat_rows)
        + f", TopK {topk_ms:.1f} ms; queries "
        + ", ".join(f"{q_['query']} {q_['hits']} hits {q_['ms']:.1f} ms"
                    for q_ in qrows)
        + "; heatmaps " + ", ".join(f"{d['query']} {d['ms']:.1f} ms"
                                    for d in drows)
        + f"; 1M-row append write {append_s:.2f} s, capacity "
          f"{rep['capacity_after_append']}")
    del ds, store, z3
    torch.cuda.empty_cache()


def lean_norm(v, lo: float, hi: float, bits: int = 21):
    """numpy BitNormalizedDimension.normalize: floor((v - lo) · 2^bits /
    (hi - lo)), clamped to [0, 2^bits - 1] (v >= hi → the top cell)."""
    import numpy as np
    n = 1 << bits
    i = np.floor((np.maximum(v, lo) - lo) * (n / (hi - lo)))
    return np.clip(i, 0, n - 1).astype(np.int64)


def lean_denorm(i, lo: float, hi: float, bits: int = 21):
    """numpy BitNormalizedDimension.denormalize: the cell's centre."""
    return lo + (i + 0.5) * ((hi - lo) / (1 << bits))


def lean_density_oracle(cols, layout, boxes, lo, hi, env, width: int,
                        height: int, chunk: int = 1 << 24):
    """numpy oracle of the lean density contract, per tier: rows of a
    full-tier generation pass the exact box and [lo, hi] tests, rows of
    a keys- or host-tier generation the z-cell tests (normalized box
    bounds, (week bin, time cell) between those of lo and hi); every
    passing row bins at its z-cell centre (floor over ``env``, clipped).
    ``layout`` is the index's ``(base, n, tier)`` per generation."""
    import numpy as np
    from geomesa_tpu_torch.curve.binnedtime import (
        TimePeriod, max_offset, to_binned_time)
    x, y, t = cols
    t_max = float(max_offset(TimePeriod.WEEK))
    nb = [[int(lean_norm(np.float64(b[0]), -180, 180)),
           int(lean_norm(np.float64(b[1]), -90, 90)),
           int(lean_norm(np.float64(b[2]), -180, 180)),
           int(lean_norm(np.float64(b[3]), -90, 90))] for b in boxes]
    (b_lo,), (o_lo,) = to_binned_time(np.array([lo]), TimePeriod.WEEK)
    (b_hi,), (o_hi,) = to_binned_time(np.array([hi]), TimePeriod.WEEK)
    c_lo = int(lean_norm(np.float64(o_lo), 0.0, t_max))
    c_hi = int(lean_norm(np.float64(o_hi), 0.0, t_max))
    counts = np.zeros(width * height, dtype=np.int64)
    # a box covering the world passes every row's box test on both tiers
    # (normalized, the world's bounds are the first and last cells)
    world = any(b[0] <= -180.0 and b[1] <= -90.0 and b[2] >= 180.0
                and b[3] >= 90.0 for b in boxes)
    for base, n, tier in layout:
        for s in range(base, base + n, chunk):
            e = min(s + chunk, base + n)
            tc = t[s:e]
            if world and lo <= tc.min() and hi >= tc.max():
                # every row of the chunk passes either tier's tests
                sel = np.arange(s, e)
            else:
                # rows more than a cell outside every box or the window
                # fail either tier's tests: only the rest are tested
                near = np.zeros(e - s, dtype=bool)
                for b in boxes:
                    near |= ((x[s:e] >= b[0] - 1e-3) & (x[s:e] <= b[2] + 1e-3)
                             & (y[s:e] >= b[1] - 1e-3)
                             & (y[s:e] <= b[3] + 1e-3))
                near &= (tc >= lo - 1000) & (tc <= hi + 1000)
                sel = s + np.flatnonzero(near)
                xc, yc, tc = x[sel], y[sel], t[sel]
                m = np.zeros(len(sel), dtype=bool)
                if tier == "full":
                    for b in boxes:
                        m |= ((xc >= b[0]) & (xc <= b[2]) & (yc >= b[1])
                              & (yc <= b[3]))
                    m &= (tc >= lo) & (tc <= hi)
                else:
                    ix = lean_norm(xc, -180, 180)
                    iy = lean_norm(yc, -90, 90)
                    for b in nb:
                        m |= ((ix >= b[0]) & (ix <= b[2]) & (iy >= b[1])
                              & (iy <= b[3]))
                    bins, offs = to_binned_time(tc, TimePeriod.WEEK)
                    it = lean_norm(offs.astype(np.float64), 0.0, t_max)
                    m &= (((bins > b_lo) | ((bins == b_lo) & (it >= c_lo)))
                          & ((bins < b_hi)
                             | ((bins == b_hi) & (it <= c_hi))))
                sel = sel[m]
            xd = lean_denorm(lean_norm(x[sel], -180, 180), -180, 180)
            yd = lean_denorm(lean_norm(y[sel], -90, 90), -90, 90)
            gx = np.clip(((xd - env[0]) / max(env[2] - env[0], 1e-12)
                          * width).astype(np.int64), 0, width - 1)
            gy = np.clip(((yd - env[1]) / max(env[3] - env[1], 1e-12)
                          * height).astype(np.int64), 0, height - 1)
            counts += np.bincount(gy * width + gx,
                                  minlength=width * height)
    return counts.astype(np.float64).reshape(height, width)


def _split3(v):
    """numpy Morton spread of 21-bit uint64 values to every third bit."""
    import numpy as np
    v = v & np.uint64(0x1FFFFF)
    for shift, mask in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                        (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                        (2, 0x1249249249249249)):
        v = (v | (v << np.uint64(shift))) & np.uint64(mask)
    return v


def z3_cells_oracle(x, y, t, bits: int, chunk: int = 1 << 24) -> dict:
    """numpy oracle of Z3Histogram(geom, dtg, week, bits): rows counted per
    (week bin, top ``bits`` of the z3 key), the key interleaving the
    21-bit normalized lon (bit 0), lat (bit 1) and week offset (bit 2).
    With ``bits`` a multiple of 3 the top bits are the top ``bits // 3``
    bits of each dimension interleaved, spread through a lookup table."""
    import numpy as np
    from geomesa_tpu_torch.curve.binnedtime import (
        TimePeriod, max_offset, to_binned_time)
    t_max = float(max_offset(TimePeriod.WEEK))
    counts: dict = {}
    per_dim, top = divmod(bits, 3)
    lut = (_split3(np.arange(1 << per_dim, dtype=np.uint64))
           if top == 0 else None)
    for s in range(0, len(x), chunk):
        bins, offs = to_binned_time(t[s:s + chunk], TimePeriod.WEEK)
        ix = lean_norm(x[s:s + chunk], -180, 180)
        iy = lean_norm(y[s:s + chunk], -90, 90)
        it = lean_norm(offs.astype(np.float64), 0.0, t_max)
        if lut is not None:
            sh = 21 - per_dim
            cell = (lut[ix >> sh] | (lut[iy >> sh] << np.uint64(1))
                    | (lut[it >> sh] << np.uint64(2))).astype(np.int64)
        else:
            z = (_split3(ix.astype(np.uint64))
                 | (_split3(iy.astype(np.uint64)) << np.uint64(1))
                 | (_split3(it.astype(np.uint64)) << np.uint64(2)))
            cell = (z >> np.uint64(63 - bits)).astype(np.int64)
        b0 = int(bins.min())
        per = np.bincount((bins.astype(np.int64) - b0) * (1 << bits) + cell)
        for k in np.flatnonzero(per).tolist():
            kk = (b0 + (k >> bits), k & ((1 << bits) - 1))
            counts[kk] = counts.get(kk, 0) + int(per[k])
    return counts


class StatRoute:
    """Records which lean stats route answered: the Count push-down, the
    sketch push-down, or (neither) the materializing query path."""

    def __init__(self):
        import importlib
        # the module, not the function the package exports under its name
        sp = importlib.import_module("geomesa_tpu_torch.process.stats_process")
        self.sp, self.route = sp, None
        self._count, self._sketch = (sp._lean_count_pushdown,
                                     sp._lean_sketch_pushdown)

        def count(*a):
            got = self._count(*a)
            self.route = self.route or (got is not None and "count")
            return got

        def sketch(*a):
            got = self._sketch(*a)
            self.route = self.route or (got is not None and "sketch")
            return got

        sp._lean_count_pushdown, sp._lean_sketch_pushdown = count, sketch

    def run(self, fn):
        """(result, route) of one stats call."""
        self.route = None
        out = fn()
        return out, self.route or "materialized"

    def close(self):
        self.sp._lean_count_pushdown = self._count
        self.sp._lean_sketch_pushdown = self._sketch


def snap_weighted(x, y, w, env, width: int, height: int):
    """numpy weighted histogram of points snapped as GridSnap snaps them,
    the weights cast to float32 and summed in float64."""
    import numpy as np
    xmin, ymin, xmax, ymax = env
    dx, dy = (xmax - xmin) / width, (ymax - ymin) / height
    ix = np.clip(np.floor((x - xmin) / dx), 0, width - 1).astype(np.int64)
    iy = np.clip(np.floor((y - ymin) / dy), 0, height - 1).astype(np.int64)
    return np.bincount(iy * width + ix,
                       weights=w.astype(np.float32).astype(np.float64),
                       minlength=width * height).reshape(height, width)


def device_launches(fn) -> dict:
    """Kernel launches of one call of ``fn`` under ``torch.profiler``:
    device-side events (kernels, copies, sets) and launch calls on the
    host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    return {"device_events": int(sum(
                e.count for e in avg
                if e.device_type == torch.autograd.DeviceType.CUDA)),
            "launch_calls": int(sum(
                e.count for e in avg if e.key.startswith("cudaLaunchKernel")))}


def catalog_room(path: str, nbytes: int) -> int:
    """Raise unless the file system of ``path`` has room for twice the
    ``nbytes`` a phase is about to write; returns the free bytes."""
    free = shutil.disk_usage(path).free
    if free < 2 * nbytes:
        raise AssertionError(f"{path}: {free} bytes free, a phase writing "
                             f"~{nbytes} bytes needs twice that")
    return free


def dir_bytes(path: str) -> int:
    """Bytes of every file under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def allocated_after_gc(cuda: bool):
    """``torch.cuda.memory_allocated`` after the cyclic collector ran (a
    dropped store frees its device memory only then, PERF.md §7)."""
    import torch
    gc.collect()
    if not cuda:
        return None
    torch.cuda.empty_cache()
    return int(torch.cuda.memory_allocated())


#: one line of the Prometheus text exposition: a sample (with an optional
#: label and an optional OpenMetrics exemplar) or a ``# TYPE`` line
_PROM_SAMPLE = (r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]+="[^"]*"\})? '
                r'[-+0-9.eE]+(inf)?( # \{trace_id="[^"]+"\} [-+0-9.eE]+)?$')
_PROM_TYPE = (r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
              r"(counter|gauge|summary|histogram)$")


def prom_lines(text: str) -> int:
    """Check ``text`` line by line as Prometheus text exposition; returns
    the number of lines, raises at the first line that does not parse."""
    import re
    sample, typ = re.compile(_PROM_SAMPLE), re.compile(_PROM_TYPE)
    lines = text.splitlines()
    for line in lines:
        if not (sample.match(line) or typ.match(line)):
            raise AssertionError(f"Prometheus text: {line!r} does not parse")
    return len(lines)


def _ledger(traces) -> dict:
    """The summed stage ledger of the finished ``query`` roots of
    ``traces`` (obs/attribution.py): ``{stages_ms, total_ms, queries,
    unattributed_share}``, and ``unmapped_ms``, the exclusive time of the
    spans the ledger maps to no stage (the root's own among them), by
    span name: what the ``unattributed`` stage holds."""
    from geomesa_tpu_torch.obs import SLO_STAGES, attribute
    from geomesa_tpu_torch.obs.attribution import SPAN_STAGE
    led = dict.fromkeys(SLO_STAGES, 0.0)
    unmapped: dict = {}
    total, n, shares = 0.0, 0, []
    for tr in traces:
        att = attribute(tr)
        if att is None or att["class"] != "query":
            continue
        for k, v in att["stages"].items():
            led[k] += v
        total += att["total_ms"]
        shares.append(att["stages"]["unattributed"]
                      / max(att["total_ms"], 1e-9))
        n += 1
        child: dict = {}
        for sp in tr.spans:
            if sp.parent_id is not None:
                child[sp.parent_id] = child.get(sp.parent_id, 0.0) \
                    + sp.duration_ms
        for sp in tr.spans:
            if sp.name not in SPAN_STAGE:
                unmapped[sp.name] = unmapped.get(sp.name, 0.0) + max(
                    0.0, sp.duration_ms - child.get(sp.span_id, 0.0))
    return {"stages_ms": led, "total_ms": total, "queries": n,
            "unattributed_share": led["unattributed"] / max(total, 1e-9),
            "unattributed_share_max": max(shares) if shares else 0.0,
            "unmapped_ms": unmapped}


def obs_facade_part(qs, ds, report):
    """6d on the facade's ``gdelt`` store: the trace phase's 20 queries,
    traced, fold into the SLO plane under an objective they all miss
    (1 ms at 0.99, the alert at a burn of 1); the ``query`` class's stage
    ledger, both windows' burn, one alert fired exactly once; the
    registry's Prometheus text and the plane's exposition parsed line by
    line; the kernel-build count unchanged across the warm queries."""
    from geomesa_tpu_torch.config import clear_property, set_property
    from geomesa_tpu_torch.metrics import ALERT_SLO_FIRED, registry
    from geomesa_tpu_torch.obs import (
        compile_count, prometheus_text, slo_plane, tracer,
    )

    qsql = [_ecql(boxes, lo, hi) for _, boxes, lo, hi in qs]
    knobs = {"geomesa.slo.objectives": "query:1:0.99",
             "geomesa.slo.burn.alert": 1.0, "geomesa.obs.sampler": "always"}
    for k, v in knobs.items():
        set_property(k, v)
    try:
        slo_plane.reset()
        fired0 = registry.counter(ALERT_SLO_FIRED).count
        req0 = registry.counter("slo.query.requests").count
        builds0 = compile_count()
        with tracer.capture(capacity=len(qsql) + 8) as cap:
            for q in qsql:
                ds.query_result("gdelt", q)
        builds = compile_count() - builds0
        traces = cap.traces()
        slo = slo_plane.report()["classes"]["query"]
        alerts = slo_plane.alerts(cls="query")
        fired = registry.counter(ALERT_SLO_FIRED).count - fired0
        folded = registry.counter("slo.query.requests").count - req0
        slo_plane.publish()
        text = (prometheus_text(registry.snapshot())
                + slo_plane.exposition())
        n_lines = prom_lines(text)
    finally:
        for k in knobs:
            clear_property(k)
    led = _ledger(traces)
    rep = {"ledger": led, "folded": folded, "burn_5m": slo["burn_5m"],
           "burn_1h": slo["burn_1h"], "alerts_fired": fired,
           "alerts_in_ring": len(alerts), "prom_lines": n_lines,
           "prom_exemplars": text.count("# {trace_id="),
           "kernel_builds": builds}
    if folded != len(qsql) or led["queries"] != len(qsql):
        raise AssertionError(f"SLO plane folded {folded} and attributed "
                             f"{led['queries']} of {len(qsql)} queries")
    if not (slo["burn_5m"] > 1.0 and slo["burn_1h"] > 1.0):
        raise AssertionError(f"the query class does not burn: {slo}")
    if fired != 1 or len(alerts) != 1:
        raise AssertionError(f"{fired} alerts fired, {len(alerts)} in the "
                             f"ring: one expected")
    if builds:
        raise AssertionError(f"{builds} kernel builds across the warm "
                             f"queries")
    report.setdefault("obs", {})["facade"] = rep
    stages = ", ".join(f"{k} {v:.1f}" for k, v in led["stages_ms"].items()
                       if v)
    log(f"obs (facade): {len(qsql)} traced queries folded; query ledger "
        f"(ms) {stages} of {led['total_ms']:.1f} ms, unattributed "
        f"{led['unattributed_share']:.2%} (unmapped spans' own ms "
        f"{ {k: round(v, 1) for k, v in led['unmapped_ms'].items()} }); "
        f"burn 5m {slo['burn_5m']}, 1h "
        f"{slo['burn_1h']}; alerts fired {fired} (ring {len(alerts)}); "
        f"Prometheus text {n_lines} lines parsed, "
        f"{rep['prom_exemplars']} exemplars; kernel builds {builds}")


def _reached(traces) -> int:
    """Traced queries whose plan held ranges: their scan reached every
    generation of the index (the probe's seek)."""
    return sum(1 for tr in traces for s in tr.spans
               if s.name == "query.decompose"
               and s.attributes.get("ranges", 0) > 0)


def obs_lean_part(ds, name, checks, report, reps: int = 2):
    """6d on the lean phase's store (after its ``compact``): the lean
    queries with the heat tracker cleared, then ``heat_report``: every
    generation of the z3 index ranks once, its touches equal the queries
    whose scan reached it, its tier equals ``storage_report``'s.  The
    BBOX+DURING queries' p50 with ``geomesa.obs.heat.enabled`` on and off
    in turns (not gated).  One ``CompactionJob`` and one ``PyramidJob``,
    each ``succeeded`` in ``jobs_registry`` with its phase span."""
    import numpy as np
    from geomesa_tpu_torch.config import clear_property, set_property
    from geomesa_tpu_torch.jobs import CompactionJob, PyramidJob
    from geomesa_tpu_torch.obs import (
        compile_count, heat_tracker, jobs_registry, tracer,
    )

    # one query first: the estimator refolds its cell table after the
    # phase's compaction, a touch of every generation of its own
    ds.query_result(name, checks[0][1])
    builds0 = compile_count()
    heat_tracker.clear()
    set_property("geomesa.obs.sampler", "always")
    try:
        with tracer.capture(capacity=len(checks) + 8) as cap:
            for c in checks:
                ds.query_result(name, c[1])
        reached = _reached(cap.traces())
        heat = ds.heat_report()
        storage = ds.storage_report()
        # heat on and off in turns, BBOX+DURING queries only
        wall = {"on": [], "off": []}
        timed = [c for c in checks if c[3] is not None]
        for turn in range(2 * reps):
            mode = ("on", "off")[(turn + turn // 2) % 2]
            set_property("geomesa.obs.heat.enabled", mode == "on")
            for c in timed:
                t0 = time.perf_counter()
                ds.query_result(name, c[1])
                wall[mode].append((time.perf_counter() - t0) * 1e3)
        clear_property("geomesa.obs.heat.enabled")
        jobs_registry.clear()
        with tracer.capture() as jcap:
            merged = CompactionJob(ds, name).run()
            built = PyramidJob(ds, name).run()
    finally:
        clear_property("geomesa.obs.sampler")
        clear_property("geomesa.obs.heat.enabled")
    builds = compile_count() - builds0
    z3 = [r for r in heat["generations"] if r["index"] == "z3"]
    ids = [r["gen_id"] for r in z3]
    placed = {g["gen_id"]: g["tier"] for g in
              storage["schemas"][name]["indexes"]["z3"]["generations"]}
    if sorted(ids) != sorted(placed) or len(ids) != len(set(ids)):
        raise AssertionError(f"heat ranks z3 generations {sorted(ids)}, "
                             f"storage holds {sorted(placed)}")
    bad = [r for r in z3 if r["scans"] != reached
           or r["tier"] != placed[r["gen_id"]]
           or r["placement"]["tier"] != placed[r["gen_id"]]]
    if bad or reached != len(checks):
        raise AssertionError(f"heat: {len(bad)} generations off ({bad[:2]}),"
                             f" {reached} of {len(checks)} queries reached "
                             f"the index")
    jobs = {}
    for kind, phase in (("compaction", "compact"), ("pyramid", "build")):
        rec = jobs_registry.jobs(kind=kind)
        spans = [s for t in jcap.traces() if t.name == f"job.{kind}"
                 for s in t.spans if s.name == "job.phase"]
        if (len(rec) != 1 or rec[0].state != "succeeded"
                or [p["name"] for p in rec[0].phases] != [phase]
                or [s.attributes.get("phase") for s in spans] != [phase]):
            raise AssertionError(f"job {kind}: "
                                 f"{[r.to_json() for r in rec]}, phase "
                                 f"spans {len(spans)}")
        jobs[kind] = {"state": rec[0].state, "ms": rec[0].duration_ms,
                      "progress": rec[0].progress}
    if builds:
        raise AssertionError(f"{builds} kernel builds across the lean "
                             f"queries")
    p50 = {m: float(np.median(v)) for m, v in wall.items()}
    temps = [r["temperature"] for r in z3]
    rep = {"generations": len(z3), "reached": reached,
           "tiers": {t: sum(r["tier"] == t for r in z3)
                     for t in ("full", "keys", "host")},
           "temperature_max": max(temps), "temperature_min": min(temps),
           "p50_ms": p50, "p50_ratio_on_off": p50["on"] / p50["off"],
           "queries_timed": len(timed), "reps": reps, "jobs": jobs,
           "compaction": {k: v.get("merged_groups") for k, v in
                          merged.items()}, "pyramids_built": built,
           "kernel_builds": builds}
    report.setdefault("obs", {})["lean"] = rep
    log(f"obs (lean): heat ranks {len(z3)} z3 generations once each, "
        f"{reached} touches a generation = the queries that reached it, "
        f"tiers {rep['tiers']} as storage_report; temperature "
        f"{min(temps):.3f}-{max(temps):.3f}; p50 heat on "
        f"{p50['on']:.2f} ms / off {p50['off']:.2f} ms "
        f"({rep['p50_ratio_on_off']:.3f}x, not gated); CompactionJob "
        f"{jobs['compaction']['ms']:.1f} ms, PyramidJob "
        f"{jobs['pyramid']['ms']:.1f} ms ({built} built), both succeeded "
        f"with their phase spans")


def obs_mesh_lean_part(ds, name, checks, report):
    """6d on the mesh lean phase's store (after its ``compact``): the lean
    queries traced, their ``unattributed`` share of the query ledger, and
    one ``heat_report`` that ranks every generation of the sharded z3
    and attribute indexes once."""
    from geomesa_tpu_torch.config import clear_property, set_property
    from geomesa_tpu_torch.obs import compile_count, heat_tracker, tracer

    builds0 = compile_count()
    heat_tracker.clear()
    set_property("geomesa.obs.sampler", "always")
    try:
        with tracer.capture(capacity=len(checks) + 8) as cap:
            for c in checks:
                ds.query_result(name, c[1])
    finally:
        clear_property("geomesa.obs.sampler")
    led = _ledger(cap.traces())
    heat = ds.heat_report()
    builds = compile_count() - builds0
    store = ds._store(name)
    want = sorted((k, g.gen_id) for k, i in store._indexes.items()
                  if hasattr(i, "generations") for g in i.generations)
    got = sorted((r["index"], r["gen_id"]) for r in heat["generations"])
    if got != want:
        raise AssertionError(f"mesh lean heat ranks {got}, the indexes "
                             f"hold {want}")
    if led["queries"] != len(checks) or builds:
        raise AssertionError(f"mesh lean: {led['queries']} of {len(checks)}"
                             f" queries attributed, {builds} builds")
    touched = sum(1 for r in heat["generations"] if r["scans"])
    rep = {"ledger": led, "generations": len(got), "touched": touched,
           "indexes": heat["indexes"], "kernel_builds": builds}
    report.setdefault("obs", {})["mesh_lean"] = rep
    log(f"obs (mesh lean): {len(checks)} traced queries, unattributed "
        f"{led['unattributed_share']:.2%} of {led['total_ms']:.1f} ms "
        f"(worst query {led['unattributed_share_max']:.2%}; unmapped "
        f"spans' own ms "
        f"{ {k: round(v, 1) for k, v in led['unmapped_ms'].items()} }); "
        f"heat ranks "
        f"{len(got)} generations once each, {touched} touched")


def _drain_ipc(run):
    """One query's Arrow IPC stream drained whole (``run`` returns the
    stream): the bytes, the table a stock reader opens, and the wall
    time, scan included."""
    import pyarrow as pa
    t0 = time.perf_counter()
    blob = run().to_ipc_bytes()
    s = time.perf_counter() - t0
    return blob, pa.ipc.open_stream(blob).read_all(), s


def _points_of(table, geom: str = "geom"):
    flat = table.column(geom).combine_chunks().flatten().to_numpy()
    return flat[0::2], flat[1::2]


def _check_rows(label: str, table, ids, x, y, t) -> None:
    """A result table against the oracle's rows: ids, x, y and dtg."""
    import numpy as np
    import pyarrow as pa
    gx, gy = _points_of(table)
    got_t = table.column("dtg").cast(pa.int64()).to_numpy()
    got_ids = np.asarray(table.column("__fid__").to_pylist(), dtype=object)
    if not (table.num_rows == len(x) and np.array_equal(gx, x)
            and np.array_equal(gy, y) and np.array_equal(got_t, t)
            and np.array_equal(got_ids, np.asarray(ids, dtype=object))):
        raise AssertionError(f"arrow {label}: {table.num_rows} rows "
                             f"disagree with the oracle's {len(x)}")


def _mercator(lon, lat):
    """Spherical web Mercator in numpy, the oracle of a ``crs`` query."""
    import numpy as np
    r = 6378137.0
    lat = np.clip(lat, -85.05112877980659, 85.05112877980659)
    return (r * np.radians(lon),
            r * np.log(np.tan(np.pi / 4.0 + np.radians(lat) / 2.0)))


def _rates(rows: int, nbytes: int, s: float) -> dict:
    return {"rows": rows, "ipc_bytes": nbytes, "s": s,
            "rows_per_s": rows / max(s, 1e-9),
            "ipc_bytes_per_s": nbytes / max(s, 1e-9)}


def _stage_ms(name: str) -> dict:
    """The store's running totals of scan and materialize (encode and
    gather) time, ms, from its ``query.<name>.*_ms`` timers."""
    from geomesa_tpu_torch.metrics import registry
    return {k: registry.timer(f"query.{name}.{k}_ms").total
            for k in ("scan", "materialize")}


def _stage_split(name: str, before: dict) -> dict:
    return {f"{k}_ms": v - before[k] for k, v in _stage_ms(name).items()}


def arrow_facade_part(qs, ds, report):
    """6e on the facade's ``gdelt`` store: the index phase's 20 queries
    through ``query_arrow`` with auto dictionaries, drained as IPC and
    opened by a stock reader, ids and x, y, dtg equal to the oracle's
    rows; the largest result's ``ipc_chunks`` equal to its ``to_table``;
    one city query through ``query_arrow_table``,
    ``arrow_conversion_process`` and ``bin_conversion_process``, each
    decoding to the oracle's rows; the same city query with
    ``crs="EPSG:3857"`` equal to a numpy Mercator of them."""
    import numpy as np
    import pyarrow as pa
    from geomesa_tpu_torch.arrow import ipc_chunks, read_feature_batch
    from geomesa_tpu_torch.io import decode_bin, encode_bin
    from geomesa_tpu_torch.planning.planner import Query
    from geomesa_tpu_torch.process import (
        arrow_conversion_process, bin_conversion_process,
    )

    batch = ds._store("gdelt").batch
    x, y = batch.geom_xy()
    t = batch.column("dtg")
    ids = batch.ids
    # the first encode imports pyarrow's pandas shim: timed apart, so
    # that the rates below are steady state
    t0 = time.perf_counter()
    ds.query_arrow("gdelt", _ecql(*qs[0][1:])).to_ipc_bytes()
    first_s = time.perf_counter() - t0
    rows = nbytes = 0
    secs = 0.0
    sizes = []
    stages0 = _stage_ms("gdelt")
    for kind, boxes, lo, hi in qs:
        ecql = _ecql(boxes, lo, hi)
        # DURING takes whole seconds: the oracle reads the bounds as parsed
        want = oracle(x, y, t, boxes, lo - lo % 1000, hi - hi % 1000)
        blob, table, s = _drain_ipc(lambda: ds.query_arrow("gdelt", ecql))
        # auto dictionaries sample the hits: an empty result has none
        if len(want) and not isinstance(table.schema.field("actor").type,
                                        pa.DictionaryType):
            raise AssertionError("arrow: actor is not dictionary-encoded")
        _check_rows(kind, table, ids[want], x[want], y[want], t[want])
        rows += table.num_rows
        nbytes += len(blob)
        secs += s
        sizes.append(table.num_rows)
    rep = {"queries": len(qs), "first_call_s": first_s,
           **_rates(rows, nbytes, secs), **_stage_split("gdelt", stages0)}
    # the largest result through ipc_chunks: the same table as to_table
    city = qs[max((i for i, q in enumerate(qs) if q[0] == "city"),
                  key=sizes.__getitem__)]
    ecql = _ecql(*qs[int(np.argmax(sizes))][1:])
    parts = list(ipc_chunks(ds.query_arrow("gdelt", ecql, chunk_rows=1024),
                            buffer_bytes=1 << 14))
    whole = ds.query_arrow("gdelt", ecql, chunk_rows=1024).to_table()
    if not (len(parts) > 1
            and pa.ipc.open_stream(b"".join(parts)).read_all().equals(whole)):
        raise AssertionError(f"arrow: {len(parts)} ipc_chunks disagree with "
                             f"to_table")
    # the largest city result: the table, the conversion processes and a
    # reprojection
    _, boxes, lo, hi = city
    ecql = _ecql(boxes, lo, hi)
    want = oracle(x, y, t, boxes, lo - lo % 1000, hi - hi % 1000)
    if not len(want):
        raise AssertionError("arrow: every city query came back empty")
    order = want[np.argsort(t[want], kind="stable")]
    table = ds.query_arrow_table("gdelt", ecql, dictionary_fields=("actor",),
                                 sort_field="dtg")
    _check_rows("query_arrow_table", table, ids[order], x[order], y[order],
                t[order])
    conv = read_feature_batch(arrow_conversion_process(
        ds, "gdelt", ecql, dictionary_fields=("actor",), sort_field="dtg"))
    cx, cy = conv.geom_xy()
    if not (np.array_equal(cx, x[order]) and np.array_equal(cy, y[order])
            and np.array_equal(conv.column("dtg"), t[order])
            and np.array_equal(conv.ids.astype(object), ids[order])
            and np.array_equal(conv.column("actor"),
                               batch.column("actor")[order])):
        raise AssertionError("arrow_conversion_process disagrees with the "
                             "oracle")
    bins = bin_conversion_process(ds, "gdelt", ecql)
    dec = decode_bin(bins)
    if not (bins == encode_bin(x[want], y[want], t[want], track=ids[want])
            and np.array_equal(dec["lon"], x[want].astype(np.float32))
            and np.array_equal(dec["lat"], y[want].astype(np.float32))
            and np.array_equal(dec["dtg_ms"], t[want] // 1000 * 1000)):
        raise AssertionError("bin_conversion_process disagrees with the "
                             "oracle")
    merc = ds.query_arrow("gdelt", Query.of(ecql, crs="EPSG:3857")).to_table()
    mx, my = _mercator(x[want], y[want])
    gx, gy = _points_of(merc)
    if not (len(gx) == len(want) and np.allclose(gx, mx, rtol=1e-12, atol=0)
            and np.allclose(gy, my, rtol=1e-12, atol=0)):
        raise AssertionError("arrow: the EPSG:3857 query disagrees with a "
                             "numpy Mercator of the oracle's rows")
    rep.update(ipc_chunks=len(parts), city_rows=int(len(want)),
               bin_bytes=len(bins))
    report.setdefault("arrow", {})["facade"] = rep
    log(f"arrow (facade): {len(qs)} queries through query_arrow equal to "
        f"the oracle, {rows} rows, {nbytes} IPC bytes in {secs:.3f} s "
        f"(scan {rep['scan_ms']:.1f} ms, materialize "
        f"{rep['materialize_ms']:.1f} ms): "
        f"{rep['rows_per_s']:.4g} rows/s, {rep['ipc_bytes_per_s']:.4g} "
        f"bytes/s (the first call, apart: {first_s:.3f} s); "
        f"{len(parts)} ipc_chunks equal to to_table; city "
        f"({len(want)} rows): query_arrow_table, arrow and bin conversion, "
        f"EPSG:3857 equal to the oracle")


def arrow_lean_part(ds, name, checks, report):
    """6e on the lean phase's store (after its ``compact``): the
    BBOX+DURING queries through ``query_arrow``, x, y and dtg read by the
    index's device gather (``gather_payload``: the dispatch count moves
    and a ``query.materialize`` span has ``stage="gather"``), equal to
    the host payload at the oracle's rows."""
    import numpy as np
    from geomesa_tpu_torch.obs import tracer

    store = ds._store(name)
    idx = store.z3_index()
    x, y = store.batch.geom_xy()
    t = store.batch.column("dtg")
    if idx.tier_counts()["full"] <= 0:
        raise AssertionError(f"lean arrow: no full-tier generation "
                             f"({idx.tier_counts()})")
    rows = nbytes = 0
    secs = 0.0
    d0 = idx.dispatch_count
    stages0 = _stage_ms(name)
    with tracer.capture(capacity=64) as cap:
        for kind, ecql, boxes, lo, hi in checks:
            if lo is None:
                continue
            want = oracle(x, y, t, boxes, lo, hi)
            blob, table, s = _drain_ipc(
                lambda: ds.query_arrow(name, ecql, dictionary_fields=()))
            _check_rows(f"lean {kind}", table, want.astype(str), x[want],
                        y[want], t[want])
            rows += table.num_rows
            nbytes += len(blob)
            secs += s
    gathered = sum(1 for tr in cap.traces() for sp in tr.spans
                   if sp.name == "query.materialize"
                   and sp.attributes.get("stage") == "gather")
    dispatches = idx.dispatch_count - d0
    if not gathered or dispatches <= 0:
        raise AssertionError(f"lean arrow: the device gather was not taken "
                             f"({gathered} gather spans, {dispatches} "
                             f"dispatches)")
    rep = {"queries": sum(1 for c in checks if c[3] is not None),
           "gather_spans": gathered, "dispatches": dispatches,
           "tiers": idx.tier_counts(), **_rates(rows, nbytes, secs),
           **_stage_split(name, stages0)}
    report.setdefault("arrow", {})["lean"] = rep
    log(f"arrow (lean): {rep['queries']} BBOX+DURING queries through "
        f"query_arrow equal to the host payload and the oracle, {rows} rows, "
        f"{nbytes} IPC bytes in {secs:.3f} s (scan {rep['scan_ms']:.1f} ms, "
        f"materialize {rep['materialize_ms']:.1f} ms): "
        f"{rep['rows_per_s']:.4g} "
        f"rows/s, {rep['ipc_bytes_per_s']:.4g} bytes/s; device gather "
        f"{gathered} spans, {dispatches} dispatches, tiers {rep['tiers']}")


def arrow_mesh_part(ds, name, q, r, hits, report):
    """6e on the mesh phase's ``events`` store: ``query_arrow_table``
    with ``actor`` dictionary-encoded and sorted on ``dtg`` (the mesh
    reduce, ``merged_arrow``) equal to one ``DeltaWriter`` over the
    oracle's rows, dictionary values decoded."""
    import numpy as np
    import pyarrow as pa
    from geomesa_tpu_torch.arrow import DeltaWriter
    from geomesa_tpu_torch.arrow.reader import read_table
    from geomesa_tpu_torch.features.batch import FeatureBatch

    store = ds._store(name)
    t0 = time.perf_counter()
    table = ds.query_arrow_table(name, q, dictionary_fields=("actor",),
                                 sort_field="dtg")
    # the result serialized as IPC, timed with the query
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as ipc:
        ipc.write_table(table)
    nbytes = sink.getvalue().size
    secs = time.perf_counter() - t0
    one = FeatureBatch.from_dict(store.sft, {
        "actor": r["actor"][hits], "score": r["score"][hits],
        "dtg": r["t"][hits], "geom": (r["x"][hits], r["y"][hits])},
        ids=store.batch.ids[hits])
    w = DeltaWriter(store.sft, ("actor",), sort_field="dtg")
    w.write(one)
    blob = w.finish()
    want = read_table(blob)

    def decoded(tb):
        return [c.cast(c.type.value_type)
                if isinstance(c.type, pa.DictionaryType) else c
                for c in tb.combine_chunks().columns]

    if (table.column_names != want.column_names
            or table.num_rows != len(hits)
            or not all(a.equals(b) for a, b in zip(decoded(table),
                                                   decoded(want)))):
        raise AssertionError(f"arrow (mesh): query_arrow_table's "
                             f"{table.num_rows} rows disagree with one "
                             f"DeltaWriter over the oracle's {len(hits)}")
    rep = _rates(table.num_rows, nbytes, secs)
    report.setdefault("arrow", {})["mesh"] = rep
    log(f"arrow (mesh): query_arrow_table {table.num_rows} rows equal to "
        f"one DeltaWriter over the oracle; with the IPC write of its "
        f"{nbytes} bytes {secs:.3f} s: {rep['rows_per_s']:.4g} rows/s, "
        f"{rep['ipc_bytes_per_s']:.4g} bytes/s")


def lean_checks(qs) -> list:
    """The lean phases' queries: 3 city, 3 region and 2 continent
    BBOX+DURING queries of the index phase, then the first city and the
    first region box alone — ``(kind, ecql, boxes, lo, hi)``, the bounds
    as DURING parses them (``None`` for the BBOX-only ones)."""
    def bbox(b):
        return f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"

    picks = ([q for q in qs if q[0] == "city"][:3]
             + [q for q in qs if q[0] == "region"][:3]
             + [q for q in qs if q[0] == "continent"][:2])
    checks = []
    for kind, boxes, lo, hi in picks:
        # DURING takes whole seconds: the oracle reads the bounds as parsed
        lo_s, hi_s = lo - lo % 1000, hi - hi % 1000
        checks.append((kind, f"{bbox(boxes[0])} AND dtg DURING {iso(lo)}/"
                             f"{iso(hi)}", boxes, lo_s, hi_s))
    for kind, boxes, _lo, _hi in (picks[0], picks[3]):
        checks.append((f"{kind}-bbox", bbox(boxes[0]), boxes, None, None))
    return checks


def lean_phase(rng, args, centres, qs, dev, report, cat=None, serving=None,
               obs=None, arrow=None, analytics=None):
    """The lean profile: ``--lean-rows`` GDELT-like rows (with a ``score``)
    written in 4 batches to a schema with no profile set, whose first
    write switches it to lean; a budget that leaves all three tiers;
    BBOX+DURING and BBOX queries (estimator-costed, and one replanned),
    pyramids, Count and Z3Histogram, heatmaps (pushed down, from the
    pyramids and weighted) and tiles against numpy oracles, before and
    after ``compact``.  With ``cat`` the store keeps its catalog there
    from the start and is flushed after its closing ``age_off``; returns
    what the lean persist phase reopens and checks.  ``serving(ds, name,
    (x, y, t))``, ``obs(ds, name, checks)``, ``arrow(ds, name, checks)``
    and then ``analytics(ds, name, (x, y, t), checks)`` run after
    ``compact``, before the ``age_off``."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, density_process
    from geomesa_tpu_torch.index.pyramid import pyramid_spec, tile_env
    from geomesa_tpu_torch.index.z3_lean import LeanZ3Index
    from geomesa_tpu_torch.planning import ExplainString

    cuda = dev.type == "cuda"
    slots = args.lean_slots
    # one full generation (40 B a slot), four keys ones (16 B) and the
    # sentinel charges (16 + 40 B) take 160 B a slot; a fifth keys one
    # would take 176
    budget = 164 * slots
    ud = [f"geomesa.lean.hbm.budget={budget}",
          # opportunistic compaction off: compact() below merges at the
          # index's class factor
          "geomesa.lean.compaction.factor=0"]
    if slots != LeanZ3Index.GENERATION_SLOTS:
        ud.append(f"geomesa.lean.generation.slots={slots}")
    ds = TpuDataStore(device=dev, catalog_dir=cat)
    ds.create_schema("scale", "score:Double,dtg:Date,*geom:Point;"
                     + ",".join(ud))
    store = ds._store("scale")
    # the first write reaches the lean switch; the rest split the other
    # rows three ways
    first = max(args.lean_rows // 4, TpuDataStore.LEAN_AUTO_ROWS)
    sizes = [first] + [(args.lean_rows - first) // 3] * 3
    if sizes[1] <= 0:
        raise AssertionError(f"{args.lean_rows} rows do not fill 4 writes "
                             f"past the lean switch "
                             f"({TpuDataStore.LEAN_AUTO_ROWS})")
    write_s = []
    for i, per in enumerate(sizes):
        x, y, t = gdelt_like(rng, per, centres)
        score = rng.uniform(0.0, 100.0, per)
        t0 = time.perf_counter()
        ds.write("scale", {"score": score, "dtg": t, "geom": (x, y)})
        store.z3_index().block()
        write_s.append(time.perf_counter() - t0)
        if i == 0 and not (store.lean and store.sft.user_data.get(
                "geomesa.index.profile") == "lean"):
            raise AssertionError("the first write did not switch the "
                                 "schema to the lean profile")
    del x, y, t, score
    idx = store.z3_index()
    n = sum(sizes)
    x, y = store.batch.geom_xy()
    t = store.batch.column("dtg")
    score = store.batch.column("score")
    tiers = idx.tier_counts()
    if len(idx) != n or min(tiers.values()) == 0:
        raise AssertionError(f"lean store of {len(idx)} rows, tiers {tiers}")
    layout = [(g.base, g.n, g.tier) for g in idx.generations]
    t_min, t_max = int(t.min()), int(t.max())
    rep = {"rows": n, "slots": slots, "budget_bytes": budget,
           "write_s": write_s,
           "write_rows_per_s": [m / w for m, w in zip(sizes, write_s)],
           "tiers": tiers, "generations": len(idx.generations),
           "device_bytes": idx.device_bytes(),
           "host_key_bytes": idx.host_key_bytes(),
           "memory_allocated": (int(torch.cuda.memory_allocated())
                                if cuda else None)}
    log(f"lean: {n} rows in 4 writes ({', '.join(f'{s:.2f}' for s in write_s)}"
        f" s); tiers {tiers}; accounted device bytes {rep['device_bytes']}, "
        f"allocated {rep['memory_allocated']}")

    checks = lean_checks(qs)

    # the estimator: on at this size; its cold fold (every generation's
    # z3 cell counts) timed apart from the queries it then costs
    t0 = time.perf_counter()
    est = store.estimator()
    if est is None:
        raise AssertionError(f"no cardinality estimator on a lean store of "
                             f"{n} rows")
    est.z3_rows([WORLD], [(None, None)])
    rep["estimator_cold_ms"] = (time.perf_counter() - t0) * 1e3

    def run_query(kind, ecql, boxes, lo, hi, source="sketch"):
        ex = ExplainString()
        t0 = time.perf_counter()
        res = ds.query_result("scale", ecql, ex)
        ms = (time.perf_counter() - t0) * 1e3
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        st = res.strategy
        if (st.index != "z3" or st.source != source
                or not np.array_equal(res.positions, want)):
            raise AssertionError(
                f"lean {kind} {ecql}: strategy {st.index} ({st.source}), "
                f"{len(res.positions)} hits, oracle {len(want)}")
        ids = list(res.batch.ids[:3])
        if ids != [str(int(p)) for p in want[:3]]:
            raise AssertionError(f"lean {kind}: implicit ids {ids}")
        return {"query": kind, "ms": ms, "hits": int(len(want)),
                "plan_ms": res.plan_time_ms, "scan_ms": res.scan_time_ms,
                "source": st.source, "max_ranges": st.max_ranges,
                "cost": float(st.cost),
                "replans": str(ex).count("Replanning:")}

    rows = []
    for c in checks:
        d0 = idx.dispatch_count
        row = run_query(*c)
        row["dispatches"] = idx.dispatch_count - d0
        rows.append(row)
    lat = np.array([r["ms"] for r in rows])
    rep.update(queries=rows, query_ms_p50=float(np.median(lat)),
               query_ms_max=float(lat.max()))
    if cuda:
        rep["launches_per_query"] = {
            c[0]: device_launches(lambda c=c: ds.query_result("scale", c[1]))
            for c in (checks[0], checks[6], checks[8])}
    if args.profile:
        rep["profile"] = profile_queries(
            "lean", lambda c: ds.query_result("scale", c[1]), checks)
    # the same queries planned from whole-store fractions (the default
    # max_ranges), then from the sketch again, in turns in this call
    turns = {}
    for label, env, src in (("fractions", FRACTION_ENV, "stats"),
                            ("sketch", {}, "sketch")):
        with env_set(env):
            turns[label] = [run_query(*c, source=src) for c in checks]
    rep["turns"] = turns

    def split(rs):
        return [tuple(round(r[k], 1) for k in ("ms", "plan_ms", "scan_ms"))
                for r in rs]

    log(f"lean: estimator cold fold {rep['estimator_cold_ms']:.1f} ms; "
        f"{len(rows)} queries equal to the oracle, every plan costed by "
        f"the sketch; p50 {np.median(lat):.3f} ms, max {lat.max():.3f} ms; "
        f"hits {[r['hits'] for r in rows]}; max_ranges "
        f"{[r['max_ranges'] for r in rows]}; launches "
        f"{rep.get('launches_per_query')}; in turns (ms, plan ms, scan "
        f"ms), fraction-costed {split(turns['fractions'])}, sketch-costed "
        f"{split(turns['sketch'])}")

    # a mispredicted plan: the estimator off, the fraction-costed dense
    # city BBOX observes far more candidates than costed and replans once
    kind, _q, boxes, _lo, _hi = checks[8]
    with env_set(REPLAN_ENV):
        row = run_query(kind, checks[8][1], boxes, None, None,
                        source="observed")
    if row["replans"] != 1:
        raise AssertionError(f"lean mispredicted {kind}: {row['replans']} "
                             f"replans, not 1")
    rep["replan"] = row
    log(f"lean: mispredicted {kind} replanned once, {row['ms']:.1f} ms, "
        f"{row['hits']} hits equal to the oracle")

    box = checks[3][2][0]
    lo_c, hi_c = max(checks[3][3], t_min), min(checks[3][4], t_max)
    tx = int((box[0] + box[2]) / 2 + 180.0) // 180
    ty = 1 - int((box[1] + box[3]) / 2 + 90.0) // 90
    t3x = int(((box[0] + box[2]) / 2 + 180.0) // 45.0)
    t3y = 7 - int(((box[1] + box[3]) / 2 + 90.0) // 22.5)
    env3 = tile_env(3, t3x, t3y)

    @functools.lru_cache(maxsize=None)
    def world_oracle(res):
        # whole extent, whole time: every tier's test passes every row,
        # so the grid does not depend on the tier layout; a power-of-two
        # grid is the 2x2 block sum of the one twice as fine (floor
        # binning halves exactly)
        if res < 512:
            f = 512 // res
            return world_oracle(512).reshape(res, f, res, f).sum(axis=(1, 3))
        return lean_density_oracle((x, y, t), layout, [WORLD], t_min, t_max,
                                   WORLD, res, res)

    def tile1_oracle():
        g = world_oracle(512)
        return g[(1 - ty) * 256:(2 - ty) * 256, tx * 256:(tx + 1) * 256]

    def check_grid(name, run, want_fn, size=256):
        h0 = idx.pyramid_serve_hits
        t0 = time.perf_counter()
        grid = run()
        ms = (time.perf_counter() - t0) * 1e3
        served = idx.pyramid_serve_hits - h0
        want = want_fn()
        if grid.shape != (size, size) or not np.array_equal(grid, want):
            raise AssertionError(f"lean density {name}: grid disagrees with "
                                 f"the oracle ({float(grid.sum())} against "
                                 f"{float(want.sum())} points)")
        return {"query": name, "ms": ms, "points": float(want.sum()),
                "pyramid_served": served}

    # the world heatmap before any pyramid exists: every generation sweeps
    drows = [check_grid("world-before-pyramids",
                        lambda: density_process(ds, "scale", "INCLUDE",
                                                WORLD),
                        lambda: world_oracle(256))]

    # pyramids: one per sealed generation, then served in their place
    sealed = len(idx.generations) - 1
    t0 = time.perf_counter()
    built = ds.build_pyramids("scale")
    build_s = time.perf_counter() - t0
    if built != sealed or store.pyramid_build_failures:
        raise AssertionError(f"built {built} pyramids for {sealed} sealed "
                             f"generations ({store.pyramid_build_error})")
    rep["pyramids"] = {"built": built, "s": build_s}
    log(f"lean: {built} pyramids built for {sealed} sealed generations in "
        f"{build_s:.3f} s")

    # Count pushed down on INCLUDE (the pyramids' 1x1 level), materialized
    # on BBOX+DURING (the keys and host tiers are cell-granular); a whole
    # extent Z3Histogram from the keys (the sketch push-down)
    kind, q_and, boxes, lo, hi = checks[3]
    routes = StatRoute()
    crow = []
    try:
        for name, ecql, want, route in (
                ("include", "INCLUDE", n, "count"),
                (kind, q_and, len(oracle(x, y, t, boxes, lo, hi)),
                 "materialized")):
            t0 = time.perf_counter()
            got, how = routes.run(lambda: ds.stats("scale", ecql,
                                                   "Count()").count)
            ms = (time.perf_counter() - t0) * 1e3
            if got != want or how != route:
                raise AssertionError(f"lean Count {name}: {got} by {how}, "
                                     f"oracle {want} by {route}")
            crow.append({"query": name, "ms": ms, "count": int(got),
                         "route": how})
        t0 = time.perf_counter()
        hist, how = routes.run(lambda: ds.stats(
            "scale", "INCLUDE", f"Z3Histogram(geom,dtg,week,{Z3_BITS})"))
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        routes.close()
    want = z3_cells_oracle(x, y, t, Z3_BITS)
    if hist.counts != want or how != "sketch":
        raise AssertionError(f"lean Z3Histogram by {how}: "
                             f"{sum(hist.counts.values())} rows in "
                             f"{len(hist.counts)} cells, oracle "
                             f"{sum(want.values())} in {len(want)}")
    crow.append({"query": f"z3histogram-{Z3_BITS}", "ms": ms,
                 "cells": len(want), "route": how})
    rep["count"] = crow

    # heatmaps: pushed down (the per-tier contract; world grids and the
    # z = 1 tile from the pyramids), weighted (the query path and the
    # density kernel), tiles
    drows += [check_grid(*d) for d in (
        (kind, lambda: density_process(ds, "scale", q_and, box),
         lambda: lean_density_oracle((x, y, t), layout, [box], lo_c, hi_c,
                                     box, 256, 256)),
        ("world", lambda: density_process(ds, "scale", "INCLUDE", WORLD),
         lambda: world_oracle(256)),
        ("world-512", lambda: density_process(ds, "scale", "INCLUDE", WORLD,
                                              512, 512),
         lambda: world_oracle(512), 512),
        (f"tile_1_{tx}_{ty}", lambda: ds.density_tile("scale", 1, tx, ty),
         tile1_oracle),
        (f"tile_3_{t3x}_{t3y}", lambda: ds.density_tile("scale", 3, t3x,
                                                         t3y),
         lambda: lean_density_oracle((x, y, t), layout, [env3], t_min,
                                     t_max, env3, 256, 256)))]
    for r in drows[2:5]:
        if r["pyramid_served"] != sealed:
            raise AssertionError(f"lean {r['query']}: {r['pyramid_served']} "
                                 f"of {sealed} sealed generations served "
                                 f"from pyramids")
    hits = oracle(x, y, t, boxes, lo, hi)
    t0 = time.perf_counter()
    grid = density_process(ds, "scale", q_and, box, weight_attr="score")
    ms = (time.perf_counter() - t0) * 1e3
    want = snap_weighted(x[hits], y[hits], score[hits], box, 256, 256)
    if not np.allclose(grid, want, rtol=1e-5, atol=0.0):
        raise AssertionError(f"lean weighted density: grid disagrees with "
                             f"the oracle ({float(grid.sum())} against "
                             f"{float(want.sum())})")
    drows.append({"query": f"{kind}-weighted", "ms": ms,
                  "points": int(len(hits)), "dtype": str(grid.dtype)})
    rep["density"] = drows
    log("lean: counts, Z3Histogram and heatmaps equal to the oracle: "
        + ", ".join(f"{r['query']} {r['ms']:.1f} ms"
                    + (f" ({r['route']})" if "route" in r else "")
                    + (f" ({r['pyramid_served']} from pyramids)"
                       if "pyramid_served" in r else "")
                    for r in crow + drows))

    # compaction: fewer generations, the same answers; the merged run
    # inherits its parents' summed pyramid
    gens_before = len(idx.generations)
    t0 = time.perf_counter()
    res = ds.compact("scale")
    idx.block()
    compact_s = time.perf_counter() - t0
    if res["z3"]["generations"] >= gens_before:
        raise AssertionError(f"compaction left {res} from {gens_before} "
                             f"generations")
    pyr = idx._pyramid_cache.spec_cache(pyramid_spec(512))
    sealed = len(idx.generations) - 1
    if not all(g.gen_id in pyr for g in idx.generations[:-1]):
        raise AssertionError("a merged generation did not inherit its "
                             "parents' pyramids")
    layout = [(g.base, g.n, g.tier) for g in idx.generations]
    after = [run_query(*checks[0]), run_query(*checks[6])]
    wrow = check_grid("world-after-compact",
                      lambda: density_process(ds, "scale", "INCLUDE", WORLD),
                      lambda: world_oracle(256))
    if wrow["pyramid_served"] != sealed:
        raise AssertionError(f"after compaction {wrow['pyramid_served']} of "
                             f"{sealed} sealed generations served from "
                             f"pyramids")
    rep["compact"] = {"s": compact_s, "result": res["z3"],
                      "generations_before": gens_before,
                      "queries": after, "world": wrow,
                      "device_bytes": idx.device_bytes(),
                      "memory_allocated": (int(torch.cuda.memory_allocated())
                                           if cuda else None)}
    log(f"lean: compact in {compact_s:.3f} s, {gens_before} → "
        f"{res['z3']['generations']} generations, tiers {res['z3']['tiers']}; "
        f"queries equal to the oracle; world heatmap {wrow['ms']:.1f} ms, "
        f"{sealed} sealed generations (merged ones inherited) from pyramids")
    if serving is not None:
        serving(ds, "scale", (x, y, t))
    if obs is not None:
        obs(ds, "scale", checks)
    if arrow is not None:
        arrow(ds, "scale", checks)
    if analytics is not None:
        analytics(ds, "scale", (x, y, t), checks)
    rep["tombstones"] = lean_tombstones(ds, store, (x, y, t), checks, box,
                                        env3, (t3x, t3y), cuda)
    report["lean"] = rep
    if cat is None:
        del ds, store, idx
        if cuda:
            torch.cuda.empty_cache()
        return None
    # the snapshot: sliced parquet parts with the tombstones, the manifest
    # last, then the stats
    catalog_room(cat, n * 40)
    t0 = time.perf_counter()
    ds.flush("scale")
    flush_s = time.perf_counter() - t0
    persisted = {"flush_s": flush_s, "bytes": dir_bytes(cat),
                 "parts": len([f for f in os.listdir(
                     os.path.join(cat, "scale.lean")) if f.startswith(
                     "part-")]),
                 "device_bytes": idx.device_bytes(),
                 "memory_allocated": (int(torch.cuda.memory_allocated())
                                      if cuda else None)}
    log(f"lean: flushed {n} rows in {persisted['parts']} parts in "
        f"{flush_s:.2f} s, {persisted['bytes']} bytes on disk")
    tomb = store.tombstone.copy()
    del ds, store, idx
    return {"catalog": cat, "cols": (x, y, t), "checks": checks,
            "tombstone": tomb, "persisted": persisted}


#: the age-off cutoff of the lifecycle checks: rows dated before
#: 2018-01-15
AGE_OFF_MS = MS_2018 + 14 * DAY


def lean_tombstones(ds, store, cols, checks, box, env3, t3,
                    cuda: bool) -> dict:
    """The lean phase's store after ``age_off`` of the rows dated before
    2018-01-15 (tombstoned, not removed): the count, the estimator-costed
    queries (the oracle less the tombstoned rows), a region heatmap and
    the z = 3 tile (now the materializing path and the density kernel:
    exact grids) and ``Count()`` on INCLUDE, whose push-down must fall
    back."""
    import numpy as np
    from geomesa_tpu_torch import density_process
    from geomesa_tpu_torch.age_off import age_off
    from geomesa_tpu_torch.ops.density_kernel import density_grid_kernel

    x, y, t = cols
    n = len(x)
    expired = t < AGE_OFF_MS
    n_expired = int(expired.sum())
    live = ~expired
    t0 = time.perf_counter()
    got = age_off(ds, "scale", older_than_ms=AGE_OFF_MS)
    age_s = time.perf_counter() - t0
    if got != n_expired or int(store.tombstone.sum()) != n_expired:
        raise AssertionError(f"lean age_off tombstoned {got} rows, oracle "
                             f"{n_expired}")
    count = ds.get_count("scale")
    if count != n - n_expired:
        raise AssertionError(f"lean get_count {count} after age_off, oracle "
                             f"{n - n_expired}")
    rows = []
    for kind, ecql, boxes, lo, hi in checks:
        t0 = time.perf_counter()
        res = ds.query_result("scale", ecql)
        ms = (time.perf_counter() - t0) * 1e3
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        want = want[live[want]]
        if (res.strategy.source != "sketch"
                or not np.array_equal(res.positions, want)):
            raise AssertionError(
                f"lean {kind} after age_off: {res.strategy.index} "
                f"({res.strategy.source}), {len(res.positions)} hits, "
                f"oracle {len(want)}")
        rows.append({"query": kind, "ms": ms, "hits": int(len(want))})
    kind, q_and, boxes, lo, hi = checks[3]
    hits = oracle(x, y, t, boxes, lo, hi)
    hits = hits[live[hits]]
    t3x, t3y = t3
    tile_hits = box_oracle(x, y, [env3])
    tile_hits = tile_hits[live[tile_hits]]
    drows = []
    for name, run, env, want_hits in (
            (kind, lambda: density_process(ds, "scale", q_and, box), box,
             hits),
            (f"tile_3_{t3x}_{t3y}",
             lambda: ds.density_tile("scale", 3, t3x, t3y), env3,
             tile_hits)):
        d0 = density_grid_kernel.launches
        t0 = time.perf_counter()
        grid = run()
        ms = (time.perf_counter() - t0) * 1e3
        want = snap_counts(x[want_hits], y[want_hits], env, 256, 256)
        if grid.shape != (256, 256) or not np.array_equal(
                grid.astype(np.float64), want.astype(np.float32)):
            raise AssertionError(f"lean {name} after age_off: grid "
                                 f"disagrees with the oracle "
                                 f"({float(grid.sum())} against "
                                 f"{float(want.sum())} points)")
        launched = density_grid_kernel.launches - d0
        route = "materialized" if launched else "pushed down"
        if cuda and launched != 1:
            raise AssertionError(f"lean {name} after age_off: density_grid "
                                 f"launched {launched} times, not once")
        drows.append({"query": name, "ms": ms, "points": float(want.sum()),
                      "route": route, "density_grid_launches": launched})
    routes = StatRoute()
    try:
        t0 = time.perf_counter()
        got, how = routes.run(lambda: ds.stats("scale", "INCLUDE",
                                               "Count()").count)
        count_ms = (time.perf_counter() - t0) * 1e3
    finally:
        routes.close()
    if got != n - n_expired or how != "materialized":
        raise AssertionError(f"lean Count() after age_off: {got} by {how}, "
                             f"oracle {n - n_expired} materialized")
    lat = np.array([r["ms"] for r in rows])
    out = {"expired": n_expired, "age_off_s": age_s, "get_count": count,
           "queries": rows, "query_ms_p50": float(np.median(lat)),
           "query_ms_max": float(lat.max()), "density": drows,
           "count": {"ms": count_ms, "count": int(got), "route": how}}
    log(f"lean: age_off tombstoned {n_expired} rows in {age_s:.2f} s "
        f"(with the stats re-observed over {n - n_expired} live rows); "
        f"get_count {count}; {len(rows)} queries equal to the oracle less "
        f"the tombstones, p50 {np.median(lat):.1f} ms, max "
        f"{lat.max():.1f} ms; "
        + ", ".join(f"{d['query']} {d['ms']:.1f} ms ({d['route']})"
                    for d in drows)
        + f"; Count() {count_ms:.1f} ms ({how})")
    return out


#: the lifecycle phase's row labels, one per write, and the caller's
#: authorizations: it sees the first two writes
LABELS = ("", "user", "admin", "user&admin")
AUTHS = frozenset({"user"})
#: the lifecycle phases' schema (the facade's), and its v1-layout twin
LIFE_SPEC = "actor:String,dtg:Date,*geom:Point"
LEGACY_SPEC = LIFE_SPEC + ";geomesa.index.versions='z3:1,z2:1'"


def life_queries(qs) -> list:
    """The index phase's 20 queries as ECQL: each BBOX+DURING (z3) and
    its boxes alone (z2), with the oracle's whole-second bounds."""
    out = []
    for kind, boxes, lo, hi in qs:
        geo = " OR ".join(f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"
                          for b in boxes)
        if len(boxes) > 1:
            geo = f"({geo})"
        out.append((f"{kind}-during", "z3",
                    f"{geo} AND dtg DURING {iso(lo)}/{iso(hi)}", boxes,
                    lo - lo % 1000, hi - hi % 1000))
        out.append((f"{kind}-bbox", "z2", geo, boxes, None, None))
    return out


def scanned(explain_text: str) -> int:
    """The candidates a query handed its residual filter (the explain
    trace's estimate audit)."""
    import re
    return int(re.search(r"scanned (\d+)", explain_text).group(1))


def run_life_queries(ds, name, lq, cols, visible=None, label="") -> list:
    """Each of ``lq`` through ``ds`` against the oracle over ``cols``
    (restricted to ``visible`` rows when given): strategy, positions and
    the candidates scanned."""
    import numpy as np
    from geomesa_tpu_torch.planning import ExplainString
    x, y, t = cols
    rows = []
    for kind, strategy, ecql, boxes, lo, hi in lq:
        ex = ExplainString()
        t0 = time.perf_counter()
        res = ds.query_result(name, ecql, ex)
        ms = (time.perf_counter() - t0) * 1e3
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        if visible is not None:
            want = want[visible[want]]
        if (res.strategy.index != strategy
                or not np.array_equal(res.positions, want)):
            raise AssertionError(
                f"{label} {kind}: {res.strategy.index} (expected "
                f"{strategy}), {len(res.positions)} hits, oracle "
                f"{len(want)}")
        rows.append({"query": kind, "ms": ms, "hits": int(len(want)),
                     "candidates": scanned(str(ex))})
    return rows


def life_summary(rows) -> str:
    import numpy as np
    lat = np.array([r["ms"] for r in rows])
    return (f"{len(rows)} queries equal to the oracle, p50 "
            f"{np.median(lat):.1f} ms, max {lat.max():.1f} ms")


def lifecycle_phase(rng, args, centres, qs, dev, report, cat=None):
    """Deletes, visibilities and the read APIs on the default profile:
    ``--life-rows`` GDELT-like rows in 4 writes labelled ``LABELS``, with
    ``actor`` guarded by ``admin``, read by a caller authorized for
    ``user`` (the first two writes); the index phase's queries, a
    ``max_features`` limit, a probe of the guarded attribute, get_count,
    get_bounds and a materialized region heatmap; then a delete of 1% of
    the rows by id (timed, and the first query after it, which rebuilds
    the indexes, timed apart), the queries again, a repeated delete that
    counts 0, and ``age_off`` of the rows before 2018-01-15.  With ``cat``
    the store keeps its catalog there from the start and is flushed at
    the end.  Returns the rows written and the candidates of each query,
    which the legacy phase compares, and what the persist phase reopens
    and checks."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, density_process
    from geomesa_tpu_torch.age_off import age_off
    from geomesa_tpu_torch.ops.density_kernel import density_grid_kernel
    from geomesa_tpu_torch.planning.planner import Query
    from geomesa_tpu_torch.security import StaticAuthorizationsProvider

    actors = np.array(["USA", "GBR", "FRA", "CHN", "IND", "BRA", "RUS"],
                      dtype=object)
    ds = TpuDataStore(device=dev,
                      auth_provider=StaticAuthorizationsProvider(AUTHS),
                      catalog_dir=cat)
    ds.create_schema("life", LIFE_SPEC)
    n = args.life_rows
    per = n // 4
    chunks, write_s = [], []
    for label in LABELS:
        x, y, t = gdelt_like(rng, per, centres)
        chunk = {"actor": actors[rng.integers(0, len(actors), per)],
                 "dtg": t, "geom": (x, y)}
        chunks.append(chunk)
        t0 = time.perf_counter()
        ds.write("life", chunk, visibility=label,
                 attribute_visibilities={"actor": "admin"})
        write_s.append(time.perf_counter() - t0)
    x, y, t = (np.concatenate([c["geom"][0] for c in chunks]),
               np.concatenate([c["geom"][1] for c in chunks]),
               np.concatenate([c["dtg"] for c in chunks]))
    visible = np.arange(n) < 2 * per
    lq = life_queries(qs)
    rows = run_life_queries(ds, "life", lq, (x, y, t), visible, "lifecycle")
    cands = [r["candidates"] for r in rows]
    # max_features fills from the rows the caller may see
    for kind, _s, ecql, boxes, lo, hi in (lq[8], lq[9], lq[16]):
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        want = want[visible[want]]
        k = max(1, len(want) // 2)
        got = ds.query_result("life", Query.of(ecql, max_features=k))
        if not np.array_equal(got.positions, want[:k]):
            raise AssertionError(f"lifecycle {kind}: max_features {k} gave "
                                 f"{len(got.positions)} rows")
    # the guarded attribute answers no filter for this caller
    probe = ds.query_result("life", f"actor = 'USA' AND {lq[17][2]}")
    if len(probe.positions):
        raise AssertionError(f"lifecycle: a guarded actor matched "
                             f"{len(probe.positions)} rows")
    count = ds.get_count("life")
    env = ds.get_bounds("life").as_tuple()
    want_env = (x[visible].min(), y[visible].min(), x[visible].max(),
                y[visible].max())
    if count != 2 * per or env != want_env:
        raise AssertionError(f"lifecycle: get_count {count}, bounds {env}; "
                             f"oracle {2 * per}, {want_env}")
    kind, _s, q_region, boxes, lo, hi = lq[16]    # a region, a week
    box = boxes[0]
    hits = oracle(x, y, t, boxes, lo, hi)
    hits = hits[visible[hits]]
    d0 = density_grid_kernel.launches
    t0 = time.perf_counter()
    grid = density_process(ds, "life", q_region, box)
    heat_ms = (time.perf_counter() - t0) * 1e3
    want = snap_counts(x[hits], y[hits], box, 256, 256)
    if not np.array_equal(grid.astype(np.float64), want.astype(np.float32)):
        raise AssertionError(f"lifecycle heatmap: {float(grid.sum())} "
                             f"points, oracle {float(want.sum())}")
    heat_launches = density_grid_kernel.launches - d0
    log(f"lifecycle: {n} rows in 4 labelled writes "
        f"({', '.join(f'{s:.2f}' for s in write_s)} s); restricted "
        f"{life_summary(rows)}; max_features and the guarded-attribute "
        f"probe equal; get_count {count}; region heatmap {heat_ms:.1f} ms "
        f"(density_grid x{heat_launches})")

    # a delete of 1% of the rows by id, then every query again
    dpos = rng.choice(n, n // 100, replace=False)
    ids = np.array([str(p) for p in dpos], dtype=object)
    t0 = time.perf_counter()
    removed = ds.delete("life", ids)
    delete_s = time.perf_counter() - t0
    if removed != len(dpos) or ds._store("life")._indexes:
        raise AssertionError(f"lifecycle delete removed {removed} of "
                             f"{len(dpos)} rows")
    keep = np.ones(n, bool)
    keep[dpos] = False
    xk, yk, tk, vk = x[keep], y[keep], t[keep], visible[keep]
    first = run_life_queries(ds, "life", lq[:1], (xk, yk, tk), vk,
                             "lifecycle after delete")
    after = run_life_queries(ds, "life", lq[1:], (xk, yk, tk), vk,
                             "lifecycle after delete")
    again = ds.delete("life", ids)
    if again != 0:
        raise AssertionError(f"lifecycle: a repeated delete removed {again}")
    t0 = time.perf_counter()
    aged = age_off(ds, "life", older_than_ms=AGE_OFF_MS)
    age_s = time.perf_counter() - t0
    want_aged = int((tk < AGE_OFF_MS).sum())
    live = tk >= AGE_OFF_MS
    if aged != want_aged or ds.get_count("life") != int((vk & live).sum()):
        raise AssertionError(f"lifecycle age_off removed {aged}, oracle "
                             f"{want_aged}")
    report["lifecycle"] = {
        "rows": n, "write_s": write_s, "queries": rows,
        "get_count": count, "heatmap_ms": heat_ms,
        "heatmap_density_grid_launches": heat_launches,
        "deleted": removed, "delete_s": delete_s,
        "first_query_after_delete_ms": first[0]["ms"],
        "queries_after_delete": first + after, "aged_off": aged,
        "age_off_s": age_s}
    log(f"lifecycle: deleted {removed} rows by id in {delete_s:.2f} s; the "
        f"first query after it (index rebuild) {first[0]['ms']:.1f} ms; "
        f"{life_summary(after)}; a repeated delete counts 0; age_off "
        f"removed {aged} rows in {age_s:.2f} s")
    persisted = None
    if cat is not None:
        # parquet rows, the labels dictionary-encoded, then the stats
        catalog_room(cat, n * 96)
        t0 = time.perf_counter()
        ds.flush("life")
        flush_s = time.perf_counter() - t0
        persisted = {
            "catalog": cat, "cols": (xk[live], yk[live], tk[live]),
            "visible": vk[live], "issued": n, "flush_s": flush_s,
            "bytes": dir_bytes(cat),
            "memory_allocated": (int(torch.cuda.memory_allocated())
                                 if dev.type == "cuda" else None)}
        log(f"lifecycle: flushed {int(live.sum())} rows in {flush_s:.2f} s, "
            f"{persisted['bytes']} bytes on disk")
    del ds
    return chunks, (x, y, t), cands, persisted


def legacy_phase(args, chunks, cols, cands, qs, dev, report):
    """The lifecycle phase's rows on a schema pinned to the v1 key layouts
    (the legacy curves): the same queries, with the candidates of each
    next to the current layout's, then ``migrate_schema`` and the queries
    again (now with the current layout's candidates)."""
    from geomesa_tpu_torch import TpuDataStore

    ds = TpuDataStore(device=dev)
    ds.create_schema("legacy", LEGACY_SPEC)
    t0 = time.perf_counter()
    for chunk in chunks:
        ds.write("legacy", chunk)
    write_s = time.perf_counter() - t0
    store = ds._store("legacy")
    lq = life_queries(qs)
    v1 = run_life_queries(ds, "legacy", lq, cols, label="legacy v1")
    if (store.z3_index().version, store.z2_index().version) != (1, 1):
        raise AssertionError("the legacy store's indexes are not v1")
    for r, c in zip(v1, cands):
        r["candidates_v2"] = c
    t0 = time.perf_counter()
    old = ds.migrate_schema("legacy")
    migrate_s = time.perf_counter() - t0
    v2 = run_life_queries(ds, "legacy", lq, cols, label="legacy migrated")
    if (old["z3"], old["z2"], store.z3_index().version) != (1, 1, 2):
        raise AssertionError(f"migrate_schema from {old}")
    if [r["candidates"] for r in v2] != cands:
        raise AssertionError("after migration the candidates differ from "
                             "the current layout's")
    report["legacy"] = {"write_s": write_s, "queries_v1": v1,
                        "migrate_s": migrate_s, "queries_migrated": v2}
    differ = sum(r["candidates"] != r["candidates_v2"] for r in v1)
    log(f"legacy: {len(chunks)} writes in {write_s:.2f} s; v1 "
        f"{life_summary(v1)}; candidates v1/v2 "
        + ", ".join(f"{r['candidates']}/{r['candidates_v2']}" for r in v1)
        + f" ({differ} of {len(v1)} differ); migrate_schema "
          f"{migrate_s * 1e3:.1f} ms, then {life_summary(v2)}")
    del ds, store


def mesh_lifecycle_phase(rng, args, centres, qs, dev, report):
    """``device_mesh(1)``: ``--life-mesh-rows`` rows in 2 writes labelled
    "" and ``admin``, a delete of 1% of them; Count, MinMax and a
    Histogram of ``score`` pushed down through hist1d over the sharded
    index rebuilt after the delete, and the queries; then the same rows
    and delete read by a caller authorized for ``user`` only (the first
    write), the queries restricted to it."""
    import numpy as np
    from geomesa_tpu_torch import TpuDataStore, device_mesh
    from geomesa_tpu_torch.ops.hist1d_kernel import hist1d
    from geomesa_tpu_torch.security import StaticAuthorizationsProvider

    spec = "actor:String,score:Double,dtg:Date,*geom:Point"
    n = args.life_mesh_rows
    per = n // 2
    chunks = []
    for _ in range(2):
        x, y, t = gdelt_like(rng, per, centres)
        chunks.append({"actor": np.array(["USA"] * per, dtype=object),
                       "score": rng.uniform(0.0, 100.0, per), "dtg": t,
                       "geom": (x, y)})
    x, y, t, score = (np.concatenate([c["geom"][0] for c in chunks]),
                      np.concatenate([c["geom"][1] for c in chunks]),
                      np.concatenate([c["dtg"] for c in chunks]),
                      np.concatenate([c["score"] for c in chunks]))
    dpos = rng.choice(n, n // 100, replace=False)
    ids = np.array([str(p) for p in dpos], dtype=object)
    keep = np.ones(n, bool)
    keep[dpos] = False
    xk, yk, tk, sk = x[keep], y[keep], t[keep], score[keep]
    lq = life_queries(qs)
    out = {}
    for label, auths in (("open", None), ("restricted", AUTHS)):
        ds = TpuDataStore(
            device=dev, mesh=device_mesh(1),
            auth_provider=(None if auths is None
                           else StaticAuthorizationsProvider(auths)))
        ds.create_schema("mlife", spec)
        for chunk, vis in zip(chunks, ("", "admin")):
            ds.write("mlife", chunk, visibility=vis)
        ds.query_result("mlife", lq[0][2])   # builds the sharded indexes
        t0 = time.perf_counter()
        removed = ds.delete("mlife", ids)
        delete_s = time.perf_counter() - t0
        if removed != len(dpos):
            raise AssertionError(f"mesh lifecycle delete removed {removed}")
        visible = (None if auths is None
                   else (np.arange(n) < per)[keep])
        rows = run_life_queries(ds, "mlife", lq, (xk, yk, tk), visible,
                                f"mesh lifecycle ({label})")
        rep = {"deleted": removed, "delete_s": delete_s, "queries": rows}
        if auths is None:
            stats = []
            kind, _s, q, boxes, lo, hi = lq[28]   # a continent, a month
            for name, ecql, hits in (
                    (kind, q, oracle(xk, yk, tk, boxes, lo, hi)),
                    ("include", "INCLUDE", np.arange(len(xk)))):
                h0 = hist1d.launches
                t0 = time.perf_counter()
                c, mm, h = ds.stats(
                    "mlife", ecql,
                    "Count();MinMax(score);Histogram(score,64,0,100)").stats
                ms = (time.perf_counter() - t0) * 1e3
                sc = sk[hits]
                want_h = np.bincount(
                    np.clip(sc / (100.0 / 64), 0, 63).astype(np.int64),
                    minlength=64)
                if (c.count != len(hits) or (mm.min, mm.max)
                        != (sc.min(), sc.max())
                        or not np.array_equal(h.counts, want_h)):
                    raise AssertionError(f"mesh lifecycle stats {name} "
                                         "disagree with numpy")
                stats.append({"stats": name, "ms": ms,
                              "hist1d_launches": hist1d.launches - h0})
            rep["stats"] = stats
        out[label] = rep
        del ds
    report["mesh_lifecycle"] = out
    log(f"mesh lifecycle: {n} rows, deleted {len(dpos)} by id in "
        f"{out['open']['delete_s']:.2f} s; stats after the delete equal to "
        f"numpy: " + ", ".join(f"{s['stats']} {s['ms']:.1f} ms (hist1d "
                               f"x{s['hist1d_launches']})"
                               for s in out["open"]["stats"])
        + f"; open {life_summary(out['open']['queries'])}; restricted "
          f"{life_summary(out['restricted']['queries'])}")


def persist_phase(args, qs, dev, report, life) -> None:
    """The lifecycle store's catalog (flushed after its delete and
    age_off): the store dropped (its device memory must fall), reopened
    with the same auth provider — the reopen and the first query timed
    apart, the two together the time to recover — then the queries
    against the oracle (the visible rows less the deleted and aged-off
    ones), a restricted heatmap (density_grid), a 1M-row write whose auto
    ids follow every id ever issued, and an ``update_schema`` rename; the
    catalog reopened on ``device_mesh(1)``, which must hold the renamed
    schema only, answering Count, MinMax and a 64-bin Histogram of
    ``dtg`` through hist1d, against numpy; then ``remove_schema``, after
    which no file of the schema is left."""
    import numpy as np
    from geomesa_tpu_torch import TpuDataStore, density_process, device_mesh
    from geomesa_tpu_torch.features.feature_type import parse_spec
    from geomesa_tpu_torch.ops.density_kernel import density_grid_kernel
    from geomesa_tpu_torch.ops.hist1d_kernel import hist1d
    from geomesa_tpu_torch.security import StaticAuthorizationsProvider

    cuda = dev.type == "cuda"
    cat = life["catalog"]
    x, y, t = life["cols"]
    visible = life["visible"]
    n = len(x)
    alloc = allocated_after_gc(cuda)
    if cuda and alloc >= life["memory_allocated"]:
        raise AssertionError(f"persist: dropping the store left "
                             f"{alloc} bytes allocated (was "
                             f"{life['memory_allocated']})")
    lq = life_queries(qs)
    t0 = time.perf_counter()
    ds = TpuDataStore(device=dev,
                      auth_provider=StaticAuthorizationsProvider(AUTHS),
                      catalog_dir=cat)
    reopen_s = time.perf_counter() - t0
    if ds.type_names != ["life"] or len(ds._store("life").batch) != n:
        raise AssertionError(f"persist: reopened {ds.type_names} with "
                             f"{len(ds._store('life').batch)} rows, not {n}")
    first = run_life_queries(ds, "life", lq[:1], (x, y, t), visible,
                             "persist")
    rest = run_life_queries(ds, "life", lq[1:], (x, y, t), visible,
                            "persist")
    if cuda:
        launches = device_launches(lambda: ds.query_result("life", lq[0][2]))
    else:
        launches = None
    kind, _s, q_region, boxes, lo, hi = lq[16]
    box = boxes[0]
    hits = oracle(x, y, t, boxes, lo, hi)
    hits = hits[visible[hits]]
    d0 = density_grid_kernel.launches
    t0 = time.perf_counter()
    grid = density_process(ds, "life", q_region, box)
    heat_ms = (time.perf_counter() - t0) * 1e3
    want = snap_counts(x[hits], y[hits], box, 256, 256)
    if not np.array_equal(grid.astype(np.float64), want.astype(np.float32)):
        raise AssertionError(f"persist heatmap: {float(grid.sum())} points, "
                             f"oracle {float(want.sum())}")
    heat_launches = density_grid_kernel.launches - d0
    # auto ids after the reopen follow every id ever issued: deleted and
    # aged-off ids are never reused
    m = 1_000_000
    rng = np.random.default_rng(args.seed + 10)
    centres = np.stack([rng.uniform(-130.0, 150.0, 50),
                        rng.uniform(-40.0, 60.0, 50)], axis=1)
    xa, ya, ta = gdelt_like(rng, m, centres)
    t0 = time.perf_counter()
    ds.write("life", {"actor": np.array(["USA"] * m, dtype=object),
                      "dtg": ta, "geom": (xa, ya)}, visibility="user")
    append_s = time.perf_counter() - t0
    ids = ds._store("life").batch.ids[-m:]
    if ids[0] != str(life["issued"]) or ids[-1] != str(life["issued"] + m - 1):
        raise AssertionError(f"persist: auto ids {ids[0]}..{ids[-1]} after "
                             f"the reopen, {life['issued']} issued before")
    after = run_life_queries(
        ds, "life", lq[:2], (np.r_[x, xa], np.r_[y, ya], np.r_[t, ta]),
        np.r_[visible, np.ones(m, bool)], "persist after the write")
    report_rows = {"reopen_s": reopen_s,
                   "first_query_ms": first[0]["ms"],
                   "recover_s": reopen_s + first[0]["ms"] / 1e3,
                   "queries": first + rest, "heatmap_ms": heat_ms,
                   "heatmap_density_grid_launches": heat_launches,
                   "device_launches": launches, "append_s": append_s,
                   "queries_after_append": after}
    # a rename moves every file of the schema (the next reopen must see
    # the new name only)
    t0 = time.perf_counter()
    ds.update_schema("life", parse_spec("life_v2", LIFE_SPEC))
    rename_ms = (time.perf_counter() - t0) * 1e3
    del ds
    log(f"persist: flush {life['flush_s']:.2f} s, {life['bytes']} bytes; "
        f"reopen {reopen_s:.2f} s, first restricted query "
        f"{first[0]['ms']:.1f} ms (time to recover "
        f"{report_rows['recover_s']:.2f} s); {life_summary(first + rest)}; "
        f"heatmap {heat_ms:.1f} ms (density_grid x{heat_launches}); 1M-row "
        f"write {append_s:.2f} s with ids from {life['issued']}")

    # the catalog on a mesh: stats pushed down through hist1d
    t0 = time.perf_counter()
    ms = TpuDataStore(device=dev, mesh=device_mesh(1), catalog_dir=cat)
    mesh_reopen_s = time.perf_counter() - t0
    if ms.type_names != ["life_v2"] or ms.get_count("life_v2") != n:
        raise AssertionError(f"persist: after the rename {ms.type_names}")
    stats = []
    kind, _s, q, boxes, lo, hi = lq[28]   # a continent, a month
    for name, ecql, rows in ((kind, q, oracle(x, y, t, boxes, lo, hi)),
                             ("include", "INCLUDE", np.arange(n))):
        h0 = hist1d.launches
        t0 = time.perf_counter()
        c, mm, h = ms.stats(
            "life_v2", ecql,
            f"Count();MinMax(dtg);Histogram(dtg,64,{MS_2018},{MS_2019})"
        ).stats
        stat_ms = (time.perf_counter() - t0) * 1e3
        tr = t[rows]
        want_h = np.bincount(np.clip(
            (tr.astype(np.float64) - MS_2018) / ((MS_2019 - MS_2018) / 64),
            0, 63).astype(np.int64), minlength=64)
        if (c.count != len(rows) or (mm.min, mm.max) != (tr.min(), tr.max())
                or not np.array_equal(h.counts, want_h)):
            raise AssertionError(f"persist mesh stats {name} disagree with "
                                 "numpy")
        stats.append({"stats": name, "ms": stat_ms,
                      "hist1d_launches": hist1d.launches - h0})
    # a remove leaves no file of the schema
    ms.remove_schema("life_v2")
    left = sorted(f for f in os.listdir(cat) if f.startswith("life"))
    if left or ms.type_names:
        raise AssertionError(f"persist: remove_schema left {left}")
    del ms
    report_rows.update(
        flush_s=life["flush_s"], bytes=life["bytes"],
        flush_rows_per_s=n / life["flush_s"], mesh_reopen_s=mesh_reopen_s,
        mesh_stats=stats, rename_ms=rename_ms,
        memory_allocated_after_drop=alloc)
    report["persist"] = report_rows
    log(f"persist: mesh reopen {mesh_reopen_s:.2f} s, stats equal to numpy: "
        + ", ".join(f"{s['stats']} {s['ms']:.1f} ms (hist1d "
                    f"x{s['hist1d_launches']})" for s in stats)
        + f"; the rename {rename_ms:.1f} ms, seen by the reopen; "
          "remove_schema left no file")


def lean_persist_phase(args, dev, report, lean) -> None:
    """The lean phase's snapshot (flushed after its tombstoning age_off):
    the store dropped (its device memory must fall), reopened, the lazy
    streaming index rebuild timed inside the first query, the
    estimator-costed queries against the oracle less the tombstones,
    ``get_count`` and ``Count()``, and the accounted device bytes next
    to ``torch.cuda.memory_allocated``."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore

    cuda = dev.type == "cuda"
    cat = lean["catalog"]
    x, y, t = lean["cols"]
    live = ~lean["tombstone"]
    n = len(x)
    persisted = lean["persisted"]
    alloc = allocated_after_gc(cuda)
    if cuda and alloc >= persisted["memory_allocated"]:
        raise AssertionError(f"lean persist: dropping the store left {alloc} "
                             f"bytes allocated (was "
                             f"{persisted['memory_allocated']})")
    t0 = time.perf_counter()
    ds = TpuDataStore(device=dev, catalog_dir=cat)
    reopen_s = time.perf_counter() - t0
    store = ds._store("scale")
    if (not store.lean or len(store.batch) != n or store._indexes
            or int(store.tombstone.sum()) != int((~live).sum())):
        raise AssertionError(f"lean persist: reopened {len(store.batch)} "
                             f"rows, indexes {sorted(store._indexes)}")
    rows = []
    for i, (kind, ecql, boxes, lo, hi) in enumerate(lean["checks"]):
        t0 = time.perf_counter()
        res = ds.query_result("scale", ecql)
        ms = (time.perf_counter() - t0) * 1e3
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        want = want[live[want]]
        # the first plan precedes the index (its rebuild runs in the
        # scan), so the estimator has no cell counts yet and it is costed
        # from the persisted stats, as in the JAX package; the rest from
        # the sketch
        if (res.strategy.index != "z3"
                or res.strategy.source != ("stats" if i == 0 else "sketch")
                or not np.array_equal(res.positions, want)):
            raise AssertionError(
                f"lean persist {kind}: {res.strategy.index} "
                f"({res.strategy.source}), {len(res.positions)} hits, "
                f"oracle {len(want)}")
        rows.append({"query": kind, "ms": ms, "hits": int(len(want)),
                     "source": res.strategy.source})
    idx = store._indexes["z3"]
    launches = (device_launches(lambda: ds.query_result(
        "scale", lean["checks"][0][1])) if cuda else None)
    count = ds.get_count("scale")
    t0 = time.perf_counter()
    counted = ds.stats("scale", "INCLUDE", "Count()").count
    count_ms = (time.perf_counter() - t0) * 1e3
    if count != counted or count != int(live.sum()):
        raise AssertionError(f"lean persist: get_count {count}, Count() "
                             f"{counted}, oracle {int(live.sum())}")
    dev_bytes = idx.device_bytes()
    grown = (int(torch.cuda.memory_allocated()) - alloc) if cuda else None
    if cuda and not 0.99 <= grown / dev_bytes <= 1.05:
        raise AssertionError(f"lean persist: {grown} bytes allocated since "
                             f"the reopen, {dev_bytes} accounted")
    lat = np.array([r["ms"] for r in rows[1:]])
    report["lean_persist"] = {
        "rows": n, "flush_s": persisted["flush_s"],
        "flush_rows_per_s": n / persisted["flush_s"],
        "bytes": persisted["bytes"], "parts": persisted["parts"],
        "reopen_s": reopen_s, "first_query_ms": rows[0]["ms"],
        "recover_s": reopen_s + rows[0]["ms"] / 1e3, "queries": rows,
        "query_ms_p50": float(np.median(lat)), "tiers": idx.tier_counts(),
        "get_count": count, "count_ms": count_ms,
        "device_bytes": dev_bytes, "allocated_since_reopen": grown,
        "device_launches": launches}
    log(f"lean persist: reopen {reopen_s:.2f} s; the first query (the lazy "
        f"streaming rebuild of {n} rows) {rows[0]['ms']:.1f} ms, time to "
        f"recover {reopen_s + rows[0]['ms'] / 1e3:.2f} s; tiers "
        f"{idx.tier_counts()}; {len(rows)} queries equal to the oracle less "
        f"the tombstones, the rest p50 {np.median(lat):.1f} ms; get_count "
        f"and Count() {count} ({count_ms:.1f} ms); device bytes {dev_bytes} "
        f"accounted, {grown} allocated since the reopen")
    del ds, store, idx
    allocated_after_gc(cuda)


def fsds_phase(rng, args, centres, qs, dev, report) -> None:
    """``FileSystemDataStore`` with the daily datetime scheme:
    ``--fsds-rows`` GDELT-like rows over 2018 in 4 writes (365 partitions,
    4 files each); a city-week BBOX+DURING query pruned on the host
    against the oracle, reading only the week's days and the one-day
    over-cover on each side; ``compact`` (one file a partition); the
    store rediscovered from disk; then ``to_device_store`` on the card and
    the query and a BBOX-only one through z3 and z2, equal to the oracle
    and to ``fs.query``."""
    import numpy as np
    from geomesa_tpu_torch.filters import parse_ecql
    from geomesa_tpu_torch.fs import FileSystemDataStore, to_device_store

    n = args.fsds_rows
    per = n // 4
    root = tempfile.mkdtemp(prefix="chip_smoke_fsds_")
    try:
        catalog_room(root, n * 200)
        fs = FileSystemDataStore(root)
        fs.create_schema("gdelt", LIFE_SPEC, {"scheme": "datetime",
                                              "datetime-step": "daily"})
        actors = np.array(["USA", "GBR", "FRA", "CHN"], dtype=object)
        cols, write_s = [], []
        for _ in range(4):
            x, y, t = gdelt_like(rng, per, centres)
            cols.append((x, y, t))
            t0 = time.perf_counter()
            fs.write("gdelt", {"actor": actors[rng.integers(0, 4, per)],
                               "dtg": t, "geom": (x, y)})
            write_s.append(time.perf_counter() - t0)
        x, y, t = (np.concatenate(c) for c in zip(*cols))
        del cols
        info = fs.partition_info("gdelt")
        if (len(info) != 365 or fs.count("gdelt") != n
                or {v["files"] for v in info.values()} != {4}):
            raise AssertionError(f"fsds: {len(info)} partitions, "
                                 f"{fs.count('gdelt')} rows")
        city = next(q for q in qs if q[0] == "city")[1][0]
        lo, hi = MS_2018 + 59 * DAY, MS_2018 + 66 * DAY   # Mar 1 to Mar 8
        q = (f"BBOX(geom, {city[0]}, {city[1]}, {city[2]}, {city[3]}) "
             f"AND dtg DURING {iso(lo)}/{iso(hi)}")
        q2 = f"BBOX(geom, {city[0]}, {city[1]}, {city[2]}, {city[3]})"
        want = oracle(x, y, t, [city], lo, hi)
        want2 = box_oracle(x, y, [city])
        read = fs._storage("gdelt")._select_partitions(parse_ecql(q))
        # the scheme over-covers the window by a day on each side
        days = (hi + DAY) // DAY - (lo - DAY) // DAY + 1

        def host_query(label):
            t0 = time.perf_counter()
            got = fs.query("gdelt", q)
            ms = (time.perf_counter() - t0) * 1e3
            ids = np.sort(got.ids.astype(np.int64))
            if not np.array_equal(ids, want):
                raise AssertionError(f"fsds {label}: {len(ids)} hits, "
                                     f"oracle {len(want)}")
            return ms

        query_ms = host_query("pruned query")
        if len(read) != days:
            raise AssertionError(f"fsds: the pruned query read {len(read)} "
                                 f"partitions, not {days}")
        t0 = time.perf_counter()
        fs.compact("gdelt")
        compact_s = time.perf_counter() - t0
        if {v["files"] for v in fs.partition_info("gdelt").values()} != {1}:
            raise AssertionError("fsds: compact left several files in a "
                                 "partition")
        compacted_ms = host_query("query after compact")
        t0 = time.perf_counter()
        fs = FileSystemDataStore(root)
        rediscover_ms = (time.perf_counter() - t0) * 1e3
        if fs.type_names != ["gdelt"] or fs.count("gdelt") != n:
            raise AssertionError(f"fsds: rediscovered {fs.type_names}")
        rediscovered_ms = host_query("query after rediscovery")
        t0 = time.perf_counter()
        ds = to_device_store(fs, "gdelt", device=dev)
        lift_s = time.perf_counter() - t0
        device = []
        for label, ecql, index, w in (("bbox-during", q, "z3", want),
                                      ("bbox", q2, "z2", want2)):
            t0 = time.perf_counter()
            res = ds.query_result("gdelt", ecql)
            ms = (time.perf_counter() - t0) * 1e3
            ids = np.sort(res.batch.ids.astype(np.int64))
            host = np.sort(fs.query("gdelt", ecql).ids.astype(np.int64))
            if (res.strategy.index != index or not np.array_equal(ids, w)
                    or not np.array_equal(host, w)):
                raise AssertionError(f"fsds device {label}: "
                                     f"{res.strategy.index}, {len(ids)} hits, "
                                     f"host {len(host)}, oracle {len(w)}")
            device.append({"query": label, "ms": ms, "hits": int(len(w)),
                           "strategy": index})
        del ds
        report["fsds"] = {
            "rows": n, "write_s": write_s,
            "write_rows_per_s": [per / s for s in write_s],
            "partitions": len(info), "bytes": dir_bytes(root),
            "partitions_read": len(read), "query_ms": query_ms,
            "compact_s": compact_s, "query_after_compact_ms": compacted_ms,
            "rediscover_ms": rediscover_ms,
            "query_after_rediscovery_ms": rediscovered_ms,
            "to_device_store_s": lift_s, "device_queries": device}
        log(f"fsds: {n} rows in 4 writes "
            f"({', '.join(f'{s:.2f}' for s in write_s)} s), {len(info)} "
            f"partitions; the city-week query read {len(read)} partitions "
            f"in {query_ms:.1f} ms, {len(want)} hits equal to the oracle; "
            f"compact {compact_s:.2f} s, then {compacted_ms:.1f} ms; "
            f"rediscovered in {rediscover_ms:.1f} ms; to_device_store "
            f"{lift_s:.2f} s; on the card "
            + ", ".join(f"{d['query']} {d['ms']:.1f} ms ({d['strategy']})"
                        for d in device))
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: the attribute phases' schema: GDELT's actor code and GoldsteinScale
ATTR_SPEC = ("actor:String:index=true,score:Double:index=true,dtg:Date,"
             "*geom:Point")
#: the rare actor code (about 0.01% of the rows)
RARE_ACTOR = "QQQ"
#: the actor codes that LIKE 'U%' matches, placed in the Zipf tail
U_ACTORS = ("USA", "UKR", "UGA", "URY", "UZB")


def actor_codes(rng):
    """About 200 three-letter actor codes with Zipf(1.1) frequencies, the
    ``U_ACTORS`` at ranks 150-154, plus ``RARE_ACTOR`` at 0.01%: the
    codes (fixed-width, the rare one last) and their probabilities."""
    import numpy as np
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTVWXYZ"))   # no U
    codes: list = []
    while len(codes) < 200:
        c = "".join(rng.choice(letters, 3))
        if c not in codes and c != RARE_ACTOR:
            codes.append(c)
    codes[150:150 + len(U_ACTORS)] = U_ACTORS
    w = 1.0 / np.arange(1, 201) ** 1.1
    p = np.r_[w / w.sum() * (1.0 - 1e-4), 1e-4]
    return np.array(codes + [RARE_ACTOR]), p


def attr_rows(rng, n: int, centres, p):
    """``n`` GDELT-like rows with an actor code index (into the codes of
    :func:`actor_codes`) and a GoldsteinScale-like score, a multiple of
    0.1 in [-10, 10]."""
    import numpy as np
    x, y, t = gdelt_like(rng, n, centres)
    aidx = rng.choice(len(p), n, p=p).astype(np.int16)
    score = rng.integers(-100, 101, n) / 10.0
    return x, y, t, aidx, score


def attr_queries(codes, centres, lean: bool) -> list:
    """(name, ecql, expected strategy, oracle mask function) for the
    attribute phases.  The oracle takes ``(x, y, t, aidx, score)``."""
    import numpy as np
    cx, cy = centres[3]
    city = (cx - 0.5, cy - 0.5, cx + 0.5, cy + 0.5)
    continent = (-20.0, 20.0, 40.0, 60.0)
    month = (MS_2018 + 59 * DAY, MS_2018 + 90 * DAY - 1000)
    day = (MS_2018 + 100 * DAY, MS_2018 + 101 * DAY - 1000)
    mid = (20, 21)
    u_idx = [int(np.flatnonzero(codes == c)[0]) for c in U_ACTORS]
    rare = len(codes) - 1

    def bbox(b):
        return f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"

    def during(w):
        return f"dtg DURING {iso(w[0])}/{iso(w[1])}"

    def inbox(x, y, b):
        return (x >= b[0]) & (x <= b[2]) & (y >= b[1]) & (y <= b[3])

    def inwin(t, w):
        return (t >= w[0]) & (t <= w[1])

    qs = [
        ("rare-continent-month",
         f"actor = '{RARE_ACTOR}' AND {bbox(continent)} AND {during(month)}",
         "attr:actor",
         lambda x, y, t, a, s: (a == rare) & inbox(x, y, continent)
         & inwin(t, month)),
        ("in-two-mid",
         f"actor IN ('{codes[mid[0]]}', '{codes[mid[1]]}')", "attr:actor",
         lambda x, y, t, a, s: np.isin(a, mid)),
        ("score-band", "score BETWEEN 2.95 AND 3.05", "attr:score",
         lambda x, y, t, a, s: (s >= 2.95) & (s <= 3.05)),
        ("like-U", "actor LIKE 'U%'", "attr:actor",
         lambda x, y, t, a, s: np.isin(a, u_idx)),
        ("city-day", f"{bbox(city)} AND {during(day)}", "z3",
         lambda x, y, t, a, s: inbox(x, y, city) & inwin(t, day)),
    ]
    if lean:
        qs += [
            ("actor-day", f"actor = '{codes[10]}' AND {during(day)}",
             "attr:actor",
             lambda x, y, t, a, s: (a == 10) & inwin(t, day)),
            ("top-actor-city-day",
             f"actor = '{codes[0]}' AND {bbox(city)} AND {during(day)}",
             "z3",
             lambda x, y, t, a, s: (a == 0) & inbox(x, y, city)
             & inwin(t, day)),
        ]
    return qs


def run_attr_query(ds, schema, q, cols, source=None) -> dict:
    """One attribute-phase query: strategy (and, when given, cost source)
    as expected, positions equal to the oracle; its ms, plan source and
    candidate count (the explain trace's "scanned")."""
    import re
    import numpy as np
    from geomesa_tpu_torch.planning import ExplainString
    name, ecql, strategy, mask = q
    ex = ExplainString()
    t0 = time.perf_counter()
    res = ds.query_result(schema, ecql, ex)
    ms = (time.perf_counter() - t0) * 1e3
    want = np.flatnonzero(mask(*cols))
    st = res.strategy
    if st.index != strategy or (source is not None and st.source != source):
        raise AssertionError(f"attr {name}: strategy {st.index} "
                             f"({st.source}), expected {strategy} "
                             f"({source})")
    if not np.array_equal(res.positions, want):
        raise AssertionError(f"attr {name}: {len(res.positions)} hits, "
                             f"oracle {len(want)}")
    scanned = re.search(r"scanned (\d+)", str(ex))
    return {"query": name, "strategy": st.index, "source": st.source,
            "cost": float(st.cost), "ms": ms, "plan_ms": res.plan_time_ms,
            "scan_ms": res.scan_time_ms, "hits": int(len(want)),
            "candidates": int(scanned.group(1)) if scanned else None}


def attr_phase(rng, args, centres, dev, report):
    """Attribute indexes on the default profile: ``--attr-rows`` rows in 4
    writes, the z3-tiered host indexes of ``actor`` and ``score``, five
    queries (rare actor with a continent BBOX and a month, actor IN, a
    score band, LIKE 'U%', and a city BBOX + day that stays on z3) with
    their strategies and oracles; then a 1M-row append (the kept
    indexes' tail) and the same queries again."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore
    from geomesa_tpu_torch.index.attribute import AttributeIndex

    codes, p = actor_codes(rng)
    ds = TpuDataStore(device=dev)
    ds.create_schema("attrs", ATTR_SPEC)
    per = args.attr_rows // 4
    parts, write_s = [], []
    for _ in range(4):
        x, y, t, a, s = attr_rows(rng, per, centres, p)
        parts.append((x, y, t, a, s))
        t0 = time.perf_counter()
        ds.write("attrs", {"actor": codes[a], "score": s, "dtg": t,
                           "geom": (x, y)})
        write_s.append(time.perf_counter() - t0)
    store = ds._store("attrs")
    # the z3 index, which the city query would build, built and timed
    # apart, then the two attribute indexes
    t0 = time.perf_counter()
    store.z3_index()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build = {"z3": time.perf_counter() - t0}
    for attr in ("actor", "score"):
        t0 = time.perf_counter()
        idx = store.attribute_index(attr)
        build[attr] = time.perf_counter() - t0
        if not isinstance(idx, AttributeIndex) or idx.sec_z is None:
            raise AssertionError(f"attribute index of {attr}: "
                                 f"{type(idx).__name__}, no z3 tier")
    qs = attr_queries(codes, centres, lean=False)

    def cols():
        return tuple(np.concatenate(c) for c in zip(*parts))

    c = cols()
    rows = [run_attr_query(ds, "attrs", q, c) for q in qs]
    # an append: the kept indexes serve it as their tail (1M rows at the
    # default size, a 16th of the rows below it: under the rebuild
    # fraction)
    m = min(1_000_000, per // 4)
    x, y, t, a, s = attr_rows(rng, m, centres, p)
    parts.append((x, y, t, a, s))
    t0 = time.perf_counter()
    ds.write("attrs", {"actor": codes[a], "score": s, "dtg": t,
                       "geom": (x, y)})
    append_s = time.perf_counter() - t0
    c = cols()
    after = [run_attr_query(ds, "attrs", q, c) for q in qs]
    tail = store.index_tail("attr:actor")
    if (tail is None or len(tail) != m
            or store.build_counts.get("attr:actor") != 1):
        raise AssertionError(f"the kept actor index: tail "
                             f"{None if tail is None else len(tail)}, "
                             f"builds {store.build_counts}")
    report["attr"] = {"rows": 4 * per, "codes": len(codes),
                      "write_s": write_s,
                      "write_rows_per_s": [per / w for w in write_s],
                      "build_s": build, "queries": rows,
                      "append_s": append_s, "after_append": after,
                      "build_counts": dict(store.build_counts)}
    log(f"attr: {4 * per} rows in 4 writes "
        f"({', '.join(f'{w:.2f}' for w in write_s)} s); indexes built "
        f"z3 {build['z3']:.2f} s, actor {build['actor']:.2f} s, score "
        f"{build['score']:.2f} s; "
        "queries equal to the oracle: "
        + ", ".join(f"{r['query']} {r['strategy']} {r['hits']} hits "
                    f"{r['candidates']} candidates {r['ms']:.1f} ms"
                    for r in rows)
        + f"; after a {m}-row append ({append_s:.2f} s, tail {len(tail)}): "
        + ", ".join(f"{r['query']} {r['ms']:.1f} ms" for r in after))
    del ds, store


def mesh_attr_phase(rng, args, centres, dev, report):
    """The sharded attribute index on a one-card mesh: ``--attr-mesh-rows``
    rows, an actor equality with a time window (the z3 tier) and a score
    range, each against the oracle."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, device_mesh
    from geomesa_tpu_torch.parallel.attribute import ShardedAttributeIndex

    codes, p = actor_codes(rng)
    ds = TpuDataStore(device=dev, mesh=device_mesh(1))
    ds.create_schema("events", ATTR_SPEC)
    n = args.attr_mesh_rows
    cols = attr_rows(rng, n, centres, p)
    x, y, t, a, s = cols
    t0 = time.perf_counter()
    ds.write("events", {"actor": codes[a], "score": s, "dtg": t,
                        "geom": (x, y)})
    write_s = time.perf_counter() - t0
    store = ds._store("events")
    t0 = time.perf_counter()
    idx = store.attribute_index("actor")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not isinstance(idx, ShardedAttributeIndex) or idx.tier != "z3":
        raise AssertionError(f"mesh attribute index {type(idx).__name__}")
    week = (MS_2018 + 150 * DAY, MS_2018 + 157 * DAY - 1000)
    qs = [("actor-week", f"actor = '{codes[5]}' AND dtg DURING "
           f"{iso(week[0])}/{iso(week[1])}", "attr:actor",
           lambda x, y, t, a, s: (a == 5) & (t >= week[0]) & (t <= week[1])),
          ("score-range", "score >= 9.8", "attr:score",
           lambda x, y, t, a, s: s >= 9.8)]
    rows = [run_attr_query(ds, "events", q, cols) for q in qs]
    report["mesh_attr"] = {"rows": n, "write_s": write_s,
                           "build_s": build_s, "queries": rows}
    log(f"mesh attr: {n} rows ({write_s:.2f} s), sharded actor index "
        f"(z3 tier) built in {build_s:.2f} s; queries equal to the oracle: "
        + ", ".join(f"{r['query']} {r['strategy']} {r['hits']} hits "
                    f"{r['ms']:.1f} ms" for r in rows))
    del ds, store, idx


#: the lean attribute phase's budget, in bytes a generation slot: the z3
#: index gets 0.75 of it (156 B), one full and three keys generations
#: beside its sentinel charges; each attribute index gets its floor of
#: two class-default generations, one live device generation beside its
#: sentinel charge, the rest on the host
LEAN_ATTR_BUDGET_PER_SLOT = 208


def lean_attr_phase(rng, args, centres, dev, report):
    """The lean profile with attribute indexes: ``--lean-attr-rows`` rows
    in 4 writes, attribute generations on the device and the host, the
    z3 index under the carve-out; the attribute queries (estimator-
    costed), the attribute sketch push-down of MinMax, Histogram,
    Frequency and Count against numpy oracles (cold and warm folds), the
    estimator's choice for the rare-actor continent query, then
    ``compact`` and two queries again."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore
    from geomesa_tpu_torch.stats.stat import Frequency, Histogram

    cuda = dev.type == "cuda"
    # a dropped lean store frees its device memory only when the cyclic
    # collector runs (PERF.md §7): collect the lean phase's store, so that
    # memory_allocated below reads this phase's
    gc.collect()
    slots = args.lean_attr_slots
    budget = LEAN_ATTR_BUDGET_PER_SLOT * slots
    ud = ["geomesa.index.profile=lean", f"geomesa.lean.hbm.budget={budget}",
          f"geomesa.lean.generation.slots={slots}",
          "geomesa.lean.compaction.factor=0"]
    codes, p = actor_codes(rng)
    ds = TpuDataStore(device=dev)
    ds.create_schema("lattrs", f"{ATTR_SPEC};{','.join(ud)}")
    store = ds._store("lattrs")
    per = args.lean_attr_rows // 4
    parts, write_s = [], []
    for _ in range(4):
        x, y, t, a, s = attr_rows(rng, per, centres, p)
        parts.append((x, y, t, a, s))
        t0 = time.perf_counter()
        ds.write("lattrs", {"actor": codes[a], "score": s, "dtg": t,
                            "geom": (x, y)})
        for key in ("z3", "attr:actor", "attr:score"):
            store._indexes[key].block()
        write_s.append(time.perf_counter() - t0)
    n = 4 * per
    cols = tuple(np.concatenate(c) for c in zip(*parts))
    del parts
    x, y, t, a, s = cols
    if store.batch.column("actor").dtype.kind != "U":
        raise AssertionError("the lean actor column is not fixed-width")
    idxs = {k: store._indexes[k] for k in ("z3", "attr:actor", "attr:score")}
    tiers = {k: i.tier_counts() for k, i in idxs.items()}
    if (tiers["attr:actor"]["host"] == 0 or tiers["attr:score"]["host"] == 0
            or tiers["z3"]["keys"] == 0 or tiers["z3"]["host"] == 0):
        raise AssertionError(f"lean attribute tiers {tiers}")
    dev_bytes = {k: i.device_bytes() for k, i in idxs.items()}
    rep = {"rows": n, "slots": slots, "budget_bytes": budget,
           "write_s": write_s, "write_rows_per_s": [per / w for w in write_s],
           "tiers": tiers, "device_bytes": dev_bytes,
           "device_bytes_total": sum(dev_bytes.values()),
           "memory_allocated": (int(torch.cuda.memory_allocated())
                                if cuda else None),
           "z3_budget_bytes": idxs["z3"].hbm_budget_bytes,
           "attr_budget_bytes": idxs["attr:actor"].hbm_budget_bytes}
    log(f"lean attr: {n} rows in 4 writes "
        f"({', '.join(f'{w:.2f}' for w in write_s)} s); tiers {tiers}; "
        f"accounted device bytes {rep['device_bytes_total']}, allocated "
        f"{rep['memory_allocated']}")

    # the estimator: its cold attribute folds timed apart
    est = store.estimator()
    if est is None:
        raise AssertionError(f"no estimator on a lean store of {n} rows")
    t0 = time.perf_counter()
    est.attr_equals_rows("actor", (RARE_ACTOR,))
    est.attr_range_rows("score", 2.95, 3.05)
    rep["estimator_attr_cold_ms"] = (time.perf_counter() - t0) * 1e3
    qs = attr_queries(codes, centres, lean=True)
    rows = [run_attr_query(ds, "lattrs", q, cols,
                           source=("sketch" if q[0] != "like-U"
                                   else "heuristic"))
            for q in qs]
    lat = np.array([r["ms"] for r in rows])
    rep.update(queries=rows, query_ms_p50=float(np.median(lat)),
               query_ms_max=float(lat.max()))
    log(f"lean attr: estimator cold attribute folds "
        f"{rep['estimator_attr_cold_ms']:.1f} ms; queries equal to the "
        "oracle: " + ", ".join(
            f"{r['query']} {r['strategy']} ({r['source']}) {r['hits']} hits "
            f"{r['candidates']} candidates {r['ms']:.1f} ms" for r in rows))

    # the attribute sketch push-down, cold and warm, against numpy
    routes = StatRoute()
    window = (MS_2018 + 90 * DAY, MS_2018 + 181 * DAY - 1000)
    q_win = (f"BBOX(geom, -180, -90, 180, 90) AND dtg DURING "
             f"{iso(window[0])}/{iso(window[1])}")
    spec = ("Count();MinMax(score);Histogram(score,64,-10,10);"
            "Frequency(score,4,1024)")
    srows = []
    try:
        for name, query, m in (("window", q_win,
                                (t >= window[0]) & (t <= window[1])),
                               ("include", "INCLUDE", None)):
            hit = s if m is None else s[m]
            hist = Histogram("score", 64, -10.0, 10.0)
            hist.observe({"score": hit})
            freq = Frequency("score", 4, 1024)
            freq.observe({"score": hit})
            for turn in ("cold", "warm"):
                t0 = time.perf_counter()
                got, how = routes.run(lambda: ds.stats("lattrs", query,
                                                       spec))
                ms = (time.perf_counter() - t0) * 1e3
                cnt, mm, h, f = got.stats
                if (how != "sketch" or cnt.count != len(hit)
                        or (mm.min, mm.max) != (hit.min(), hit.max())
                        or not np.array_equal(h.counts, hist.counts)
                        or not np.array_equal(f.table, freq.table)):
                    raise AssertionError(f"lean attr stats {name} "
                                         f"({turn}) by {how} disagree with "
                                         f"the oracle")
                srows.append({"query": name, "turn": turn, "ms": ms,
                              "count": int(cnt.count), "route": how})
        # an attribute predicate is not a bbox+time filter: the count
        # materializes through the attribute index in both packages
        t0 = time.perf_counter()
        got, how = routes.run(lambda: ds.stats("lattrs", "score > 9.5",
                                               "Count()"))
        ms = (time.perf_counter() - t0) * 1e3
        want = int((s > 9.5).sum())
        if got.count != want or how != "materialized":
            raise AssertionError(f"lean attr Count(score > 9.5): "
                                 f"{got.count} by {how}, oracle {want}")
        srows.append({"query": "score>9.5", "ms": ms, "count": want,
                      "route": how})
    finally:
        routes.close()
    rep["stats"] = srows
    log("lean attr: stats equal to the oracle: " + ", ".join(
        f"{r['query']} {r.get('turn', '')} {r['ms']:.1f} ms ({r['route']})"
        for r in srows))

    # compaction, then two queries again
    gens = {k: len(i.generations) for k, i in idxs.items()}
    t0 = time.perf_counter()
    res = ds.compact("lattrs")
    for i in idxs.values():
        i.block()
    compact_s = time.perf_counter() - t0
    if not all(k in res for k in idxs):
        raise AssertionError(f"compact covered {sorted(res)}")
    # the host-run merge of the LeanAttrIndex core (which the lean XZ
    # indexes share) must run on the card: at 8 generations each
    # attribute index holds a group of four host runs
    if any(res[k]["merged_groups"] == 0 for k in ("attr:actor", "attr:score")):
        raise AssertionError(f"lean attr compact merged nothing: {res}")
    after = [run_attr_query(ds, "lattrs", q, cols) for q in (qs[0], qs[5])]
    rep["compact"] = {"s": compact_s, "generations_before": gens,
                      "result": res, "queries": after,
                      "device_bytes": {k: i.device_bytes()
                                       for k, i in idxs.items()}}
    log(f"lean attr: compact in {compact_s:.3f} s, generations {gens} → "
        f"{ {k: r['generations'] for k, r in res.items()} }; queries equal "
        "to the oracle: " + ", ".join(f"{r['query']} {r['ms']:.1f} ms"
                                      for r in after))
    report["lean_attr"] = rep
    del ds, store, idxs
    if cuda:
        torch.cuda.empty_cache()


#: the mesh lean phase's budget, in bytes a per-shard generation slot.
#: Each attribute index gets an eighth of it (a quarter split two ways):
#: 48 B, its sentinel charge and live generation at 24 B a slot (an int64
#: gid over a mesh), so every sealed attribute generation spills; the z3
#: index the rest, 288 B: past the sentinel charges (20 + 44 B) room for
#: payload-carrying and keys generations.  A z3 host tier would need the
#: whole budget under 240 B a slot at 8 generations, which leaves the
#: attribute indexes less than their live generation (the same accounting
#: in both packages): the mesh lean z3 phase runs it
MESH_LEAN_BUDGET_PER_SLOT = 384
#: the mesh lean z3 phase: a point schema without attribute indexes at
#: a sixteenth of the mesh lean phase's generation slots (2^18 at the
#: defaults) and 168 B a slot (sentinels 64 B, a live full generation
#: 44 B, three keys generations), so generations pass through the full,
#: keys and host tiers as 8 generations of rows arrive
MESH_LEAN_Z3_BUDGET_PER_SLOT = 168


def mesh_lean_phase(rng, args, centres, qs, dev, report, obs=None):
    """Lean schemas over ``device_mesh(1)``: ``--mesh-lean-rows`` rows of
    the attribute phases' generator in 4 writes on the lean attribute
    schema at ``--mesh-lean-slots``-slot per-shard generations
    (ShardedLeanZ3Index and two ShardedLeanAttrIndexes); the lean phase's
    queries estimator-costed and one replanned, the attribute queries,
    the Count and Z3Histogram push-downs, heatmaps and tiles before and
    after pyramids, a weighted heatmap (the density kernel), compaction,
    then a flush, a drop and a reopen over ``device_mesh(1)``; the
    accounted device bytes against ``torch.cuda.memory_allocated``.  Then
    a point schema whose z3 generations pass through all three tiers.
    ``obs(ds, name, checks)`` runs after the compaction, before the
    flush."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, density_process, device_mesh
    from geomesa_tpu_torch.index.pyramid import pyramid_spec, tile_env
    from geomesa_tpu_torch.parallel import (
        ShardedLeanAttrIndex, ShardedLeanZ3Index,
    )
    from geomesa_tpu_torch.planning import ExplainString

    cuda = dev.type == "cuda"
    base_alloc = allocated_after_gc(cuda)
    slots = args.mesh_lean_slots
    budget = MESH_LEAN_BUDGET_PER_SLOT * slots
    ud = ["geomesa.index.profile=lean", f"geomesa.lean.hbm.budget={budget}",
          f"geomesa.lean.generation.slots={slots}",
          "geomesa.lean.compaction.factor=0"]
    codes, p = actor_codes(rng)
    cat = tempfile.mkdtemp(prefix="chip_smoke_mesh_lean_")
    rep: dict = {"slots": slots, "budget_bytes": budget}
    try:
        ds = TpuDataStore(device=dev, mesh=device_mesh(1), catalog_dir=cat)
        ds.create_schema("mlean", f"{ATTR_SPEC};{','.join(ud)}")
        store = ds._store("mlean")
        per = args.mesh_lean_rows // 4
        parts, write_s = [], []
        for _ in range(4):
            xp, yp, tp, ap, sp = attr_rows(rng, per, centres, p)
            parts.append((xp, yp, tp, ap, sp))
            t0 = time.perf_counter()
            ds.write("mlean", {"actor": codes[ap], "score": sp, "dtg": tp,
                               "geom": (xp, yp)})
            for key in ("z3", "attr:actor", "attr:score"):
                store._indexes[key].block()
            write_s.append(time.perf_counter() - t0)
        n = 4 * per
        cols = tuple(np.concatenate(c) for c in zip(*parts))
        del parts, xp, yp, tp, ap, sp
        x, y, t, a, s = cols
        idxs = {k: store._indexes[k] for k in ("z3", "attr:actor",
                                               "attr:score")}
        idx = idxs["z3"]
        if not (isinstance(idx, ShardedLeanZ3Index) and all(
                isinstance(idxs[k], ShardedLeanAttrIndex)
                for k in ("attr:actor", "attr:score"))):
            raise AssertionError(f"mesh lean indexes {idxs}")
        tiers = {k: i.tier_counts() for k, i in idxs.items()}
        if (tiers["z3"]["full"] == 0 or tiers["z3"]["keys"] == 0
                or any(tiers[k]["device"] == 0 or tiers[k]["host"] == 0
                       for k in ("attr:actor", "attr:score"))):
            raise AssertionError(f"mesh lean tiers {tiers}")
        # one shard: generation k holds rows [base_k, base_k + n_k)
        layout, base = [], 0
        for g in idx.generations:
            layout.append((base, g.n, g.tier))
            base += g.n
        if base != n:
            raise AssertionError(f"mesh lean generations hold {base} rows")
        dev_bytes = {k: i.device_bytes() for k, i in idxs.items()}
        alloc = (allocated_after_gc(cuda) - base_alloc) if cuda else None
        total_bytes = sum(dev_bytes.values())
        if cuda and abs(alloc / total_bytes - 1.0) > 0.02:
            raise AssertionError(f"mesh lean: {alloc} bytes allocated, "
                                 f"{total_bytes} accounted")
        rep.update(rows=n, write_s=write_s,
                   write_rows_per_s=[per / w for w in write_s], tiers=tiers,
                   generations=len(idx.generations), device_bytes=dev_bytes,
                   device_bytes_total=total_bytes, memory_allocated=alloc,
                   z3_budget_bytes=idx.hbm_budget_bytes,
                   attr_budget_bytes=idxs["attr:actor"].hbm_budget_bytes)
        log(f"mesh lean: {n} rows in 4 writes "
            f"({', '.join(f'{w:.2f}' for w in write_s)} s); tiers {tiers}; "
            f"accounted device bytes {total_bytes}, allocated {alloc}")

        checks = lean_checks(qs)
        t_min, t_max = int(t.min()), int(t.max())
        est = store.estimator()
        if est is None:
            raise AssertionError(f"no estimator on a mesh lean store of {n} "
                                 "rows")
        t0 = time.perf_counter()
        est.z3_rows([WORLD], [(None, None)])
        rep["estimator_cold_ms"] = (time.perf_counter() - t0) * 1e3
        del est   # it holds the store, which the reopen below drops

        def run_query(ds, kind, ecql, boxes, lo, hi, source="sketch"):
            ex = ExplainString()
            t0 = time.perf_counter()
            res = ds.query_result("mlean", ecql, ex)
            ms = (time.perf_counter() - t0) * 1e3
            want = (box_oracle(x, y, boxes) if lo is None
                    else oracle(x, y, t, boxes, lo, hi))
            st = res.strategy
            if (st.index != "z3" or (source and st.source != source)
                    or not np.array_equal(res.positions, want)):
                raise AssertionError(
                    f"mesh lean {kind} {ecql}: strategy {st.index} "
                    f"({st.source}), {len(res.positions)} hits, oracle "
                    f"{len(want)}")
            return {"query": kind, "ms": ms, "hits": int(len(want)),
                    "source": st.source, "max_ranges": st.max_ranges,
                    "replans": str(ex).count("Replanning:")}

        rows = []
        for c in checks:
            d0 = idx.dispatch_count
            row = run_query(ds, *c)
            row["dispatches"] = idx.dispatch_count - d0
            rows.append(row)
        lat = np.array([r["ms"] for r in rows])
        rep.update(queries=rows, query_ms_p50=float(np.median(lat)),
                   query_ms_max=float(lat.max()))
        kind, _q, boxes, _lo, _hi = checks[8]
        with env_set(REPLAN_ENV):
            row = run_query(ds, kind, checks[8][1], boxes, None, None,
                            source="observed")
        if row["replans"] != 1:
            raise AssertionError(f"mesh lean mispredicted {kind}: "
                                 f"{row['replans']} replans, not 1")
        rep["replan"] = row
        aq = attr_queries(codes, centres, lean=True)
        arows = [run_attr_query(ds, "mlean", q, cols, source="sketch")
                 for q in (aq[0], aq[2])]
        rep["attr_queries"] = arows
        log(f"mesh lean: estimator cold fold {rep['estimator_cold_ms']:.1f} "
            f"ms; {len(rows)} queries equal to the oracle, sketch-costed, "
            f"p50 {np.median(lat):.1f} ms, max {lat.max():.1f} ms; "
            f"mispredicted {kind} replanned once ({row['ms']:.1f} ms); "
            + ", ".join(f"{r['query']} {r['strategy']} {r['ms']:.1f} ms"
                        for r in arows))

        # Count and the whole-extent Z3Histogram pushed down
        routes = StatRoute()
        crow = []
        try:
            t0 = time.perf_counter()
            got, how = routes.run(lambda: ds.stats("mlean", "INCLUDE",
                                                   "Count()").count)
            ms = (time.perf_counter() - t0) * 1e3
            if got != n or how != "count":
                raise AssertionError(f"mesh lean Count(): {got} by {how}")
            crow.append({"query": "include", "ms": ms, "route": how})
            t0 = time.perf_counter()
            hist, how = routes.run(lambda: ds.stats(
                "mlean", "INCLUDE", f"Z3Histogram(geom,dtg,week,{Z3_BITS})"))
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            routes.close()
        want = z3_cells_oracle(x, y, t, Z3_BITS)
        if hist.counts != want or how != "sketch":
            raise AssertionError(f"mesh lean Z3Histogram by {how}: "
                                 f"{sum(hist.counts.values())} rows")
        crow.append({"query": f"z3histogram-{Z3_BITS}", "ms": ms,
                     "route": how})
        rep["count"] = crow

        @functools.lru_cache(maxsize=None)
        def world_oracle(res):
            # as in the lean phase: the coarser grid from the 512 one
            if res < 512:
                f = 512 // res
                return world_oracle(512).reshape(res, f, res, f).sum(
                    axis=(1, 3))
            return lean_density_oracle((x, y, t), layout, [WORLD], t_min,
                                       t_max, WORLD, res, res)

        @functools.lru_cache(maxsize=None)
        def tile3_oracle():
            return lean_density_oracle((x, y, t), layout, [env3], t_min,
                                       t_max, env3, 256, 256)

        def check_grid(name, run, want_fn, size=256):
            h0 = idx.pyramid_serve_hits
            t0 = time.perf_counter()
            grid = run()
            ms = (time.perf_counter() - t0) * 1e3
            want = want_fn()
            if grid.shape != (size, size) or not np.array_equal(grid, want):
                raise AssertionError(f"mesh lean density {name}: "
                                     f"{float(grid.sum())} points, oracle "
                                     f"{float(want.sum())}")
            return {"query": name, "ms": ms, "points": float(want.sum()),
                    "pyramid_served": idx.pyramid_serve_hits - h0}

        box = checks[3][2][0]
        tx = int((box[0] + box[2]) / 2 + 180.0) // 180
        ty = 1 - int((box[1] + box[3]) / 2 + 90.0) // 90
        t3x = int(((box[0] + box[2]) / 2 + 180.0) // 45.0)
        t3y = 7 - int(((box[1] + box[3]) / 2 + 90.0) // 22.5)
        env3 = tile_env(3, t3x, t3y)

        def tiles():
            g = world_oracle(512)
            return [
                (f"tile_1_{tx}_{ty}",
                 lambda: ds.density_tile("mlean", 1, tx, ty),
                 lambda: g[(1 - ty) * 256:(2 - ty) * 256,
                           tx * 256:(tx + 1) * 256]),
                (f"tile_3_{t3x}_{t3y}",
                 lambda: ds.density_tile("mlean", 3, t3x, t3y),
                 tile3_oracle)]

        world = ("world", lambda: density_process(ds, "mlean", "INCLUDE",
                                                  WORLD),
                 lambda: world_oracle(256))
        drows = [check_grid(*world)] + [check_grid(*d) for d in tiles()]
        sealed = len(idx.generations) - 1
        t0 = time.perf_counter()
        built = ds.build_pyramids("mlean")
        build_s = time.perf_counter() - t0
        if built != sealed:
            raise AssertionError(f"mesh lean: built {built} pyramids for "
                                 f"{sealed} sealed generations")
        after = [check_grid(*world)] + [check_grid(*d) for d in tiles()]
        if after[0]["pyramid_served"] != sealed:
            raise AssertionError(f"mesh lean world heatmap: "
                                 f"{after[0]['pyramid_served']} of {sealed} "
                                 "sealed generations from pyramids")
        # the weighted heatmap runs the query path and the density kernel
        kind, q_and, boxes, lo, hi = checks[3]
        hits = oracle(x, y, t, boxes, lo, hi)
        t0 = time.perf_counter()
        grid = density_process(ds, "mlean", q_and, box, weight_attr="score")
        ms = (time.perf_counter() - t0) * 1e3
        want = snap_weighted(x[hits], y[hits], s[hits], box, 256, 256)
        if not np.allclose(grid, want, rtol=1e-5, atol=0.0):
            raise AssertionError("mesh lean weighted density disagrees with "
                                 "the oracle")
        rep["density"] = {"before_pyramids": drows, "pyramids_built": built,
                          "pyramids_s": build_s, "after_pyramids": after,
                          "weighted": {"query": kind, "ms": ms,
                                       "points": int(len(hits))}}
        log("mesh lean: Count and Z3Histogram equal to the oracle ("
            + ", ".join(f"{r['query']} {r['ms']:.1f} ms ({r['route']})"
                        for r in crow)
            + f"); {built} pyramids in {build_s:.2f} s; heatmaps before "
            + ", ".join(f"{r['query']} {r['ms']:.1f} ms" for r in drows)
            + ", after " + ", ".join(
                f"{r['query']} {r['ms']:.1f} ms ({r['pyramid_served']} from "
                "pyramids)" for r in after)
            + f"; weighted {ms:.1f} ms")

        # compaction: fewer generations, inherited pyramids, same answers
        gens_before = len(idx.generations)
        t0 = time.perf_counter()
        res = ds.compact("mlean")
        for i in idxs.values():
            i.block()
        compact_s = time.perf_counter() - t0
        # z3 merges keys runs; each attribute index a group of host runs
        if res["z3"]["generations"] >= gens_before or any(
                res[k]["merged_groups"] == 0
                for k in ("attr:actor", "attr:score")):
            raise AssertionError(f"mesh lean compaction left {res}")
        pyr = idx._pyramid_cache.spec_cache(pyramid_spec(512))
        if not all(g.gen_id in pyr for g in idx.generations[:-1]):
            raise AssertionError("mesh lean: a merged generation did not "
                                 "inherit its parents' pyramids")
        wrow = check_grid(*world)
        again = [run_query(ds, *checks[0]), run_query(ds, *checks[6])]
        rep["compact"] = {"s": compact_s, "generations_before": gens_before,
                          "result": res, "world": wrow, "queries": again}
        if obs is not None:
            obs(ds, "mlean", checks)
        log(f"mesh lean: compact in {compact_s:.2f} s, {gens_before} → "
            f"{ {k: r['generations'] for k, r in res.items()} } "
            "generations; world heatmap "
            f"{wrow['ms']:.1f} ms ({wrow['pyramid_served']} from pyramids)")

        # flush, drop, reopen over device_mesh(1): the first query rebuilds
        # the sharded index by streaming the snapshot
        catalog_room(cat, n * 48)
        t0 = time.perf_counter()
        ds.flush("mlean")
        flush_s = time.perf_counter() - t0
        on_disk = dir_bytes(cat)
        del ds, store, idx, idxs
        dropped = allocated_after_gc(cuda)
        t0 = time.perf_counter()
        ds = TpuDataStore(device=dev, mesh=device_mesh(1), catalog_dir=cat)
        reopen_s = time.perf_counter() - t0
        store = ds._store("mlean")
        if len(store.batch) != n or store._indexes:
            raise AssertionError(f"mesh lean reopen: {len(store.batch)} rows,"
                                 f" indexes {sorted(store._indexes)}")
        first = run_query(ds, *checks[0], source=None)
        rest = [run_query(ds, *c) for c in checks[1:]]
        idx = store._indexes["z3"]
        grown = (allocated_after_gc(cuda) - dropped) if cuda else None
        if not isinstance(idx, ShardedLeanZ3Index):
            raise AssertionError(f"mesh lean reopen: {type(idx).__name__}")
        lat = np.array([r["ms"] for r in rest])
        rep["persist"] = {
            "flush_s": flush_s, "flush_rows_per_s": n / flush_s,
            "bytes": on_disk, "reopen_s": reopen_s,
            "first_query_ms": first["ms"],
            "recover_s": reopen_s + first["ms"] / 1e3,
            "queries_ms_p50": float(np.median(lat)),
            "tiers": idx.tier_counts(), "device_bytes": idx.device_bytes(),
            "allocated_since_reopen": grown}
        log(f"mesh lean: flushed {n} rows in {flush_s:.2f} s ({on_disk} "
            f"bytes); reopen {reopen_s:.2f} s, first query (the streaming "
            f"rebuild) {first['ms']:.1f} ms, time to recover "
            f"{rep['persist']['recover_s']:.2f} s; the rest p50 "
            f"{np.median(lat):.1f} ms; tiers {idx.tier_counts()}; z3 device "
            f"bytes {idx.device_bytes()} accounted, {grown} allocated since "
            "the reopen")
        del ds, store, idx
    finally:
        shutil.rmtree(cat, ignore_errors=True)
    allocated_after_gc(cuda)

    # a point schema whose z3 generations pass through every tier
    slots = args.mesh_lean_slots >> 4
    budget = MESH_LEAN_Z3_BUDGET_PER_SLOT * slots
    ds = TpuDataStore(device=dev, mesh=device_mesh(1))
    ds.create_schema("mz3", "dtg:Date,*geom:Point;geomesa.index.profile=lean,"
                     f"geomesa.lean.hbm.budget={budget},"
                     f"geomesa.lean.generation.slots={slots},"
                     "geomesa.lean.compaction.factor=0")
    per = 2 * slots
    parts, seen = [], set()
    for _ in range(4):
        xp, yp, tp = gdelt_like(rng, per, centres)
        parts.append((xp, yp, tp))
        ds.write("mz3", {"dtg": tp, "geom": (xp, yp)})
        seen |= {k for k, v in ds._store("mz3").index("z3")
                 .tier_counts().items() if v}
    x, y, t = (np.concatenate(c) for c in zip(*parts))
    idx = ds._store("mz3").index("z3")
    if seen != {"full", "keys", "host"}:
        raise AssertionError(f"mesh lean z3 tiers seen {seen}")
    zrows = []
    for c in checks:
        kind, ecql, boxes, lo, hi = c
        t0 = time.perf_counter()
        res = ds.query_result("mz3", ecql)
        ms = (time.perf_counter() - t0) * 1e3
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        if not np.array_equal(res.positions, want):
            raise AssertionError(f"mesh lean z3 {kind}: "
                                 f"{len(res.positions)} hits, oracle "
                                 f"{len(want)}")
        zrows.append({"query": kind, "ms": ms, "hits": int(len(want))})
    grid = density_process(ds, "mz3", "INCLUDE", WORLD)
    if grid.sum() != len(x):
        raise AssertionError("mesh lean z3 world heatmap lost rows")
    rep["z3_tiers"] = {"rows": len(x), "slots": slots, "budget": budget,
                       "tiers_seen": sorted(seen),
                       "tiers": idx.tier_counts(), "queries": zrows}
    log(f"mesh lean z3: {len(x)} rows; tiers seen {sorted(seen)}, at the "
        f"end {idx.tier_counts()}; {len(zrows)} queries equal to the oracle")
    report["mesh_lean"] = rep
    del ds, idx
    allocated_after_gc(cuda)


#: poly_scale_proof.py's OSM-building-shaped stream (``_slice_data``):
#: footprint centres drawn from four hotspots (New York, Paris, Beijing,
#: Johannesburg) with σ = 15° in x and 10° in y, half-sides U(0.0005,
#: 0.01)°, and a kind of road/building/park/water/rare
POLY_HOTSPOTS = ((-74.0, 40.7), (2.3, 48.8), (116.4, 39.9), (28.0, -26.2))
POLY_KINDS = ("road", "building", "park", "water", "rare")
POLY_KIND_P = (0.4, 0.4, 0.1, 0.0999, 0.0001)
POLY_SPEC = "kind:String:index=true,dtg:Date,*geom:Polygon"
LEAN_POLY_SPEC = "kind:String:index=true,*geom:Polygon"
#: the lean polygon phases' budget, in bytes a generation slot: the xz
#: index gets 0.75 of it (45 B: its sentinel charge and device
#: generations of 20 B slots, the rest on the host); the kind index its
#: floor of two class-default generations
LEAN_POLY_BUDGET_PER_SLOT = 60
#: the mesh lean polygon phases' budget a per-shard slot: the xz index
#: gets 75 B (its sentinel charge and two device generations at 24 B a
#: slot — the live one and one sealed — the rest on the host), the kind
#: index its floor of two class-default generations
MESH_LEAN_POLY_BUDGET_PER_SLOT = 100
#: the continent window of the polygon phases: South America, away from
#: the hotspots (the widest range plan, a sparse tail of rows)
CONTINENT = (-85.0, -56.0, -34.0, 12.0)


def footprints(rng, n: int):
    """``n`` footprints as ``poly_scale_proof._slice_data`` draws them:
    ``(bbox (n, 4), kind index, dtg uniform over 2018)``."""
    import numpy as np
    hs = np.asarray(POLY_HOTSPOTS)
    hot = rng.integers(0, len(hs), n)
    x = np.clip(hs[hot, 0] + rng.normal(0, 15.0, n), -179.8, 179.8)
    y = np.clip(hs[hot, 1] + rng.normal(0, 10.0, n), -84.8, 84.8)
    w = rng.uniform(0.0005, 0.01, n)
    h = rng.uniform(0.0005, 0.01, n)
    bbox = np.stack([x - w, y - h, x + w, y + h], axis=1)
    kind = rng.choice(len(POLY_KINDS), n, p=POLY_KIND_P).astype(np.uint8)
    t = rng.integers(MS_2018, MS_2019, n)
    return bbox, kind, t


def rect_box(bb, box, chunk: int = 1 << 24):
    """Rows whose rectangle meets ``box`` (closed intervals on both
    axes): the oracle of a BBOX query over axis-aligned footprints."""
    import numpy as np
    out = []
    for lo in range(0, len(bb), chunk):
        b = bb[lo:lo + chunk]
        out.append(lo + np.flatnonzero(
            (b[:, 0] <= box[2]) & (b[:, 2] >= box[0])
            & (b[:, 1] <= box[3]) & (b[:, 3] >= box[1])))
    return np.concatenate(out)


def rect_convex(bb, ring):
    """Rows whose rectangle meets the convex polygon ``ring`` (vertices,
    not closed): the separating-axis test over both rectangle axes and
    every edge normal of the polygon, closed intervals."""
    import numpy as np
    pts = np.asarray(ring, np.float64)
    env = (pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(),
           pts[:, 1].max())
    cand = rect_box(bb, env)
    b = bb[cand]
    keep = np.ones(len(cand), bool)
    for i in range(len(pts)):
        (ax, ay), (bx, by) = pts[i], pts[(i + 1) % len(pts)]
        nx, ny = by - ay, ax - bx
        proj = pts[:, 0] * nx + pts[:, 1] * ny
        rmin = (np.minimum(nx * b[:, 0], nx * b[:, 2])
                + np.minimum(ny * b[:, 1], ny * b[:, 3]))
        rmax = (np.maximum(nx * b[:, 0], nx * b[:, 2])
                + np.maximum(ny * b[:, 1], ny * b[:, 3]))
        keep &= (rmax >= proj.min()) & (rmin <= proj.max())
    return cand[keep]


def _wkt_ring(ring) -> str:
    pts = list(ring) + [ring[0]]
    return ", ".join(f"{x} {y}" for x, y in pts)


def poly_queries(rng, n_rows: int, dtg: bool, lean: bool) -> list:
    """The polygon phases' queries as dicts: ``name``, ``ecql``, the
    expected ``strategy``, the query ``env`` and time window (for the
    range-planning timings) and ``oracle(bb, kind, t)`` → positions."""
    import numpy as np
    (nyx, nyy), (pax, pay), (bjx, bjy), (jox, joy) = POLY_HOTSPOTS
    city = [(nyx - 0.6, nyy - 0.5), (nyx + 0.6, nyy - 0.3),
            (nyx, nyy + 0.6)]
    region = [(pax - 3.0, pay - 2.5), (pax + 3.0, pay - 2.0),
              (pax + 0.5, pay + 3.0)]
    bj_box = (bjx - 2.0, bjy - 1.5, bjx + 2.0, bjy + 1.5)
    jo_tri = [(jox - 2.5, joy - 2.0), (jox + 2.5, joy - 1.5),
              (jox, joy + 2.5)]
    continent = [(-82.0, 12.0), (-34.0, -6.0), (-70.0, -56.0)]
    day = MS_2018 + int(rng.integers(0, 360)) * DAY
    day_w = (day, day + DAY - 1000)
    week = MS_2018 + int(rng.integers(0, 350)) * DAY
    week_w = (week, week + 7 * DAY - 1000)
    rare = POLY_KINDS.index("rare")
    ids = np.sort(rng.choice(n_rows, 5, replace=False))

    def env_of(ring):
        a = np.asarray(ring)
        return (a[:, 0].min(), a[:, 1].min(), a[:, 0].max(), a[:, 1].max())

    def inter(ring):
        return f"INTERSECTS(geom, POLYGON(({_wkt_ring(ring)})))"

    def bbox(b):
        return f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"

    def during(w):
        return f"dtg DURING {iso(w[0])}/{iso(w[1])}"

    def inwin(t, w):
        return (t >= w[0]) & (t <= w[1])

    def q(name, ecql, strategy, env, window, oracle):
        return {"name": name, "ecql": ecql, "strategy": strategy,
                "env": env, "window": window, "oracle": oracle}

    qs = []
    if dtg:
        qs += [
            q("city-day", f"{inter(city)} AND {during(day_w)}", "xz3",
              env_of(city), day_w,
              lambda bb, k, t: (lambda c: c[inwin(t[c], day_w)])(
                  rect_convex(bb, city))),
            q("region-week", f"{inter(region)} AND {during(week_w)}", "xz3",
              env_of(region), week_w,
              lambda bb, k, t: (lambda c: c[inwin(t[c], week_w)])(
                  rect_convex(bb, region))),
            q("during-day", during(day_w), "xz3", WORLD, day_w,
              lambda bb, k, t: np.flatnonzero(inwin(t, day_w))),
        ]
    strategy2 = "xz2" if not (lean and dtg) else "xz3"
    window2 = None if strategy2 == "xz2" else (None, None)
    qs += [
        q("bbox-city", bbox(bj_box), strategy2, bj_box, window2,
          lambda bb, k, t: rect_box(bb, bj_box)),
        q("intersects-region", inter(jo_tri), strategy2, env_of(jo_tri),
          window2, lambda bb, k, t: rect_convex(bb, jo_tri)),
        q("intersects-continent", inter(continent), strategy2,
          env_of(continent), window2,
          lambda bb, k, t: rect_convex(bb, continent)),
    ]
    if lean and not dtg:
        qs += [
            q("intersects-city", inter(city), "xz2", env_of(city), None,
              lambda bb, k, t: rect_convex(bb, city)),
            q("bbox-continent", bbox(CONTINENT), "xz2", CONTINENT, None,
              lambda bb, k, t: rect_box(bb, CONTINENT)),
        ]
    if not (lean and dtg):
        qs += [
            q("rare-continent", f"kind = 'rare' AND {bbox(CONTINENT)}",
              "attr:kind", None, None,
              lambda bb, k, t: (lambda c: c[k[c] == rare])(
                  rect_box(bb, CONTINENT))),
            q("ids", "IN (" + ", ".join(f"'{i}'" for i in ids) + ")", "id",
              None, None, lambda bb, k, t: ids),
        ]
    return qs


def run_poly_query(ds, schema, q, cols, sweeps: bool) -> dict:
    """One polygon-phase query: strategy as expected, positions equal to
    the oracle; its ms, the explain trace's candidate count, and (with
    ``sweeps``) its range planning timed with the native sweep and with
    the numpy sweep, whose outputs must agree."""
    import re
    import numpy as np
    from geomesa_tpu_torch.planning import ExplainString
    ex = ExplainString()
    t0 = time.perf_counter()
    res = ds.query_result(schema, q["ecql"], ex)
    ms = (time.perf_counter() - t0) * 1e3
    want = q["oracle"](*cols)
    if res.strategy.index != q["strategy"]:
        raise AssertionError(f"poly {q['name']}: strategy "
                             f"{res.strategy.index}, expected "
                             f"{q['strategy']}")
    if not np.array_equal(res.positions, want):
        raise AssertionError(f"poly {q['name']}: {len(res.positions)} "
                             f"hits, oracle {len(want)}")
    scanned = re.search(r"scanned (\d+)", str(ex))
    row = {"query": q["name"], "strategy": res.strategy.index, "ms": ms,
           "plan_ms": res.plan_time_ms, "scan_ms": res.scan_time_ms,
           "hits": int(len(want)),
           "candidates": int(scanned.group(1)) if scanned else None}
    if sweeps and q["env"] is not None and q["strategy"] in ("xz2", "xz3"):
        row.update(zip(("ranges", "ranges_native_ms", "ranges_numpy_ms"),
                       xz_range_sweeps(ds._store(schema), q)))
    return row


def xz_range_sweeps(store, q):
    """A query's covering-range plan, timed with the native sweep and
    again with the numpy sweep (both packages' fallback); the two plans
    must be equal.  Returns ``(ranges, native ms, numpy ms)``."""
    from geomesa_tpu_torch import native
    from geomesa_tpu_torch.config import DEFAULT_MAX_RANGES
    from geomesa_tpu_torch.index.xz3 import xz3_bin_code_ranges
    idx = store._indexes.get(q["strategy"]) or store.index(q["strategy"])
    env = q["env"]
    if q["strategy"] == "xz2":
        def plan():
            return [tuple(r) for r in idx.sfc.ranges(
                [env], max_ranges=DEFAULT_MAX_RANGES).tolist()]
    else:
        lo, hi = q["window"]
        if lo is None:
            lo = idx.t_min_ms if hasattr(idx, "t_min_ms") else int(
                idx.dtg.min())
            hi = idx.t_max_ms if hasattr(idx, "t_max_ms") else int(
                idx.dtg.max())

        def plan():
            return xz3_bin_code_ranges(idx.sfc, env, lo, hi, idx.period,
                                       DEFAULT_MAX_RANGES)
    return sweep_pair(plan)


def sweep_pair(plan):
    """``(len(plan()), native ms, numpy ms)`` of one range-planning call,
    the numpy one with the native dispatch switched off; raises when the
    two disagree."""
    from geomesa_tpu_torch import native
    t0 = time.perf_counter()
    a = plan()
    native_ms = (time.perf_counter() - t0) * 1e3
    saved = native.zranges_native, native.xz_ranges_native
    native.zranges_native = native.xz_ranges_native = (
        lambda *args, **kw: None)
    try:
        t0 = time.perf_counter()
        b = plan()
        numpy_ms = (time.perf_counter() - t0) * 1e3
    finally:
        native.zranges_native, native.xz_ranges_native = saved
    if not _same_plan(a, b):
        raise AssertionError("the native and numpy sweeps disagree")
    return getattr(a, "num_ranges", None) or len(a), native_ms, numpy_ms


def _same_plan(a, b) -> bool:
    import numpy as np
    if hasattr(a, "rbin"):
        return all(np.array_equal(getattr(a, k), getattr(b, k))
                   for k in ("rbin", "rzlo", "rzhi"))
    return a == b


def z3_sweeps(qs) -> list:
    """The z3 index phase's plans (``plan_z3_query`` of each of its
    queries) timed with the native sweep and the numpy sweep."""
    from geomesa_tpu_torch.index.z3 import plan_z3_query
    rows = []
    for kind, boxes, lo, hi in qs:
        n, a, b = sweep_pair(lambda: plan_z3_query(boxes, lo, hi, "week"))
        rows.append({"kind": kind, "plan_native_ms": a,
                     "plan_numpy_ms": b})
    return rows


def _poly_write(ds, schema, bb, kind, t, lean: bool):
    """One write of footprints, packed object-free."""
    import numpy as np
    from geomesa_tpu_torch.geometry.packed import packed_from_boxes
    names = np.array(POLY_KINDS)
    data = {"kind": names[kind] if lean else names[kind].astype(object),
            "geom": packed_from_boxes(bb)}
    if t is not None:
        data["dtg"] = t
    t0 = time.perf_counter()
    ds.write(schema, data)
    return time.perf_counter() - t0


def _poly_store_phase(rng, args, dev, report, key: str, mesh: bool):
    """The default-profile polygon store (``polys``) or its one-card mesh
    twin (``mesh_polys``): rows in 4 writes, the xz3, xz2, attribute and
    id queries against the oracles; the default store then takes a
    1M-row append the kept indexes serve as their tail, and the mesh
    store a stats call."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, device_mesh
    from geomesa_tpu_torch.process.density import density_process
    from geomesa_tpu_torch.stats.stat import Histogram

    n = args.poly_mesh_rows if mesh else args.poly_rows
    ds = (TpuDataStore(device=dev, mesh=device_mesh(1)) if mesh
          else TpuDataStore(device=dev))
    ds.create_schema("polys", POLY_SPEC)
    store = ds._store("polys")
    per = n // 4
    parts, write_s = [], []
    for _ in range(4):
        bb, kind, t = footprints(rng, per)
        parts.append((bb, kind, t))
        write_s.append(_poly_write(ds, "polys", bb, kind, t, lean=False))
    cols = tuple(np.concatenate(c) for c in zip(*parts))
    build = {}
    for name in ("xz3", "xz2"):
        t0 = time.perf_counter()
        idx = store.index(name)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        build[name] = time.perf_counter() - t0
        want = ("ShardedXZ3Index", "ShardedXZ2Index") if mesh else (
            "XZ3Index", "XZ2Index")
        if type(idx).__name__ not in want:
            raise AssertionError(f"{key}: {name} index is "
                                 f"{type(idx).__name__}")
    t0 = time.perf_counter()
    store.attribute_index("kind")
    build["attr:kind"] = time.perf_counter() - t0
    qs = poly_queries(rng, 4 * per, dtg=True, lean=False)
    rows = [run_poly_query(ds, "polys", q, cols, sweeps=not mesh)
            for q in qs]
    rep = {"rows": 4 * per, "write_s": write_s,
           "write_rows_per_s": [per / w for w in write_s],
           "build_s": build, "queries": rows}
    # a heatmap over polygons: the reference bins x/y columns, which a
    # polygon schema does not have, and raises; so does the port
    try:
        density_process(ds, "polys", "INCLUDE", WORLD, 256, 256)
        raise AssertionError(f"{key}: a polygon heatmap answered")
    except KeyError as e:
        rep["heatmap"] = f"KeyError {e}"
    if mesh:
        spec = f"Count();Histogram(dtg,64,{MS_2018},{MS_2019})"
        q = next(q for q in qs if q["name"] == "bbox-city")
        t0 = time.perf_counter()
        got = ds.stats("polys", q["ecql"], spec)
        ms = (time.perf_counter() - t0) * 1e3
        hit = cols[2][q["oracle"](*cols)]
        hist = Histogram("dtg", 64, MS_2018, MS_2019)
        hist.observe({"dtg": hit})
        if (got.stats[0].count != len(hit)
                or not np.array_equal(got.stats[1].counts, hist.counts)):
            raise AssertionError(f"{key}: stats disagree with the oracle")
        rep["stats"] = {"spec": spec, "ms": ms, "count": int(len(hit))}
    else:
        m = min(1_000_000, per * 4 // 8)
        bb, kind, t = footprints(rng, m)
        parts.append((bb, kind, t))
        rep["append_s"] = _poly_write(ds, "polys", bb, kind, t, lean=False)
        cols = tuple(np.concatenate(c) for c in zip(*parts))
        rep["after_append"] = [run_poly_query(ds, "polys", q, cols,
                                              sweeps=False) for q in qs]
        tails = {k: store.index_tail(k) for k in ("xz3", "xz2")}
        if (any(v is None or len(v) != m for v in tails.values())
                or store.build_counts.get("xz3") != 1):
            raise AssertionError(f"{key}: kept xz indexes, builds "
                                 f"{store.build_counts}")
        rep["build_counts"] = dict(store.build_counts)
    report[key] = rep
    log(f"{key}: {4 * per} rows in 4 writes "
        f"({', '.join(f'{w:.2f}' for w in write_s)} s); built "
        + ", ".join(f"{k} {v:.2f} s" for k, v in build.items())
        + "; queries equal to the oracle: "
        + ", ".join(f"{r['query']} {r['strategy']} {r['hits']} hits "
                    f"{r['candidates']} candidates {r['ms']:.1f} ms"
                    + (f" (ranges {r['ranges']}: native "
                       f"{r['ranges_native_ms']:.2f} ms, numpy "
                       f"{r['ranges_numpy_ms']:.2f} ms)"
                       if "ranges" in r else "") for r in rows)
        + f"; heatmap {rep['heatmap']}"
        + (f"; stats {rep['stats']['ms']:.1f} ms" if mesh else
           f"; after a {len(parts[-1][0])}-row append "
           f"({rep['append_s']:.2f} s): "
           + ", ".join(f"{r['query']} {r['ms']:.1f} ms"
                       for r in rep["after_append"])))
    del ds, store


def polys_phase(rng, args, dev, report):
    """Polygons on the default profile (host xz3/xz2 indexes)."""
    _poly_store_phase(rng, args, dev, report, "polys", mesh=False)


def mesh_polys_phase(rng, args, dev, report):
    """Polygons on a one-card mesh (ShardedXZ3Index / ShardedXZ2Index)."""
    _poly_store_phase(rng, args, dev, report, "mesh_polys", mesh=True)


def _lean_poly_phase(rng, args, dev, report, key: str, n: int, dtg: bool,
                     slots: int, mesh: bool = False):
    """A lean polygon store: ``n`` footprints in 4 writes at ``slots``-slot
    generations under the lean polygon budget; its tiers (device and host
    generations both), accounted and allocated device bytes, the queries
    against the oracles, then ``compact`` and the first query again.
    With ``mesh`` the store is on ``device_mesh(1)`` (the sharded lean XZ
    and attribute indexes) under the mesh budget a slot."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, device_mesh

    cuda = dev.type == "cuda"
    # a dropped store frees its device memory at the cyclic collector
    base_alloc = allocated_after_gc(cuda)
    budget = (MESH_LEAN_POLY_BUDGET_PER_SLOT if mesh
              else LEAN_POLY_BUDGET_PER_SLOT) * slots
    ud = ["geomesa.index.profile=lean", f"geomesa.lean.hbm.budget={budget}",
          f"geomesa.lean.generation.slots={slots}",
          "geomesa.lean.compaction.factor=0"]
    spec = POLY_SPEC if dtg else LEAN_POLY_SPEC
    ds = TpuDataStore(device=dev, mesh=device_mesh(1) if mesh else None)
    ds.create_schema(key, f"{spec};{','.join(ud)}")
    store = ds._store(key)
    kind_key = "xz3" if dtg else "xz2"
    per = n // 4
    parts, write_s = [], []
    for _ in range(4):
        bb, kind, t = footprints(rng, per)
        parts.append((bb, kind, t))
        t0 = time.perf_counter()
        _poly_write(ds, key, bb, kind, t if dtg else None, lean=True)
        for k in (kind_key, "attr:kind"):
            store._indexes[k].block()
        write_s.append(time.perf_counter() - t0)
    cols = tuple(np.concatenate(c) for c in zip(*parts))
    del parts
    if store.lean_kind != kind_key:
        raise AssertionError(f"{key}: lean kind {store.lean_kind}")
    idxs = {k: store._indexes[k] for k in (kind_key, "attr:kind")}
    tiers = {k: i.tier_counts() for k, i in idxs.items()}
    dev_bytes = {k: i.device_bytes() for k, i in idxs.items()}
    rep = {"rows": 4 * per, "slots": slots, "budget_bytes": budget,
           "write_s": write_s, "write_rows_per_s": [per / w for w in write_s],
           "tiers": tiers, "device_bytes": dev_bytes,
           "device_bytes_total": sum(dev_bytes.values()),
           "memory_allocated": (int(torch.cuda.memory_allocated())
                                if cuda else None),
           "allocated_in_phase": ((allocated_after_gc(cuda) - base_alloc)
                                  if cuda else None)}
    if tiers[kind_key]["device"] == 0 or tiers[kind_key]["host"] == 0:
        raise AssertionError(f"{key}: tiers {tiers}")
    if mesh and type(idxs[kind_key]).__name__ != (
            "ShardedLeanXZ3Index" if dtg else "ShardedLeanXZ2Index"):
        raise AssertionError(f"{key}: {type(idxs[kind_key]).__name__}")
    log(f"{key}: {4 * per} rows in 4 writes "
        f"({', '.join(f'{w:.2f}' for w in write_s)} s); tiers {tiers}; "
        f"accounted device bytes {rep['device_bytes_total']}, allocated "
        f"{rep['memory_allocated']}")
    qs = poly_queries(rng, 4 * per, dtg=dtg, lean=True)
    rows = [run_poly_query(ds, key, q, cols, sweeps=not mesh) for q in qs]
    lat = np.array([r["ms"] for r in rows])
    rep.update(queries=rows, query_ms_p50=float(np.median(lat)),
               query_ms_max=float(lat.max()))
    log(f"{key}: queries equal to the oracle: " + ", ".join(
        f"{r['query']} {r['strategy']} {r['hits']} hits {r['candidates']} "
        f"candidates {r['ms']:.1f} ms"
        + (f" (ranges {r['ranges']}: native {r['ranges_native_ms']:.2f} "
           f"ms, numpy {r['ranges_numpy_ms']:.2f} ms)"
           if "ranges" in r else "") for r in rows))
    t0 = time.perf_counter()
    res = ds.compact(key)
    for i in idxs.values():
        i.block()
    compact_s = time.perf_counter() - t0
    if set(res) != set(idxs):
        raise AssertionError(f"{key}: compact covered {sorted(res)}")
    # the lean tracks' generations leave a group of four host runs (the
    # mesh stores' generations, sized by rows a step at 4M-row writes,
    # fall in two size classes of at most three host runs each)
    if dtg and not mesh and res[kind_key]["merged_groups"] == 0:
        raise AssertionError(f"{key}: compact merged nothing: {res}")
    after = run_poly_query(ds, key, qs[0], cols, sweeps=False)
    rep["compact"] = {"s": compact_s, "result": res, "query": after}
    log(f"{key}: compact in {compact_s:.3f} s ({res}); {after['query']} "
        f"again equal to the oracle, {after['ms']:.1f} ms")
    report[key] = rep
    del ds, store, idxs
    if cuda:
        torch.cuda.empty_cache()


def lean_polys_phase(rng, args, dev, report):
    """The lean XZ2 store: poly_scale_proof's schema, ``--lean-poly-rows``
    rows at ``--lean-slots`` generations, device and host ones."""
    _lean_poly_phase(rng, args, dev, report, "lean_polys",
                     args.lean_poly_rows, dtg=False, slots=args.lean_slots)


def mesh_lean_polys_phase(rng, args, dev, report):
    """The lean polygon and tracks stores over ``device_mesh(1)``
    (ShardedLeanXZ2Index, ShardedLeanXZ3Index): ``--mesh-lean-poly-rows``
    footprints without a dtg and ``--mesh-lean-poly3-rows`` with one, at
    ``--mesh-lean-poly-slots``-slot per-shard generations, device and host
    generations both."""
    _lean_poly_phase(rng, args, dev, report, "mesh_lean_polys",
                     args.mesh_lean_poly_rows, dtg=False,
                     slots=args.mesh_lean_poly_slots, mesh=True)
    _lean_poly_phase(rng, args, dev, report, "mesh_lean_tracks",
                     args.mesh_lean_poly3_rows, dtg=True,
                     slots=args.mesh_lean_poly_slots, mesh=True)


def lean_tracks_phase(rng, args, dev, report):
    """The lean XZ3 store: the same footprints with a dtg over 2018,
    ``--lean-poly3-rows`` rows at ``--lean-poly3-slots`` generations
    (device and host ones, and a compaction that merges host runs); a
    spatio-temporal, a spatial-only (open, clamped interval) and a
    temporal-only query."""
    _lean_poly_phase(rng, args, dev, report, "lean_tracks",
                     args.lean_poly3_rows, dtg=True,
                     slots=args.lean_poly3_slots)


#: the multihost phase's schema: the mesh phase's widths with the indexed
#: actor of the attribute phases (Zipf codes and one rare code)
MH_SPEC = "actor:String:index=true,score:Double,dtg:Date,*geom:Point"
#: the lean multihost schema's budget, bytes a generation slot: the z3
#: index's three quarters (64.5 B) keep two keys generations beside the
#: sentinel charge and spill the older ones to their process's RAM; the
#: attribute index's floor keeps one device generation
MH_LEAN_BYTES_PER_SLOT = 86


def mh_queries(rng, centres) -> list:
    """The multihost phase's 8 BBOX+DURING queries (3 city, 3 region, 2
    continent), the same on both workers: ``(kind, ecql, boxes, lo,
    hi)``, the bounds as DURING parses them (whole seconds)."""
    out = []
    day_of = lambda: MS_2018 + int(rng.integers(0, 358)) * DAY
    picks = ([("city", i, 0.5, 1) for i in range(3)]
             + [("region", i, 5.0, 7) for i in range(8, 11)])
    for kind, i, half, days in picks:
        cx, cy = centres[i]
        lo = day_of()
        out.append((kind, [(cx - half, cy - half, cx + half, cy + half)],
                    lo, lo + days * DAY - 1))
    for box in ((-10, 35, 50, 75), (-125, 20, -65, 60)):
        lo = day_of()
        out.append(("continent", [box], lo, lo + 30 * DAY - 1))
    checks = []
    for kind, boxes, lo, hi in out:
        b = boxes[0]
        checks.append((kind, f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) "
                             f"AND dtg DURING {iso(lo)}/{iso(hi)}",
                       boxes, lo - lo % 1000, hi - hi % 1000))
    return checks


def _mh_sum(a):
    """Element-wise sum of a per-process host array over both workers."""
    import numpy as np
    from geomesa_tpu_torch.parallel.multihost import allgather_concat
    a = np.asarray(a)
    return allgather_concat(a[None]).sum(axis=0)


def _mh_local(res, rank: int):
    """This worker's rows among a result's global gids, sorted."""
    import numpy as np
    from geomesa_tpu_torch.parallel.scan import decode_gids
    procs, rows = decode_gids(res.positions)
    return np.sort(rows[procs == rank])


def _mh_default(args, rank, mesh, dev, rng_q, rng, centres, out) -> None:
    """The default profile over several processes: two writes, the
    sharded indexes' queries, the stats and heatmap push-downs, a 512K-row
    append through the built indexes, the read APIs and a delete."""
    import numpy as np
    from geomesa_tpu_torch import TpuDataStore, density_process
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.feature_type import parse_spec
    from geomesa_tpu_torch.index.pyramid import tile_env
    from geomesa_tpu_torch.stats.stat import Frequency
    from geomesa_tpu_torch.parallel.stats import _hist_kernel_ok

    codes, p = actor_codes(rng_q)
    n = args.mh_rows + (args.mh_rows // 100) * rank
    x, y, t, a, s = attr_rows(rng, n, centres, p)
    ds = TpuDataStore(device=dev, mesh=mesh, multihost=True)
    ds.create_schema("events", MH_SPEC)
    write_s = []
    half = n // 2
    for sl in (slice(0, half), slice(half, n)):
        t0 = time.perf_counter()
        ds.write("events", {"actor": codes[a[sl]], "score": s[sl],
                            "dtg": t[sl], "geom": (x[sl], y[sl])})
        write_s.append(time.perf_counter() - t0)
    store = ds._store("events")
    total = int(_mh_sum(np.array([n]))[0])
    if ds.get_count("events") != total:
        raise AssertionError(f"get_count {ds.get_count('events')} != {total}")
    cx, cy = centres[7]
    box = (cx - 10, cy - 10, cx + 10, cy + 10)
    w = (MS_2018 + 100 * DAY, MS_2018 + 114 * DAY - 1)
    q = (f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]}) AND dtg "
         f"DURING {iso(w[0])}/{iso(w[1])}")
    q_bbox = f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]})"
    rare_row = 5 if rank == 0 else 7
    queries = [("bbox_during", q, "z3",
                lambda: oracle(x, y, t, [box], *w)),
               ("bbox", q_bbox, "z2", lambda: box_oracle(x, y, [box])),
               ("rare_actor", f"actor = '{RARE_ACTOR}'", "attr:actor",
                lambda: np.flatnonzero(a == len(codes) - 1)),
               ("ids", "IN ('p0.5', 'p1.7')", "id",
                lambda: np.array([rare_row], np.int64))]
    qrows = []

    def run_queries(label):
        for name, ecql, strategy, want_fn in queries:
            t0 = time.perf_counter()
            res = ds.query_result("events", ecql)
            ms = (time.perf_counter() - t0) * 1e3
            want = want_fn()
            n_all = int(_mh_sum(np.array([len(want)]))[0])
            if (res.strategy.index != strategy
                    or not np.array_equal(_mh_local(res, rank), want)
                    or len(res.batch) != len(want)
                    or len(res.positions) != n_all):
                raise AssertionError(
                    f"multihost {label} {name}: {res.strategy.index}, "
                    f"{len(res.positions)} hits (oracle {n_all}), local "
                    f"{len(res.batch)} (oracle {len(want)})")
            qrows.append({"query": f"{label}:{name}", "ms": ms,
                          "hits": len(res.positions)})

    run_queries("write")
    z3 = store.z3_index()
    if not z3._multihost or not _hist_kernel_ok(z3):
        raise AssertionError("the sharded z3 index is not the multihost "
                             "index on the hist1d route")
    # stats: Count, MinMax and a 64-bin Histogram of score, Frequency(actor)
    spec = ("Count();MinMax(score);Histogram(score,64,-10,10);"
            "Frequency(actor,4,1024)")
    hits = oracle(x, y, t, [box], *w)
    t0 = time.perf_counter()
    got = ds.stats("events", q, spec)
    stats_ms = (time.perf_counter() - t0) * 1e3
    c, mm, h, f = got.stats
    sc = s[hits]
    host = Frequency("actor", 4, 1024)
    host.observe(FeatureBatch.from_dict(
        parse_spec("f", "actor:String,dtg:Date,*geom:Point"),
        {"actor": codes[a[hits]], "dtg": t[hits],
         "geom": (x[hits], y[hits])}))
    bins = np.clip((sc + 10.0) / (20.0 / 64), 0, 63).astype(np.int64)
    ext = _mh_sum(np.array([len(hits)]))[0]
    lo_hi = np.asarray(_mh_all(np.array([[sc.min(), -sc.max()]]
                                        if len(sc) else np.empty((0, 2)))))
    if (c.count != ext or mm.min != lo_hi[:, 0].min()
            or mm.max != -lo_hi[:, 1].min()
            or not np.array_equal(h.counts, _mh_sum(
                np.bincount(bins, minlength=64)))
            or not np.array_equal(f.table, _mh_sum(host.table))):
        raise AssertionError("multihost stats disagree with the oracle")
    out["stats"] = got.to_json()
    # heatmaps: unit-weight and score-weighted, pushed down per shard
    drows = []
    for name, run, env, sel, wts in (
            ("bbox_during", lambda: density_process(ds, "events", q, box),
             box, hits, None),
            ("bbox_during_score", lambda: density_process(
                ds, "events", q, box, weight_attr="score"), box, hits, s),
            ("tile_3", lambda: ds.density_tile(
                "events", 3, int((cx + 180.0) // 45.0),
                7 - int((cy + 90.0) // 22.5)), None, None, None)):
        if env is None:
            env = tile_env(3, int((cx + 180.0) // 45.0),
                           7 - int((cy + 90.0) // 22.5))
            sel = box_oracle(x, y, [env])
        t0 = time.perf_counter()
        grid = np.asarray(run(), np.float64)
        ms = (time.perf_counter() - t0) * 1e3
        if wts is None:
            want = _mh_sum(snap_counts(x[sel], y[sel], env, 256, 256))
            ok = np.array_equal(grid, want.astype(np.float32))
        else:
            want = _mh_sum(snap_weighted(x[sel], y[sel], wts[sel], env,
                                         256, 256))
            ok = np.allclose(grid, want, rtol=1e-5, atol=1e-2)
        if grid.shape != (256, 256) or not ok:
            raise AssertionError(f"multihost heatmap {name}: {grid.sum()}, "
                                 f"oracle {want.sum()}")
        drows.append({"heatmap": name, "ms": ms, "sum": float(grid.sum())})
    # 24d: the analytic processes across the two workers
    _mh_analytics(ds, rank, x, y, t, centres, out)
    # a 512K-row append per process through the built indexes
    m = 1 << 19
    ax, ay, at, aa, as_ = attr_rows(rng, m, centres, p)
    t0 = time.perf_counter()
    ds.write("events", {"actor": codes[aa], "score": as_, "dtg": at,
                        "geom": (ax, ay)})
    append_s = time.perf_counter() - t0
    x, y, t, a, s = (np.concatenate(v) for v in
                     ((x, ax), (y, ay), (t, at), (a, aa), (s, as_)))
    if store.z3_index() is not z3:
        raise AssertionError("the append rebuilt the sharded z3 index")
    run_queries("append")
    total += 2 * m
    bounds = ds.get_bounds("events")
    ext = np.asarray(_mh_all(np.array([[x.min(), y.min(), -x.max(),
                                        -y.max()]])))
    if (ds.get_count("events") != total
            or bounds.as_tuple() != (ext[:, 0].min(), ext[:, 1].min(),
                                     -ext[:, 2].min(), -ext[:, 3].min())):
        raise AssertionError(f"multihost reads: count "
                             f"{ds.get_count('events')} ({total}), bounds "
                             f"{bounds}")
    # a delete of 0.1% of process 0's rows, the same id list everywhere
    n0 = args.mh_rows
    ids = [f"p0.{i}" for i in np.sort(rng_q.choice(n0, n0 // 1000,
                                                    replace=False))]
    t0 = time.perf_counter()
    removed = ds.delete("events", ids)
    delete_s = time.perf_counter() - t0
    if removed != len(ids) or ds.get_count("events") != total - len(ids):
        raise AssertionError(f"multihost delete: {removed} of {len(ids)}, "
                             f"count {ds.get_count('events')}")
    lat = np.array([r["ms"] for r in qrows])
    out["default"] = {
        "rows": n, "rows_all": total, "write_s": write_s,
        "append_rows": m, "append_s": append_s, "queries": qrows,
        "query_ms_p50": float(np.median(lat)),
        "query_ms_max": float(lat.max()), "stats_ms": stats_ms,
        "heatmaps": drows, "deleted": removed, "delete_s": delete_s,
        "count_after_delete": ds.get_count("events")}
    del ds, store, z3
    gc.collect()


def _mh_all(a):
    """Per-process host rows concatenated over both workers."""
    from geomesa_tpu_torch.parallel.multihost import allgather_concat
    return allgather_concat(a)


def _mh_lean(args, rank, mesh, dev, rng_q, rng, centres, out) -> None:
    """The lean profile over several processes: four writes into the
    sharded lean indexes (tiers agreed), eight queries, a flush to
    ``{name}.lean.pN``, a drop and a reopen, whose first query is the
    time to recover."""
    import numpy as np
    from geomesa_tpu_torch import TpuDataStore
    from geomesa_tpu_torch.parallel.multihost import allgather_concat

    slots = args.mh_lean_slots
    spec = (MH_SPEC + ";geomesa.index.profile=lean,"
            f"geomesa.lean.generation.slots={slots},"
            f"geomesa.lean.hbm.budget={MH_LEAN_BYTES_PER_SLOT * slots}")
    codes, p = actor_codes(rng_q)
    n = args.mh_lean_rows + (args.mh_lean_rows // 100) * rank
    x, y, t, a, s = attr_rows(rng, n, centres, p)
    cat = os.path.join(args.mh_dir, "catalog")
    catalog_room(args.mh_dir, 2 * 60 * n)
    if rank == 0:
        ds = TpuDataStore(device=dev, mesh=mesh, multihost=True,
                          catalog_dir=cat)
        ds.create_schema("lean", spec)
    allgather_concat(np.zeros(1, np.int64))     # the schema is on disk
    if rank != 0:
        ds = TpuDataStore(device=dev, mesh=mesh, multihost=True,
                          catalog_dir=cat)
    write_s = []
    step = -(-n // 4)
    for lo in range(0, n, step):
        sl = slice(lo, lo + step)
        t0 = time.perf_counter()
        ds.write("lean", {"actor": codes[a[sl]], "score": s[sl],
                          "dtg": t[sl], "geom": (x[sl], y[sl])})
        write_s.append(time.perf_counter() - t0)
    store = ds._store("lean")
    idx = store.index("z3")
    tiers = idx.tier_counts()
    attr_tiers = store.attribute_index("actor").tier_counts()
    both = allgather_concat(np.array([[tiers["full"], tiers["keys"],
                                       tiers["host"], attr_tiers["device"],
                                       attr_tiers["host"]]], np.int64))
    if (both[0] != both[1]).any() or tiers["host"] < 1 \
            or attr_tiers["host"] < 1 or idx.host_key_bytes() <= 0:
        raise AssertionError(f"multihost lean tiers: {both.tolist()}, "
                             f"spilled {idx.host_key_bytes()} B here")
    checks = mh_queries(np.random.default_rng(args.seed + 1), centres)
    qrows = []

    def run(ds_, label):
        for kind, ecql, boxes, lo, hi in checks:
            t0 = time.perf_counter()
            res = ds_.query_result("lean", ecql)
            ms = (time.perf_counter() - t0) * 1e3
            want = oracle(x, y, t, boxes, lo, hi)
            n_all = int(_mh_sum(np.array([len(want)]))[0])
            if (not np.array_equal(_mh_local(res, rank), want)
                    or len(res.positions) != n_all):
                raise AssertionError(
                    f"multihost lean {label} {kind}: {len(res.positions)} "
                    f"hits, oracle {n_all}")
            qrows.append({"query": f"{label}:{kind}", "ms": ms,
                          "hits": n_all, "strategy": res.strategy.index})

    run(ds, "write")
    t0 = time.perf_counter()
    ds.flush("lean")
    flush_s = time.perf_counter() - t0
    if not os.path.isdir(os.path.join(cat, f"lean.lean.p{rank}")):
        raise AssertionError("no lean.lean.pN snapshot")
    allgather_concat(np.zeros(1, np.int64))
    disk = dir_bytes(os.path.join(cat, f"lean.lean.p{rank}"))
    del ds, store, idx
    gc.collect()
    t0 = time.perf_counter()
    ds = TpuDataStore(device=dev, mesh=mesh, multihost=True,
                      catalog_dir=cat)
    reopen_s = time.perf_counter() - t0
    n_before = len(qrows)
    run(ds, "reopen")
    first_ms = qrows[n_before]["ms"]
    if ds.get_count("lean") != int(_mh_sum(np.array([n]))[0]):
        raise AssertionError("multihost lean count after the reopen")
    lat = np.array([r["ms"] for r in qrows[:n_before]])
    out["lean"] = {
        "rows": n, "slots": slots, "write_s": write_s, "tiers": tiers,
        "attr_tiers": attr_tiers,
        "host_key_bytes": ds._store("lean").index("z3").host_key_bytes(),
        "queries": qrows, "query_ms_p50": float(np.median(lat)),
        "query_ms_max": float(lat.max()), "flush_s": flush_s,
        "flush_bytes": disk, "reopen_s": reopen_s,
        "first_query_ms": first_ms,
        "time_to_recover_s": reopen_s + first_ms / 1e3,
        "dispatch_count": ds._store("lean").index("z3").dispatch_count}
    del ds
    gc.collect()


def multihost_worker(args) -> int:
    """One worker process of the multihost phase: joins the group, runs
    the default and the lean profile over its own rows on its mesh (the
    card, or the CPU with ``--mh-dev cpu``), and writes its readings to
    ``{--mh-dir}/mh_{rank}.json``."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.ops import build as kbuild
    from geomesa_tpu_torch.ops.density_kernel import density_grid_kernel
    from geomesa_tpu_torch.ops.hist1d_kernel import hist1d
    from geomesa_tpu_torch.ops.z2_mask import z2_mask
    from geomesa_tpu_torch.ops.z3_mask import z3_mask
    from geomesa_tpu_torch.parallel.multihost import (
        device_backend, global_device_mesh, initialize_distributed,
        shutdown_distributed,
    )

    from geomesa_tpu_torch.parallel.attr_lean import ShardedLeanAttrIndex

    rank = args.mh_worker
    cuda = args.mh_dev == "cuda"
    # two workers share the machine's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    # the lean attribute index's budget floor is two class-default
    # generations: the phase's own slot count (the default's on the card)
    ShardedLeanAttrIndex.GENERATION_SLOTS = args.mh_lean_slots
    if cuda:
        # the parent built every kernel: a worker loads them, and never
        # compiles
        missing = [k for k in kbuild.KERNELS
                   if not kbuild.library_path(k).exists()]
        if missing:
            raise AssertionError(f"kernels not built before the workers: "
                                 f"{missing}")
    t_start = time.perf_counter()
    initialize_distributed(f"localhost:{args.mh_port}", 2, rank,
                           timeout_s=180, device_backend="gloo")
    mesh = global_device_mesh(None if cuda else ["cpu"])
    dev = mesh[0]
    out = {"rank": rank, "backend": device_backend(),
           "mesh": [str(d) for d in mesh]}
    counters = {"z3_mask": z3_mask, "z2_mask": z2_mask,
                "density_grid": density_grid_kernel, "hist1d": hist1d}
    rng_q = np.random.default_rng(args.seed)      # the same on both
    rng = np.random.default_rng([args.seed, 1000 + rank])
    centres = np.stack([rng_q.uniform(-130.0, 150.0, 50),
                        rng_q.uniform(-40.0, 60.0, 50)], axis=1)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    _mh_default(args, rank, mesh, dev, rng_q, rng, centres, out)
    t1 = time.perf_counter()
    _mh_lean(args, rank, mesh, dev, rng_q, rng, centres, out)
    t2 = time.perf_counter()
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    out["phase_s"] = {"default": t1 - t0, "lean": t2 - t1,
                      "worker": t2 - t_start}
    if cuda and min(out["launches"].values()) <= 0:
        raise AssertionError(f"a kernel of the multihost path was never "
                             f"launched in worker {rank}: {out['launches']}")
    with open(os.path.join(args.mh_dir, f"mh_{rank}.json"), "w") as f:
        json.dump(out, f)
    shutdown_distributed()
    log(f"multihost worker {rank}: done in {t2 - t_start:.1f} s")
    return 0


def multihost_phase(args, report) -> None:
    """Two worker processes of this script on the card, joined over TCP on
    localhost (a gloo host group and a gloo device group: both share the
    one card); each must exit 0 within the timeout, and their global
    readings must agree."""
    import socket

    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        port = s_.getsockname()[1]
    work = tempfile.mkdtemp(prefix="chip_smoke_mh_")
    try:
        cmd = [sys.executable, os.path.abspath(__file__),
               "--seed", str(args.seed), "--mh-port", str(port),
               "--mh-dir", work, "--mh-rows", str(args.mh_rows),
               "--mh-lean-rows", str(args.mh_lean_rows),
               "--mh-lean-slots", str(args.mh_lean_slots),
               "--mh-dev", args.mh_dev]
        logs = [open(os.path.join(work, f"worker_{r}.log"), "w")
                for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd + ["--mh-worker", str(r)],
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(2)]
        try:
            deadline = time.monotonic() + args.mh_timeout
            for p_ in procs:
                p_.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p_ in procs:
                if p_.poll() is None:
                    p_.kill()
                    p_.wait()
            for f in logs:
                f.close()
        wall_s = time.perf_counter() - t0
        tails = []
        for r, p_ in enumerate(procs):
            with open(os.path.join(work, f"worker_{r}.log")) as f:
                tails.append(f.read()[-4000:])
        if any(p_.returncode != 0 for p_ in procs):
            raise AssertionError(
                "a multihost worker failed, hung or was killed: exit "
                f"{[p_.returncode for p_ in procs]}\n"
                + "\n".join(f"--- worker {r}:\n{t}"
                            for r, t in enumerate(tails)))
        outs = []
        for r in range(2):
            with open(os.path.join(work, f"mh_{r}.json")) as f:
                outs.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    same = ("stats", "backend")
    for k in same:
        if outs[0][k] != outs[1][k]:
            raise AssertionError(f"multihost workers disagree on {k}")
    for part, keys in (("default", ("rows_all", "count_after_delete")),
                       ("lean", ("tiers", "attr_tiers", "dispatch_count"))):
        for k in keys:
            if outs[0][part][k] != outs[1][part][k]:
                raise AssertionError(f"multihost workers disagree on "
                                     f"{part}.{k}")
    for part in ("default", "lean"):
        for q0, q1 in zip(outs[0][part]["queries"],
                          outs[1][part]["queries"]):
            if q0["hits"] != q1["hits"]:
                raise AssertionError(f"multihost {q0['query']}: "
                                     f"{q0['hits']} vs {q1['hits']} hits")
    for k in ("proximity_rows", "tube_rows", "join_gate"):
        if outs[0]["analytics"][k] != outs[1]["analytics"][k]:
            raise AssertionError(f"multihost workers disagree on "
                                 f"analytics.{k}")
    report["multihost"] = {"wall_s": wall_s, "workers": outs}
    report["multihost_path_launches"] = {f"worker_{o['rank']}":
                                         o["launches"] for o in outs}
    for o in outs:
        d, lz = o["default"], o["lean"]
        log(f"multihost worker {o['rank']} (device group {o['backend']}, "
            f"mesh {o['mesh']}): default {d['rows']} of {d['rows_all']} "
            f"rows, writes {', '.join(f'{v:.2f}' for v in d['write_s'])} s, "
            f"append {d['append_s']:.2f} s, queries p50 "
            f"{d['query_ms_p50']:.1f} ms max {d['query_ms_max']:.1f} ms, "
            f"stats {d['stats_ms']:.1f} ms, heatmaps "
            + ", ".join(f"{h['heatmap']} {h['ms']:.1f} ms"
                        for h in d["heatmaps"])
            + f", delete {d['deleted']} rows {d['delete_s']:.2f} s; lean "
            f"{lz['rows']} rows, writes "
            f"{', '.join(f'{v:.2f}' for v in lz['write_s'])} s, tiers "
            f"{lz['tiers']} attr {lz['attr_tiers']}, queries p50 "
            f"{lz['query_ms_p50']:.1f} ms max {lz['query_ms_max']:.1f} ms, "
            f"flush {lz['flush_s']:.2f} s, time to recover "
            f"{lz['time_to_recover_s']:.2f} s (reopen {lz['reopen_s']:.2f} "
            f"s + first query {lz['first_query_ms']:.1f} ms); launches "
            f"{o['launches']}; {o['phase_s']['worker']:.1f} s")
        a = o["analytics"]
        log(f"multihost worker {o['rank']} analytics (24d): kNN "
            f"{a['knn_ms']:.1f} ms, proximity {a['proximity_rows']} rows "
            f"{a['proximity_ms']:.1f} ms, tube {a['tube_rows']} rows "
            f"{a['tube_ms']:.1f} ms, equal to the oracle over both "
            f"workers; sql_join raised ({a['join_gate']}); launches "
            f"{a['launches']}")
    log(f"multihost: both workers agree; wall {wall_s:.1f} s")


#: phase 23's schema: the GDELT 1.0 event file's action point, day,
#: Actor1Name, EventCode and GoldsteinScale
INGEST_SPEC = "actor:String,code:String,score:Double,dtg:Date,*geom:Point"
#: the converter of a GDELT 1.0 event file (58 tab-separated fields, no
#: header; GeoMesa's bundled ``gdelt`` converter reads the same columns):
#: GLOBALEVENTID, SQLDATE (yyyyMMdd), Actor1Name, EventCode,
#: GoldsteinScale, ActionGeo_Lat and ActionGeo_Long
INGEST_CONFIG = {
    "type": "tsv", "id-field": "toString($0)",
    "fields": [{"name": "actor", "transform": "$6"},
               {"name": "code", "transform": "toString($26)"},
               {"name": "score", "transform": "toDouble($30)"},
               {"name": "dtg", "transform": "date('yyyyMMdd', $1)"},
               {"name": "geom",
                "transform": "point(toDouble($54), toDouble($53))"}],
    "options": {"error-mode": "skip", "validators": ["z-index"]}}
GDELT_FIELDS = 58
_ACTORS = ("UNITED STATES", "CHINA", "RUSSIA", "POLICE", "GOVERNMENT",
           "PRESIDENT", "UNITED KINGDOM", "IRAN", "ISRAEL", "MILITARY",
           "PROTESTER", "")
_CODES = ("USA", "CHN", "RUS", "GBR", "IRN", "ISR", "FRA", "DEU", "IND",
          "COP", "GOV", "")
_EVENT_CODES = ("010", "020", "036", "042", "043", "051", "112", "120",
                "173", "190")
_PLACES = ("Washington, District of Columbia, United States",
           "Beijing, Beijing, China", "Moscow, Moskva, Russia",
           "London, London, City of, United Kingdom", "Tehran, Tehran, Iran",
           "Jerusalem, Israel (general), Israel", "Paris, Ile-de-France, "
           "France", "New Delhi, NCT, India", "Lagos, Lagos, Nigeria", "")


def gdelt_events(rng, centres, first_id: int, n: int, n_bounds: int,
                 n_time: int):
    """``n`` GDELT 1.0 event rows as a 58-column pyarrow table (the
    points of :func:`gdelt_like` at GDELT's 4 decimals, the day its
    SQLDATE); ``n_bounds`` of them with an ActionGeo point outside
    WGS84 and ``n_time`` dated before the z3 epoch (1965-1969).  Returns
    the table and the good rows' ``(ids, x, y, day_ms)``."""
    import numpy as np
    import pyarrow as pa

    x, y, t = gdelt_like(rng, n, centres)
    x, y = np.round(x, 4), np.round(y, 4)
    day = t // DAY * DAY
    d = day.astype("M8[ms]").astype("M8[D]")
    year = d.astype("M8[Y]").astype(np.int64) + 1970
    month = d.astype("M8[M]").astype(np.int64) % 12 + 1
    dom = (d - d.astype("M8[M]")).astype(np.int64) + 1
    sqldate = year * 10000 + month * 100 + dom
    bad = rng.permutation(n)[:n_bounds + n_time]
    lat, lon = y.copy(), x.copy()
    lat[bad[:n_bounds:2]] = 95.5
    lon[bad[1:n_bounds:2]] = 200.25
    sqldate[bad[n_bounds:]] = 19650101 + rng.integers(0, 4, n_time) * 10000
    good = np.ones(n, dtype=bool)
    good[bad] = False
    ids = first_id + np.arange(n, dtype=np.int64)

    def pick(vocab):
        return pa.array(vocab).take(pa.array(rng.integers(0, len(vocab), n)))

    def ints(lo, hi):
        return pa.array(rng.integers(lo, hi, n))

    def tenths(lo, hi):
        return pa.array(np.round(rng.uniform(lo, hi, n), 1))

    urls = tuple(f"https://www.news{i % 37}.example.com/world/2018/"
                 f"{i:05d}/story-about-the-event-{i * 7919 % 100000}.html"
                 for i in range(997))
    lat_a, lon_a = pa.array(lat), pa.array(lon)
    cols = [pa.array(ids), pa.array(sqldate), pa.array(sqldate // 100),
            pa.array(year), pa.array(np.round(year + (dom + 30 * month)
                                              / 365.0, 4)),
            pick(_CODES), pick(_ACTORS), pick(_CODES), pick(_CODES),
            pick(_CODES), pick(_CODES), pick(_CODES), pick(_CODES),
            pick(_CODES), pick(_CODES),                      # 5-14
            pick(_CODES), pick(_ACTORS), pick(_CODES), pick(_CODES),
            pick(_CODES), pick(_CODES), pick(_CODES), pick(_CODES),
            pick(_CODES), pick(_CODES),                      # 15-24
            ints(0, 2), pick(_EVENT_CODES), pick(_EVENT_CODES),
            pick(_EVENT_CODES), ints(1, 5), tenths(-10, 10),  # 25-30
            ints(1, 40), ints(1, 10), ints(1, 40),
            pa.array(np.round(rng.uniform(-20, 20, n), 6)),  # 31-34
            ints(1, 5), pick(_PLACES), pick(_CODES), pick(_CODES),
            lat_a, lon_a, ints(-9_999_999, 9_999_999),        # 35-41
            ints(1, 5), pick(_PLACES), pick(_CODES), pick(_CODES),
            lat_a, lon_a, ints(-9_999_999, 9_999_999),        # 42-48
            ints(1, 5), pick(_PLACES), pick(_CODES), pick(_CODES),
            lat_a, lon_a, ints(-9_999_999, 9_999_999),        # 49-55
            pa.array(sqldate * 1000000 + rng.integers(0, 240000, n)),
            pick(urls)]                                      # 56-57
    assert len(cols) == GDELT_FIELDS
    table = pa.table(cols, names=[f"c{i}" for i in range(GDELT_FIELDS)])
    return table, (ids[good], x[good], y[good], day[good])


def write_gdelt_file(path: str, table, first_ragged_id: int,
                     n_ragged: int) -> None:
    """The table as a headerless TSV (pyarrow's CSV writer), then
    ``n_ragged`` rows cut short at 40 fields."""
    import pyarrow.csv as pacsv

    pacsv.write_csv(table, path, pacsv.WriteOptions(
        include_header=False, delimiter="\t", quoting_style="none"))
    with open(path, "a") as f:
        for k in range(n_ragged):
            f.write("\t".join([str(first_ragged_id + k), "20180105"]
                              + ["x"] * 38) + "\n")


class _TimedWrites:
    """A store whose ``write`` is timed (the ingest job's single writer),
    the rest passed through."""

    def __init__(self, ds):
        self.ds, self.write_s, self.writes = ds, 0.0, 0

    def get_schema(self, name):
        return self.ds.get_schema(name)

    def write(self, name, batch):
        import torch
        t0 = time.perf_counter()
        n = self.ds.write(name, batch)
        torch.cuda.synchronize()
        self.write_s += time.perf_counter() - t0
        self.writes += 1
        return n


def _ids_of(batch):
    import numpy as np
    return np.sort(np.asarray(batch.ids).astype(np.int64))


def ingest_phase(rng, args, centres, qs, dev, report, keep=None):
    """Phase 23: converter ingest of a week of GDELT 1.0 event files
    (``--ingest-files`` TSV files of ``--ingest-rows`` rows, 58 fields,
    0.1% bad) through ``run_ingest`` (skip mode, ``z-index`` validator,
    4 workers) into a default-profile store on the card; the index
    phase's 20 queries as BBOX+DURING (z3) and BBOX (z2) against the
    oracle over the good rows; ``spatial_rdd`` and ``save_rdd``; the
    converter RDD provider and ``run_distributed_ingest`` over two of the
    files; each other converter type on a small file; and the CSV,
    GeoJSON, GML, Leaflet and shapefile exports of a city query.  With a
    ``keep`` directory, two of the files are copied there and returned
    with their good rows (``{"paths", "good", "failed"}``); else None."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, convert, device_mesh
    from geomesa_tpu_torch.jobs import run_distributed_ingest, run_ingest
    from geomesa_tpu_torch.obs import jobs_registry
    from geomesa_tpu_torch.parallel import save_rdd, spatial_rdd

    n_files, per = args.ingest_files, args.ingest_rows
    n_bad = per // 1000
    n_ragged, n_bounds = n_bad // 3, n_bad // 3
    n_time = n_bad - n_ragged - n_bounds
    root = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    try:
        catalog_room(root, n_files * per * 420)
        t0 = time.perf_counter()
        paths, good = [], []
        for f in range(n_files):
            first = 1_000_000_000 + f * per
            table, g = gdelt_events(rng, centres, first, per - n_ragged,
                                    n_bounds, n_time)
            paths.append(os.path.join(root, f"2018{f:04d}.export.tsv"))
            write_gdelt_file(paths[-1], table, first + per - n_ragged,
                             n_ragged)
            good.append(g)
            del table
        gen_s = time.perf_counter() - t0
        nbytes = dir_bytes(root)
        ids, x, y, t = (np.concatenate(c) for c in zip(*good))
        n_good = len(ids)

        ds = TpuDataStore(device=dev)
        ds.create_schema("gdelt", INGEST_SPEC)
        timed = _TimedWrites(ds)
        t0 = time.perf_counter()
        res = run_ingest(timed, "gdelt", INGEST_CONFIG, paths, workers=4)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        rec = jobs_registry.jobs(kind="ingest", limit=1)[0]
        spans = {p["name"]: p["ms"] for p in rec.phases}
        if (res.ingested != n_good or res.failed != n_files * n_bad
                or res.files != n_files or rec.state != "succeeded"):
            raise AssertionError(
                f"ingest: {res.ingested} ingested, {res.failed} failed of "
                f"{res.files} files ({rec.state}); the generator made "
                f"{n_good} good and {n_files * n_bad} bad rows")
        # every ingested row is the generator's, value for value
        batch = ds._store("gdelt").batch
        order = np.argsort(batch.ids.astype(np.int64))
        bx, by = batch.geom_xy()
        if not (np.array_equal(batch.ids.astype(np.int64)[order], ids)
                and np.array_equal(bx[order], x)
                and np.array_equal(by[order], y)
                and np.array_equal(batch.column("dtg")[order], t)):
            raise AssertionError("ingest: the stored rows differ from the "
                                 "generator's")
        del batch, order, bx, by

        # the index phase's 20 queries, BBOX+DURING (z3) then BBOX (z2);
        # the first of each builds its index, timed apart
        per_query, first_ms = [], {}
        for index, make in (("z3", lambda q: _ecql(q[1], q[2], q[3])),
                            ("z2", lambda q: _bbox_ecql(q[1]))):
            for q in qs:
                t0 = time.perf_counter()
                r = ds.query_result("gdelt", make(q))
                ms = (time.perf_counter() - t0) * 1e3
                pos = (oracle(x, y, t, q[1], q[2], q[3]) if index == "z3"
                       else box_oracle(x, y, q[1]))
                got = _ids_of(r.batch)
                if r.strategy.index != index or not np.array_equal(
                        got, ids[pos]):
                    raise AssertionError(
                        f"ingest {index} {q[0]} query: {r.strategy.index}, "
                        f"{len(got)} hits, oracle {len(pos)}")
                if index not in first_ms:
                    first_ms[index] = ms
                else:
                    per_query.append({"kind": q[0], "index": index,
                                      "ms": ms, "hits": int(len(pos))})
        lat = np.array([p["ms"] for p in per_query])

        # the RDD layer over the store: a city query's partitions, their
        # Arrow table and a save into a second store
        city = max((q for q in qs if q[0] == "city"),
                   key=lambda q: len(oracle(x, y, t, q[1], q[2], q[3])))
        city_q = _ecql(city[1], city[2], city[3])
        city_res = ds.query_result("gdelt", city_q)
        t0 = time.perf_counter()
        rdd = spatial_rdd({"store": ds}, "gdelt", city_q, num_partitions=4)
        rdd_ms = (time.perf_counter() - t0) * 1e3
        union = np.sort(np.concatenate(
            [p.ids.astype(np.int64) for p in rdd.partitions])) \
            if rdd.partitions else np.empty(0, np.int64)
        table = rdd.to_arrow()
        ds2 = TpuDataStore(device=dev)
        saved = save_rdd(rdd, {"store": ds2}, "gdelt")
        if (len(city_res.batch) == 0
                or not np.array_equal(union, _ids_of(city_res.batch))
                or table.num_rows != rdd.count()
                or saved != rdd.count() or ds2.get_count("gdelt") != saved):
            raise AssertionError(
                f"ingest rdd: {rdd.count()} rows in {rdd.num_partitions} "
                f"partitions, query {len(city_res.batch)}, arrow "
                f"{table.num_rows}, saved {saved}")
        del ds2, table

        # the converter provider over two files, filtered by a region
        region = next(q for q in qs if q[0] == "region")
        region_q = _ecql(region[1], region[2], region[3])
        two = [np.concatenate(c) for c in zip(*good[:2])]
        want2 = two[0][oracle(two[1], two[2], two[3], region[1], region[2],
                              region[3])]
        t0 = time.perf_counter()
        crdd = spatial_rdd({"paths": paths[:2], "sft": ds.get_schema("gdelt"),
                            "converter": INGEST_CONFIG}, "gdelt", region_q)
        conv_rdd_s = time.perf_counter() - t0
        got2 = np.sort(np.concatenate([p.ids.astype(np.int64)
                                       for p in crdd.partitions]))
        if not np.array_equal(got2, want2):
            raise AssertionError(f"ingest converter rdd: {len(got2)} rows in "
                                 f"{crdd.num_partitions} partitions, oracle "
                                 f"{len(want2)}")

        # run_distributed_ingest over the same two files on device_mesh(1):
        # its sharded z3 index's region query against the oracle's points
        t0 = time.perf_counter()
        didx, dres = run_distributed_ingest(
            ds.get_schema("gdelt"), INGEST_CONFIG, paths[:2],
            mesh=device_mesh(1), workers=2)
        torch.cuda.synchronize()
        dist_s = time.perf_counter() - t0
        hits = didx.query(region[1], region[2], region[3])
        st = convert.sharded_index_state(didx)
        live = np.concatenate([np.arange(c) + s * st["gid"].shape[1]
                               for s, c in enumerate(st["shard_counts"])])
        gid = st["gid"].ravel()[live]
        at = np.searchsorted(gid, hits, sorter=np.argsort(gid))
        row = live[np.argsort(gid)[at]]
        got_pts = [st[k].ravel()[row] for k in ("x", "y", "dtg")]
        opos = oracle(two[1], two[2], two[3], region[1], region[2], region[3])
        want_pts = [two[k][opos] for k in (1, 2, 3)]
        # the index keeps no feature ids: its hits' points, as a multiset
        got_o, want_o = np.lexsort(got_pts[::-1]), np.lexsort(want_pts[::-1])
        if (dres.ingested != len(two[0]) or dres.failed != 2 * n_bad
                or len(didx) != len(two[0]) or len(hits) != len(opos)
                or not all(np.array_equal(g[got_o], w[want_o])
                           for g, w in zip(got_pts, want_pts))):
            raise AssertionError(
                f"ingest distributed: {dres.ingested} ingested, "
                f"{dres.failed} failed, index {len(didx)}, {len(hits)} hits, "
                f"oracle {len(opos)}")
        del didx, st, two

        kept = None
        if keep is not None:
            # two of the files and their good rows outlive the phase: the
            # CLI part (25d) ingests them again
            kept = {"paths": [shutil.copy(p, keep) for p in paths[:2]],
                    "good": [np.concatenate(c) for c in zip(*good[:2])],
                    "failed": 2 * n_bad}
        formats = other_formats_part(rng, centres, qs, dev, root)
        exports = exports_part(city_res.batch, root)
        report["ingest"] = {
            "files": n_files, "rows_per_file": per, "fields": GDELT_FIELDS,
            "file_bytes": nbytes, "gen_write_s": gen_s,
            "ingested": res.ingested, "failed": res.failed,
            "ingest_s": ingest_s,
            "rows_per_s": n_files * per / ingest_s,
            "bytes_per_s": nbytes / ingest_s,
            "job_setup_ms": spans["setup"], "job_ingest_ms": spans["ingest"],
            "write_s": timed.write_s, "writes": timed.writes,
            "parse_convert_s": spans["ingest"] / 1e3 - timed.write_s,
            "first_query_ms": first_ms, "query_ms_p50": float(np.median(lat)),
            "query_ms_max": float(lat.max()), "queries": per_query,
            "rdd": {"rows": rdd.count(), "partitions": rdd.num_partitions,
                    "ms": rdd_ms, "saved": saved,
                    "converter_rows": int(len(got2)),
                    "converter_s": conv_rdd_s},
            "distributed": {"ingested": dres.ingested, "failed": dres.failed,
                            "hits": int(len(hits)), "s": dist_s},
            "formats": formats, "exports": exports}
        ing = report["ingest"]
        log(f"ingest: {n_files} files x {per} rows x {GDELT_FIELDS} fields "
            f"({nbytes} bytes, made in {gen_s:.2f} s); run_ingest "
            f"{res.ingested} ingested, {res.failed} failed in "
            f"{ingest_s:.2f} s = "
            f"{ing['rows_per_s']:.4g} rows/s, {ing['bytes_per_s']:.4g} B/s "
            f"(job setup {spans['setup']:.1f} ms, ingest "
            f"{spans['ingest']:.1f} ms of which {timed.write_s:.3f} s in "
            f"{timed.writes} writes); 40 queries equal to the oracle, first "
            f"z3 {first_ms['z3']:.1f} ms, first z2 {first_ms['z2']:.1f} ms, "
            f"p50 {np.median(lat):.2f} ms, max {lat.max():.2f} ms; rdd "
            f"{rdd.count()} rows in {rdd.num_partitions} partitions, saved "
            f"{saved}; converter rdd {len(got2)} rows in {conv_rdd_s:.2f} s; "
            f"distributed {dres.ingested} rows, {len(hits)} hits in "
            f"{dist_s:.2f} s; formats "
            + ", ".join(f"{k} {v['hits']}/{v['rows']}"
                        for k, v in formats.items())
            + f"; exports of {exports['rows']} rows read back equal")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return kept


def other_formats_part(rng, centres, qs, dev, root) -> dict:
    """Each other converter type (JSON, GeoJSON, XML, fixed-width, Avro,
    JDBC, shapefile, OSM) on a small file of GDELT-like points through
    ``run_ingest`` into its own schema on the card; a continent query
    (BBOX over 2018 through z3, BBOX alone through z2 on the dtg-less OSM
    schema) against the oracle."""
    import json as _json
    import sqlite3
    from xml.sax.saxutils import quoteattr

    import numpy as np
    from geomesa_tpu_torch import TpuDataStore
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.feature_type import parse_spec
    from geomesa_tpu_torch.io.avro import to_avro
    from geomesa_tpu_torch.io.export import to_shapefile
    from geomesa_tpu_torch.jobs import run_ingest

    n = 4000
    x, y, t = gdelt_like(rng, n, centres)
    x, y = np.round(x, 4), np.round(y, 4)
    eid = [f"e{i}" for i in range(n)]
    spec = "name:String,dtg:Date,*geom:Point"
    geom = {"name": "geom", "transform": "point(toDouble($lon), "
                                         "toDouble($lat))"}
    dtg = {"name": "dtg", "transform": "toLong($t)"}
    name = {"name": "name", "transform": "toString($n)"}

    def write(fname, text):
        path = os.path.join(root, fname)
        with open(path, "w") as f:
            f.write(text)
        return path

    cases = {
        "json": (spec, write("p.json", "\n".join(_json.dumps(
            {"id": eid[i], "n": f"n{i % 7}", "t": int(t[i]), "lon": x[i],
             "lat": y[i]}) for i in range(n))),
            {"type": "json", "id-field": "$id",
             "fields": [name, dtg, geom]}),
        "geojson": (spec, write("p.geojson", _json.dumps({
            "type": "FeatureCollection", "features": [
                {"type": "Feature", "id": eid[i],
                 "geometry": {"type": "Point", "coordinates": [x[i], y[i]]},
                 "properties": {"n": f"n{i % 7}", "t": int(t[i])}}
                for i in range(n)]})),
            {"type": "geojson", "id-field": "$id",
             "fields": [name, dtg, {"name": "geom",
                                    "transform": "$geometry"}]}),
        "xml": (spec, write("p.xml", "<events>" + "".join(
            f"<event id={quoteattr(eid[i])}><n>n{i % 7}</n><t>{t[i]}</t>"
            f"<pos lon=\"{float(x[i])!r}\" lat=\"{float(y[i])!r}\"/>"
            "</event>"
            for i in range(n)) + "</events>"),
            {"type": "xml", "feature-path": "event", "id-field": "$@id",
             "fields": [{"name": "name", "transform": "$n"},
                        {"name": "dtg", "transform": "toLong($t)"},
                        {"name": "geom", "transform":
                         "point(toDouble($pos/@lon), toDouble($pos/@lat))"}]}),
        "fixed-width": (spec, write("p.txt", "".join(
            f"{eid[i]:<10}{x[i]:>12.4f}{y[i]:>12.4f}{t[i]:>16d}\n"
            for i in range(n))),
            {"type": "fixed-width", "id-field": "$eid",
             "fields": [{"name": "eid", "start": 0, "width": 10},
                        {"name": "name", "transform": "substr($eid, 0, 2)"},
                        {"name": "geom", "transform":
                         "point(toDouble($lon), toDouble($lat))"},
                        {"name": "lon", "start": 10, "width": 12},
                        {"name": "lat", "start": 22, "width": 12},
                        {"name": "dtg", "start": 34, "width": 16,
                         "transform": "toLong($dtg)"}]}),
        "osm": ("name:String,*geom:Point", write("p.osm", "<osm>" + "".join(
            f"<node id=\"{i}\" lon=\"{float(x[i])!r}\" "
            f"lat=\"{float(y[i])!r}\">"
            f"<tag k=\"name\" v=\"n{i % 7}\"/></node>" for i in range(n))
            + "</osm>"),
            {"type": "osm", "id-field": "concat('e', $id)",
             "fields": [{"name": "name"},
                        {"name": "geom", "transform": "point($lon, $lat)"}]}),
    }
    sft = parse_spec("avro", spec)
    batch = FeatureBatch.from_dict(sft, {
        "name": np.array([f"n{i % 7}" for i in range(n)], dtype=object),
        "dtg": t, "geom": (x, y)}, ids=eid)
    to_avro(batch, os.path.join(root, "p.avro"))
    cases["avro"] = (spec, os.path.join(root, "p.avro"), {"type": "avro"})
    db = os.path.join(root, "p.db")
    with contextlib.closing(sqlite3.connect(db)) as conn:
        conn.execute("CREATE TABLE ev (id TEXT, n TEXT, t INT, x REAL, "
                     "y REAL)")
        conn.executemany("INSERT INTO ev VALUES (?,?,?,?,?)",
                         [(eid[i], f"n{i % 7}", int(t[i]), float(x[i]),
                           float(y[i])) for i in range(n)])
        conn.commit()
    cases["jdbc"] = (spec, db, {
        "type": "jdbc", "query": "SELECT id, n, t, x, y FROM ev",
        "id-field": "$id", "fields": [name, dtg, {
            "name": "geom", "transform": "point($x, $y)"}]})
    shp_sft = parse_spec("shp", "eid:String,name:String,dtg:Date,*geom:Point")
    to_shapefile(FeatureBatch.from_dict(shp_sft, {
        "eid": np.array(eid, dtype=object), "name": batch.column("name"),
        "dtg": t, "geom": (x, y)}), os.path.join(root, "p.shp"))
    cases["shapefile"] = (spec, os.path.join(root, "p.shp"), {
        "type": "shp", "id-field": "$eid",
        "fields": [{"name": "name"}, {"name": "dtg",
                                      "transform": "toLong($dtg)"},
                   {"name": "geom", "transform": "$geometry"}]})

    box = next(q for q in qs if q[0] == "continent")[1]
    ds = TpuDataStore(device=dev)
    out = {}
    ids = np.array(eid, dtype=object)
    for kind, (sch, path, config) in cases.items():
        schema = kind.replace("-", "_")
        ds.create_schema(schema, sch)
        t0 = time.perf_counter()
        res = run_ingest(ds, schema, config, [path], workers=1)
        ingest_ms = (time.perf_counter() - t0) * 1e3
        has_dtg = "dtg" in sch
        q = (_ecql(box, MS_2018, MS_2019 - 1) if has_dtg
             else _bbox_ecql(box))
        r = ds.query_result(schema, q)
        want = (oracle(x, y, t, box, MS_2018, MS_2019 - 1) if has_dtg
                else box_oracle(x, y, box))
        if (res.ingested != n or res.failed
                or r.strategy.index != ("z3" if has_dtg else "z2")
                or sorted(r.batch.ids) != sorted(ids[want])
                or len(want) == 0):
            raise AssertionError(
                f"ingest format {kind}: {res.ingested} ingested, "
                f"{res.failed} failed {res.errors[:2]}, "
                f"{r.strategy.index} {len(r.batch)} hits, oracle {len(want)}")
        out[kind] = {"rows": res.ingested, "hits": int(len(want)),
                     "ingest_ms": ingest_ms, "index": r.strategy.index}
    return out


def exports_part(batch, root) -> dict:
    """CSV, GeoJSON, GML, Leaflet and shapefile exports of a query's
    batch; CSV, GeoJSON and the shapefile read back equal to it."""
    import csv as _csv
    import io as _io
    import json as _json
    import xml.etree.ElementTree as ET

    import numpy as np
    from geomesa_tpu_torch.io.export import (
        to_csv, to_geojson, to_gml, to_leaflet, to_shapefile,
    )
    from geomesa_tpu_torch.io.formats import read_shapefile

    n = len(batch)
    x, y = batch.geom_xy()
    ids = [str(i) for i in batch.ids]
    actor, score = batch.column("actor"), batch.column("score")
    dtg = batch.column("dtg")
    ms = {}
    t0 = time.perf_counter()
    text = to_csv(batch)
    ms["csv"] = (time.perf_counter() - t0) * 1e3
    rows = list(_csv.reader(_io.StringIO(text)))
    pts = [r[5][len("POINT ("):-1].split() for r in rows[1:]]
    if (rows[0] != ["id", "actor", "code", "score", "dtg", "geom"]
            or [r[0] for r in rows[1:]] != ids
            or [float(p[0]) for p in pts] != list(x)
            or [float(p[1]) for p in pts] != list(y)
            or [float(r[3]) for r in rows[1:]] != list(score)
            or [int(np.datetime64(r[4], "ms").astype(np.int64))
                for r in rows[1:]] != list(dtg)):
        raise AssertionError("ingest export: the CSV does not read back")
    t0 = time.perf_counter()
    fc = _json.loads(to_geojson(batch))
    ms["geojson"] = (time.perf_counter() - t0) * 1e3
    feats = fc["features"]
    if ([f["id"] for f in feats] != ids
            or [f["geometry"]["coordinates"] for f in feats]
            != [[float(a), float(b)] for a, b in zip(x, y)]
            or [f["properties"].get("actor") for f in feats] != list(actor)
            or [f["properties"]["score"] for f in feats] != list(score)):
        raise AssertionError("ingest export: the GeoJSON does not read back")
    t0 = time.perf_counter()
    gml = to_gml(batch)
    html = to_leaflet(batch)
    ms["gml_leaflet"] = (time.perf_counter() - t0) * 1e3
    members = ET.fromstring(gml).findall(
        "{http://www.opengis.net/gml}featureMember")
    if len(members) != n or html.count('"type": "Feature"') != n:
        raise AssertionError(f"ingest export: GML {len(members)} members, "
                             f"Leaflet {html.count('Feature')} of {n}")
    t0 = time.perf_counter()
    to_shapefile(batch, os.path.join(root, "city.shp"))
    ms["shapefile"] = (time.perf_counter() - t0) * 1e3
    geoms, attrs = read_shapefile(os.path.join(root, "city.shp"))
    if ([g.x for g in geoms] != list(x) or [g.y for g in geoms] != list(y)
            or list(attrs["dtg"]) != list(dtg)
            or list(attrs["score"]) != list(score)
            or [a or None for a in attrs["actor"]]
            != [a or None for a in actor]):
        raise AssertionError("ingest export: the shapefile does not read "
                             "back")
    return {"rows": n, "ms": ms}


#: phase 24's great-circle radius: the processes' (process/knn.py)
EARTH_RADIUS_M = 6_371_008.8
#: the colours of hash_attribute_color_process (the reference's
#: HashAttributeColorProcess palette)
HASH_COLOURS = ("#6495ED", "#B0C4DE", "#00FFFF", "#9ACD32", "#00FA9A",
                "#FFF8DC", "#F5DEB3")
GEOHASH_32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def haversine_np(x0, y0, x, y):
    """Great-circle metres from ``(x0, y0)`` to each ``(x, y)``."""
    import numpy as np
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(v, dtype=np.float64))
                              for v in (x0, y0, x, y))
    dlon = lon2 - lon1
    dlat = lat2 - lat1
    a = (np.sin(dlat / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2)
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def haversine_rows(x0: float, y0: float, x, y, chunk: int = 1 << 20):
    """``haversine_np`` over every row, in chunks on a thread pool."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    out = np.empty(len(x))

    def run(s):
        out[s:s + chunk] = haversine_np(x0, y0, x[s:s + chunk],
                                        y[s:s + chunk])

    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        list(pool.map(run, range(0, len(x), chunk)))
    return out


def nearest_oracle(d, idx, k: int):
    """The ``k`` smallest of the distances ``d`` of rows ``idx``, with
    every row tied at the k-th: ``(distances, rows)`` ascending, rows in
    their order among equal distances."""
    import numpy as np
    if len(d) > k:
        keep = d <= np.partition(d, k - 1)[k - 1]
        d, idx = d[keep], idx[keep]
    order = np.argsort(d, kind="stable")
    return d[order], idx[order]


def knn_oracle(x, y, t, x0: float, y0: float, k: int, lo=None, hi=None,
               chunk: int = 1 << 24):
    """The k nearest rows by a haversine over every row (in ``[lo, hi]``
    when given), in chunks."""
    import numpy as np
    ds_, is_ = [], []
    for s in range(0, len(x), chunk):
        idx = np.arange(s, min(s + chunk, len(x)))
        if lo is not None:
            tc = t[s:s + chunk]
            idx = idx[(tc >= lo) & (tc <= hi)]
        d, i = nearest_oracle(haversine_np(x0, y0, x[idx], y[idx]), idx, k)
        ds_.append(d)
        is_.append(i)
    return nearest_oracle(np.concatenate(ds_), np.concatenate(is_), k)


def knn_band_oracle(x, y, t, x0: float, y0: float, k: int, radius_m: float,
                    lo=None, hi=None, chunk: int = 1 << 24):
    """The k nearest rows among those of the latitude band within
    ``radius_m`` of ``y0`` (a row outside it is farther than the radius:
    the central angle is at least the latitude difference).  It holds
    the k nearest when its k-th distance is at most the radius, which the
    caller checks."""
    import numpy as np
    dlat = np.degrees(radius_m / EARTH_RADIUS_M) * (1 + 1e-9) + 1e-12
    rows = []
    for s in range(0, len(y), chunk):
        m = np.abs(y[s:s + chunk] - y0) <= dlat
        if lo is not None:
            tc = t[s:s + chunk]
            m &= (tc >= lo) & (tc <= hi)
        rows.append(np.flatnonzero(m) + s)
    idx = np.concatenate(rows)
    return nearest_oracle(haversine_np(x0, y0, x[idx], y[idx]), idx, k)


def check_knn(label: str, pos, dist, od, oi, k: int) -> None:
    """kNN against the oracle: the k distances bit for bit, the positions
    equal but among the ties at the k-th distance."""
    import numpy as np
    want = od[:k]
    if len(dist) != len(want) or not np.array_equal(dist, want):
        raise AssertionError(f"{label}: kNN distances disagree with the "
                             f"oracle ({len(dist)} against {len(want)})")
    dk = want[-1]
    if (not np.array_equal(np.sort(pos[dist < dk]), np.sort(oi[od < dk]))
            or not np.isin(pos[dist == dk], oi[od == dk]).all()
            or len(np.unique(pos)) != len(pos)):
        raise AssertionError(f"{label}: kNN positions disagree with the "
                             f"oracle")


def lat_sorted(y):
    """``(order, sorted y)`` for latitude-band lookups."""
    import numpy as np
    order = np.argsort(y, kind="stable")
    return order, y[order]


def band_rows(ys, lo: float, hi: float):
    """Rows with ``lo <= y <= hi`` of a ``lat_sorted`` pair, ascending."""
    import numpy as np
    order, ysorted = ys
    a = np.searchsorted(ysorted, lo, side="left")
    b = np.searchsorted(ysorted, hi, side="right")
    return np.sort(order[a:b])


def within_rows(x, y, ys, x0: float, y0: float, dist: float):
    """Every row within ``dist`` metres of ``(x0, y0)``: the latitude
    band, the longitude bound of a spherical cap, then the haversine."""
    import numpy as np
    ang = dist / EARTH_RADIUS_M
    dlat = np.degrees(ang) * (1 + 1e-9) + 1e-12
    rows = band_rows(ys, y0 - dlat, y0 + dlat)
    lat_hi = min(89.999, abs(y0) + np.degrees(ang))
    s = np.sin(ang / 2) / np.sqrt(np.cos(np.radians(abs(y0)))
                                  * np.cos(np.radians(lat_hi)))
    dlon = (np.degrees(2 * np.arcsin(min(1.0, s))) * (1 + 1e-9) + 1e-12
            if s < 1 else 360.0)
    near = np.abs(((x[rows] - x0) + 180.0) % 360.0 - 180.0) <= dlon
    rows = rows[near]
    return rows[haversine_np(x0, y0, x[rows], y[rows]) <= dist]


def window_rows(x, y, ys, box):
    """Rows inside ``box`` (inclusive), the BBOX of a candidate window."""
    rows = band_rows(ys, box[1], box[3])
    xr = x[rows]
    return rows[(xr >= box[0]) & (xr <= box[2])]


def reference_window(env, dist: float):
    """The candidate window the processes pad an envelope with:
    ``dist`` in latitude degrees, over the cosine of the envelope's middle
    latitude in longitude."""
    import numpy as np
    dlat = np.degrees(dist / EARTH_RADIUS_M)
    cos = max(0.01, np.cos(np.radians((env[1] + env[3]) / 2)))
    return (env[0] - dlat / cos, env[1] - dlat, env[2] + dlat / cos,
            env[3] + dlat)


def segment_nearest(px, py, a, b):
    """For each point, its nearest segment ``a[i] → b[i]`` by planar
    degree distance, the fraction along it and the closest point."""
    import numpy as np
    abx, aby = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    apx = px[:, None] - a[None, :, 0]
    apy = py[:, None] - a[None, :, 1]
    denom = np.maximum(abx ** 2 + aby ** 2, 1e-18)
    f = np.clip((apx * abx[None, :] + apy * aby[None, :]) / denom[None, :],
                0.0, 1.0)
    cx = a[None, :, 0] + f * abx[None, :]
    cy = a[None, :, 1] + f * aby[None, :]
    seg = np.argmin(np.hypot(px[:, None] - cx, py[:, None] - cy), axis=1)
    fb = f[np.arange(len(px)), seg]
    return (seg, fb, a[seg, 0] + fb * (b[seg, 0] - a[seg, 0]),
            a[seg, 1] + fb * (b[seg, 1] - a[seg, 1]))


def in_ring(px, py, ring):
    """Even-odd point-in-ring test."""
    import numpy as np
    inside = np.zeros(len(px), dtype=bool)
    for (x1, y1), (x2, y2) in zip(ring[:-1], ring[1:]):
        crosses = (y1 > py) != (y2 > py)
        with np.errstate(divide="ignore", invalid="ignore"):
            xi = x1 + (py - y1) * (x2 - x1) / (y2 - y1)
        inside ^= crosses & (px < xi)
    return inside


def bearing_np(x1, y1, x2, y2):
    """Initial great-circle bearing, degrees clockwise from north."""
    import numpy as np
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(v, dtype=np.float64))
                              for v in (x1, y1, x2, y2))
    dlon = lon2 - lon1
    yy = np.sin(dlon) * np.cos(lat2)
    xx = (np.cos(lat1) * np.sin(lat2)
          - np.sin(lat1) * np.cos(lat2) * np.cos(dlon))
    return np.degrees(np.arctan2(yy, xx)) % 360.0


def geohash_oracle(lon: float, lat: float, chars: int) -> str:
    """The geohash of a point by interval bisection."""
    lo_x, hi_x, lo_y, hi_y = -180.0, 180.0, -90.0, 90.0
    bits, even = [], True
    for _ in range(chars * 5):
        if even:
            mid = (lo_x + hi_x) / 2
            bits.append(lon >= mid)
            lo_x, hi_x = (mid, hi_x) if lon >= mid else (lo_x, mid)
        else:
            mid = (lo_y + hi_y) / 2
            bits.append(lat >= mid)
            lo_y, hi_y = (mid, hi_y) if lat >= mid else (lo_y, mid)
        even = not even
    return "".join(GEOHASH_32[int("".join("1" if b else "0"
                                          for b in bits[i:i + 5]), 2)]
                   for i in range(0, len(bits), 5))


def fnv1a(text: str) -> int:
    """64-bit FNV-1a of a string's UTF-8 bytes."""
    h = 0xCBF29CE484222325
    for b in text.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def sample_oracle(pos, n: int, keys=None):
    """1-in-n of the ascending hit positions, per key group when given."""
    import numpy as np
    if keys is None:
        return pos[::n]
    out = [pos[keys == k][::n] for k in np.unique(keys)]
    return np.sort(np.concatenate(out)) if out else pos[:0]


def random_track(rng, cx: float, cy: float, vertices: int, step: float,
                 t0: int, span_ms: int):
    """A ``vertices``-vertex random walk from ``(cx, cy)`` with
    ``step``-degree steps, times spread evenly over ``span_ms``."""
    import numpy as np
    ang = np.cumsum(rng.uniform(-0.6, 0.6, vertices - 1)) + rng.uniform(
        0, 2 * np.pi)
    steps = np.stack([np.cos(ang), np.sin(ang)], 1) * step
    xy = np.vstack([[cx, cy], [cx, cy] + np.cumsum(steps, axis=0)])
    times = t0 + np.linspace(0, span_ms, vertices).astype(np.int64)
    return xy, times


def tube_oracle(x, y, t, ys, track, times, buffer_m: float, tbuf: int,
                nofill: bool = False):
    """Rows within ``buffer_m`` of the track and ``tbuf`` of its time:
    along the nearest segment with the time interpolated there, or, with
    ``nofill``, of some vertex and that vertex's time."""
    import numpy as np
    dlat = np.degrees(buffer_m / EARTH_RADIUS_M)
    cos = np.maximum(0.01, np.cos(np.radians(track[:, 1])))
    pad = 2 * max(dlat, float(np.max(dlat / cos)))
    rows = window_rows(x, y, ys, (track[:, 0].min() - pad,
                                  track[:, 1].min() - pad,
                                  track[:, 0].max() + pad,
                                  track[:, 1].max() + pad))
    rows = rows[(t[rows] >= times.min() - tbuf)
                & (t[rows] <= times.max() + tbuf)]
    px, py, ft = x[rows], y[rows], t[rows].astype(np.float64)
    if nofill:
        keep = np.zeros(len(rows), dtype=bool)
        for (vx, vy), vt in zip(track, times):
            keep |= ((haversine_np(vx, vy, px, py) <= buffer_m)
                     & (np.abs(ft - float(vt)) <= tbuf))
        return rows[keep]
    seg, fb, cx, cy = segment_nearest(px, py, track[:-1], track[1:])
    t0 = times[:-1].astype(np.float64)
    t1 = times[1:].astype(np.float64)
    t_at = t0[seg] + fb * (t1[seg] - t0[seg])
    return rows[(haversine_np(px, py, cx, cy) <= buffer_m)
                & (np.abs(ft - t_at) <= tbuf)]


def analytics_facade_part(rng, args, centres, qs, ds, report):
    """24a, on the facade's ``gdelt`` (16M rows) and ``places`` (4M)
    stores and a ``vessels`` schema of its own: kNN, proximity, tube
    select, route search, the smaller processes, the sampling hints and
    SQL, every answer against a numpy oracle over the store's rows."""
    import numpy as np
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.geometry.types import LineString, Point, Polygon
    from geomesa_tpu_torch.obs import explain_analyze_sql
    from geomesa_tpu_torch.process import (
        date_offset_process, hash_attribute_color_process,
        hash_attribute_process, join_process, knn_process, min_max_process,
        point2point_process, proximity_process, route_search_process,
        track_label_process, tube_select, unique_process,
    )
    from geomesa_tpu_torch.sql import sql_query
    from geomesa_tpu_torch.sql.join import SPATIAL_JOIN_MAX_LEFT

    b = ds._store("gdelt").batch
    x, y = b.geom_xy()
    t = b.column("dtg")
    actor = b.column("actor")
    pb = ds._store("places").batch
    plx, ply = pb.geom_xy()
    rep = {}
    timings = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        timings.setdefault(key, []).append(
            (time.perf_counter() - t0) * 1e3)
        return out

    # kNN: five city centres, k = 10 and 1,000, with and without a month;
    # the oracle takes the haversine over every row once a centre
    month = (MS_2018 + 150 * DAY, MS_2018 + 180 * DAY - 1)
    knn_rows = []
    t0 = time.perf_counter()
    for i in range(5):
        cx, cy = (float(v) for v in centres[i])
        d_all = haversine_rows(cx, cy, x, y)
        in_month = np.flatnonzero((t >= month[0]) & (t <= month[1]))
        for k in (10, 1000):
            for lo, hi in ((None, None), month):
                pos, dist = timed("knn", lambda: knn_process(
                    ds, "gdelt", cx, cy, k, lo, hi))
                idx = np.arange(len(x)) if lo is None else in_month
                od, oi = nearest_oracle(d_all[idx], idx, k)
                check_knn(f"knn city {i} k={k} month={lo is not None}",
                          pos, dist, od, oi, k)
                knn_rows.append({"centre": i, "k": k,
                                 "month": lo is not None,
                                 "ms": timings["knn"][-1],
                                 "kth_m": float(dist[-1])})
    cx, cy = (float(v) for v in centres[5])
    pos, dist = timed("knn_places", lambda: knn_process(
        ds, "places", cx, cy, 10))
    od, oi = knn_oracle(plx, ply, None, cx, cy, 10)
    check_knn("knn places", pos, dist, od, oi, 10)
    rep["knn"] = {"calls": knn_rows, "places_ms": timings["knn_places"][0],
                  "oracle_s": time.perf_counter() - t0}

    # proximity: 50 places points at 5 km, a LineString and a Polygon;
    # the oracle holds the rows of each geometry's candidate window whose
    # exact distance is within, and counts the rows within the distance
    # but outside that window
    ys = lat_sorted(y)
    pick = rng.choice(np.flatnonzero(np.abs(ply) < 60.0), 50, replace=False)
    pts = [Point(float(plx[i]), float(ply[i])) for i in pick]
    got = timed("proximity_points", lambda: proximity_process(
        ds, "gdelt", pts, 5_000.0))
    want, outside = [], 0
    for p in pts:
        win = window_rows(x, y, ys, reference_window(
            (p.x, p.y, p.x, p.y), 5_000.0))
        near = win[haversine_np(p.x, p.y, x[win], y[win]) <= 5_000.0]
        want.append(near)
        outside += int(len(np.setdiff1d(within_rows(
            x, y, ys, p.x, p.y, 5_000.0), near)))
    want = np.unique(np.concatenate(want))
    if not np.array_equal(got, want):
        raise AssertionError(f"proximity of 50 points: {len(got)} rows, "
                             f"oracle {len(want)}")
    prox = {"points": {"rows": int(len(got)),
                       "ms": timings["proximity_points"][0],
                       "outside_window": outside}}
    cx, cy = (float(v) for v in centres[6])
    line = np.array([[cx - 1.0, cy - 0.2], [cx - 0.3, cy + 0.25],
                     [cx + 0.4, cy - 0.1], [cx + 1.0, cy + 0.3]])
    ang = np.linspace(0, 2 * np.pi, 6)[:-1]
    cx2, cy2 = (float(v) for v in centres[8])
    shell = np.stack([cx2 + 0.6 * np.cos(ang), cy2 + 0.45 * np.sin(ang)], 1)
    ring = np.vstack([shell, shell[:1]])
    for name, geom, verts, is_poly in (
            ("line", LineString(line), line, False),
            ("polygon", Polygon(shell), ring, True)):
        got = timed(f"proximity_{name}", lambda: proximity_process(
            ds, "gdelt", [geom], 5_000.0))
        segs = (verts[:-1], verts[1:])
        env = (verts[:, 0].min(), verts[:, 1].min(), verts[:, 0].max(),
               verts[:, 1].max())
        win = window_rows(x, y, ys, reference_window(env, 5_000.0))
        _, _, nx, ny = segment_nearest(x[win], y[win], *segs)
        keep = haversine_np(x[win], y[win], nx, ny) <= 5_000.0
        if is_poly:
            keep |= in_ring(x[win], y[win], ring)
        want = win[keep]
        wide = window_rows(x, y, ys, reference_window(env, 15_000.0))
        _, _, wx, wy = segment_nearest(x[wide], y[wide], *segs)
        wkeep = haversine_np(x[wide], y[wide], wx, wy) <= 5_000.0
        if is_poly:
            wkeep |= in_ring(x[wide], y[wide], ring)
        if not np.array_equal(got, want):
            raise AssertionError(f"proximity {name}: {len(got)} rows, "
                                 f"oracle {len(want)}")
        prox[name] = {"rows": int(len(got)),
                      "ms": timings[f"proximity_{name}"][0],
                      "outside_window": int(len(np.setdiff1d(
                          wide[wkeep], want)))}
    rep["proximity"] = prox

    # tube select: a 200-vertex track through a city cluster, 20 km and
    # 6 h, interpolated and nofill; the route search on the same track
    cx, cy = (float(v) for v in centres[9])
    track, times = random_track(rng, cx, cy, 200, 0.02, month[0], 10 * DAY)
    tube = {}
    for mode in ("line", "nofill"):
        got = timed(f"tube_{mode}", lambda: tube_select(
            ds, "gdelt", track, times, 20_000.0, 6 * 3_600_000,
            gap_fill=mode))
        want = tube_oracle(x, y, t, ys, track, times, 20_000.0,
                           6 * 3_600_000, nofill=mode == "nofill")
        if not np.array_equal(got, want) or len(want) == 0:
            raise AssertionError(f"tube {mode}: {len(got)} rows, oracle "
                                 f"{len(want)}")
        tube[mode] = {"rows": int(len(got)), "ms": timings[f"tube_{mode}"][0]}
    rep["tube"] = tube

    ds.create_schema("vessels", "heading:Double,dtg:Date,*geom:Point")
    vx, vy, vt = gdelt_like(rng, args.vessel_rows, centres)
    vh = rng.uniform(0.0, 360.0, args.vessel_rows)
    ds.write("vessels", {"heading": vh, "dtg": vt, "geom": (vx, vy)})
    route = LineString(track)
    got = timed("route", lambda: route_search_process(
        ds, "vessels", [route], 20_000.0, 30.0, heading_field="heading"))
    vys = lat_sorted(vy)
    env = (track[:, 0].min(), track[:, 1].min(), track[:, 0].max(),
           track[:, 1].max())

    def route_rows(box):
        rows = window_rows(vx, vy, vys, box)
        seg, _, nx, ny = segment_nearest(vx[rows], vy[rows], track[:-1],
                                         track[1:])
        near = haversine_np(vx[rows], vy[rows], nx, ny) <= 20_000.0
        rb = bearing_np(track[:-1, 0][seg], track[:-1, 1][seg],
                        track[1:, 0][seg], track[1:, 1][seg])
        dh = np.abs((vh[rows] - rb) % 360.0)
        return rows[near & (np.minimum(dh, 360.0 - dh) <= 30.0)]

    want = route_rows(reference_window(env, 20_000.0))
    if not np.array_equal(got, want) or len(want) == 0:
        raise AssertionError(f"route search: {len(got)} rows, oracle "
                             f"{len(want)}")
    rep["route"] = {"vessel_rows": args.vessel_rows, "rows": int(len(got)),
                    "ms": timings["route"][0],
                    "outside_window": int(len(np.setdiff1d(route_rows(
                        reference_window(env, 60_000.0)), want)))}

    # the smaller processes on a city filter
    cx, cy = (float(v) for v in centres[2])
    cbox = (cx - 0.5, cy - 0.5, cx + 0.5, cy + 0.5)
    city_q = _ecql([cbox], *month)
    city = oracle(x, y, t, [cbox], *month)
    rx, ry = (float(v) for v in centres[11])
    rbox = (rx - 5, ry - 5, rx + 5, ry + 5)
    region_q = _ecql([rbox], *month)
    region = oracle(x, y, t, [rbox], *month)
    vals, counts = np.unique(actor[city].astype(str), return_counts=True)
    got = timed("unique", lambda: unique_process(ds, "gdelt", "actor",
                                                 city_q))
    gv, gc = timed("unique", lambda: unique_process(
        ds, "gdelt", "actor", city_q, histogram=True, sort_by_count=True))
    by_count = np.argsort(-counts, kind="stable")
    if (not np.array_equal(got, vals) or not np.array_equal(
            gv, vals[by_count]) or not np.array_equal(gc, counts[by_count])):
        raise AssertionError("unique_process disagrees with np.unique")
    if (timed("minmax", lambda: min_max_process(ds, "gdelt", "dtg"))
            != (t.min(), t.max())
            or timed("minmax", lambda: min_max_process(
                ds, "gdelt", "dtg", cached=False, filter=city_q))
            != (t[city].min(), t[city].max())):
        raise AssertionError("min_max_process disagrees with the oracle")
    jb, jv = timed("join", lambda: join_process(
        ds, "gdelt", "gdelt", "actor", primary_filter=city_q,
        join_filter=region_q))
    joined = region[np.isin(actor[region], vals)]
    if (not np.array_equal(np.asarray(jv).astype(str), vals)
            or not np.array_equal(np.sort(jb.column("dtg")),
                                  np.sort(t[joined]))):
        raise AssertionError(f"join_process: {len(jb)} rows, oracle "
                             f"{len(joined)}")
    cb = ds.query("gdelt", city_q)
    ca, ct = cb.column("actor").astype(str), cb.column("dtg")
    labels = timed("track_label", lambda: track_label_process(
        cb, "actor", "dtg"))
    want_labels = np.sort([np.flatnonzero(ca == a)[np.flatnonzero(
        ct[ca == a] == ct[ca == a].max())[-1]] for a in np.unique(ca)])
    lines = timed("point2point", lambda: point2point_process(
        cb, "actor", "dtg"))
    cxs, cys = cb.geom_xy()
    starts, ends = [], []
    for a in np.unique(ca):
        g = np.flatnonzero(ca == a)
        g = g[np.argsort(ct[g], kind="stable")]
        moved = (cxs[g[1:]] != cxs[g[:-1]]) | (cys[g[1:]] != cys[g[:-1]])
        starts.append(ct[g[:-1]][moved])
        ends.append(ct[g[1:]][moved])
    if (not np.array_equal(labels, want_labels)
            or len(lines) != sum(len(s) for s in starts)
            or not np.array_equal(np.sort(lines.column("dtg_start")),
                                  np.sort(np.concatenate(starts)))
            or not np.array_equal(np.sort(lines.column("dtg_end")),
                                  np.sort(np.concatenate(ends)))):
        raise AssertionError("the track processes disagree with the oracle")
    hashed = timed("hash", lambda: hash_attribute_process(cb, "actor", 16))
    coloured = timed("hash", lambda: hash_attribute_color_process(
        cb, "actor", 16))
    shifted = timed("date_offset", lambda: date_offset_process(
        cb, "dtg", "P1DT2H"))
    h = np.array([fnv1a(a) % 16 for a in ca], dtype=np.int64)
    if (not np.array_equal(hashed.column("hash"), h)
            or list(coloured.column("hash"))
            != [HASH_COLOURS[v % len(HASH_COLOURS)] for v in h]
            or not np.array_equal(shifted.column("dtg"), ct + 93_600_000)):
        raise AssertionError("the transform processes disagree with the "
                             "oracle")
    small = {k: float(np.sum(v)) for k, v in timings.items()
             if k in ("unique", "minmax", "join", "track_label",
                      "point2point", "hash", "date_offset")}
    small.update(city_rows=int(len(city)), region_rows=int(len(region)),
                 joined_rows=int(len(joined)), lines=int(len(lines)))
    rep["small_ms"] = small

    # the sampling hints on three of the 20 queries
    samp = []
    for kind, boxes, lo, hi in (qs[0], qs[9], qs[15]):
        lo_s, hi_s = lo - lo % 1000, hi - hi % 1000
        full = oracle(x, y, t, boxes, lo_s, hi_s)
        q = _ecql(boxes, lo, hi)
        for hints, want in (
                ({"SAMPLING": 10}, sample_oracle(full, 10)),
                ({"SAMPLING": 10, "SAMPLE_BY": "actor"},
                 sample_oracle(full, 10, actor[full]))):
            res = timed("sampling", lambda: ds.query_result(
                "gdelt", Query.of(q, hints=hints)))
            if not np.array_equal(res.positions, want):
                raise AssertionError(f"sampling {kind} {hints}: "
                                     f"{len(res.positions)} rows, oracle "
                                     f"{len(want)}")
            samp.append({"query": kind, "by": "SAMPLE_BY" in hints,
                         "rows": int(len(want)), "of": int(len(full)),
                         "ms": timings["sampling"][-1]})
    rep["sampling"] = samp

    # SQL: the 20 queries as ECQL and as st_intersects / st_contains
    def wkt(bx):
        return (f"POLYGON(({bx[0]} {bx[1]}, {bx[2]} {bx[1]}, {bx[2]} "
                f"{bx[3]}, {bx[0]} {bx[3]}, {bx[0]} {bx[1]}))")

    sql_rows = []
    for kind, boxes, lo, hi in qs:
        lo_s, hi_s = lo - lo % 1000, hi - hi % 1000
        during = f"dtg DURING {iso(lo)}/{iso(hi)}"
        inter = " OR ".join(f"st_intersects(geom, st_geomFromWKT("
                            f"'{wkt(bx)}'))" for bx in boxes)
        contains = " OR ".join(f"st_contains(st_geomFromWKT('{wkt(bx)}'), "
                               f"geom)" for bx in boxes)
        tm = (t >= lo_s) & (t <= hi_s)
        strict = np.zeros(len(x), dtype=bool)
        for bx in boxes:
            strict |= ((x > bx[0]) & (x < bx[2]) & (y > bx[1])
                       & (y < bx[3]))
        inclusive = len(oracle(x, y, t, boxes, lo_s, hi_s))
        for form, where, want in (
                ("ecql", _ecql(boxes, lo, hi), inclusive),
                ("st_intersects", f"({inter}) AND {during}", inclusive),
                ("st_contains", f"({contains}) AND {during}",
                 int(np.count_nonzero(strict & tm)))):
            n = timed(f"sql_{form}", lambda: sql_query(
                ds, f"SELECT count(*) FROM gdelt WHERE {where}"))
            if n != want:
                raise AssertionError(f"SQL {form} {kind}: {n} rows, oracle "
                                     f"{want}")
            sql_rows.append({"query": kind, "form": form, "rows": int(n),
                             "ms": timings[f"sql_{form}"][-1]})
    grouped = timed("sql_group", lambda: sql_query(
        ds, f"SELECT actor, count(*) AS n, max(dtg) AS last FROM gdelt "
            f"WHERE {region_q} GROUP BY actor HAVING n > 100 "
            f"ORDER BY n DESC"))
    ga, gn = np.unique(actor[region].astype(str), return_counts=True)
    keep = gn > 100
    order = np.argsort(gn[keep], kind="stable")[::-1]
    want_last = np.array([t[region][actor[region] == a].max()
                          for a in ga[keep]])
    if (list(grouped["actor"]) != list(ga[keep][order])
            or not np.array_equal(grouped["n"], gn[keep][order])
            or not np.array_equal(grouped["last"],
                                  want_last[order].astype(np.float64))):
        raise AssertionError("SQL GROUP BY actor HAVING disagrees with the "
                             "oracle")
    cont_kind, cont_boxes, clo, chi = qs[14]
    cont = oracle(x, y, t, cont_boxes, clo - clo % 1000, chi - chi % 1000)
    agg = timed("sql_global", lambda: sql_query(
        ds, f"SELECT count(*) AS n, min(dtg) AS lo, max(dtg) AS hi, "
            f"avg(dtg) AS mean FROM gdelt WHERE "
            f"{_ecql(cont_boxes, clo, chi)}"))
    if agg != {"n": len(cont), "lo": t[cont].min(), "hi": t[cont].max(),
               "mean": t[cont].mean()}:
        raise AssertionError(f"SQL global aggregates: {agg}")
    expr = timed("sql_expr", lambda: sql_query(
        ds, f"SELECT st_x(geom) AS lon, st_y(geom) AS lat, "
            f"st_geoHash(geom, 7) AS gh FROM gdelt WHERE {city_q}"))
    if (not np.array_equal(expr["lon"], x[city])
            or not np.array_equal(expr["lat"], y[city])
            or list(expr["gh"]) != [geohash_oracle(a, b_, 7)
                                    for a, b_ in zip(x[city], y[city])]):
        raise AssertionError("SQL expression projection disagrees with the "
                             "oracle")
    # the spatial join: places within a small city box, gdelt within 1 km
    jx, jy = (float(v) for v in centres[3])
    jbox = (jx - 0.1, jy - 0.1, jx + 0.1, jy + 0.1)
    left = box_oracle(plx, ply, [jbox])
    if not 0 < len(left) < SPATIAL_JOIN_MAX_LEFT:
        raise AssertionError(f"join left side {len(left)} rows")
    pairs = timed("sql_join", lambda: sql_query(
        ds, "SELECT a.name, b.actor FROM places a JOIN gdelt b "
            "ON st_dwithin(a.geom, b.geom, 1000) WHERE "
            f"BBOX(a.geom, {jbox[0]}, {jbox[1]}, {jbox[2]}, {jbox[3]})"))
    partner = [within_rows(x, y, ys, float(plx[i]), float(ply[i]), 1000.0)
               for i in left]
    n_pairs = sum(len(p) for p in partner)
    want_actors = np.unique(np.concatenate(
        [actor[p] for p in partner]).astype(str), return_counts=True)
    if (len(pairs["b.actor"]) != n_pairs
            or not all(np.array_equal(a, b_) for a, b_ in zip(
                np.unique(pairs["b.actor"].astype(str), return_counts=True),
                want_actors))):
        raise AssertionError(f"SQL spatial join: {len(pairs['b.actor'])} "
                             f"pairs, oracle {n_pairs}")
    ea = timed("explain_analyze_sql", lambda: explain_analyze_sql(
        ds, f"SELECT count(*) FROM gdelt WHERE {city_q}"))
    if ea.result_summary != {"value": len(city)} or not ea.traces:
        raise AssertionError(f"explain_analyze_sql: {ea.result_summary}")
    rep["sql"] = {
        "queries": sql_rows,
        "p50_ms": {f: float(np.median(timings[f"sql_{f}"]))
                   for f in ("ecql", "st_intersects", "st_contains")},
        "group_ms": timings["sql_group"][0],
        "global_ms": timings["sql_global"][0],
        "expr_ms": timings["sql_expr"][0], "expr_rows": int(len(city)),
        "join_ms": timings["sql_join"][0], "join_left": int(len(left)),
        "join_pairs": int(n_pairs),
        "explain_analyze_ms": timings["explain_analyze_sql"][0],
        "explain_analyze_traces": len(ea.traces)}
    report["analytics"] = {"facade": rep}
    log(f"analytics (facade): kNN {len(knn_rows)} + 1 calls, p50 "
        f"{np.median(timings['knn']):.1f} ms, equal to the oracle "
        f"({rep['knn']['oracle_s']:.1f} s with it); proximity "
        + ", ".join(f"{k} {v['rows']} rows {v['ms']:.1f} ms" for k, v in
                    prox.items())
        + "; tube " + ", ".join(f"{k} {v['rows']} rows {v['ms']:.1f} ms"
                                for k, v in tube.items())
        + f"; route {rep['route']['rows']} rows {rep['route']['ms']:.1f} ms"
        + f"; sampling {len(samp)} queries; SQL {len(sql_rows)} counts "
          f"p50 " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                              rep["sql"]["p50_ms"].items())
        + f", join {n_pairs} pairs of {len(left)} left rows "
          f"{rep['sql']['join_ms']:.1f} ms; all equal to the oracle")


def analytics_mesh_part(ds, name, r, centre, report):
    """24b, on the mesh store: kNN and tube select through its batched
    windows around ``centre``, against numpy oracles over its rows."""
    import numpy as np
    from geomesa_tpu_torch.process import knn_process, tube_select

    x, y, t = r["x"], r["y"], r["t"]
    ys = lat_sorted(y)
    cx, cy = (float(v) for v in centre)
    t0 = time.perf_counter()
    pos, dist = knn_process(ds, name, cx, cy, 15)
    knn_ms = (time.perf_counter() - t0) * 1e3
    od, oi = knn_band_oracle(x, y, t, cx, cy, 15, float(dist[-1]))
    check_knn("mesh knn", pos, dist, od, oi, 15)
    tk = np.linspace(0, 1, 9)
    track = np.column_stack([cx - 1.0 + 2.0 * tk, cy - 0.8 + 1.6 * tk])
    times = (MS_2018 + 100 * DAY + tk * 30 * DAY).astype(np.int64)
    t0 = time.perf_counter()
    got = tube_select(ds, name, track, times, 20_000.0, 6 * 3_600_000)
    tube_ms = (time.perf_counter() - t0) * 1e3
    want = tube_oracle(x, y, t, ys, track, times, 20_000.0, 6 * 3_600_000)
    if not np.array_equal(got, want) or len(want) == 0:
        raise AssertionError(f"mesh tube: {len(got)} rows, oracle "
                             f"{len(want)}")
    report.setdefault("analytics", {})["mesh"] = {
        "knn_ms": knn_ms, "tube_ms": tube_ms, "tube_rows": int(len(got))}
    log(f"analytics (mesh): kNN {knn_ms:.1f} ms, tube {len(got)} rows "
        f"{tube_ms:.1f} ms, equal to the oracle")


def analytics_lean_part(ds, name, cols, checks, report):
    """24c, on the lean store: kNN and a SQL ``count(*)``, against numpy
    oracles over its rows ``cols``."""
    import numpy as np
    from geomesa_tpu_torch.process import knn_process
    from geomesa_tpu_torch.sql import sql_query

    x, y, t = cols
    kind, ecql, boxes, lo, hi = checks[0]
    bx = boxes[0]
    cx, cy = (bx[0] + bx[2]) / 2, (bx[1] + bx[3]) / 2
    t0 = time.perf_counter()
    pos, dist = knn_process(ds, name, cx, cy, 15)
    knn_ms = (time.perf_counter() - t0) * 1e3
    od, oi = knn_band_oracle(x, y, t, cx, cy, 15, float(dist[-1]))
    check_knn("lean knn", pos, dist, od, oi, 15)
    t0 = time.perf_counter()
    n = sql_query(ds, f"SELECT count(*) FROM {name} WHERE {ecql}")
    sql_ms = (time.perf_counter() - t0) * 1e3
    want = len(oracle(x, y, t, boxes, lo, hi))
    if n != want:
        raise AssertionError(f"lean SQL count: {n}, oracle {want}")
    report.setdefault("analytics", {})["lean"] = {
        "knn_ms": knn_ms, "sql_count_ms": sql_ms, "sql_count": int(n)}
    log(f"analytics (lean): kNN {knn_ms:.1f} ms, SQL count {n} "
        f"{sql_ms:.1f} ms, equal to the oracle")


def _mh_analytics(ds, rank, x, y, t, centres, out) -> None:
    """24d, in each multihost worker: kNN, proximity and tube select on
    the ``events`` store, the same on both workers and equal to oracles
    over both workers' rows; ``sql_join`` raises."""
    import numpy as np
    from geomesa_tpu_torch.geometry.types import Point
    from geomesa_tpu_torch.ops.z2_mask import z2_mask
    from geomesa_tpu_torch.ops.z3_mask import z3_mask
    from geomesa_tpu_torch.parallel.multihost import allgather_concat
    from geomesa_tpu_torch.parallel.scan import encode_gids
    from geomesa_tpu_torch.process import (
        knn_process, proximity_process, tube_select,
    )
    from geomesa_tpu_torch.sql import sql_join

    l0 = (z3_mask.launches, z2_mask.launches)
    cx, cy = (float(v) for v in centres[7])
    ys = lat_sorted(y)
    timings = {}

    def same_on_both(label, a):
        a = np.asarray(a)
        both = allgather_concat(a[None].view(np.int64))
        if not (both == both[:1]).all():
            raise AssertionError(f"multihost {label}: the workers disagree")

    def gids(rows):
        return encode_gids(np.asarray(rows, np.int64), rank)

    t0 = time.perf_counter()
    pos, dist = knn_process(ds, "events", cx, cy, 10)
    timings["knn_ms"] = (time.perf_counter() - t0) * 1e3
    same_on_both("knn positions", pos)
    same_on_both("knn distances", dist)
    d, i = knn_oracle(x, y, None, cx, cy, 10)
    pairs = allgather_concat(np.stack([gids(i), d.view(np.int64)], 1))
    od, oi = nearest_oracle(pairs[:, 1].copy().view(np.float64),
                            pairs[:, 0].copy(), 10)
    check_knn("multihost knn", pos, dist, od, oi, 10)
    t0 = time.perf_counter()
    got = proximity_process(ds, "events", [Point(cx, cy)], 20_000.0)
    timings["proximity_ms"] = (time.perf_counter() - t0) * 1e3
    win = window_rows(x, y, ys, reference_window((cx, cy, cx, cy),
                                                 20_000.0))
    near = win[haversine_np(cx, cy, x[win], y[win]) <= 20_000.0]
    want = np.sort(allgather_concat(gids(near)))
    if not np.array_equal(got, want) or len(want) == 0:
        raise AssertionError(f"multihost proximity: {len(got)} rows, "
                             f"oracle {len(want)}")
    tk = np.linspace(0, 1, 9)
    track = np.column_stack([cx - 1.0 + 2.0 * tk, cy - 0.8 + 1.6 * tk])
    times = (MS_2018 + 100 * DAY + tk * 30 * DAY).astype(np.int64)
    t0 = time.perf_counter()
    tube = tube_select(ds, "events", track, times, 20_000.0, 6 * 3_600_000)
    timings["tube_ms"] = (time.perf_counter() - t0) * 1e3
    want_t = np.sort(allgather_concat(gids(tube_oracle(
        x, y, t, ys, track, times, 20_000.0, 6 * 3_600_000))))
    if not np.array_equal(tube, want_t) or len(want_t) == 0:
        raise AssertionError(f"multihost tube: {len(tube)} rows, oracle "
                             f"{len(want_t)}")
    try:
        sql_join(ds, "SELECT a.actor, b.score FROM events a JOIN events b "
                     "ON a.actor = b.actor LIMIT 5")
    except NotImplementedError as e:
        gate = str(e)
    else:
        raise AssertionError("sql_join ran over a multihost store of two "
                             "processes")
    out["analytics"] = dict(
        timings, proximity_rows=int(len(got)), tube_rows=int(len(tube)),
        join_gate=gate.split(":")[0],
        launches={"z3_mask": z3_mask.launches - l0[0],
                  "z2_mask": z2_mask.launches - l0[1]})


def mosaic_centres(origin: float, span: float, n: int, sign: int):
    """The float64 pixel centres of a mosaic, as the JAX program computes
    them once XLA has compiled it: ``(i + 0.5) * span`` rounded, times
    the float64 reciprocal of ``n``, added to ``origin`` with one
    rounding."""
    import numpy as np
    from fractions import Fraction
    recip, base = Fraction(1.0 / n), Fraction(origin)
    steps = ((np.arange(n, dtype=np.float64) + 0.5) * span).tolist()
    return np.array([float(base + sign * Fraction(v) * recip)
                     for v in steps])


def mosaic_oracle(tiles, bboxes, bbox, width: int, height: int):
    """numpy mosaic: each tile in turn paints the pixels whose centres lie
    inside it (``bx0 <= x < bx1``, ``by0 < y <= by1``) with its nearest
    source pixel; NaN where none does."""
    import numpy as np
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    px = mosaic_centres(xmin, xmax - xmin, width, 1)
    py = mosaic_centres(ymax, ymax - ymin, height, -1)
    canvas = np.full((height, width), np.nan, dtype=np.float32)
    th, tw = tiles[0].shape
    for tile, (bx0, by0, bx1, by1) in zip(tiles, bboxes):
        cols = np.flatnonzero((px >= bx0) & (px < bx1))
        if not len(cols):
            continue
        rows = np.flatnonzero((py > by0) & (py <= by1))
        if not len(rows):
            continue
        ci = np.clip(((px[cols] - bx0) / (bx1 - bx0) * tw).astype(np.int32),
                     0, tw - 1)
        ri = np.clip(((by1 - py[rows]) / (by1 - by0) * th).astype(np.int32),
                     0, th - 1)
        canvas[np.ix_(rows, cols)] = tile[np.ix_(ri, ci)]
    return canvas


def same_mosaic(label: str, got, want) -> None:
    import numpy as np
    nan = np.isnan(want)
    if (got.shape != want.shape or got.dtype != np.float32
            or not np.array_equal(np.isnan(got), nan)
            or not np.array_equal(got[~nan], want[~nan])):
        raise AssertionError(f"raster {label}: the mosaic disagrees with the "
                             f"oracle")


def raster_phase(rng, args, centres, dev, report, wcs=None):
    """24e: a raster store of its own at the published grid of GTOPO30
    (30 arc-seconds, 43,200 x 21,600 cells) as ``--raster-lat-tiles``
    rows of 180 tiles of 240 x 240 float32, 2 x 2 degrees each, on the
    card; a 3-level pyramid; three mosaics against numpy oracles; the
    other reads and a save/load round trip.  ``wcs(store, checks)``, when
    given, serves the web tile and continent windows (each ``(name,
    bbox, width, height, resolution, oracle grid)``) over ``/wcs``.  The
    store is dropped at the end."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.index.pyramid import tile_env
    from geomesa_tpu_torch.raster import RasterStore

    tp, nx, ny = 240, 180, args.raster_lat_tiles
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def allocated():
        return torch.cuda.memory_allocated() if cuda else 0

    sync()
    gc.collect()
    base_alloc = allocated()
    # the values: a cheap separable surface from the seed, below 0 (sea)
    # as NaN, GTOPO30's ocean nodata; a band of tiles at a time, made on
    # the device and copied to the host, where the store keeps its tiles
    ph = rng.uniform(0.0, 2 * np.pi, 4)
    noise = (rng.standard_normal((tp, tp)) * 25).astype(np.float32)
    lon = np.radians(-180.0 + (np.arange(nx * tp) + 0.5) / 120.0)
    lat = np.radians(90.0 - (np.arange(ny * tp) + 0.5) / 120.0)

    def on_dev(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)

    a1 = on_dev(1500 * np.sin(3 * lon + ph[0]))
    a2 = on_dev(900 * np.sin(7 * lon + ph[1]))
    b1 = on_dev(np.cos(2 * lat + ph[2]))
    b2 = on_dev(np.sin(5 * lat + ph[3]))
    noise_row = on_dev(np.tile(noise, (1, nx)))
    store = RasterStore("gtopo30", device=dev)
    put_s = 0.0
    t_all = time.perf_counter()
    for j in range(ny):
        rs = slice(j * tp, (j + 1) * tp)
        band = (torch.outer(b1[rs], a1) + torch.outer(b2[rs], a2)
                + noise_row)
        band = torch.where(band < 0, float("nan"), band).cpu().numpy()
        t0 = time.perf_counter()
        for i in range(nx):
            store.put(band[:, i * tp:(i + 1) * tp],
                      (-180.0 + 2 * i, 90.0 - 2 * (j + 1),
                       -180.0 + 2 * (i + 1), 90.0 - 2 * j))
        put_s += time.perf_counter() - t0
    gen_s = time.perf_counter() - t_all - put_s
    finest = store.available_resolutions[0]
    level = store._levels[round(finest, 12)]
    n_tiles = store.count()
    # stack and upload, timed apart, then through the store's own cache
    t0 = time.perf_counter()
    stacked = np.stack(level.tiles)
    stack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe = torch.from_numpy(stacked).to(dev, copy=True)
    sync()
    upload_s = time.perf_counter() - t0
    del probe, stacked
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    level.arrays()
    sync()
    cache_s = time.perf_counter() - t0
    # the pyramid pools the device stacks; a sample of its tiles against
    # numpy's float32 mean, as the JAX package pools them
    t0 = time.perf_counter()
    res = store.build_pyramid(3)
    sync()
    pyramid_s = time.perf_counter() - t0
    if len(res) != 4 or store.count() != 4 * n_tiles:
        raise AssertionError(f"raster pyramid: {res}, {store.count()} tiles")
    sample = rng.choice(n_tiles, 64, replace=False)
    src = np.stack([level.tiles[k] for k in sample])
    for r in res[1:]:
        want = src.reshape(64, src.shape[1] // 2, 2, src.shape[2] // 2,
                           2).mean(axis=(2, 4))
        lvl = store._levels[round(r, 12)]
        got = np.stack([lvl.tiles[k] for k in sample])
        if not np.array_equal(got, want, equal_nan=True):
            raise AssertionError(f"raster pyramid at {r}: the pooled tiles "
                                 f"disagree with numpy's mean")
        src = want
    # the three mosaics, each against the numpy oracle; the web-map tile
    # over the first city whose tile holds mostly land
    z = 9
    for cx, cy in centres:
        web = tile_env(z, int((cx + 180.0) / (360.0 / (1 << z))),
                       int((90.0 - cy) / (180.0 / (1 << z))))
        if web[1] >= 90.0 - 2 * ny and np.isnan(mosaic_oracle(
                level.tiles, level.bboxes, web, 64, 64)).mean() < 0.5:
            break
    coarsest = res[-1]
    mosaics = []
    wcs_checks = []
    for name, bbox, w, h, r in (
            ("web_tile", web, 256, 256, None),
            ("continent", (-10.0, 35.0, 50.0, 75.0), 2048, 2048, None),
            ("world", (-180.0, -90.0, 180.0, 90.0), 4096, 2048, coarsest)):
        lvl = store._levels[round(store._pick_resolution(r), 12)]
        t0 = time.perf_counter()
        got = store.mosaic(bbox, w, h, resolution=r)
        first_ms = (time.perf_counter() - t0) * 1e3
        times_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = store.mosaic(bbox, w, h, resolution=r)
            times_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        want = mosaic_oracle(lvl.tiles, lvl.bboxes, bbox, w, h)
        oracle_s = time.perf_counter() - t0
        same_mosaic(name, got, want)
        same_mosaic(f"{name} (again)", again, want)
        if name != "world":
            wcs_checks.append((name, bbox, w, h, r, want))
        mosaics.append({"mosaic": name, "bbox": list(bbox), "width": w,
                        "height": h, "level_tiles": len(lvl.tiles),
                        "tile_shape": list(lvl.tile_shape),
                        "first_ms": first_ms, "ms": min(times_ms),
                        "ms_all": times_ms, "oracle_s": oracle_s,
                        "nan_share": float(np.isnan(want).mean()),
                        "launches": device_launches(lambda: store.mosaic(
                            bbox, w, h, resolution=r)) if cuda else None})
    if wcs is not None:
        # 25b: the WCS front end over this store, timed apart
        wcs(store, wcs_checks)
    del wcs_checks
    # the other reads
    boxes = np.asarray(level.bboxes)
    hit = ((boxes[:, 0] < web[2]) & (boxes[:, 2] > web[0])
           & (boxes[:, 1] < web[3]) & (boxes[:, 3] > web[1]))
    tiles = store.get_tiles(web)
    if ([t.bbox for t in tiles] != [tuple(b) for b in boxes[hit]]
            or store.bounds() != (-180.0, 90.0 - 2 * ny, 180.0, 90.0)
            or store.grid_range() != (nx * tp, ny * tp)
            or store.grid_range(coarsest) != (nx * 30, ny * 30)):
        raise AssertionError(f"raster reads: {len(tiles)} tiles "
                             f"({int(hit.sum())}), bounds {store.bounds()}, "
                             f"grid {store.grid_range()}")
    gc.collect()
    sync()
    device_bytes = store.device_bytes()
    allocated_delta = allocated() - base_alloc
    # save and load a 16 x 16 block of tiles
    sub = RasterStore("subset", device=dev)
    pick = [k for k, b in enumerate(level.bboxes)
            if 0.0 <= b[0] < 32.0 and 40.0 <= b[1] < 72.0]
    if len(pick) != 256:
        pick = list(range(256))
    for k in pick:
        sub.put(level.tiles[k], level.bboxes[k])
    sbox = sub.bounds()
    root = tempfile.mkdtemp(prefix="chip_smoke_raster_")
    try:
        path = os.path.join(root, "subset.npz")
        t0 = time.perf_counter()
        sub.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = RasterStore.load(path, device=dev)
        load_s = time.perf_counter() - t0
        npz_bytes = os.path.getsize(path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = mosaic_oracle([level.tiles[k] for k in pick],
                         [level.bboxes[k] for k in pick], sbox, 1024, 1024)
    same_mosaic("subset", sub.mosaic(sbox, 1024, 1024), want)
    sub_launches = (device_launches(lambda: sub.mosaic(sbox, 1024, 1024))
                    if cuda else None)
    same_mosaic("subset loaded", back.mosaic(sbox, 1024, 1024), want)
    if back.count() != 256 or back.name != "subset":
        raise AssertionError(f"raster load: {back.count()} tiles")
    report["raster"] = {
        "tiles": n_tiles, "tile_shape": [tp, tp], "grid": [nx * tp, ny * tp],
        "tile_bytes": int(n_tiles * tp * tp * 4), "gen_s": gen_s,
        "put_s": put_s, "pyramid_s": pyramid_s, "resolutions": res,
        "numpy": np.__version__,
        "stack_s": stack_s, "upload_s": upload_s,
        "upload_bytes_per_s": n_tiles * tp * tp * 4 / upload_s,
        "stack_upload_s": cache_s, "mosaics": mosaics,
        "device_bytes": device_bytes,
        "memory_allocated_delta": allocated_delta if cuda else None,
        "save_s": save_s, "load_s": load_s, "npz_bytes": npz_bytes,
        "subset_launches": sub_launches}
    log(f"raster: {n_tiles} tiles of {tp}x{tp} ({n_tiles * tp * tp * 4 / 1e9:.2f}"
        f" GB) made in {gen_s:.1f} s, put in {put_s:.2f} s; pyramid "
        f"{pyramid_s:.1f} s; stack {stack_s:.2f} s, upload {upload_s:.2f} s, "
        f"the store's stack and upload {cache_s:.2f} s; mosaics equal to the "
        f"oracle: " + ", ".join(f"{m['mosaic']} {m['ms']:.1f} ms (first "
                                f"{m['first_ms']:.1f}, launches "
                                f"{m['launches']})" for m in mosaics)
        + f"; 256-tile subset launches {sub_launches}"
        + f"; device bytes {device_bytes}, allocated {allocated_delta}; "
          f"save {save_s:.2f} s, load {load_s:.2f} s")
    del store, sub, back, level
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


class _Web:
    """A port ``WebApp`` behind ``make_bounded_server`` on 127.0.0.1 (an
    ephemeral port), served from a thread, with requests through urllib
    and no proxy.  A context manager: the server stops and closes on
    exit.  ``times`` holds each named route's wall times, ms."""

    def __init__(self, app, max_concurrent: int = 32):
        self.app, self.max_concurrent = app, max_concurrent
        self.times: dict = {}

    def __enter__(self):
        import threading
        import urllib.request
        from wsgiref import simple_server

        from geomesa_tpu_torch.web.wsgi import make_bounded_server
        # wsgiref logs every request to stderr: quiet while it serves
        self._log = simple_server.WSGIRequestHandler.log_message
        simple_server.WSGIRequestHandler.log_message = lambda *a: None
        self.httpd = make_bounded_server("127.0.0.1", 0, self.app,
                                         max_concurrent=self.max_concurrent)
        self.base = f"http://127.0.0.1:{self.httpd.server_port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({}))
        return self

    def __exit__(self, *exc):
        from wsgiref import simple_server
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)
        simple_server.WSGIRequestHandler.log_message = self._log

    def request(self, method: str, path: str, body: bytes | None = None,
                route: str | None = None, ctype: str = "application/json",
                timeout: float = 600.0):
        """``(status, headers, body)``; an error status is returned, not
        raised."""
        import urllib.error
        import urllib.request
        req = urllib.request.Request(self.base + path, data=body,
                                     method=method)
        if body is not None:
            req.add_header("Content-Type", ctype)
        t0 = time.perf_counter()
        try:
            with self.opener.open(req, timeout=timeout) as r:
                out = (r.status, dict(r.headers), r.read())
        except urllib.error.HTTPError as e:
            out = (e.code, dict(e.headers), e.read())
        if route is not None:
            self.times.setdefault(route, []).append(
                (time.perf_counter() - t0) * 1e3)
        return out

    def get(self, path: str, route: str | None = None, want: int = 200):
        status, headers, body = self.request("GET", path, route=route)
        if status != want:
            raise AssertionError(f"web GET {path[:160]}: {status}, not "
                                 f"{want}: {body[:300]!r}")
        return headers, body

    def summary(self) -> dict:
        import numpy as np
        return {k: {"n": len(v), "p50_ms": float(np.median(v)),
                    "max_ms": float(max(v))} for k, v in self.times.items()}


def _q(text: str) -> str:
    from urllib.parse import quote
    return quote(text, safe="")


def _csv_points(body: bytes):
    """The ids (strings) and the POINT x, y of a CSV export's rows."""
    import csv
    import io
    import numpy as np
    rows = [r for r in csv.reader(io.StringIO(body.decode())) if r]
    header, rows = rows[0], rows[1:]
    gi = header.index("geom")
    xy = np.array([r[gi][len("POINT ("):-1].split(" ") for r in rows],
                  dtype=np.float64).reshape(-1, 2)
    return [r[0] for r in rows], xy[:, 0], xy[:, 1]


def _check_csv(label: str, body: bytes, ids, x, y) -> int:
    import numpy as np
    got_ids, gx, gy = _csv_points(body)
    if not (got_ids == [str(v) for v in ids] and np.array_equal(gx, x)
            and np.array_equal(gy, y)):
        raise AssertionError(f"web {label}: {len(got_ids)} CSV rows disagree "
                             f"with the oracle's {len(ids)}")
    return len(got_ids)


def _png_check(label: str, png: bytes, grid, flip: bool) -> None:
    """A PNG body well-formed (signature, chunk CRCs, IHDR of an 8-bit
    gray image of the grid's size, one IDAT of unfiltered rows) with the
    pixels of ``grid`` (north up: flipped when row 0 is south) min-max
    scaled to 8 bits."""
    import struct
    import zlib
    import numpy as np
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"web {label}: no PNG signature")
    chunks, pos = {}, 8
    while pos < len(png):
        n, = struct.unpack(">I", png[pos:pos + 4])
        tag, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", png[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + data) != crc:
            raise AssertionError(f"web {label}: bad CRC on {tag!r}")
        chunks[tag] = data
        pos += 12 + n
    g = np.asarray(grid, dtype=np.float64)
    if flip:
        g = g[::-1]
    h, w = g.shape
    if (set(chunks) != {b"IHDR", b"IDAT", b"IEND"}
            or struct.unpack(">IIBBBBB", chunks[b"IHDR"])
            != (w, h, 8, 0, 0, 0, 0)):
        raise AssertionError(f"web {label}: PNG header {chunks.get(b'IHDR')}")
    img = np.frombuffer(zlib.decompress(chunks[b"IDAT"]),
                        np.uint8).reshape(h, w + 1)
    lo, hi = float(np.nanmin(g)), float(np.nanmax(g))
    scale = (g - lo) / (hi - lo) if hi > lo else np.zeros_like(g)
    want = np.nan_to_num(scale * 255.0).astype(np.uint8)
    if img[:, 0].any() or not np.array_equal(img[:, 1:], want):
        raise AssertionError(f"web {label}: PNG pixels disagree with the grid")


def _tile_of(z: int, cx: float, cy: float):
    n = 1 << z
    return (min(n - 1, int((cx + 180.0) / (360.0 / n))),
            min(n - 1, int((90.0 - cy) / (180.0 / n))))


def frontend_facade_part(rng, args, centres, qs, ds, report) -> dict:
    """25a: the port's ``WebApp`` over the facade's store behind
    ``make_bounded_server``, driven over HTTP: the 20 queries through
    ``/api/data`` as CSV, ``places`` boxes, the stats routes, 8 tiles
    (JSON and PNG), 4 ``/query`` Arrow streams, ``/explain`` by CQL and
    the 20 queries' ``COUNT(*)`` through ``/explain?sql=``, the
    observability routes, a 64-request burst against 8 slots and a
    10,000-feature GeoJSON POST read back by id — every answer against
    an oracle that does not go through the web app."""
    import concurrent.futures as cf
    import json as _json
    import numpy as np
    import pyarrow as pa
    from geomesa_tpu_torch.index.pyramid import tile_env
    from geomesa_tpu_torch.ops.gate import kernel_health
    from geomesa_tpu_torch.ops.z3_mask import z3_mask
    from geomesa_tpu_torch.resilience import admission_gate
    from geomesa_tpu_torch.web import WebApp

    b = ds._store("gdelt").batch
    x, y = b.geom_xy()
    t = b.column("dtg")
    ids = b.ids
    pb = ds._store("places").batch
    px, py = pb.geom_xy()
    pids = pb.ids

    def want_of(q):
        # DURING takes whole seconds: the oracle reads the bounds as parsed
        return oracle(x, y, t, q[1], q[2] - q[2] % 1000, q[3] - q[3] % 1000)

    out = {}
    app = WebApp(ds)
    with _Web(app) as web:
        # the 20 queries as CSV: ids and points in the oracle's order
        rows = 0
        for q in qs:
            _, body = web.get(f"/api/data/gdelt?format=csv&cql="
                              f"{_q(_ecql(q[1], q[2], q[3]))}", route="data")
            pos = want_of(q)
            rows += _check_csv(f"data {q[0]}", body, ids[pos], x[pos], y[pos])
        out["data_rows"] = rows
        # BBOX-only on places (z2), the boxes of the places phase
        cx, cy = centres[5]
        bx, by = centres[6]
        for boxes in ([(cx - 3, cy - 3, cx + 3, cy + 3)],
                      [(bx - 1, by - 1, bx + 1, by + 1)],
                      [(cx - 3, cy - 3, cx + 3, cy + 3),
                       (bx - 1, by - 1, bx + 1, by + 1)]):
            _, body = web.get(f"/api/data/places?format=csv&cql="
                              f"{_q(_bbox_ecql(boxes))}", route="data_places")
            pos = box_oracle(px, py, boxes)
            _check_csv("places", body, pids[pos], px[pos], py[pos])
        # the stats routes against numpy
        count = _json.loads(web.get("/api/stats/gdelt/count",
                                    route="stats")[1])["count"]
        qcount = _json.loads(web.get(
            f"/api/stats/gdelt/count?cql={_q(_ecql(*qs[8][1:]))}",
            route="stats")[1])["count"]
        bounds = _json.loads(web.get("/api/stats/gdelt/bounds",
                                     route="stats")[1])["bounds"]
        mm = _json.loads(web.get("/api/stats/gdelt/minmax?attribute=dtg",
                                 route="stats")[1])["bounds"]
        if (count != len(x) or qcount != len(want_of(qs[8]))
                or bounds != {"minx": float(x.min()), "miny": float(y.min()),
                              "maxx": float(x.max()), "maxy": float(y.max())}
                or mm != [int(t.min()), int(t.max())]):
            raise AssertionError(f"web stats: count {count}, {qcount}; "
                                 f"bounds {bounds}; dtg {mm}")
        # 8 tiles at z 2-8 over city centres: grids against the snapped
        # oracle hits, the PNG bodies against the same grid
        tiles = []
        for i in range(8):
            z = 2 + i % 7
            tx, ty = _tile_of(z, *centres[i])
            env = tile_env(z, tx, ty)
            pos = box_oracle(x, y, [env])
            want = snap_counts(x[pos], y[pos], env, 256, 256)
            _, body = web.get(f"/tiles/{z}/{tx}/{ty}?schema=gdelt"
                              f"&format=json", route="tiles")
            doc = _json.loads(body)
            grid = np.asarray(doc["grid"], dtype=np.float64)
            if (doc["z"], doc["x"], doc["y"]) != (z, tx, ty) or \
                    not np.array_equal(grid, want) or \
                    doc["total"] != float(len(pos)):
                raise AssertionError(f"web tile {z}/{tx}/{ty}: "
                                     f"{doc['total']} points, oracle "
                                     f"{len(pos)}")
            headers, png = web.get(f"/tiles/{z}/{tx}/{ty}?schema=gdelt"
                                   f"&format=png", route="tiles_png")
            if headers.get("Content-Type") != "image/png":
                raise AssertionError(f"web tile png: {headers}")
            _png_check(f"tile {z}/{tx}/{ty}", png, want, flip=True)
            tiles.append({"z": z, "x": tx, "y": ty, "points": int(len(pos))})
        out["tiles"] = tiles
        # /query Arrow streams of four queries
        arrow_rows = 0
        for q in (qs[0], qs[8], qs[14], qs[18]):
            headers, blob = web.get(f"/query?schema=gdelt&format=arrow&cql="
                                    f"{_q(_ecql(q[1], q[2], q[3]))}",
                                    route="query_arrow")
            if (headers.get("Content-Type")
                    != "application/vnd.apache.arrow.stream"
                    or "Content-Length" in headers):
                raise AssertionError(f"web /query headers: {headers}")
            table = pa.ipc.open_stream(blob).read_all()
            pos = want_of(q)
            _check_rows(f"web /query {q[0]}", table, ids[pos], x[pos], y[pos],
                        t[pos])
            arrow_rows += table.num_rows
        out["arrow_rows"] = arrow_rows
        # /explain by CQL, and each query's COUNT(*) through ?sql=
        doc = _json.loads(web.get(
            f"/explain?schema=gdelt&cql={_q(_ecql(*qs[0][1:]))}",
            route="explain")[1])
        if (doc["summary"]["strategy"] != "z3"
                or doc["summary"]["actual_matched"] != len(want_of(qs[0]))):
            raise AssertionError(f"web /explain: {doc['summary']}")
        _, text = web.get(f"/explain?schema=gdelt&format=text&cql="
                          f"{_q(_ecql(*qs[0][1:]))}", route="explain")
        if not text.startswith(b"EXPLAIN ANALYZE schema:gdelt"):
            raise AssertionError(f"web /explain text: {text[:120]!r}")
        for q in qs:
            sql = (f"SELECT COUNT(*) FROM gdelt WHERE "
                   f"{_ecql(q[1], q[2], q[3])}")
            doc = _json.loads(web.get(f"/explain?sql={_q(sql)}",
                                      route="explain_sql")[1])
            if doc["target"] != "sql" or \
                    doc["result"].get("value") != len(want_of(q)):
                raise AssertionError(f"web /explain?sql= {q[0]}: "
                                     f"{doc['result']}, oracle "
                                     f"{len(want_of(q))}")
        # the observability routes
        _, prom = web.get("/metrics.prom", route="metrics")
        lines = prom_lines(prom.decode())
        if b"geomesa_query_gdelt_count_total" not in prom:
            raise AssertionError("web /metrics.prom: no gdelt query counter")
        storage = _json.loads(web.get("/debug/storage",
                                      route="debug_storage")[1])
        own = ds.storage_report()
        if storage["totals"]["device_bytes"] != own["totals"]["device_bytes"]:
            raise AssertionError(f"web /debug/storage: "
                                 f"{storage['totals']['device_bytes']} "
                                 f"device bytes, the store "
                                 f"{own['totals']['device_bytes']}")
        heat = _json.loads(web.get("/debug/heat?limit=8", route="debug")[1])
        slo = _json.loads(web.get("/debug/slo", route="debug")[1])
        traces = _json.loads(web.get("/traces?schema=gdelt&limit=5",
                                     route="traces")[1])
        if ("generations" not in heat or "classes" not in slo or not traces
                or any(tr["attributes"].get("schema") != "gdelt"
                       for tr in traces)):
            raise AssertionError("web debug routes: heat, slo or traces")
        out["prom_lines"] = lines
        out["device_bytes"] = storage["totals"]["device_bytes"]
        # a 10,000-feature GeoJSON POST into a new schema, read back by id
        n_post = 10_000
        fx, fy, ft = gdelt_like(rng, n_post, centres)
        fc = {"type": "FeatureCollection", "features": [
            {"type": "Feature", "id": f"p{i}",
             "geometry": {"type": "Point",
                          "coordinates": [float(fx[i]), float(fy[i])]},
             "properties": {"actor": "POSTED", "dtg": int(ft[i])}}
            for i in range(n_post)]}
        status, _, body = web.request(
            "POST", "/api/schemas", _json.dumps(
                {"name": "posted",
                 "spec": "actor:String,dtg:Date,*geom:Point"}).encode(),
            route="post_schema")
        if status != 201:
            raise AssertionError(f"web POST /api/schemas: {status} {body!r}")
        status, _, body = web.request("POST", "/api/data/posted",
                                      _json.dumps(fc).encode(),
                                      route="post_data")
        if status != 200 or _json.loads(body) != {"ingested": n_post,
                                                  "errors": []}:
            raise AssertionError(f"web POST /api/data: {status} {body[:200]!r}")
        pick = np.sort(rng.choice(n_post, 100, replace=False))
        in_ids = ", ".join(f"'p{i}'" for i in pick)
        _, body = web.get(f"/api/data/posted?format=csv&cql="
                          f"{_q(f'IN ({in_ids})')}", route="data_by_id")
        got_ids, gx, gy = _csv_points(body)
        order = np.argsort([int(v[1:]) for v in got_ids])
        if ([got_ids[k] for k in order] != [f"p{i}" for i in pick]
                or not np.array_equal(gx[order], fx[pick])
                or not np.array_equal(gy[order], fy[pick])):
            raise AssertionError(f"web POST read-back: {len(got_ids)} rows")
        if _json.loads(web.get("/api/stats/posted/count",
                               route="stats")[1])["count"] != n_post:
            raise AssertionError("web POST: the count is not 10,000")
        out["times"] = web.summary()

    # 64 concurrent /api/data requests against 8 slots: each answer a 200
    # equal to the oracle or a 503 with Retry-After, never anything else
    burst = qs[:8]
    launches0 = z3_mask.launches
    with _Web(WebApp(ds), max_concurrent=8) as web:
        def one(k):
            q = burst[k % len(burst)]
            status, headers, body = web.request(
                "GET", f"/api/data/gdelt?format=csv&cql="
                       f"{_q(_ecql(q[1], q[2], q[3]))}", route="burst")
            if status == 200:
                pos = want_of(q)
                _check_csv(f"burst {k}", body, ids[pos], x[pos], y[pos])
            elif status != 503 or not headers.get("Retry-After"):
                raise AssertionError(f"web burst {k}: {status} {headers} "
                                     f"{body[:200]!r}")
            return status

        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(64) as pool:
            statuses = list(pool.map(one, range(64)))
        burst_s = time.perf_counter() - t0
        burst_times = web.summary()
    # no gate fell back under the burst (a gate no kernel passed yet reads
    # None; the end of the run requires every one ok)
    health = kernel_health()
    bad = {k: v for k, v in health.items()
           if (k.endswith("_ok") and v is False)
           or (k.endswith("_failures") and v)}
    if bad or admission_gate.inflight != 0:
        raise AssertionError(f"web burst: gates {bad}, admission in flight "
                             f"{admission_gate.inflight}")
    # each answer scanned on the card (the CPU's plain scans count none)
    if (ds.device.type == "cuda"
            and z3_mask.launches - launches0 < statuses.count(200)):
        raise AssertionError(f"web burst: {statuses.count(200)} answers, "
                             f"{z3_mask.launches - launches0} z3 launches")
    out["burst"] = {"ok": statuses.count(200), "shed": statuses.count(503),
                    "s": burst_s, "times": burst_times.get("burst")}
    report["frontend"] = {"facade": out}
    tm = out["times"]
    log(f"frontend (25a): 20 /api/data queries ({rows} rows), places, "
        f"stats, 8 tiles and their PNGs, 4 /query streams ({arrow_rows} "
        f"rows), /explain and 20 COUNT(*) through ?sql=, /metrics.prom "
        f"({lines} lines), /debug/* and /traces, a 10,000-feature POST — "
        f"all equal to the oracle; burst of 64 against 8 slots: "
        f"{out['burst']['ok']} answered, {out['burst']['shed']} shed 503 in "
        f"{burst_s:.2f} s; p50 / max ms: "
        + ", ".join(f"{k} {v['p50_ms']:.1f} / {v['max_ms']:.1f}"
                    for k, v in tm.items()))
    return out


def frontend_other_part(rng, args, centres, qs, ds, dev, report) -> dict:
    """25c: the blob store (``--blob-count`` 1 KB blobs at WKT points,
    100 through ``POST /api/blob`` and the rest through the API) with
    its BBOX query and byte reads over HTTP; a ``GeoJsonIndex`` of
    ``--geojson-docs`` point documents with a nested property and three
    mongo-style queries through ``/geojson/index/{name}/query``; a
    ``MergedDataStoreView`` over the facade's store and a second store of
    ``--view-rows`` rows with scope filters — each against an oracle."""
    import json as _json
    import numpy as np
    from geomesa_tpu_torch import TpuDataStore
    from geomesa_tpu_torch.blob import GeoIndexedBlobStore
    from geomesa_tpu_torch.filters import parse_ecql
    from geomesa_tpu_torch.geojson import GeoJsonIndex
    from geomesa_tpu_torch.geometry.types import Point
    from geomesa_tpu_torch.views import MergedDataStoreView
    from geomesa_tpu_torch.web import WebApp

    out = {}
    n_blob = args.blob_count
    bx, by, bt = gdelt_like(rng, n_blob, centres)
    payloads = [rng.bytes(1024) for _ in range(n_blob)]
    blobs = GeoIndexedBlobStore(TpuDataStore(device=dev))
    n_docs = args.geojson_docs
    gx, gy, _ = gdelt_like(rng, n_docs, centres)
    kind = rng.integers(0, 50, n_docs)
    gj = GeoJsonIndex()
    gj.create_index("events", points=True)
    t0 = time.perf_counter()
    gj.add("events", {"type": "FeatureCollection", "features": [
        {"type": "Feature", "id": f"g{i}",
         "geometry": {"type": "Point",
                      "coordinates": [float(gx[i]), float(gy[i])]},
         "properties": {"meta": {"kind": int(kind[i])}}}
        for i in range(n_docs)]})
    out["geojson_add_s"] = time.perf_counter() - t0
    with _Web(WebApp(TpuDataStore(device=dev), blob=blobs,
                     geojson=gj)) as web:
        bid = {}
        t0 = time.perf_counter()
        for i in range(n_blob):
            if i < 100:
                status, _, body = web.request(
                    "POST", f"/api/blob?wkt={_q(f'POINT ({bx[i]} {by[i]})')}"
                            f"&dtg={int(bt[i])}&filename=b{i}",
                    payloads[i], route="blob_post",
                    ctype="application/octet-stream")
                if status != 201:
                    raise AssertionError(f"web POST /api/blob: {status}")
                bid[_json.loads(body)["id"]] = i
            else:
                bid[blobs.put(payloads[i], geometry=Point(bx[i], by[i]),
                              dtg=int(bt[i]), filename=f"b{i}")] = i
        out["blob_put_s"] = time.perf_counter() - t0
        for c in range(4):
            cx, cy = centres[c]
            box = (cx - 4, cy - 4, cx + 4, cy + 4)
            _, body = web.get(f"/api/blob?cql={_q(_bbox_ecql([box]))}",
                              route="blob_query")
            got = sorted(bid[v] for v in _json.loads(body)["ids"])
            want = box_oracle(bx, by, [box]).tolist()
            if got != want:
                raise AssertionError(f"web blob query {c}: {len(got)} ids, "
                                     f"oracle {len(want)}")
        inv = {i: k for k, i in bid.items()}
        for i in rng.choice(n_blob, 32, replace=False):
            headers, body = web.get(f"/api/blob/{inv[int(i)]}",
                                    route="blob_get")
            if body != payloads[int(i)]:
                raise AssertionError(f"web blob {i}: the bytes differ")
        # three mongo-style queries: spatial, property and both
        cx, cy = centres[0]
        box = [cx - 3, cy - 3, cx + 3, cy + 3]
        inbox = (gx >= box[0]) & (gx <= box[2]) & (gy >= box[1]) & \
            (gy <= box[3])
        for name, q, want in (
                ("spatial", {"geometry": {"$bbox": box}}, inbox),
                ("property", {"$.properties.meta.kind": 7}, kind == 7),
                ("both", {"geometry": {"$bbox": box},
                          "$.properties.meta.kind": {"$lt": 25}},
                 inbox & (kind < 25))):
            _, body = web.get(f"/geojson/index/events/query?q="
                              f"{_q(_json.dumps(q))}", route="geojson")
            got = [f["id"] for f in _json.loads(body)["features"]]
            if got != [f"g{i}" for i in np.flatnonzero(want)]:
                raise AssertionError(f"web geojson {name}: {len(got)} "
                                     f"documents, oracle {int(want.sum())}")
        out["times"] = web.summary()
    del blobs, gj

    # the merged view over the facade's store and a second store
    b = ds._store("gdelt").batch
    x, y = b.geom_xy()
    t = b.column("dtg")
    ds2 = TpuDataStore(device=dev)
    ds2.create_schema("gdelt", "actor:String,dtg:Date,*geom:Point")
    x2, y2, t2 = gdelt_like(rng, args.view_rows, centres)
    ds2.write("gdelt", {"actor": np.full(len(x2), "VIEW", dtype=object),
                        "dtg": t2, "geom": (x2, y2)})
    half = MS_2018 + 181 * DAY
    view = MergedDataStoreView(
        [ds, ds2], filters=[parse_ecql("BBOX(geom, -180, -90, 0, 90)"),
                            parse_ecql(f"dtg DURING {iso(half)}/"
                                       f"{iso(MS_2019 - 1000)}")])
    view_ms = []
    for q in (qs[0], qs[8], qs[14], qs[18]):
        lo, hi = q[2] - q[2] % 1000, q[3] - q[3] % 1000
        a = oracle(x, y, t, q[1], lo, hi)
        a = a[x[a] <= 0.0]
        c = oracle(x2, y2, t2, q[1], lo, hi)
        c = c[(t2[c] >= half) & (t2[c] <= MS_2019 - 1000)]
        t0 = time.perf_counter()
        got = view.query("gdelt", _ecql(q[1], q[2], q[3]))
        view_ms.append((time.perf_counter() - t0) * 1e3)
        vx, vy = got.geom_xy()
        if not (np.array_equal(vx, np.concatenate([x[a], x2[c]]))
                and np.array_equal(vy, np.concatenate([y[a], y2[c]]))):
            raise AssertionError(f"view {q[0]}: {len(got)} rows, oracle "
                                 f"{len(a)} + {len(c)}")
    out["view_ms"] = view_ms
    del ds2, view
    report.setdefault("frontend", {})["other"] = out
    tm = out["times"]
    log(f"frontend (25c): {n_blob} blobs put in {out['blob_put_s']:.2f} s "
        f"(100 through POST), {n_docs} GeoJSON documents added in "
        f"{out['geojson_add_s']:.2f} s, a {args.view_rows}-row second store "
        f"under the merged view — all equal to the oracle; p50 / max ms: "
        + ", ".join(f"{k} {v['p50_ms']:.1f} / {v['max_ms']:.1f}"
                    for k, v in tm.items())
        + f", view {np.median(view_ms):.1f} / {max(view_ms):.1f}")
    return out


def frontend_wcs_part(store, checks, dev, report) -> dict:
    """25b: ``/wcs`` over 24e's raster store: ``GetCapabilities``,
    ``DescribeCoverage`` and ``GetCoverage`` (``npy`` and ``png``) for
    the web tile and the continent, each grid bit for bit equal to the
    store's own ``mosaic`` and to ``mosaic_oracle``."""
    import io
    import numpy as np
    from geomesa_tpu_torch import TpuDataStore
    from geomesa_tpu_torch.web import WebApp

    out = {}
    with _Web(WebApp(TpuDataStore(device=dev), raster=store)) as web:
        _, caps = web.get("/wcs?request=GetCapabilities", route="wcs_caps")
        _, desc = web.get(f"/wcs?request=DescribeCoverage&coverage="
                          f"{store.name}", route="wcs_describe")
        b = store.bounds()
        res = ",".join(str(r) for r in store.available_resolutions)
        if (f"<name>{store.name}</name>".encode() not in caps
                or f"<lonLatEnvelope>{b[0]} {b[1]} {b[2]} {b[3]}"
                   f"</lonLatEnvelope>".encode() not in desc
                or f"<resolutions>{res}</resolutions>".encode() not in desc):
            raise AssertionError(f"web wcs: {caps[:200]!r} {desc[:300]!r}")
        for name, bbox, w, h, r, want in checks:
            box = ",".join(repr(float(v)) for v in bbox)
            path = (f"/wcs?request=GetCoverage&coverage={store.name}&bbox="
                    f"{box}&width={w}&height={h}")
            if r is not None:
                path += f"&resolution={r!r}"
            _, body = web.get(path + "&format=npy", route=f"wcs_{name}")
            grid = np.load(io.BytesIO(body))
            own = store.mosaic(bbox, w, h, resolution=r)
            if grid.dtype != own.dtype or not np.array_equal(
                    grid, own, equal_nan=True):
                raise AssertionError(f"web wcs {name}: the npy grid differs "
                                     f"from the store's mosaic")
            same_mosaic(f"wcs {name}", grid, want)
            headers, png = web.get(path + "&format=png",
                                   route=f"wcs_{name}_png")
            _png_check(f"wcs {name}", png, want, flip=False)
        out["times"] = web.summary()
    report.setdefault("frontend", {})["wcs"] = out
    log("frontend (25b): /wcs GetCapabilities, DescribeCoverage and "
        "GetCoverage (npy bit-equal to the store's mosaic and the oracle, "
        "png) ; p50 / max ms: "
        + ", ".join(f"{k} {v['p50_ms']:.1f} / {v['max_ms']:.1f}"
                    for k, v in out["times"].items()))
    return out


#: 25d's runner: each argv of the JSON list in argv[1] through the CLI's
#: ``main`` in turn, in one process, with the kernels' launch counts set to
#: 0 just before each command and read just after; one JSON list of
#: {stdout, s, launches} on stdout
_CLI_RUNNER = """
import contextlib, io, json, sys, time
from geomesa_tpu_torch.cli.main import main
from geomesa_tpu_torch.ops.density_kernel import density_grid_kernel
from geomesa_tpu_torch.ops.z2_mask import z2_mask
from geomesa_tpu_torch.ops.z3_mask import z3_mask
counters = {"z3_mask": z3_mask, "z2_mask": z2_mask,
            "density_grid": density_grid_kernel}
out = []
for argv in json.loads(sys.argv[1]):
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out.append({"stdout": buf.getvalue(), "s": time.perf_counter() - t0,
                "launches": {k: fn.launches for k, fn in counters.items()}})
json.dump(out, sys.stdout)
"""


def frontend_cli_part(args, kept, qs, dev, report) -> dict:
    """25d: the command line in two processes, each calling the CLI's
    ``main`` (``--device <card>``) once a command: the first runs
    ``create-schema`` and an ``ingest`` of two of phase 23's GDELT files
    into a fresh catalog; the second opens that catalog for
    ``stats-count``, a ``sql`` ``COUNT(*)`` of a region query, an
    ``export`` of a continent month as CSV and ``explain`` — each
    against the generator's rows.  Each command's launch counts, read in
    its process, come back under ``launches``."""
    import numpy as np

    ids, x, y, t = kept["good"]
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    out = {}
    try:
        conv = os.path.join(root, "gdelt.json")
        with open(conv, "w") as f:
            json.dump(INGEST_CONFIG, f)
        cat = os.path.join(root, "catalog")

        def cli(calls):
            argvs = [["--device", str(dev), *a] for a in calls.values()]
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-c", _CLI_RUNNER, json.dumps(argvs)],
                capture_output=True, text=True, timeout=900, cwd=here)
            s = time.perf_counter() - t0
            if res.returncode != 0:
                raise AssertionError(f"cli {list(calls)}: exit "
                                     f"{res.returncode}: {res.stderr[-2000:]}")
            last = res.stdout.strip().splitlines()[-1]
            return dict(zip(calls, json.loads(last))), s

        wrote, s_write = cli({
            "create-schema": ("create-schema", "-c", cat, "-f", "gdelt",
                              "-s", INGEST_SPEC),
            "ingest": ("ingest", "-c", cat, "-f", "gdelt", "-C", conv,
                       *kept["paths"])})
        std = wrote["ingest"]["stdout"]
        if std.strip() != (f"ingested {len(ids)} features "
                           f"({kept['failed']} failed)"):
            raise AssertionError(f"cli ingest: {std.strip()!r}, the generator "
                                 f"made {len(ids)} good and "
                                 f"{kept['failed']} bad rows")
        region = next(q for q in qs if q[0] == "region")
        # the continent month with the most rows: the export's query
        wide = max((q for q in qs if q[0] == "continent"),
                   key=lambda q: len(oracle(x, y, t, q[1], q[2], q[3])))
        done, queries_s = cli({
            "stats-count": ("stats-count", "-c", cat, "-f", "gdelt"),
            "sql": ("sql", "-c", cat, "SELECT COUNT(*) FROM gdelt WHERE "
                    + _ecql(region[1], region[2], region[3])),
            "export": ("export", "-c", cat, "-f", "gdelt", "-F", "csv",
                       "-q", _ecql(wide[1], wide[2], wide[3])),
            "explain": ("explain", "-c", cat, "-f", "gdelt", "-q",
                        _ecql(wide[1], wide[2], wide[3]))})
        want_r = oracle(x, y, t, region[1], region[2] - region[2] % 1000,
                        region[3] - region[3] % 1000)
        want_c = oracle(x, y, t, wide[1], wide[2] - wide[2] % 1000,
                        wide[3] - wide[3] % 1000)
        text = {k: v["stdout"] for k, v in done.items()}
        got_ids, gx, gy = _csv_points(text["export"].encode())
        if (text["stats-count"].strip() != str(len(ids))
                or text["sql"].strip() != str(len(want_r))
                or not np.array_equal(np.array(got_ids).astype(np.int64),
                                      ids[want_c])
                or not np.array_equal(gx, x[want_c])
                or "chosen: z3" not in text["explain"]):
            raise AssertionError(
                f"cli: count {text['stats-count'].strip()} "
                f"({len(ids)}), sql {text['sql'].strip()} "
                f"({len(want_r)}), export {len(got_ids)} rows "
                f"({len(want_c)}), explain {text['explain'][:200]!r}")
        out = {"rows": int(len(ids)), "write_s": s_write,
               "create_s": wrote["create-schema"]["s"],
               "ingest_s": wrote["ingest"]["s"],
               "rows_per_s": len(ids) / wrote["ingest"]["s"],
               "queries_s": queries_s,
               "query_s": {k: v["s"] for k, v in done.items()},
               "launches": {k: v["launches"] for d in (wrote, done)
                            for k, v in d.items()},
               "export_rows": len(got_ids), "sql_count": int(len(want_r))}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report.setdefault("frontend", {})["cli"] = out
    log(f"frontend (25d): CLI writer process {out['write_s']:.1f} s "
        f"(create-schema {out['create_s']:.1f} s, ingest of {out['rows']} "
        f"rows from 2 files {out['ingest_s']:.1f} s, "
        f"{out['rows_per_s']:.4g} rows/s); reader process "
        f"{out['queries_s']:.1f} s for stats-count, sql ({out['sql_count']}), "
        f"export ({out['export_rows']} rows) and explain ("
        + ", ".join(f"{k} {v:.1f}" for k, v in out["query_s"].items())
        + " s) — all equal to the generator's rows; launches "
        f"{out['launches']}")
    return out


def stream_plan(rng, centres, n_msgs: int, n_ids: int, rounds: int = 4):
    """26a's AIS-like message plan: per round ``(flushed, transient)``
    lists of ``(fid, x, y, dtg, sog)``.  ``flushed`` holds positions of
    ids seen in earlier rounds (drawn with replacement: a vessel may
    report twice in a round) and of new ids, and is persisted in its
    round; ``transient`` holds ids never seen before, left in the stream
    layer when the round's merged reads run.  The first round draws 40%
    of the ids (three quarters flushed), each later round 20% (half
    flushed), so ``n_ids`` ids take ``n_msgs`` messages in all."""
    import numpy as np
    first_new, first_fresh = int(0.3 * n_ids), int(0.1 * n_ids)
    later = (n_ids - first_new - first_fresh) // (rounds - 1)
    new_n, fresh_n = later // 2, later - later // 2
    again_n = ((n_msgs - first_new - first_fresh) // (rounds - 1)
               - new_n - fresh_n)
    if again_n < 0:
        raise ValueError(f"{n_msgs} messages cannot reach {n_ids} ids")
    ids = rng.permutation(n_ids)
    used = 0
    plan = []
    for r in range(rounds):
        n_new, n_fresh = ((first_new, first_fresh) if r == 0
                          else (new_n, fresh_n))
        new = ids[used:used + n_new]
        fresh = ids[used + n_new:used + n_new + n_fresh]
        again = (rng.choice(ids[:used], again_n) if r else
                 np.empty(0, np.int64))
        used += n_new + n_fresh
        parts = []
        for sel in (np.concatenate([again, new]), fresh):
            x, y, _ = gdelt_like(rng, len(sel), centres)
            # a month of positions: the merged reads' windows cut it
            t = MS_2018 + rng.integers(0, 30 * DAY, len(sel))
            sog = np.round(rng.uniform(0.0, 25.0, len(sel)), 2)
            parts.append([(f"v{int(i)}", float(a), float(b), int(c),
                           float(s))
                          for i, a, b, c, s in zip(sel, x, y, t, sog)])
        plan.append(tuple(parts))
    return plan


def lambda_part(rng, args, centres, dev, report, lean: bool) -> dict:
    """26a: a ``LambdaDataStore`` over a ``TpuDataStore`` on the card that
    already holds ``history`` persisted rows (``--stream-history-rows``
    on the lean profile, ``--stream-default-rows`` on the default one),
    a ``StreamDataStore`` of 4 partitions, and 4 rounds of
    :func:`stream_plan`'s ``--stream-messages`` messages over
    ``--stream-vessels`` vessel ids: ``write``, ``consume`` until drained,
    the clock stepped past the expiry, ``persist``, the round's
    transient writes, then ``--stream-queries`` merged BBOX+DURING
    ``query`` calls and one ``count``, each against a numpy oracle of the
    history rows and each vessel's latest position (no id twice, every
    position exact).  Persisted upserts leave no duplicates: the store
    holds the history plus one row per persisted vessel."""
    import numpy as np
    from geomesa_tpu_torch import TpuDataStore
    from geomesa_tpu_torch.lambda_store import LambdaDataStore
    from geomesa_tpu_torch.stream import InProcessBroker, StreamDataStore

    kind = "lean" if lean else "default"
    name = "ais"
    spec = "vessel:String,sog:Double,dtg:Date,*geom:Point"
    n_hist = args.stream_history_rows if lean else args.stream_default_rows
    ds = TpuDataStore(device=dev)
    ds.create_schema(name, spec + (
        ";geomesa.index.profile=lean,"
        f"geomesa.lean.generation.slots={args.stream_slots}"
        if lean else ""))
    hx, hy, _ = gdelt_like(rng, n_hist, centres)
    ht = MS_2018 + rng.integers(0, 30 * DAY, n_hist)
    pool = np.array([f"h{k}" for k in range(1000)], dtype=object)
    t0 = time.perf_counter()
    for lo in range(0, n_hist, 1 << 21):
        sl = slice(lo, min(n_hist, lo + (1 << 21)))
        ds.write(name, {"vessel": pool[np.arange(sl.start, sl.stop) % 1000],
                        "sog": np.zeros(sl.stop - sl.start),
                        "dtg": ht[sl], "geom": (hx[sl], hy[sl])})
    history_s = time.perf_counter() - t0
    # the history rows' ids: implicit row ids (the store's prefix and the
    # row) on the lean profile, the first write's auto ids on the default
    hist_ids = ds._store(name).batch.id_prefix if lean else ""
    if not lean:
        first = [str(i) for i in ds.query(name, "IN ('0', '1')").ids]
        if first != ["0", "1"]:
            raise AssertionError(f"26a ({kind}): history ids {first}")
    clk = [1_000_000.0]
    expiry_ms = 60_000
    lam = LambdaDataStore(ds, StreamDataStore(InProcessBroker(4)),
                          expiry_ms=expiry_ms, clock=lambda: clk[0])
    lam.stream.create_schema(name, spec)
    plan = stream_plan(np.random.default_rng(args.seed + 26), centres,
                       args.stream_messages, args.stream_vessels)
    latest: dict = {}

    def write(batch) -> float:
        t0 = time.perf_counter()
        for fid, x, y, t, s in batch:
            lam.write(name, fid, {"vessel": fid, "sog": s, "dtg": t,
                                  "geom": (x, y)})
            latest[fid] = (x, y, t)
        return time.perf_counter() - t0

    def drain() -> tuple:
        t0 = time.perf_counter()
        n = 0
        while True:
            got = lam.stream.consume(name, max_records=50_000)
            if not got:
                return n, time.perf_counter() - t0
            n += got

    def key(i: str, back: dict):
        if i in latest:
            return i
        if i in back:
            return back[i]
        k = int(i[len(hist_ids):])
        if not 0 <= k < n_hist:
            raise AssertionError(f"26a ({kind}): unknown id {i!r}")
        return k

    rounds = []
    query_ms = []
    qrng = np.random.default_rng(args.seed + 2026)
    for r, (flushed, transient) in enumerate(plan):
        rec = {"messages": len(flushed) + len(transient)}
        rec["write_s"] = write(flushed)
        n, rec["consume_s"] = drain()
        if n != len(flushed):
            raise AssertionError(f"26a ({kind}) round {r}: consumed {n} of "
                                 f"{len(flushed)}")
        clk[0] += (expiry_ms + 1000) / 1000.0
        expect = len(lam.stream.cache(name))
        t0 = time.perf_counter()
        got = lam.persist(name)
        rec["persist_ms"] = (time.perf_counter() - t0) * 1e3
        if got != expect or len(lam.stream.cache(name)):
            raise AssertionError(f"26a ({kind}) round {r}: persisted {got} "
                                 f"of {expect}")
        # the stream layer is empty now: every vessel so far is persisted
        n_persisted = len(latest)
        rec["persisted"] = got
        rec["write_s"] += write(transient)
        n, s = drain()
        rec["consume_s"] += s
        stored = ds.get_count(name)
        if stored != n_hist + n_persisted:
            raise AssertionError(f"26a ({kind}) round {r}: the store holds "
                                 f"{stored} rows, expected {n_hist} + "
                                 f"{n_persisted} (a duplicate)")
        back = ({v: k[1] for k, v in lam._persisted_row.items()}
                if lean else {})
        fx = np.array([v[0] for v in latest.values()])
        fy = np.array([v[1] for v in latest.values()])
        ft = np.array([v[2] for v in latest.values()], dtype=np.int64)
        fids = list(latest)
        hits = []
        for _ in range(args.stream_queries):
            cx, cy = centres[int(qrng.integers(0, len(centres)))]
            box = (float(cx) - 3.0, float(cy) - 3.0, float(cx) + 3.0,
                   float(cy) + 3.0)
            d0 = int(qrng.integers(0, 20))
            lo, hi = MS_2018 + d0 * DAY, MS_2018 + (d0 + 10) * DAY - 1
            t0 = time.perf_counter()
            out = lam.query(name, f"{_ecql([box], lo, hi)}")
            query_ms.append((time.perf_counter() - t0) * 1e3)
            keys = [key(str(i), back) for i in out.ids]
            if len(set(keys)) != len(keys):
                raise AssertionError(f"26a ({kind}) round {r}: an id twice")
            want_h = oracle(hx, hy, ht, [box], lo, hi)
            want_v = [fids[i] for i in oracle(fx, fy, ft, [box], lo, hi)]
            got_h = sorted(k for k in keys if isinstance(k, int))
            got_v = sorted(k for k in keys if isinstance(k, str))
            if got_h != want_h.tolist() or got_v != sorted(want_v):
                raise AssertionError(
                    f"26a ({kind}) round {r}: {len(got_h)} history and "
                    f"{len(got_v)} vessel hits, oracle {len(want_h)} and "
                    f"{len(want_v)}")
            xs, ys = out.geom_xy()
            for k, x, y in zip(keys, xs, ys):
                want = ((hx[k], hy[k]) if isinstance(k, int)
                        else latest[k][:2])
                if (x, y) != want:
                    raise AssertionError(f"26a ({kind}) round {r}: {k} at "
                                         f"{(x, y)}, latest {want}")
            hits.append(len(keys))
        t0 = time.perf_counter()
        count = lam.count(name)
        rec["count_ms"] = (time.perf_counter() - t0) * 1e3
        if count != n_hist + len(latest):
            raise AssertionError(f"26a ({kind}) round {r}: count {count}, "
                                 f"oracle {n_hist + len(latest)}")
        rec["hits"] = hits
        rounds.append(rec)
        log(f"26a ({kind}) round {r}: {rec['messages']} messages, write "
            f"{rec['write_s']:.2f} s, consume {rec['consume_s']:.2f} s, "
            f"persist {got} in {rec['persist_ms']:.1f} ms, count {count} "
            f"in {rec['count_ms']:.1f} ms, hits {hits}")
    out = {"history_rows": n_hist, "history_write_s": history_s,
           "vessels": len(latest), "messages": args.stream_messages,
           "rounds": rounds, "query_ms": query_ms,
           "query_p50_ms": _p50(query_ms), "query_max_ms": max(query_ms),
           "persist_ms": [r["persist_ms"] for r in rounds]}
    log(f"26a ({kind}): {n_hist} history rows, {len(latest)} vessels, "
        f"persist ms {[round(v, 1) for v in out['persist_ms']]}, merged "
        f"query p50 {out['query_p50_ms']:.2f} ms, max "
        f"{out['query_max_ms']:.2f} ms over {len(query_ms)}")
    report.setdefault("stream", {})[f"lambda_{kind}"] = out
    return {"store": ds, "name": name, "queries": len(query_ms)}


def native_part(rng, args, centres, dev, report) -> dict:
    """26b: a point ``NativeIndex`` on the card: ``--native-inserts``
    single-value inserts with explicit fids, a tenth as many updates and
    a twentieth as many deletes, then ``--native-queries`` ``within`` +
    ``during`` queries, each equal as a set to a numpy oracle over the
    live values; and a ``points=False`` index of ``--native-polys``
    rectangles answering ``--native-poly-queries`` ``within`` queries
    through the XZ indexes, each equal to the rectangles' oracle."""
    import numpy as np
    from geomesa_tpu_torch.geometry.types import Point, Polygon
    from geomesa_tpu_torch.datastore import TpuDataStore
    from geomesa_tpu_torch.native_api import NativeIndex, NativeQuery

    n = args.native_inserts
    x, y, t = gdelt_like(rng, n, centres)
    idx = NativeIndex("native", store=TpuDataStore(device=dev))
    t0 = time.perf_counter()
    for i in range(n):
        idx.insert(i, Point(float(x[i]), float(y[i])), int(t[i]),
                   fid=f"n{i}")
    insert_s = time.perf_counter() - t0
    live = {i: (x[i], y[i], t[i]) for i in range(n)}
    upd = rng.choice(n, n // 10, replace=False)
    ux, uy, ut = gdelt_like(rng, len(upd), centres)
    t0 = time.perf_counter()
    for j, i in enumerate(upd):
        idx.update(f"n{i}", n + int(i), Point(float(ux[j]), float(uy[j])),
                   int(ut[j]))
        live.pop(int(i))
        live[n + int(i)] = (ux[j], uy[j], ut[j])
    update_s = time.perf_counter() - t0
    dele = rng.choice(np.setdiff1d(np.arange(n), upd), n // 20,
                      replace=False)
    t0 = time.perf_counter()
    for i in dele:
        idx.delete(f"n{i}")
        live.pop(int(i))
    delete_s = time.perf_counter() - t0
    vals = np.array(list(live))
    lx = np.array([live[v][0] for v in vals])
    ly = np.array([live[v][1] for v in vals])
    lt = np.array([live[v][2] for v in vals], dtype=np.int64)
    query_ms, hits = [], []
    for q in range(args.native_queries):
        cx, cy = centres[q % len(centres)]
        box = (float(cx) - 8.0, float(cy) - 8.0, float(cx) + 8.0,
               float(cy) + 8.0)
        d0 = int(rng.integers(0, 300))
        lo, hi = MS_2018 + d0 * DAY, MS_2018 + (d0 + 60) * DAY
        t0 = time.perf_counter()
        got = idx.query(NativeQuery().within(*box).during(lo, hi))
        query_ms.append((time.perf_counter() - t0) * 1e3)
        want = vals[oracle(lx, ly, lt, [box], lo, hi)]
        if sorted(got) != sorted(want.tolist()):
            raise AssertionError(f"26b query {q}: {len(got)} values, "
                                 f"oracle {len(want)}")
        hits.append(len(got))
    if sum(hits) == 0:
        raise AssertionError("26b: every query came back empty")
    bb, _, pt = footprints(rng, args.native_polys)
    pidx = NativeIndex("native_polys", points=False,
                       store=TpuDataStore(device=dev))
    t0 = time.perf_counter()
    for i, (a, b, c, d) in enumerate(bb):
        pidx.insert(i, Polygon([(a, b), (c, b), (c, d), (a, d), (a, b)]),
                    int(pt[i]), fid=f"p{i}")
    poly_insert_s = time.perf_counter() - t0
    poly_hits = []
    for q in range(args.native_poly_queries):
        hx, hy = POLY_HOTSPOTS[q % len(POLY_HOTSPOTS)]
        box = (hx - 20.0 + q, hy - 15.0, hx + 5.0 + q, hy + 10.0)
        got = pidx.query(NativeQuery().within(*box))
        want = rect_box(bb, box).tolist()
        if sorted(got) != want:
            raise AssertionError(f"26b polygon query {q}: {len(got)} "
                                 f"values, oracle {len(want)}")
        poly_hits.append(len(got))
    if sum(poly_hits) == 0:
        raise AssertionError("26b: every polygon query came back empty")
    strategy = pidx.store.query_result(
        "native_polys", NativeQuery().within(0, 0, 1, 1).to_filter()
    ).strategy.index
    if strategy != "xz2":
        raise AssertionError(f"26b: the polygon index planned {strategy}")
    out = {"inserts": n, "insert_ms_each": insert_s / n * 1e3,
           "updates": len(upd), "update_ms_each": update_s / len(upd) * 1e3,
           "deletes": len(dele),
           "delete_ms_each": delete_s / len(dele) * 1e3,
           "live": len(live), "query_ms": query_ms,
           "query_p50_ms": _p50(query_ms), "hits": hits,
           "polys": len(bb), "poly_insert_ms_each":
           poly_insert_s / len(bb) * 1e3, "poly_hits": poly_hits}
    log(f"26b: {n} inserts at {out['insert_ms_each']:.3f} ms, "
        f"{len(upd)} updates at {out['update_ms_each']:.3f} ms, "
        f"{len(dele)} deletes at {out['delete_ms_each']:.3f} ms; "
        f"{len(hits)} queries p50 {out['query_p50_ms']:.2f} ms, hits "
        f"{sum(hits)}; {len(bb)} polygons at "
        f"{out['poly_insert_ms_each']:.3f} ms, {len(poly_hits)} queries, "
        f"hits {sum(poly_hits)}")
    report.setdefault("stream", {})["native"] = out
    return out


def profiling_part(ds, name: str, report) -> dict:
    """26c: one BBOX+DURING query of a facade store under
    ``torch.profiler`` with CUDA activity: the trace holds the planner's
    ``query.plan`` and ``query.scan`` ranges, the plan before the scan,
    and a ``z3_mask`` kernel inside the scan's interval."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    q = ("BBOX(geom,-180,-90,180,90) AND dtg DURING "
         "2018-01-05T00:00:00Z/2018-01-12T00:00:00Z")
    ds.query_result(name, q)                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = ds.query_result(name, q)
        torch.cuda.synchronize()
    if res.strategy.index != "z3" or not len(res.positions):
        raise AssertionError(f"26c: {res.strategy.index} with "
                             f"{len(res.positions)} hits")
    ev = prof.events()
    # the host ranges (the device timeline repeats each as a GPU
    # annotation)
    ranges = {}
    for e in ev:
        if (e.name in ("query.plan", "query.scan")
                and e.device_type == torch.autograd.DeviceType.CPU):
            ranges.setdefault(e.name, e)
    if set(ranges) != {"query.plan", "query.scan"}:
        raise AssertionError(f"26c: the trace holds {sorted(ranges)}")
    plan, scan = ranges["query.plan"].time_range, \
        ranges["query.scan"].time_range
    if plan.end > scan.start:
        raise AssertionError("26c: query.plan does not end before "
                             "query.scan")
    kernels = [e for e in ev if "z3_mask" in e.name
               and e.device_type == torch.autograd.DeviceType.CUDA]
    inside = [e for e in kernels if scan.start <= e.time_range.start
              and e.time_range.end <= scan.end]
    if not inside:
        raise AssertionError(f"26c: {len(kernels)} z3_mask kernels, none "
                             f"inside query.scan [{scan.start}, "
                             f"{scan.end}] us")
    out = {"plan_us": plan.end - plan.start,
           "scan_us": scan.end - scan.start,
           "z3_mask_kernels": len(kernels), "inside_scan": len(inside),
           "kernel_us": sum(e.time_range.end - e.time_range.start
                            for e in inside)}
    log(f"26c: query.plan {out['plan_us']:.0f} us, query.scan "
        f"{out['scan_us']:.0f} us holding {len(inside)} z3_mask kernels "
        f"({out['kernel_us']:.0f} us)")
    report.setdefault("stream", {})["profile"] = out
    return out


def stream_phase(args, centres, dev, report, counters, phase_s,
                 smi) -> dict:
    """Phase 26: the lambda store over a lean and a default-profile
    store, the native API and a profiler capture, each part with its own
    counts (set to 0 just before, read just after).  The lean store's
    scans run no kernel (the JAX lean programs reach no Pallas kernel);
    the default profile's merged reads, the native queries and the
    capture's query launch z3_mask.  Draws from a generator of its own.
    Returns each part's launches."""
    import numpy as np
    import torch

    rng26 = np.random.default_rng(args.seed + 26)
    stream_launches = {}
    lam26 = None
    for part in ("lambda_lean", "lambda_default", "native", "profile"):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        if part == "lambda_lean":
            lambda_part(rng26, args, centres, dev, report, lean=True)
            gc.collect()
            torch.cuda.empty_cache()
        elif part == "lambda_default":
            lam26 = lambda_part(rng26, args, centres, dev, report,
                                lean=False)
        elif part == "native":
            native_part(rng26, args, centres, dev, report)
        else:
            profiling_part(lam26["store"], lam26["name"], report)
        phase_s[f"stream_{part}"] = time.perf_counter() - t0
        stream_launches[part] = {k: fn.launches for k, fn in counters.items()}
        log(f"26 ({part}) path: launches {stream_launches[part]}, "
            f"{phase_s[f'stream_{part}']:.1f} s")
    # at least one z3_mask launch per merged read, per native query and
    # in the capture
    need = {"lambda_default": len(
                report["stream"]["lambda_default"]["query_ms"]),
            "native": args.native_queries, "profile": 1}
    for part, least in need.items():
        if stream_launches[part]["z3_mask"] < least:
            raise AssertionError(f"26 ({part}): {stream_launches[part]} "
                                 f"launches, fewer than {least} z3_mask")
    report["stream_path_launches"] = stream_launches
    log("phase 26: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in phase_s.items()
        if k.startswith("stream_")) + f"; total "
        f"{sum(v for k, v in phase_s.items() if k.startswith('stream_')):.1f}"
        f" s; card: {smi}")
    return stream_launches


def lint_phase(report, timeout: float = 120.0) -> dict:
    """Phase 27a: the port's gm-lint over its own tree as a user runs it,
    ``python -m geomesa_tpu_torch.analysis --fail-on-new`` (JSON out), in
    a subprocess with a timeout.  A new finding, a stale baseline entry
    or a non-zero exit fails the run.  Returns the analyzer's JSON (its
    findings and the baselined ones, each with file and line)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "geomesa_tpu_torch.analysis", "--fail-on-new",
         "--format", "json"],
        capture_output=True, text=True, timeout=timeout, cwd=here)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"gm-lint exited {proc.returncode}: "
                             f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout)
    if out["findings"] or out["stale_baseline"]:
        raise AssertionError(f"gm-lint: new findings {out['findings']}, "
                             f"stale entries {out['stale_baseline']}")
    rep = {"findings": len(out["findings"]),
           "baselined": len(out["baselined"]),
           "analyzer_s": out["elapsed_s"], "wall_s": wall}
    report["lint"] = rep
    log(f"27a gm-lint: {rep['findings']} new finding(s), "
        f"{rep['baselined']} baselined, analyzer {rep['analyzer_s']:.2f} s, "
        f"{wall:.2f} s with the interpreter")
    return out


def _sync_verdict(rel: str, line: int, fn: str, lint: dict) -> str:
    """What 27a's static check says of one synchronizing site: it flags
    it, baselines it (on its line, or in its function), or misses it."""
    for key, word in (("findings", "flags"), ("baselined", "baselines")):
        for f in lint[key]:
            if f["file"] != rel or f["check"] != "host-sync":
                continue
            if f["line"] == line:
                return word
            if f"(in `{fn}`)" in f["message"]:
                return f"{word} (its function, line {f['line']})"
    from geomesa_tpu_torch.analysis.walker import HOT_PATH_PARTS
    if rel.split("/")[0] not in HOT_PATH_PARTS:
        return "misses (outside the hot-path directories)"
    return "misses"


def sync_reading(qs, ds, lint, report, n_queries: int = 4) -> None:
    """Phase 27b, a reading and not a gate: ``n_queries`` of the index
    phase's queries (every fifth) as BBOX+DURING ECQL on the facade's
    ``gdelt`` store, each under the tracer, with
    ``torch.cuda.set_sync_debug_mode("warn")``.  Each synchronizing call
    torch reports counts inside an open device span (the recording span,
    ``obs.trace.current_span``, is a ``device_span``) or outside it;
    an outside call is attributed to the innermost frame in the port's
    package, and each such site is printed with what 27a's static
    host-sync check says of it (:func:`_sync_verdict`)."""
    import warnings

    import torch
    from geomesa_tpu_torch.obs import tracer
    from geomesa_tpu_torch.obs.trace import current_span

    port = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "geomesa_tpu_torch") + os.sep
    picked = qs[::5][:n_queries]
    qsql = [_ecql(boxes, lo, hi) for _, boxes, lo, hi in picked]
    counts = {"inside": 0, "outside": 0}
    sites: dict = {}
    hits = []

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def hook(message, category, filename, lineno, file=None, line=None):
            if "synchronizing CUDA operation" not in str(message):
                return shown(message, category, filename, lineno, file, line)
            sp = current_span()
            if sp is not None and sp.attributes.get("kind") == "device":
                counts["inside"] += 1
                return None
            counts["outside"] += 1
            frame = sys._getframe(1)
            while frame is not None \
                    and not frame.f_code.co_filename.startswith(port):
                frame = frame.f_back
            key = (("<outside the package>", 0, "")
                   if frame is None else
                   (frame.f_code.co_filename[len(port):].replace(os.sep, "/"),
                    frame.f_lineno, frame.f_code.co_name))
            sites[key] = sites.get(key, 0) + 1
            return None

        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for q in qsql:
                with tracer.capture():
                    hits.append(int(len(ds.query_result("gdelt",
                                                        q).positions)))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    rows = [{"site": f"{rel}:{line}", "function": fn, "count": n,
             "verdict": _sync_verdict(rel, line, fn, lint)}
            for (rel, line, fn), n in sorted(sites.items())]
    report["sync"] = {"queries": len(qsql), "hits": hits, **counts,
                      "outside_sites": rows}
    log(f"27b sync reading: {len(qsql)} queries ({sum(hits)} hits), "
        f"{counts['inside']} synchronizing call(s) inside a device span, "
        f"{counts['outside']} outside at {len(rows)} site(s)")
    for r in rows:
        log(f"27b   outside {r['site']} ({r['function']}) x{r['count']}: "
            f"the static check {r['verdict']}")


def kernel_entry(name: str, replaces: str, launches: int, rows: list,
                 row: dict) -> dict:
    """One kernel's entry of the ``{"kernels": [...]}`` line."""
    return {"name": name, "route": "cuda",
            "source": f"geomesa_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--points", type=int, default=100_000_000)
    ap.add_argument("--facade-rows", type=int, default=16_000_000)
    ap.add_argument("--places-rows", type=int, default=4_000_000)
    ap.add_argument("--mesh-rows", type=int, default=16_000_000)
    ap.add_argument("--lean-rows", type=int, default=48_000_000,
                    help="rows of the lean phase: a first write of the "
                         "lean switch's 32M rows, then the rest in 3")
    ap.add_argument("--lean-slots", type=int, default=1 << 23,
                    help="slots per generation of the lean and lean "
                         "polygon phases")
    ap.add_argument("--attr-rows", type=int, default=8_000_000,
                    help="rows of the default-profile attribute phase")
    ap.add_argument("--attr-mesh-rows", type=int, default=4_000_000,
                    help="rows of the mesh attribute phase")
    ap.add_argument("--lean-attr-rows", type=int, default=32_000_000,
                    help="rows of the lean attribute phase")
    ap.add_argument("--lean-attr-slots", type=int, default=1 << 22,
                    help="slots per generation of the lean attribute phase "
                         "(8 generations at the default rows)")
    ap.add_argument("--mesh-lean-rows", type=int, default=32_000_000,
                    help="rows of the mesh lean phase")
    ap.add_argument("--mesh-lean-slots", type=int, default=1 << 22,
                    help="per-shard slots per generation of the mesh lean "
                         "phase (8 generations at the default rows)")
    ap.add_argument("--poly-rows", type=int, default=6_000_000,
                    help="rows of the default-profile polygon phase")
    ap.add_argument("--poly-mesh-rows", type=int, default=6_000_000,
                    help="rows of the mesh polygon phase")
    ap.add_argument("--lean-poly-rows", type=int, default=16_000_000,
                    help="rows of the lean XZ2 polygon phase")
    ap.add_argument("--lean-poly3-rows", type=int, default=8_000_000,
                    help="rows of the lean XZ3 polygon phase")
    ap.add_argument("--lean-poly3-slots", type=int, default=1 << 20,
                    help="slots per generation of the lean XZ3 phase (8 "
                         "generations at 8M rows: device and host tiers, "
                         "and a compaction that merges host runs)")
    ap.add_argument("--mesh-lean-poly-rows", type=int, default=8_000_000,
                    help="rows of the mesh lean XZ2 polygon phase")
    ap.add_argument("--mesh-lean-poly3-rows", type=int, default=8_000_000,
                    help="rows of the mesh lean XZ3 polygon phase")
    ap.add_argument("--mesh-lean-poly-slots", type=int, default=1 << 21,
                    help="per-shard slots per generation of the mesh lean "
                         "polygon phases")
    ap.add_argument("--res-rows", type=int, default=8_000_000,
                    help="rows of the resilience phase's lean store")
    ap.add_argument("--res-slots", type=int, default=1 << 20,
                    help="slots per generation of the resilience phase")
    ap.add_argument("--life-rows", type=int, default=4_000_000,
                    help="rows of the lifecycle and legacy phases")
    ap.add_argument("--life-mesh-rows", type=int, default=4_000_000,
                    help="rows of the mesh lifecycle phase")
    ap.add_argument("--fsds-rows", type=int, default=1_000_000,
                    help="rows of the FileSystemDataStore phase")
    ap.add_argument("--ingest-files", type=int, default=8,
                    help="GDELT event files of the ingest phase")
    ap.add_argument("--ingest-rows", type=int, default=250_000,
                    help="rows of each ingest file (0.1%% of them bad)")
    ap.add_argument("--vessel-rows", type=int, default=2_000_000,
                    help="rows of phase 24a's vessels schema (a heading a "
                         "row), which the route search reads")
    ap.add_argument("--blob-count", type=int, default=10_000,
                    help="1 KB blobs of the front-end phase's blob store")
    ap.add_argument("--geojson-docs", type=int, default=200_000,
                    help="point documents of the front-end phase's GeoJSON "
                         "index")
    ap.add_argument("--view-rows", type=int, default=1_000_000,
                    help="rows of the second store under the merged view")
    ap.add_argument("--raster-lat-tiles", type=int, default=90,
                    help="rows of 180 two-degree tiles of phase 24e's "
                         "raster store, from the north (90: the whole "
                         "GTOPO30 grid; 45: the northern hemisphere)")
    ap.add_argument("--mh-rows", type=int, default=8_000_000,
                    help="rows per worker of the multihost phase's default "
                         "profile (worker 1 writes 1%% more)")
    ap.add_argument("--mh-lean-rows", type=int, default=16_000_000,
                    help="rows per worker of the multihost phase's lean "
                         "profile (worker 1 writes 1%% more)")
    ap.add_argument("--mh-lean-slots", type=int, default=1 << 22,
                    help="per-shard slots per generation of the multihost "
                         "lean profile")
    ap.add_argument("--mh-timeout", type=float, default=400.0,
                    help="seconds the multihost phase waits for its two "
                         "workers before it kills them and fails")
    ap.add_argument("--mh-dev", default="cuda", choices=("cuda", "cpu"),
                    help="device of the multihost workers (cpu: a "
                         "rehearsal of the phase without a card)")
    ap.add_argument("--mh-worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mh-port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--mh-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--stream-history-rows", type=int, default=4_000_000,
                    help="persisted history rows of 26a's lean store")
    ap.add_argument("--stream-default-rows", type=int, default=1_000_000,
                    help="persisted history rows of 26a's default-profile "
                         "store")
    ap.add_argument("--stream-slots", type=int, default=1 << 20,
                    help="slots per generation of 26a's lean store")
    ap.add_argument("--stream-messages", type=int, default=250_000,
                    help="position messages of 26a, over 4 rounds")
    ap.add_argument("--stream-vessels", type=int, default=100_000,
                    help="vessel ids of 26a (a global AIS feed's live "
                         "vessels)")
    ap.add_argument("--stream-queries", type=int, default=3,
                    help="merged BBOX+DURING reads of 26a after each round")
    ap.add_argument("--native-inserts", type=int, default=10_000,
                    help="single-value inserts of 26b's point index")
    ap.add_argument("--native-queries", type=int, default=50)
    ap.add_argument("--native-polys", type=int, default=1_000)
    ap.add_argument("--native-poly-queries", type=int, default=10)
    ap.add_argument("--profile", action="store_true",
                    help="profile the z3 and z2 index queries, the mesh "
                         "phase's stats, query and heatmap, and the lean "
                         "queries once more (torch.profiler) into the "
                         "report")
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON to this file")
    args = ap.parse_args(argv)
    if args.mh_worker is not None:
        # one worker process of the multihost phase, started by it
        return multihost_worker(args)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from geomesa_tpu_torch.ops import build as kbuild
    except ImportError as e:
        print(f"chip_smoke: the geomesa_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    import numpy as np
    from geomesa_tpu_torch.ops.density_kernel import density_grid_kernel
    from geomesa_tpu_torch.ops.hist1d_kernel import hist1d
    from geomesa_tpu_torch.ops.z2_mask import z2_mask
    from geomesa_tpu_torch.ops.z3_mask import z3_mask

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed}

    t0 = time.perf_counter()
    libs = kbuild.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {sorted(libs)} in {report['build_s']:.2f} s")
    # the native range sweep (g++), which every range plan goes through
    from geomesa_tpu_torch import native
    if not native.available():
        raise AssertionError(f"the native range sweep is not available: "
                             f"{native.build_error()}")
    report["native"] = {"available": True,
                        "load_s": native.build_seconds()}
    log(f"build: native range sweep available, built and loaded in "
        f"{native.build_seconds():.2f} s")

    rng = np.random.default_rng(args.seed)
    centres = np.stack([rng.uniform(-130.0, 150.0, 50),
                        rng.uniform(-40.0, 60.0, 50)], axis=1)
    z3_rows = kernel_phase(rng, dev)
    z2_rows = z2_kernel_phase(rng, dev)
    dens_rows = density_kernel_phase(rng, centres, dev)
    hist_rows = hist1d_kernel_phase(rng, dev)
    report["kernel"] = {"z3_mask": z3_rows, "z2_mask": z2_rows,
                        "density_grid": dens_rows, "hist1d": hist_rows}

    # the multihost path: two worker processes of this script on the card,
    # each counting its own launches (set to 0 in the worker just before
    # its run, read just after); the kernels are built above, so the
    # workers only load them
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    multihost_phase(args, report)
    report.setdefault("phase_s", {})["multihost"] = time.perf_counter() - t0

    # degraded execution, the fault catalog and the storage reading on a
    # lean store of its own, first on the card after the kernel phase: a
    # caching allocator holding little else is what lets its cap bite.
    # Counts set to 0 just before, read just after (the JAX package's
    # lean programs reach no Pallas kernel, so none is required)
    res_counters = {"z3_mask": z3_mask, "z2_mask": z2_mask,
                    "density_grid": density_grid_kernel, "hist1d": hist1d}
    for fn in res_counters.values():
        fn.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resilience_phase(rng, args, centres, dev, report)
    report["phase_s"]["resilience"] = time.perf_counter() - t0
    report["resilience_path_launches"] = {k: fn.launches
                                          for k, fn in res_counters.items()}
    gc.collect()
    torch.cuda.empty_cache()

    # the main path: counts set to 0 just before, read just after
    counters = {"z3_mask": z3_mask, "z2_mask": z2_mask,
                "density_grid": density_grid_kernel}
    for fn in counters.values():
        fn.launches = 0
    phase_s = report.setdefault("phase_s", {})
    t0 = time.perf_counter()
    x, y, m, qs = index_phase(rng, args, centres, dev, report)
    phase_s["index"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    z2_index_phase(args, x, y, m, qs, dev, report)
    phase_s["z2_index"] = time.perf_counter() - t0
    del x, y
    t0 = time.perf_counter()
    ds = facade_phase(rng, args, centres, dev, report)
    places_phase(rng, args, centres, ds, report)
    phase_s["facade_places"] = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was never launched on "
                             f"the main path: {launches}")
    report["main_path_launches"] = launches

    # the trace reading on the facade's store: counts set to 0 just
    # before, read just after
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trace_reading(qs, ds, report)
    phase_s["trace"] = time.perf_counter() - t0
    report["trace_path_launches"] = {k: fn.launches
                                     for k, fn in counters.items()}
    if report["trace_path_launches"]["z3_mask"] <= 0:
        raise AssertionError(f"z3_mask was never launched on the traced "
                             f"queries: {report['trace_path_launches']}")

    # 27, gm-lint on the card's machine: 27a the analyzer over the port's
    # tree (no kernel), 27b the synchronizing calls of a few traced
    # queries on the facade's store (counts set to 0 just before, read
    # just after: its BBOX+DURING queries launch z3_mask)
    t0 = time.perf_counter()
    lint = lint_phase(report)
    phase_s["lint"] = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    sync_reading(qs, ds, lint, report)
    phase_s["sync"] = time.perf_counter() - t0
    report["sync_path_launches"] = {k: fn.launches
                                    for k, fn in counters.items()}
    if report["sync_path_launches"]["z3_mask"] <= 0:
        raise AssertionError(f"z3_mask was never launched on the sync "
                             f"reading's queries: "
                             f"{report['sync_path_launches']}")
    log(f"phase 27: 27a {phase_s['lint']:.1f} s, 27b {phase_s['sync']:.1f} s "
        f"(launches {report['sync_path_launches']}); card: {smi}")

    # 6d, obs: the SLO plane, the Prometheus text and the build watch on
    # the facade's store (counts set to 0 just before, read just after);
    # its lean and mesh lean parts run inside those phases below
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    obs_facade_part(qs, ds, report)
    phase_s["obs_facade"] = time.perf_counter() - t0
    obs_launches = {"facade": {k: fn.launches for k, fn in counters.items()}}
    report["obs_path_launches"] = obs_launches
    if obs_launches["facade"]["z3_mask"] <= 0:
        raise AssertionError(f"z3_mask was never launched on the obs "
                             f"path: {obs_launches['facade']}")

    def counted_part(kind, label, part, into):
        # a 6d or 6e part inside another phase: its own counts (set to 0
        # just before, read just after); the host phase's resume where
        # they stood
        def run(*a):
            saved = {k: fn.launches for k, fn in counters.items()}
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            part(*a, report)
            phase_s[f"{kind}_{label}"] = time.perf_counter() - t0
            into[label] = {k: fn.launches for k, fn in counters.items()}
            log(f"{kind} ({label}) path: launches {into[label]}, "
                f"{phase_s[f'{kind}_{label}']:.1f} s")
            for k, fn in counters.items():
                fn.launches = saved[k]
        return run

    def obs_part(label, part):
        return counted_part("obs", label, part, obs_launches)

    # 6e, arrow: the Arrow result path on the facade's store (counts set
    # to 0 just before, read just after); its mesh and lean parts run
    # inside those phases below
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    arrow_facade_part(qs, ds, report)
    phase_s["arrow_facade"] = time.perf_counter() - t0
    arrow_launches = {"facade": {k: fn.launches
                                 for k, fn in counters.items()}}
    report["arrow_path_launches"] = arrow_launches
    log(f"arrow (facade) path: launches {arrow_launches['facade']}, "
        f"{phase_s['arrow_facade']:.1f} s")
    if arrow_launches["facade"]["z3_mask"] <= 0:
        raise AssertionError(f"z3_mask was never launched on the arrow "
                             f"path: {arrow_launches['facade']}")

    def arrow_part(label, part):
        return counted_part("arrow", label, part, arrow_launches)

    # the serving plane on the facade's store: counts set to 0 just
    # before, read just after; batched windows launch z3_mask (timed) and
    # z2_mask (untimed), the tile density_grid
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    serving_phase(args, centres, ds, report)
    phase_s["serving"] = time.perf_counter() - t0
    serving_launches = {k: fn.launches for k, fn in counters.items()}
    if min(serving_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the serving path was never "
                             f"launched on it: {serving_launches}")
    report["serving_path_launches"] = serving_launches
    log(f"serving path: launches {serving_launches}, "
        f"{phase_s['serving']:.1f} s")

    # 24a, analytics: the processes, the sampling hints and SQL on the
    # facade's stores (counts set to 0 just before, read just after); its
    # mesh and lean parts count apart inside phases 7 and 8, and 24d in
    # each multihost worker.  Timed windows launch z3_mask, untimed ones
    # and the places schema z2_mask
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    analytics_facade_part(rng, args, centres, qs, ds, report)
    phase_s["analytics_facade"] = time.perf_counter() - t0
    analytics_launches = {"facade": {k: fn.launches
                                     for k, fn in counters.items()}}
    report["analytics_path_launches"] = analytics_launches
    log(f"analytics (facade) path: launches {analytics_launches['facade']}, "
        f"{phase_s['analytics_facade']:.1f} s")
    if min(analytics_launches["facade"]["z3_mask"],
           analytics_launches["facade"]["z2_mask"]) <= 0:
        raise AssertionError(f"a kernel of the analytics path was never "
                             f"launched on it: "
                             f"{analytics_launches['facade']}")

    def analytics_part(label, part):
        return counted_part("analytics", label, part, analytics_launches)

    # 25a, the front ends: the web app over the facade's store, driven over
    # HTTP (counts set to 0 just before, read just after: its BBOX+DURING
    # requests launch z3_mask, the places boxes z2_mask, the tiles
    # density_grid); 25c, the blob store, the GeoJSON index and the merged
    # view, counted apart.  Phase 25 draws from a generator of its own, so
    # the later phases' rows stay those of the seed
    rng25 = np.random.default_rng(args.seed + 25)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    frontend_facade_part(rng25, args, centres, qs, ds, report)
    phase_s["frontend_facade"] = time.perf_counter() - t0
    frontend_launches = {"facade": {k: fn.launches
                                    for k, fn in counters.items()}}
    report["frontend_path_launches"] = frontend_launches
    log(f"frontend (facade) path: launches {frontend_launches['facade']}, "
        f"{phase_s['frontend_facade']:.1f} s")
    if min(frontend_launches["facade"].values()) <= 0:
        raise AssertionError(f"a kernel of the front-end path was never "
                             f"launched on it: {frontend_launches['facade']}")
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    frontend_other_part(rng25, args, centres, qs, ds, dev, report)
    phase_s["frontend_other"] = time.perf_counter() - t0
    frontend_launches["other"] = {k: fn.launches
                                  for k, fn in counters.items()}
    log(f"frontend (other) path: launches {frontend_launches['other']}, "
        f"{phase_s['frontend_other']:.1f} s")

    del ds
    torch.cuda.empty_cache()

    # the mesh path: every count set to 0 just before, read just after
    counters["hist1d"] = hist1d
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    mesh_phase(rng, args, centres, dev, report,
               arrow=arrow_part("mesh", arrow_mesh_part),
               analytics=analytics_part("mesh", analytics_mesh_part))
    phase_s["mesh"] = time.perf_counter() - t0
    if arrow_launches["mesh"]["z3_mask"] <= 0:
        raise AssertionError(f"z3_mask was never launched on the mesh "
                             f"arrow path: {arrow_launches['mesh']}")
    mesh_launches = {k: fn.launches for k, fn in counters.items()}
    if min(mesh_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the mesh path was never launched "
                             f"on it: {mesh_launches}")
    report["mesh_path_launches"] = mesh_launches

    # the lean path: every count set to 0 just before, read just after;
    # the store keeps a catalog, flushed at the end, which the lean
    # persist path reopens (its own counts)
    persist_launches = {}
    lean_cat = tempfile.mkdtemp(prefix="chip_smoke_lean_")

    def lean_serving(ds, name, cols):
        # the fused part has its own counts (set to 0 just before, read
        # just after); the lean phase's resume where they stood
        saved = {k: fn.launches for k, fn in counters.items()}
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        serving_fused_part(args, centres, ds, name, cols, report)
        phase_s["serving_fused"] = time.perf_counter() - t0
        report["serving_fused_path_launches"] = {
            k: fn.launches for k, fn in counters.items()}
        log(f"serving fused path: launches "
            f"{report['serving_fused_path_launches']} (the lean fused "
            f"scan runs no kernel), {phase_s['serving_fused']:.1f} s")
        for k, fn in counters.items():
            fn.launches = saved[k]

    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        lean = lean_phase(rng, args, centres, qs, dev, report, cat=lean_cat,
                          serving=lean_serving,
                          obs=obs_part("lean", obs_lean_part),
                          arrow=arrow_part("lean", arrow_lean_part),
                          analytics=analytics_part("lean",
                                                   analytics_lean_part))
        phase_s["lean"] = time.perf_counter() - t0
        lean_launches = {k: fn.launches for k, fn in counters.items()}
        if lean_launches["density_grid"] <= 0:
            raise AssertionError(f"density_grid was never launched on the "
                                 f"lean path: {lean_launches}")
        report["lean_path_launches"] = lean_launches
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        lean_persist_phase(args, dev, report, lean)
        phase_s["lean_persist"] = time.perf_counter() - t0
        persist_launches["lean_persist"] = {k: fn.launches
                                            for k, fn in counters.items()}
        del lean
    finally:
        shutil.rmtree(lean_cat, ignore_errors=True)
    torch.cuda.empty_cache()

    # the attribute paths (default profile and mesh, then lean): counts
    # set to 0 just before each, read just after
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    attr_phase(rng, args, centres, dev, report)
    phase_s["attr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_attr_phase(rng, args, centres, dev, report)
    phase_s["mesh_attr"] = time.perf_counter() - t0
    attr_launches = {k: fn.launches for k, fn in counters.items()}
    if attr_launches["z3_mask"] <= 0:
        raise AssertionError(f"z3_mask was never launched on the attribute "
                             f"path: {attr_launches}")
    report["attr_path_launches"] = attr_launches
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    lean_attr_phase(rng, args, centres, dev, report)
    phase_s["lean_attr"] = time.perf_counter() - t0
    report["lean_attr_path_launches"] = {k: fn.launches
                                         for k, fn in counters.items()}

    # the lean schemas over a mesh (ShardedLeanZ3Index and the sharded
    # attribute indexes): counts set to 0 just before, read just after.
    # Their scans run no kernel (the JAX package's sharded lean programs
    # reach no Pallas kernel); the weighted heatmap's query path launches
    # density_grid
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    mesh_lean_phase(rng, args, centres, qs, dev, report,
                    obs=obs_part("mesh_lean", obs_mesh_lean_part))
    phase_s["mesh_lean"] = time.perf_counter() - t0
    mesh_lean_launches = {k: fn.launches for k, fn in counters.items()}
    if mesh_lean_launches["density_grid"] <= 0:
        raise AssertionError(f"density_grid was never launched on the mesh "
                             f"lean path: {mesh_lean_launches}")
    report["mesh_lean_path_launches"] = mesh_lean_launches
    log(f"mesh lean path: launches {mesh_lean_launches}, "
        f"{phase_s['mesh_lean']:.1f} s")
    log(f"attribute paths: launches {attr_launches}, lean "
        f"{report['lean_attr_path_launches']}; "
        + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))

    # the polygon paths (xz3/xz2 on the default profile, the mesh and the
    # lean profile): counts set to 0 just before each, read just after.
    # The JAX package runs no Pallas kernel on them (its xz programs are
    # host numpy or plain XLA), so none is required here; the counts are
    # reported
    report["z3_sweeps"] = z3_sweeps(qs)
    xz_launches = {}
    for name, phase in (("polys", polys_phase),
                        ("mesh_polys", mesh_polys_phase),
                        ("lean_polys", lean_polys_phase),
                        ("lean_tracks", lean_tracks_phase),
                        ("mesh_lean_polys", mesh_lean_polys_phase)):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        phase(rng, args, dev, report)
        phase_s[name] = time.perf_counter() - t0
        xz_launches[name] = {k: fn.launches for k, fn in counters.items()}
    report["xz_path_launches"] = xz_launches

    # the lifecycle paths (deletes, visibilities, the read APIs, the v1
    # layouts, the mesh after a delete): counts set to 0 just before
    # each, read just after; each must launch the kernels it runs
    life_launches = {}
    need = {"lifecycle": ("z3_mask", "z2_mask", "density_grid"),
            "legacy": ("z3_mask", "z2_mask"),
            "mesh_lifecycle": ("z3_mask", "z2_mask", "hist1d")}
    life_cat = tempfile.mkdtemp(prefix="chip_smoke_life_")
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        chunks, cols, cands, life = lifecycle_phase(
            rng, args, centres, qs, dev, report, cat=life_cat)
        phase_s["lifecycle"] = time.perf_counter() - t0
        life_launches["lifecycle"] = {k: fn.launches
                                      for k, fn in counters.items()}
        # the persist path: the lifecycle store's catalog reopened
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        persist_phase(args, qs, dev, report, life)
        phase_s["persist"] = time.perf_counter() - t0
        persist_launches["persist"] = {k: fn.launches
                                       for k, fn in counters.items()}
        del life
    finally:
        shutil.rmtree(life_cat, ignore_errors=True)
    torch.cuda.empty_cache()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    legacy_phase(args, chunks, cols, cands, qs, dev, report)
    phase_s["legacy"] = time.perf_counter() - t0
    life_launches["legacy"] = {k: fn.launches for k, fn in counters.items()}
    del chunks, cols
    torch.cuda.empty_cache()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    mesh_lifecycle_phase(rng, args, centres, qs, dev, report)
    phase_s["mesh_lifecycle"] = time.perf_counter() - t0
    life_launches["mesh_lifecycle"] = {k: fn.launches
                                       for k, fn in counters.items()}
    for phase, names in need.items():
        if min(life_launches[phase][k] for k in names) <= 0:
            raise AssertionError(f"a kernel of the {phase} path was never "
                                 f"launched on it: {life_launches[phase]}")
    report["life_path_launches"] = life_launches
    log(f"lifecycle paths: launches {life_launches}; "
        + ", ".join(f"{k} {phase_s[k]:.1f} s" for k in life_launches))

    # the FileSystemDataStore lifted onto the card: counts set to 0 just
    # before, read just after
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    fsds_phase(rng, args, centres, qs, dev, report)
    phase_s["fsds"] = time.perf_counter() - t0
    persist_launches["fsds"] = {k: fn.launches for k, fn in counters.items()}
    need = {"persist": ("z3_mask", "z2_mask", "density_grid", "hist1d"),
            "fsds": ("z3_mask", "z2_mask")}
    for phase, names in need.items():
        if min(persist_launches[phase][k] for k in names) <= 0:
            raise AssertionError(f"a kernel of the {phase} path was never "
                                 f"launched on it: {persist_launches[phase]}")
    report["persist_path_launches"] = persist_launches
    log(f"persistence paths: launches {persist_launches}; "
        + ", ".join(f"{k} {phase_s[k]:.1f} s" for k in persist_launches))

    # 23, ingest: counts set to 0 just before, read just after; its
    # BBOX+DURING queries must launch z3_mask, its BBOX ones z2_mask
    for fn in counters.values():
        fn.launches = 0
    cli_files = tempfile.mkdtemp(prefix="chip_smoke_cli_files_")
    t0 = time.perf_counter()
    kept = ingest_phase(rng, args, centres, qs, dev, report, keep=cli_files)
    phase_s["ingest"] = time.perf_counter() - t0
    ingest_launches = {k: fn.launches for k, fn in counters.items()}
    if min(ingest_launches["z3_mask"], ingest_launches["z2_mask"]) <= 0:
        raise AssertionError(f"a kernel of the ingest path was never "
                             f"launched on it: {ingest_launches}")
    report["ingest_path_launches"] = ingest_launches
    log(f"ingest path: launches {ingest_launches}, "
        f"{phase_s['ingest']:.1f} s")

    # 24e, raster: a coverage store of its own (counts set to 0 just
    # before, read just after; the mosaic is device PyTorch, as the JAX
    # package's is plain XLA, so no kernel is required)
    gc.collect()
    torch.cuda.empty_cache()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    # 25b inside it: /wcs over its store, counted and timed apart
    raster_phase(rng, args, centres, dev, report, wcs=counted_part(
        "frontend", "wcs", lambda store, checks, rep: frontend_wcs_part(
            store, checks, dev, rep), frontend_launches))
    phase_s["raster"] = (time.perf_counter() - t0
                         - phase_s["frontend_wcs"])
    analytics_launches["raster"] = {k: fn.launches
                                    for k, fn in counters.items()}

    # 25d, the command line in two processes on the card, over two of
    # phase 23's files (each command's launches counted in its process)
    try:
        t0 = time.perf_counter()
        cli_out = frontend_cli_part(args, kept, qs, dev, report)
        phase_s["frontend_cli"] = time.perf_counter() - t0
        frontend_launches["cli"] = cli_out["launches"]
        # the three commands that scan ran z3_mask in their process
        unlaunched = [k for k in ("sql", "export", "explain")
                      if cli_out["launches"][k]["z3_mask"] <= 0]
        if unlaunched:
            raise AssertionError(f"the CLI's {unlaunched} launched no "
                                 f"z3_mask: {cli_out['launches']}")
    finally:
        shutil.rmtree(cli_files, ignore_errors=True)
    log("phase 25: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in phase_s.items()
        if k.startswith("frontend")) + f"; total "
        f"{sum(v for k, v in phase_s.items() if k.startswith('frontend')):.1f}"
        f" s; card: {smi}")
    log(f"raster path: launches {analytics_launches['raster']}, "
        f"{phase_s['raster']:.1f} s; phase 24 "
        f"{sum(v for k, v in phase_s.items() if k.startswith('analytics') or k == 'raster'):.1f} s")
    z3s = report["z3_sweeps"]
    log(f"polygon paths: launches {xz_launches}; "
        + ", ".join(f"{k} {phase_s[k]:.1f} s" for k in xz_launches)
        + "; z3 plans native "
        f"{sum(r['plan_native_ms'] for r in z3s):.1f} ms, numpy "
        f"{sum(r['plan_numpy_ms'] for r in z3s):.1f} ms over "
        f"{len(z3s)} queries")
    # 26, streaming (counts set to 0 just before each part, read just
    # after)
    gc.collect()
    torch.cuda.empty_cache()
    stream_launches = stream_phase(args, centres, dev, report, counters,
                                   phase_s, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # every kernel launched through its gate, and none failed
    from geomesa_tpu_torch.ops.gate import kernel_health
    health = kernel_health()
    report["kernel_health"] = health
    bad = {k: v for k, v in health.items()
           if (k.endswith("_ok") and v is not True)
           or (k.endswith("_failures") and v)}
    if bad:
        raise AssertionError(f"kernel gates after the run: {bad}")
    log(f"kernel gates: {health}")
    report["total_s"] = time.perf_counter() - t_start

    def pick(rows, **kw):
        return next(r for r in rows
                    if all(r[k] == v for k, v in kw.items()))

    src = "geomesa_tpu/ops/pallas_kernels.py"
    # each kernel's launches: its main path's (the mesh path's for
    # hist1d) and phase 26's
    streamed = {k: sum(v[k] for v in stream_launches.values())
                for k in counters}
    kernels = {"kernels": [
        kernel_entry("z3_mask", f"{src}:404",
                     launches["z3_mask"] + streamed["z3_mask"], z3_rows,
                     pick(z3_rows, n=1 << 22, r=8)),
        # the shape most z2 scans of the main path give the kernel
        kernel_entry("z2_mask", f"{src}:485",
                     launches["z2_mask"] + streamed["z2_mask"], z2_rows,
                     pick(z2_rows, n=1 << 24, r=1)),
        kernel_entry("density_grid", f"{src}:305",
                     launches["density_grid"] + streamed["density_grid"],
                     dens_rows, pick(dens_rows, dist="clustered",
                                     weights="unit", grid=256,
                                     masked_in_share=0.5)),
        # the mesh phase's shape: its per-shard slots, a Histogram stat
        kernel_entry("hist1d", f"{src}:554",
                     mesh_launches["hist1d"] + streamed["hist1d"],
                     hist_rows, pick(hist_rows, n=16_000_000, bins=64,
                                     weights="unit", masked_in_share=0.5)),
    ]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    arw = report["arrow"]
    log("arrow rates: " + "; ".join(
        f"{part} {arw[part]['rows_per_s']:.4g} rows/s, "
        f"{arw[part]['ipc_bytes_per_s']:.4g} IPC bytes/s"
        for part in ("facade", "lean", "mesh"))
        + f"; 6e {sum(phase_s[f'arrow_{p}'] for p in arw):.1f} s; "
        f"card: {smi}")
    log(f"total: {report['total_s']:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
