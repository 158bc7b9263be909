#!/usr/bin/env python3
"""Smoke run of modin_tpu_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py [--rows N] [--arithmetic-rows N] [--earlier-rows N]
                          [--float-rows N] [--io-rows N] [--window-rows N]
                          [--clean-rows N] [--dates-rows N] [--fusion-rows N] [--plan-rows N]
                          [--memory-rows N] [--views-rows N] [--views-time-rows N]
                          [--robust-cost-rows N] [--trace-rows N] [--stream-rows N]
                          [--stream-sort-rows N] [--mesh-rows N] [--serve-rows N] [--ingest-rows N]
                          [--fleet-rows N] [--seed S] [--parent-checkout DIR]
                          [--phases main,float,relational,arithmetic,io,window,clean,dates,fusion,plan,formats,
                                    memory,views,robust,trace,stream,mesh,serve,ingest,fleet]

Phases, one JSON object per line each:

1. device  - card name, ``nvidia-smi`` name and power limit, versions.
2. build   - every CUDA kernel built from the sources in this checkout.
3. kernel  - ``bincount`` held against its plain torch version (exactly) on
             the card at 1e8 codes (and a ragged 1e8 + 77), widths from 3
             to 2^22 across the shared-memory cap, codes that include the
             overflow value, and all codes in one slot; times of the
             kernel, the plain version and ``torch.bincount`` (medians of 5
             runs after a warm-up, CUDA events) beside the bound.  Then
             ``scan`` against ``scan_plain`` at 1e8 rows: the linear mode
             over float64, seg_add and seg_max over int64 (exactly) and
             float64 (within a bound from the scans' depths) with sorted
             codes of 100 and 10 000 groups, seg_add without codes (beside
             ``torch.cumsum``, the same function), block widths forward and
             in reverse; ten launches bit for bit; each case's bound from
             its own bytes (16 or 24 a row); then ragged and misaligned
             shapes in every mode.  Then the fused expression kernel
             (``fused.cu``) against ``run_program_plain`` at 1e8 rows, bit
             for bit and ten launches repeating: ``a * b + c`` over float64
             kept (beside ``torch.addcmul``), with a sum tail and with a
             var tail (two launches), an int64 chain with floor division,
             modulo and wrapping, a 150-node program over 8 leaves, ``a * b
             + c`` over float32 (beside ``torch.addcmul`` in float32) and an
             int32 and a float32 leaf cast into a float64 result; the
             ptxas report of the kernel's builds, each case's launch shape,
             and ``a * b + c`` and the 150-node program at 1, 2 and 4 rows a
             thread; with ``--parent-checkout DIR`` the fused kernel of an
             earlier commit on the same cases before and after this one's;
             and one node of every op over every dtype (NaN, +/-inf,
             +/-0.0, int extremes) against a column of every dtype or a
             scalar, bit for bit (``fused_grid_check``).  Then the fused
             kernel's masked mode at phase 13's shapes: sum, mean, var,
             min, max and count of ``[b, c]`` under the deferred mask
             ``a > 0``, the fused groupby's probe (``fused_probe_program``:
             the key's min and max and the kept rows in one launch) and its
             slot column (``fused_slot_expr``), each beside torch's
             reduction of the compacted rows.  Then ``groupagg`` against
             ``groupagg_plain`` at 1e8 rows, bit for bit and repeating: one
             int8, int64, float32 or float64 column by slots of key ranges
             of 8, 100, 10 000 and 65 536 (a tenth of the rows in the
             overflow slot), half the aggregations a width so that each
             table shape (eight table copies, one, slot ranges) meets every
             aggregation over every dtype; int64 codes as slots (the eager
             groupby's), the main path's ten int64 columns by 101 codes in
             sum and mean; then phase 13's fused groupbys (the slot column
             of ``a > 0`` by the 1000-value key ``d``, every aggregation
             over its column set); beside ``index_add_``/
             ``scatter_reduce_``/``bincount``, the previous design's recorded
             times, and
             ``groupby_reduce``'s grouped sums on the staged path and on
             ``groupagg`` at 100 and 10 000 groups and at the main path's
             shape; with ``--parent-checkout`` the earlier commit's
             ``groupagg`` on the same cases.  The masked cases and the
             groupagg check print their seconds.
4. main    - the asv main path (``make_frame((N, 10), ngroups=g)`` for
             g in 100 and 10 000, plus a key of range 1e6) through
             ``modin_tpu_torch.pandas``: from_pandas, add/mul/mod/abs,
             df1 + df2, gt, sum/mean/count, groupby count/size/sum/mean,
             to_pandas; every result against pandas (ints exactly, floats
             to rtol 1e-12).  Without pandas the same queries go through
             ``TorchQueryCompiler.from_numpy_columns`` against numpy.  The
             grouped sums and means take ``groupagg`` where the route gate
             says so: its launches are printed, and none where the gate
             predicts one fails the phase.
5. float   - float keys with NaN and float values with NaN (5e6 rows):
             groupby sum/mean/count under dropna True/False and the skipna
             reductions; the group mean twice, bit for bit.
6. relational - the asv relational suite at ``--earlier-rows`` rows through
             ``modin_tpu_torch.pandas``: ``query`` and the same boolean
             mask, ``isin``, ``sort_values`` on one key and on two keys in
             opposite directions, ``concat`` of two frames, ``__setitem__``
             of ``col0 % 5`` and a two-key groupby sum, a star-schema
             ``merge`` (N-row fact, N/10-row dimension with a unique key,
             inner and left) and the asv ``TimeMerge`` recipe (5000 x 5000
             against 2500 x 3 on ``col0``, inner and left).  Every result
             equals pandas exactly, index included, no query defaults to
             pandas, and every value column stays on ``cuda``.  Needs
             pandas, the reference it is held against.
7. arithmetic - asv ``TimeArithmetic`` on ``make_frame((rows, 10))``
             (``--arithmetic-rows``, 7.5e6 by default): sum, count, median, nunique, mean, mode,
             add/mul/mod(2) at ``axis=0`` and ``axis=1``, abs and isin
             (which take no axis), ``quantile([0.1, 0.5, 0.9])`` and
             ``describe()`` on the device, each against pandas (ints
             exactly, floats to rtol 1e-12); the row-wise ``nunique``,
             ``mode`` and ``median``, per-row loops in pandas, against numpy
             at full size and against pandas on the first 1e5 rows.  No query
             defaults to pandas, and each ``nunique``/``mode`` along axis 0
             launches the bincount kernel at least once per column.  Then
             reads through ``iloc``, ``loc`` and ``head`` at full size, on
             the device, and ``apply``, ``aggregate`` with a callable and
             ``transpose`` at asv's Big unary shape (1e6 x 10; 1e5 rows for
             ``axis=1``), each defaulting to pandas exactly once.
8. io      - files in and strings on the card at ``--io-rows`` (2.5e6) rows of
             asv's ``str_int`` CSV shape (10 columns, three of them the
             strings alpha/beta/gamma-delta): ``to_csv`` of the uploaded
             frame, byte for byte pandas' file (asv ``TimeToCsv``);
             ``read_csv`` of it through the native splitter and the
             parallel parse; the dictionary encoding of the string columns,
             timed apart; the README pipeline, groupby on string keys
             (``size`` of two keys, ``as_index=False``, a string ``max``),
             ``value_counts``, ``nunique``, ``unique``, comparisons with a
             string, ``.str.startswith``/``.str.len``, ``isin``, a sort by a
             string and an int key and a left merge with a 3-row string-keyed
             dimension; then ``to_parquet`` and ``read_parquet`` against
             pandas' round trip.  Every result equals pandas' exactly (float
             means to rtol 1e-12), str dtypes and index included, nothing
             defaults to pandas, and the bincount kernel launches.
9. window  - windows, cumulative ops and the rest of groupby on
             ``make_frame((rows, 10), ngroups=100)`` at ``--window-rows``
             (2.5e6 by default) and on phase 5's NaN float
             frame (with +/-inf rows): cumsum/cummax/shift/diff/pow,
             skew/kurt, ``rolling(10)``/``rolling(1000)``
             sum/mean/std/min/max/count, ``expanding`` mean/std, ``ewm``
             mean/std/adjust=False/corr, groupby median/quantile/nunique/
             first/last/var/prod/cumsum/cummax/cumcount/transform/agg list
             and dict/describe, each against pandas within the tolerance its
             line states; then rolling(10) sum/mean/var/std of a spike
             series (ten values of 1e15, then N(0, 1)) and a trend series
             (t * 1e3 + N(0, 1)), each within pandas' own error against an
             exact long-double window plus the block-partial bound; no query
             defaults to pandas, the scan and the bincount kernels launch,
             and an ewm mean and a rolling std repeat bit for bit.
10. clean  - missing data, dtypes, masked assignment and the sort-shaped
             breadth at ``--clean-rows`` (2.5e6) on ``make_frame((rows, 10),
             ngroups=100)``, on phase 5's NaN float frame (with +/-inf rows)
             and on that frame with a string column of three values:
             ``isna``/``notna``, ``fillna`` (0, a dict, ``df.mean()``),
             ``dropna`` (all columns; a subset with ``how="all"``),
             ``astype`` int to float64/float32/int32, ``round(2)`` and
             ``round(-1)`` of ints, ``clip`` (ints with fractional bounds
             too), ``df.loc[mask, col] = v`` on int and float columns,
             ``idxmin``/``idxmax`` and ``nlargest``/``nsmallest`` (frame and
             Series, k past the valid count), ``rank`` in every method and
             ``na_option`` with ``pct=True`` and with ``ascending=False``,
             and ``duplicated``/``drop_duplicates`` with every ``keep`` on
             one and two int keys and a string key.  Each equals pandas
             exactly (floats bit for bit, dtypes, index and row order), no
             query defaults to pandas, the value columns stay on ``cuda``,
             and ``rank`` launches the scan kernel.
11. dates  - datetimes, bool keys, statistics and encodings at
             ``--dates-rows`` (2.5e6): all 23 ``.dt`` fields of a
             datetime64[us] column from 1900 to 2100 with 1 % NaT and of the
             same instants as datetime64[ns], the 5 timedelta fields of their
             difference from 2000-01-01, groupby sum/mean/count by
             ``s.dt.year`` and by ``[s.dt.year, s.dt.month]``, ``resample``
             of a one-minute frame (4 float columns with NaN, an int and a
             bool column) by h/D/W/ME/QE and by h with
             ``closed="right", label="right"`` in every device op, sort and
             merge on a bool key, corr/cov with and without NaN and at an
             offset of 1e8, ``get_dummies`` of a string and a categorical
             column, dict ``Series.map`` of a string and an int column,
             ``np.sqrt``/``np.log``/``np.floor`` of the float frame, and a
             1e6-row ``read_csv(parse_dates=...)`` whose column lands on
             ``cuda``.  Each equals pandas (ints, bools, dtypes, labels and
             index names exactly, floats to rtol 1e-12, corr/cov to rtol
             1e-10; ``corr`` without missing values against the
             correlations of pandas' two-pass ``cov``, pandas' own Welford
             ``corr`` being off in its smallest entries and at the
             offset), no query defaults to pandas, and the groupby by two
             ``.dt`` keys launches the bincount kernel.
12. fusion - deferred chains at ``--fusion-rows`` (1e7): ``df * 2 + 1``,
             ``(df - df.mean()) / df.std()``, ``df1 + df2 * df1``, ``a * b +
             c`` with each reduction tail with and without ``skipna``,
             ``.sum(axis=1)`` of a chain, a filter on a lazy mask,
             ``np.sqrt(df.abs()) + 1``, ``fillna(0).clip(-1, 1).round(2)``,
             float32 and int8/uint8 wrapping, int and float floor division
             and modulo, a diamond, a bool chain, a 161-node chain (past the
             depth cap) and ``df * 2`` then ``df * 3`` (one program).  Each
             equals pandas (bit for bit; rtol 1e-12 where sums reorder; 2 n
             eps for the product; the moment bound for skew/kurt) and the
             same programs through ``run_program_plain`` on the card bit for
             bit, no query defaults to pandas, and each launches the fused
             kernel as often as predicted.  Every earlier phase runs its
             elementwise queries through the fused kernel too; the kernels
             line gives its launches on every path.
13. plan   - the whole-query planner at ``--plan-rows`` (2.5e6) rows of the
             ``scripts/plan_smoke.py`` CSV shape (columns a-f): ``read_csv(p)
             .query("a > 0")[["b", "c"]].agg(...)`` for sum/mean/var/min/
             max/count, a map chain into a sum, stacked filters and
             ``query(...).groupby("d")`` for sum/mean/count/min/max/prod;
             then, on smaller files, a query on each side of each route
             threshold: groupagg's table split into slot ranges (Auto
             declines, Fused takes it), the key range at and one past
             ``FUSED_MAX_GROUPS``, a key spanning 2^40, and the rows on
             each side of ``FuseMinRows``.  Each under
             ``MODIN_TPU_TORCH_PLAN=Auto`` (with its ``FuseMode``) and
             ``Off`` against pandas (ints and order-free results exactly,
             float reductions to rtol 1e-12, grouped float sums and means
             to 1e-12 of each group's magnitude), the parse sees only the
             surviving columns, EXPLAIN attributes the pushdown, each
             query takes its predicted route (fused, declined or staged),
             a fused one launches the fused kernel once (twice for var)
             or, for a groupby, twice plus one ``groupagg`` launch (a
             declined groupby's eager path as the gate predicts), and
             nothing defaults to pandas.  Before the queries: the
             acceptance pipeline's breakdown (the parse of 6 and of 3
             columns, the sniff, EXPLAIN ANALYZE per node) and the route
             sweep (Fused against Staged by key range, value columns and
             rows, on in-memory frames, through the planner's fused leg and
             through the eager groupby).
14. formats - the remaining IO at the sizes users hold such files, on
             the card: ``read_json(lines=True)`` of 1e6 records (2 int64, 2
             float64, a str and a bool column) and the streamed
             ``to_json(orient="records", lines=True)`` byte for byte
             pandas' file; ``read_fwf`` of 5e5 rows x 5 columns (written
             with printf formats) with inferred and explicit spans; a 1e6
             x 5 sqlite3 file through ``read_sql`` with a plain connection
             and a ``ModinDatabaseConnection``, and ``to_sql`` read back; ``to_excel`` and
             ``read_excel`` of 1e5 x 4 through the port's xlsx codec (no
             Excel engine there), held to the original frame; an HDF round
             trip where PyTables imports, else pandas' ``ImportError`` and a
             note that HDF is unverified; pandas' ``from_dataframe`` over the
             port's interchange producer of ``make_frame((1e7, 10)) + 1``
             against pandas' producer (10 column fetches; a selection of 2
             fetching 2), and ``to_numpy`` in one device-to-host copy
             against pandas'.  Each read equals pandas' exactly (records,
             dtypes, values); on each read's frame ``groupby("k")`` sum and
             mean (ints exactly, floats to 1e-12 of each group's
             magnitude), ``(b * c + 1).sum()`` (rtol 1e-12) and
             ``k.nunique()`` equal pandas' and launch ``groupagg``, the
             fused kernel and ``bincount``; nothing defaults to pandas.

15. memory - routing and memory (``phase_memory``): the kernel router's
             calibration on this card (``torch.sort``, the sorted-consume
             pass and the histogram through ``bincount.cu`` at 2^18 and
             2^24 rows, each fitted as a fixed and a growing part; pandas'
             median, quantile, nunique and mode in both cardinality
             regimes), its wall time and the cache hit of a second
             resolution; a sweep of median, quantile, nunique of few and of
             many values and mode over int64 columns of 1e5 to 1e8 rows and
             at each crossover the model predicts inside that range, each
             verdict with its predicted costs beside the device's and
             pandas' measured times (a verdict on the side that measured
             slower by more than ``MIN_SAVINGS_S`` fails); ``DeviceMemoryBudget`` =
             20 GiB over int64 frames of ``--memory-rows`` (1e8) x 10: A
             from ``from_pandas``, B = A * 3 + 1, C = A - 7, D = B + C, then
             sums and a 100-key groupby of B, exactly as numpy derives them
             from A's host data, with the spills, restores, their rates and
             the ledger's and the allocator's bytes; phase 13's filtered
             reduction and 1000-key groupby twice with no budget (nothing
             donated, the repeat restoring nothing), then under a budget
             with the scan's columns donated and pinned (bit-equal, a later
             read restoring); phase 13's
             pipelines under ``OptMode`` Auto and Off (bit-equal, re-plans
             printed).
16. views  - the derived-artifact cache (``phase_views``): (a) at
             ``--views-rows`` (1e6: int64 ``i``, float64 ``f`` with 20 % NaN,
             bool ``b``, an int key ``k`` in [0, 1000), a str column ``s``)
             sum, mean, min, max, count, prod of ``b``, any, all, var,
             median, nunique, mode and groupby by ``k`` sum/mean/count/
             size/min/max and by ``s`` sum, each cold, again (a hit), after
             each of 3 chained appends of a tenth of the rows (a fold where
             the artifact folds), on a branch appended to the same parent
             and under ``ViewsMode`` Off, against pandas (ints exactly,
             floats to rtol 1e-12, grouped float sums and means to 1e-12 of
             their group's magnitude); (b) at ``--views-time-rows`` (5e7 x
             ``i, f, k``, 1.2 GB) sum, mean, min, groupby by ``k``
             sum/mean/count and ``k``'s nunique, cold, hit, after each of 10
             appends of a hundredth of the rows, and recomputed under Off on
             the final frame: each stage's ``port_ms``, each kernel's launches
             and the rows they read, the hit, fold and miss counts; the last
             fold's answers equal Off's (ints bit for bit, floats to rtol
             1e-12).  A hit launches no kernel, a fold's launches read only
             the tail (the first fold of a grouped mean also reads the prefix
             once, for its valid counts), nothing defaults to pandas.
17. robust - fault-tolerant execution (``phase_robust``): (a) a real
             ``torch.cuda.OutOfMemoryError`` at 1e8 rows, under a cap between
             the query's own peak and that peak plus 6 GB of resident cold
             frames, absorbed by evict-then-retry in ``device_path`` (an
             int-key groupby mean on ``groupagg``) and in ``engine_call``
             (``(a * b + c).sum()``, one fused launch through ``deploy``), with
             no fallback, answers as pandas' and the spilled columns restored
             exactly; (b) injected faults: transient ones at ``put`` and
             ``materialize`` retried, losses in a fused chain and a filter ->
             groupby -> merge re-seating host, io and op lineage bit for bit
             (nothing unrecoverable, a views artifact of before the loss
             missing after it), threshold-many losses raising ``DeviceLost``
             and opening the ``reduce`` breaker, the next call raising
             ``BreakerOpen`` without touching the card, a probe closing it (no
             fallback, no default); (c) five phase-4 queries at
             ``--robust-cost-rows`` (1e7) with ``ResilienceMode``/
             ``RecoveryMode`` on and off, in five rounds, and the layer's own
             cost per call and calls per query.  Every other phase ends with no
             device-path fallback and every breaker closed; a
             ``{"resilience": ...}`` line precedes the card's name.
18. trace  - observability (``phase_trace``), at ``--trace-rows`` (1e7): (b)
             this card's peaks, measured now (a 1 GiB device-to-device copy
             and the float64 FMA loop of ``csrc/peaks.cu``), the roofline's
             basis; (a) phase 4's frames (100 groups) under ``profile()``:
             ``df + df``, ``sum``, ``mean``, grouped sum/mean (``groupagg``)
             and size (``bincount``), ``(df * 2 + df2).var()`` (``fused``,
             two launches) and ``cumsum`` (``scan``), each with its
             ``to_pandas`` under one root span; the rollup (wall, host,
             engine, device, builds and lowerings, self time by layer), each
             kernel's launches, event-timed device ms, bytes, achieved GB/s
             and roofline fraction; the launch ledger's counts equal to the
             wrappers' ``LAUNCHES`` deltas, each kernel's event time within
             its root's wall, the Chrome trace written and read back, every
             answer equal to pandas'; (c) five phase-4 queries with tracing
             and meters on and off in 5 rounds of on, off, off, on (each
             median delta beside its rounds' spread), the per-call cost of
             a wrapped method and of a span (Enable less Disable, best of 3
             x 20 000), a wrapped method over a bare one with everything
             off and each query's wrapped calls, and with everything off no
             span, meter or ledger record made over the queries; (e)
             EXPLAIN ANALYZE of a deferred 1e6-row CSV query: with tracing
             on, the nodes that launched show bandwidth and roofline over
             their launches' events, off, over the host wall (``~host``);
             (d) losses injected at
             ``materialize`` open the ``reduce`` breaker, the next call raises
             ``BreakerOpen``, and the flight recorder has dumped its ring, with
             the attempt spans and a meter snapshot, to a temporary
             ``TraceDir``.  An ``{"observability": ...}`` line follows the
             resilience line, and each kernel's entry of the kernels line
             carries its ledger.
19. stream - out-of-core streaming (``phase_stream``): (a) a
             ``--stream-rows`` (5e6) CSV of ``i`` (int64 over 2e9), ``f``
             (float64, 20 % NaN) and ``k`` (1000 keys) under a 128 MiB
             ``DeviceMemoryBudget`` (``StreamMode`` Auto): a filtered sum and
             mean and a filtered grouped sum and mean, each streamed in
             windows, against the resident port (no budget) and pandas (ints
             exactly, floats to 1e-12 of the magnitudes they sum), with the
             windows, the prefetch's overlap and wait seconds, the device
             peak against the budget plus one window's working set, and the
             launch ledger's launches (bincount, groupagg and fused each
             above 0); (b) ``sort_values`` of a ``--stream-sort-rows`` (5e6)
             frame by an int64 key with ties and by a float64 key with NaN,
             in both directions, under 64 MiB, external against resident
             and pandas, exactly; (c) an inner and a left ``merge`` of half
             by a tenth of ``--stream-rows`` with misses under 32 MiB; (d) a
             device loss injected into window 3 of a 2e6-row stream under 32
             MiB, past the seams, raising and replaying that one window;
             each part's ``port_ms``, ``resident_ms`` and ``pandas_ms``, and
             ``defaults_to_pandas`` 0.
20. mesh   - the row-shard mesh and the range shuffle (``phase_mesh``) under
             ``MeshShape`` (4, 1): four shards on one card, or on distinct
             cards where there are several (a line says which).  Each query
             runs once to warm up and once timed.  (e) the
             layout router's calibration on this mesh (the shuffle's sharded
             sort, the block exchange's bytes a second) and its Auto
             verdicts with their predicted costs; then, each query under
             ``SpmdMode`` Sharded held bit for bit against ``SpmdMode``
             Local and exactly against pandas (order, dtypes, index): (a)
             ``sort_values`` of a ``--mesh-rows`` (1e7) frame by an int64
             key with ties and by a float64 key with NaN and +/-inf, both
             directions, nine payload columns; (b) ``median``,
             ``quantile``, ``nunique`` and ``mode`` of the float key and of a
             wide int column through the sharded sorted representation; (c)
             inner, left and outer merges of ``--mesh-rows`` x a fifth of it
             with misses; (d) ``groupby(k).apply(udf)`` over 1e6 rows and
             1000 keys.  Each sharded query's ``port_ms`` beside the local
             path's and pandas', the shuffle's stages by CUDA events (sample,
             pack, exchange, compaction, gather), the exchange's bytes and
             rate, ``collective_bytes``, rows a shard, slack retries, the
             device peak and ``defaults_to_pandas`` 0, and the phase's
             bincount launches (the shuffle's per-destination counts).
21. serve  - multi-tenant serving (``phase_serve``): ``serving.submit``
             from threads on one card over a ``--serve-rows`` (1e7) frame of
             float64 ``a``, ``b``, ``c``, int64 ``i`` and a key ``k`` of 100
             values, ``ViewsMode`` Off so that every query runs its kernels.
             (f) first, lockdep off: one query alone with serving off and
             on (a no-op and the chain sum), us a query, and no context or
             validator object made while off; ns of one acquisition of a
             bare ``threading`` lock, a named lock and a named lock on the
             validating methods; with ``--parent-checkout`` a host-bound
             hot path (chain sum and filtered mean on 4096 rows) on the
             earlier commit and on this one, processes of their own in the
             order parent, this, this, parent, this, parent, parent, this.  Then, under strict lockdep:
             (a) 200 queries of a mix (``(a * b + c).sum()`` and a filtered
             mean on ``fused.cu``, grouped sum and mean on ``groupagg.cu``,
             grouped size on ``bincount.cu``, a ``sort_values`` head) by
             three tenants weighted 2 : 1 : 1 from 8 threads, at
             ``ServingMaxConcurrent`` 1, 2, 4 and 8: each result bit for bit
             the query's serial run (held to pandas: exact, or floats to
             1e-12 of the magnitudes summed), queries/s, p50/p99 wall and
             execution, the queries executing at once, the dispatch lock's
             held share and wait, the slowest query, device memory, OOM and
             spill tallies and GC pauses, each kernel's launches; then 48
             queries at MaxConcurrent 8 with tracing on: the launch ledger's
             CUDA event pairs from eight threads, its launches equal to the
             wrappers' and each one timed; (b) a burst of 16 at MaxConcurrent 1 and QueueDepth
             2: 13 typed ``queue_full`` sheds, as the snapshot counts them;
             (c) a deadline expiring in the queue and one mid-query, both
             ``DeadlineExceeded``, with their overshoots, then 16 mid-query
             deadlines while 7 threads keep MaxConcurrent 8 busy (each
             raised, at a seam or waiting for the dispatch lock); (d) byte
             headroom under a ``DeviceMemoryBudget`` of the residency plus
             two working sets (the residency past 0.9 of it): admissions
             queue (none shed or degraded), two at most run with costs set
             to half the budget, and the budget over the billed cost at
             most with the costs the gate billed for earlier served runs,
             the device peak within the budget plus one query's working
             set; then a budget of 0.9 of the residency, every query
             answered on the card through spills; (e) a breaker opened by
             injected faults:
             the typed ``degraded`` shed, nothing run or sent to pandas.
             The observed lock edges, 0 violations, and the launches.
22. ingest - continuous ingestion and durability (``phase_ingest``): (a) a
             feed (``k`` unique int64, ``i`` int64, ``x`` float64, ``g`` of
             1000 groups, ``ts`` seconds) bootstrapped with ``--ingest-rows``
             (5e6) rows in one append, then 100 micro-batches of 1e4 rows,
             with five live views (``sum(x)``, ``mean(x) where i > 0``,
             ``groupby(g).mean(x)``, ``topk(x, 10)``, a count over 60 s
             buckets of ``ts``): each read held to pandas over the admitted
             rows (ints exactly, float sums and means to 1e-12 of the
             magnitudes they sum) and to ``feed.recompute`` on the card, the
             read's, the recompute's and pandas' ms; the ad-hoc
             ``frame["x"].sum()`` and ``frame.groupby("g")["x"].sum()``
             every 10 batches against pandas, folding (the views registry's
             counts); the append's p50/p99 with the mirror's concat, the
             batch's upload and the device concat timed apart (each ended
             by a synchronise); the zero-row frame of a new feed and every
             grown frame on ``cuda``; (b) a keyed feed of 1e6 rows under a
             retention of 1e6 and 10 upsert batches of 1e4 rows, half of
             their keys stored: every (integer or order-free) view exactly
             pandas' after each upsert, the frame exactly pandas' at the
             end, the re-upload and the key-index rebuild timed per call;
             (c) a child process on the card: a durable GroupCommit feed of
             1e6 rows, micro-batches of 1e3 rows until 40 records past
             ``WalMaxReplayBatches`` a ``DiskFaultInjector("torn_write")``
             SIGKILLs it; this process reopens it: one ``wal.torn_tail``,
             the checkpoint loaded, the replayed records, the frame and
             every view pandas' over the acked batches, the checkpoint's
             bytes and ms and the recovery's ms; (d) four threads append and
             read a durable feed through ``ServingEnabled`` at
             MaxConcurrent 4 under strict lockdep: 0 violations, the four
             ingest edges observed.  ``DEFAULTS_TO_PANDAS`` 0 and bincount,
             groupagg and fused each launched in the phase.
23. fleet  - the replicated serving fleet and live telemetry
             (``phase_fleet``) over a ``--fleet-rows`` (2e6) Parquet file
             (``k`` int64 of 1000 groups, ``i`` int64, ``x`` float64): (a)
             the fleet off: ``fleet.submit`` bit for bit the local serving
             answer, no fleet object or thread made; then, with strict
             lockdep and the launch ledger here and in every replica, (b)
             three replica processes on the card (spawn-to-hello seconds
             each) warmed through ``register_dataset(..., "read_parquet",
             path)``; 240 catalog queries from 8 threads of 3 tenants, each
             answer held to pandas (ints exactly, float sums and means to
             1e-12 of the magnitudes summed), the routed p50 and p99; each
             replica's wrapper and ledger launches (``bincount`` and
             ``groupagg`` in every one), pandas defaults 0, lockdep clean;
             (c) kill -9 of a replica under the same load: every query a
             result or a typed rejection before its join deadline, the
             MTTR from the kill to the slot respawned, warmed and routable,
             ``fleet.replica.lost``/``fleet.drain.redistributed``/
             ``fleet.replica.respawned`` in this process's meters, the
             respawned replica's ``view.ingest`` and a direct grouped sum
             there answered warm with no launch; (d) a crash inside the
             next respawn's warm request, and the retry; (e) the watch
             service here: 8 serving sessions under a 25 ms SLO with an
             80 ms slow deploy injected, ``/metrics`` scraped mid-load and
             parsed, ``slo_burn`` tripped with exactly one evidence bundle
             of four legs, ``/statusz`` and ``/debug/queries``, a feed's
             fold lag tripping ``fold_lag``.

The main-path and relational phases run at ``--earlier-rows`` (1e7 by
default), the float phase at ``--float-rows`` (5e6), the arithmetic phase at
``--arithmetic-rows`` (7.5e6), the io, window, clean, dates and plan phases
at ``--io-rows``, ``--window-rows``, ``--clean-rows``, ``--dates-rows`` and
``--plan-rows`` (2.5e6 each), the
fusion phase at ``--fusion-rows`` (1e7), phase 15's CSV queries at
``--donation-rows`` (5e6), phase 16 at ``--views-rows`` (1e6) and
``--views-time-rows`` (5e7), phase 21 at ``--serve-rows`` (1e7), phase 22 at ``--ingest-rows`` (5e6) and phase 23
at ``--fleet-rows`` (2e6) so that the
whole script stays near half of its time limit; the kernel checks run at ``--rows``.  ``--phases``
picks the phases after the kernel check for a quick run; only a run of all
of them prints the result lines.  Then the card's name and power limit, one
``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``.  Any mismatch raises and the process
exits non-zero.  Without a CUDA card, or without the package beside this
file, it exits non-zero and prints no result.
"""

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ALL_PHASES = ("main", "float", "relational", "arithmetic", "io", "window", "clean", "dates", "fusion", "plan",
              "formats", "memory", "views", "robust", "trace", "stream", "mesh", "serve", "ingest", "fleet")
# H100 SXM device-memory rate (NVIDIA data sheet), for the bound of a kernel
HBM_BYTES_PER_S = 3.35e12
FLOAT_RTOL = 1e-12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn):
    """(result, wall ms) of ``fn`` ended by a device synchronise."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def make_frame_data(rows: int, seed: int, cols: int = 10, ngroups=None) -> dict:
    """The asv recipe (asv_bench/benchmarks/utils.py::make_frame)."""
    rng = np.random.default_rng(seed)
    data = {f"col{i}": rng.integers(0, 100, rows) for i in range(cols)}
    if ngroups is not None:
        data["groupby_col"] = rng.integers(0, ngroups, rows)
    return data


def mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def free_device_memory() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- #
# 1-2. device and build
# ---------------------------------------------------------------------- #


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    try:
        import pandas

        pandas_version = pandas.__version__
    except ImportError:
        pandas_version = None
    emit({
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "pandas": pandas_version,
        "mem_available_gib": round(mem_available_gib(), 1),
    })
    return smi


def phase_build() -> None:
    from modin_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    paths = build.build_all()
    emit({
        "phase": "build",
        "seconds": round(time.perf_counter() - t0, 3),
        "libraries": {k: os.path.relpath(v, HERE) for k, v in paths.items()},
        "ptxas": {k: ptxas_by_kernel(v) for k, v in build.BUILD_LOGS.items()},
    })


def kernel_label(mangled: str) -> str:
    """A kernel instantiation's readable name: a scan kernel's mode, dtype
    and codes, a fused kernel's rows a thread and block size, a groupagg
    kernel's aggregation and its stage's groups and column batch (the
    bincount kernels keep their own names)."""
    m = re.search(r"fused_kernelILi(\d)ELi(\d+)E", mangled)
    if m:
        return f"fused_kernel_k{m.group(1)}_t{m.group(2)}"
    m = re.search(r"groupagg_(kernel|merge)ILi(\d)E(?:Li(\d)ELi(\d)E)?", mangled)
    if m:
        aggs = ("sum", "prod", "count", "mean", "min", "max")
        tail = f"_k{m.group(3)}_b{m.group(4)}" if m.group(3) else ""
        return f"groupagg_{m.group(1)}_{aggs[int(m.group(2))]}{tail}"
    if "fused_merge" in mangled:
        return "fused_merge"
    m = re.search(r"SegOpI([ld])\w*?(Add|Mul|Max|Min)[IF]ELb([01])", mangled)
    if m:
        dtype = "i64" if m.group(1) == "l" else "f64"
        return f"seg_{m.group(2).lower()}_{dtype}" + ("_codes" if m.group(3) == "1" else "")
    return "linear" if "LinearOp" in mangled else mangled


def ptxas_by_kernel(log: str) -> dict:
    """``nvcc -Xptxas -v``'s registers, shared memory, stack and spills of
    each kernel of one build."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = kernel_label(m.group(1))
            out[name] = []
        elif name is not None and ("registers" in ln or "spill" in ln):
            out[name].append(ln.split("ptxas info    :")[-1].strip())
    return out


# ---------------------------------------------------------------------- #
# 3. the kernel against its plain version
# ---------------------------------------------------------------------- #


def phase_kernel(rows: int, seed: int, parent: str = None) -> dict:
    import torch

    from modin_tpu_torch.ops.cuda import groupby_kernels as gk

    dev = torch.device("cuda", torch.cuda.current_device())
    cap = gk.smem_slots(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    by_width = {}
    max_err = 0

    def check_and_time(codes, width, label):
        nonlocal max_err
        got = gk.bincount(codes, width)
        want = gk.bincount_plain(codes, width)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if width else 0
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"bincount != bincount_plain ({label}, width {width}): max err {err}")
        n = codes.numel()
        rec = {
            "phase": "kernel", "case": label, "n": n, "width": width,
            "mode": "shared" if width <= cap else "global",
            "exact": True,
            "kernel_ms": cuda_ms(lambda: gk.bincount(codes, width)),
            "plain_ms": cuda_ms(lambda: gk.bincount_plain(codes, width)),
            "library_ms": cuda_ms(lambda: torch.bincount(codes, minlength=width)),
            "bound_ms": (8 * n + 8 * width) / HBM_BYTES_PER_S * 1e3,
        }
        emit(rec)
        return rec

    for n in (rows, rows + 77):
        for width in (3, 100, 512, 10_000, cap, cap + 1, 10**6, 1 << 22):
            # codes in [0, width]: the top value is the overflow bucket
            codes = torch.randint(0, width + 1, (n,), device=dev, generator=gen)
            rec = check_and_time(codes, width, "uniform+overflow")
            if n == rows:
                by_width[width] = rec
            del codes
    for width in (100, cap + 1):
        codes = torch.full((rows,), 7, dtype=torch.int64, device=dev)
        check_and_time(codes, width, "one_slot")
        del codes
    free_device_memory()
    return {"cap": cap, "by_width": by_width, "max_abs_err": max_err, "scan": scan_check(rows, seed),
            "fused": fused_check(rows, seed, parent), "groupagg": groupagg_check(rows, seed, parent)}


# ---------------------------------------------------------------------- #
# 3d. the fused groupby's groupagg kernel against its plain version
# ---------------------------------------------------------------------- #

GROUPAGG_WIDTHS = (8, 100, 10_000, 65_536)
GROUPAGG_DTYPES = ("int8", "int64", "float32", "float64")
# half the aggregations a width: each table shape (eight copies at widths 8
# and 100, one copy at 10 000, slot ranges at 65 536) meets every aggregation
# over every dtype
GROUPAGG_AGGS = {8: ("mean", "max", "prod"), 100: ("sum", "min", "count"),
                 10_000: ("sum", "min", "count"), 65_536: ("mean", "max", "prod")}
GROUPAGG_REPEATS = 2
# the eager route's widths: around ops/route.py's ATOMIC_MAX_SLOTS
GROUPAGG_EAGER_WIDTHS = (100, 1000, 4000, 10_000)
# phase 13's fused groupbys by d: case -> (aggregation, value columns)
PLAN_GROUPBY_CASES = {
    **{f"plan13_{agg}": (agg, ("b", "f") if agg == "prod" else ("a", "c"))
       for agg in ("sum", "mean", "count", "min", "max", "prod")},
    "plan13_sum_five_columns": ("sum", ("a", "b", "c", "e", "f")),
}
def plan_columns(rows: int, seed: int, dev) -> dict:
    """Phase 13's columns (``plan_csv``'s distributions) on the card:
    ``a`` int64 in [-50, 50), ``b`` uniform [0, 1), ``c`` uniform [-1, 1),
    ``d`` int64 in [0, 1000) (the groupby key), ``e`` uniform [0, 100),
    ``f`` int64 0/1."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)

    def uniform(lo, hi):
        return torch.rand(rows, dtype=torch.float64, device=dev, generator=gen) * (hi - lo) + lo

    return {
        "a": torch.randint(-50, 50, (rows,), device=dev, generator=gen),
        "b": uniform(0.0, 1.0),
        "c": uniform(-1.0, 1.0),
        "d": torch.randint(0, 1000, (rows,), device=dev, generator=gen),
        "e": uniform(0.0, 100.0),
        "f": torch.randint(0, 2, (rows,), device=dev, generator=gen),
    }


def groupagg_check(rows: int, seed: int, parent: str = None) -> dict:
    """``groupagg.cu`` against ``groupagg_plain`` at ``rows`` rows, bit for
    bit and repeating.  First one column by the slots of key ranges of 8,
    100, 10 000 and 65 536 values (``fused_groups_bucket`` slots, about a
    tenth of the rows in the overflow slot, as a filter drops them): an
    int8, an int64, a float32 and a float64 column (1 % NaN), half the
    aggregations at each width (``GROUPAGG_AGGS``), so that each table
    shape meets every aggregation over every dtype.  Then the eager path's
    shapes, int64 codes as slots: a float64 sum by int64 codes (a tenth of
    the rows on the overflow code), an int64 sum and min and a float64 sum
    by codes of ``GROUPAGG_EAGER_WIDTHS`` groups with no overflow row (the
    widths around the route gate's ``ATOMIC_MAX_SLOTS``), and the main
    path's ten int64 columns by 101 codes in sum and mean.  Then phase 13's fused groupbys at this size: the slot
    column the fused kernel writes for ``a > 0`` by the 1000-value key
    ``d`` (``fused_slot_expr``, 1025 slots), and every aggregation over the
    columns phase 13 passes (``PLAN_GROUPBY_CASES``: an int64 and a float64
    column, ``b`` and ``f`` for prod, and all five for a sum).
    Times of the kernel, the plain version (one run) and one torch call
    computing the same function (``index_add_`` for sum and mean's sum,
    ``scatter_reduce_`` for min, max and prod, one call a column over the
    1-D column widened to one dtype; ``torch.bincount`` for count; and the
    same call on the kept rows alone, ``library_kept_ms``, where rows lie in
    the overflow slot, which the kernel skips and the call adds into one hot
    slot), beside the bound: the slot and the values read once a row at
    3.35 TB/s.  Then
    the grouped float64 sum
    of ``groupby_reduce`` over the factorized codes at 100 and 10 000
    groups on the same rows, on the staged path (``FuseMode=Staged``) and
    on ``groupagg`` (``Fused``), and the seconds the check took.  With
    ``parent`` (an earlier commit's checkout) that commit's kernel times on
    the same cases (``parent_ms``), from a process of its own run first."""
    import torch

    from modin_tpu_torch.config import FuseMode
    from modin_tpu_torch.ops import elementwise as ew
    from modin_tpu_torch.ops import groupby as gb_ops
    from modin_tpu_torch.ops import lazy
    from modin_tpu_torch.ops.cuda import build
    from modin_tpu_torch.ops.cuda import groupagg_kernels as ga

    parent_ms = parent_groupagg_times(parent, rows, seed) if parent else {}
    t_check = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    emit({"phase": "kernel", "kernel": "groupagg", "ptxas": ptxas_by_kernel(build.BUILD_LOGS.get("groupagg", ""))})
    by_case, staged, eager = {}, {}, {}

    def check(name, agg, slot, cols, g1, width, **extra):
        """One case, bit for bit, repeating and timed."""

        def run():
            return ga.groupagg(agg, slot, cols, g1)

        def plain():
            return ga.groupagg_plain(agg, slot, cols, g1)

        got = run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain()
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"groupagg {name}: {bad} table entries differ from groupagg_plain")
        for _ in range(GROUPAGG_REPEATS):
            if not torch.equal(run(), got):
                raise AssertionError(f"groupagg {name}: a launch did not repeat")
        idx = slot.to(torch.int64)
        fl = any(c.dtype.is_floating_point for c in cols)
        wide = [torch.nan_to_num(c.to(torch.float64), nan=0.0) if fl else c.to(torch.int64) for c in cols]
        accs = [torch.zeros(g1, dtype=w.dtype, device=dev) for w in wide]
        how = {"prod": "prod", "min": "amin", "max": "amax"}.get(agg)

        def library_on(idx, wide):
            if agg == "count":
                return lambda: torch.bincount(idx, minlength=g1)

            def library():
                for a, w in zip(accs, wide):
                    if how is None:
                        a.index_add_(0, idx, w)
                    else:
                        a.scatter_reduce_(0, idx, w, how)
            return library

        library_name = "torch.bincount" if agg == "count" else \
            ("index_add_" if how is None else f"scatter_reduce_({how!r})") + " over 1-D columns, one call a column"
        library_ms = cuda_ms(library_on(idx, wide), reps=3)
        kept = idx < g1 - 1
        dropped_rows = int(slot.shape[0] - kept.sum())
        if dropped_rows:
            # the same call on the kept rows alone (compacted untimed): the
            # overflow slot's rows are one hot slot for the atomics
            idx_k, wide_k = idx[kept], [w[kept] for w in wide]
            library_kept_ms = cuda_ms(library_on(idx_k, wide_k), reps=3)
            del idx_k, wide_k
        else:
            library_kept_ms = library_ms
        geo = ga.launch_geometry(slot.shape[0], g1, len(cols))
        row_bytes = slot.element_size() + sum(c.element_size() for c in cols)
        rec = {
            "phase": "kernel", "kernel": "groupagg", "case": name, "n": slot.shape[0], "agg": agg,
            "width": width, "slots": g1, "columns": len(cols), "slot_dtype": str(slot.dtype),
            "blocks": geo.blocks, "chunk": geo.chunk, "copies": geo.copies, "ranges": geo.ranges,
            "stages": geo.stages, "stage_groups": geo.stage_groups, "tables": "shared",
            "exact": True, "max_abs_err": 0.0,
            "kernel_ms": cuda_ms(run, reps=3), "parent_ms": parent_ms.get(name),
            "plain_ms": plain_ms, "plain_runs": 1,
            "library_ms": library_ms, "library": library_name, "library_kept_ms": library_kept_ms,
            "overflow_rows": dropped_rows,
            "bound_ms": row_bytes * slot.shape[0] / HBM_BYTES_PER_S * 1e3, "bytes_per_row": row_bytes,
            "bound_by": "bytes", **extra,
        }
        emit(rec)
        by_case[name] = rec
        del got, want, wide, accs, kept

    def reduce_ms(mode, codes, values, groups):
        with FuseMode.context(mode):
            return cuda_ms(lambda: gb_ops.groupby_reduce("sum", values, codes, groups, rows), reps=3)

    for width in GROUPAGG_WIDTHS:
        G = gb_ops.fused_groups_bucket(width)
        slot = torch.randint(0, width, (rows,), dtype=torch.int32, device=dev, generator=gen)
        dropped = torch.rand(rows, device=dev, generator=gen) < 0.1
        slot[dropped] = G
        for dtname in GROUPAGG_DTYPES:
            dtype = getattr(torch, dtname)
            if dtype.is_floating_point:
                x = torch.randn(rows, dtype=torch.float64, device=dev, generator=gen).to(dtype)
                x[torch.rand(rows, device=dev, generator=gen) < 0.01] = float("nan")
            else:
                lo, hi = (-100, 100) if dtname == "int8" else (-2**40, 2**40)
                x = torch.randint(lo, hi, (rows,), dtype=dtype, device=dev, generator=gen)
            for agg in GROUPAGG_AGGS[width]:
                check(f"{agg}_{dtname}_w{width}", agg, slot, [x], G + 1, width)
            del x
            free_device_memory()
        if width in (100, 10_000):
            # the eager path's codes: the overflow code is the group count
            codes = torch.where(dropped, width, slot.to(torch.int64))
            v = torch.randn(rows, dtype=torch.float64, device=dev, generator=gen)
            check(f"sum_float64_int64_codes_w{width}", "sum", codes, [v], width + 1, width)
            staged[width] = reduce_ms("Staged", codes, [v], width)
            eager[width] = reduce_ms("Fused", codes, [v], width)
            emit({"phase": "kernel", "kernel": "groupagg", "case": f"groupby_reduce_sum_float64_w{width}", "n": rows,
                  "staged_ms": staged[width], "groupagg_route_ms": eager[width],
                  "groupagg_ms": by_case[f"sum_float64_int64_codes_w{width}"]["kernel_ms"],
                  "note": "groupby_reduce over the codes: the staged path's grouped sum (FuseMode=Staged) "
                          "and the groupagg route (Fused: the launch, finish and the result's slice)"})
            del codes, v
        del slot, dropped
        free_device_memory()
    # the eager route's gate: int64 codes with no overflow row (no NaN key),
    # one int64 or float64 column, where the staged path's atomics stop
    # contending (ops/route.py ATOMIC_MAX_SLOTS)
    for width in GROUPAGG_EAGER_WIDTHS:
        codes = torch.randint(0, width, (rows,), device=dev, generator=gen)
        xi = torch.randint(-2**40, 2**40, (rows,), device=dev, generator=gen)
        xf = torch.randn(rows, dtype=torch.float64, device=dev, generator=gen)
        check(f"eager_sum_int64_w{width}", "sum", codes, [xi], width + 1, width)
        check(f"eager_min_int64_w{width}", "min", codes, [xi], width + 1, width)
        check(f"eager_sum_float64_w{width}", "sum", codes, [xf], width + 1, width)
        del codes, xi, xf
        free_device_memory()
    # the main path's shape: ten int64 columns (asv make_frame's values) by
    # 100 groups' codes, the overflow code last
    codes = torch.randint(0, 100, (rows,), device=dev, generator=gen)
    main_cols = [torch.randint(0, 100, (rows,), device=dev, generator=gen) for _ in range(10)]
    for agg in ("sum", "mean"):
        check(f"main_{agg}_int64x10_w100", agg, codes, main_cols, 101, 100)
    staged["main_int64x10"] = reduce_ms("Staged", codes, main_cols, 100)
    eager["main_int64x10"] = reduce_ms("Fused", codes, main_cols, 100)
    emit({"phase": "kernel", "kernel": "groupagg", "case": "groupby_reduce_sum_int64x10_w100", "n": rows,
          "staged_ms": staged["main_int64x10"], "groupagg_route_ms": eager["main_int64x10"],
          "note": "groupby_reduce of the main path's shape: staged (one index_add_ a column) and groupagg"})
    del codes, main_cols
    free_device_memory()
    one_column_s = time.perf_counter() - t_check
    # phase 13's fused groupby, its slot column written as the path writes it
    cols = plan_columns(rows, seed, dev)
    keep = ew.binary_op_columns("gt", [cols["a"]], 0)[0]
    kmin, kmax, kept = gb_ops.fused_group_probe(cols["d"], keep, rows)
    G = gb_ops.fused_groups_bucket(kmax - kmin + 1)
    slot = lazy.materialize_exprs([gb_ops.fused_slot_expr(cols["d"], keep, kmin, G)])[0]
    for name, (agg, names) in PLAN_GROUPBY_CASES.items():
        check(name, agg, slot, [cols[c] for c in names], G + 1, kmax - kmin + 1,
              value_columns="".join(names), kept=kept)
    del cols, keep, slot
    free_device_memory()
    seconds = time.perf_counter() - t_check
    emit({"phase": "kernel", "kernel": "groupagg", "cases": len(by_case), "seconds": seconds,
          "one_column_seconds": one_column_s, "plan13_seconds": seconds - one_column_s})
    return {"by_case": by_case, "max_abs_err": 0.0, "staged_ms": staged, "groupagg_route_ms": eager,
            "seconds": seconds}


# ---------------------------------------------------------------------- #
# 3b. the scan kernel against its plain version
# ---------------------------------------------------------------------- #

# unit roundoff of float64
U64 = 2.0 ** -53


def scan_tolerance_factor(n: int) -> float:
    """Relative bound (to the same scan of absolute values) between the
    kernel and the plain doubling scan on float64.  An output passes
    through at most ceil(log2 n) combines in the plain scan, and in the
    kernel at most ceil(log2 tiles) + 56 (csrc/scan.cu's note: 16 + 5 + 11
    to a tile's total, ceil(log2 tiles) + 5 into the carry, 2 + 17 into the
    row), tiles <= n; a combine rounds twice in the linear mode.
    4 ceil(log2 n) + 64 steps cover both with room, times 2 roundings,
    times the unit roundoff."""
    return 2 * (4 * int(np.ceil(np.log2(max(n, 2)))) + 64) * U64


# launches of each scan case compared bit for bit with the first
SCAN_REPEATS = 10


def scan_bytes_per_row(mode: str, aux) -> int:
    """Bytes the scan must move a row: each input read once, y written once
    (linear: a, b, y; segmented: values[, codes], y)."""
    return 24 if (mode == "linear" or aux is not None) else 16


def scan_check(rows: int, seed: int) -> dict:
    """``scan`` against ``scan_plain`` on the card at ``rows`` rows: linear
    over float64 (a in (0, 1], b normal), seg_add and seg_max over int64
    and float64 with sorted codes of 100 and 10 000 groups, seg_add without
    codes (the function of ``torch.cumsum``), seg_max and reverse seg_min
    over int64 without codes (``rank``'s passes), and block-width scans forward
    and in reverse (the van Herk blocks of the rolling windows).  Ints
    exactly, floats within ``scan_tolerance_factor`` times the scan of
    absolute values (max exactly); ``SCAN_REPEATS`` launches bitwise equal;
    times of the kernel, the plain version and ``torch.cumsum`` (the same
    function only for seg_add without codes; elsewhere an unsegmented
    yardstick, ``cumsum_ms``); the bound from each case's own bytes.  Then
    ragged and misaligned shapes (not timed)."""
    import torch

    from modin_tpu_torch.ops.cuda import scan_kernels as sk

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    factor = scan_tolerance_factor(rows)
    by_case = {}
    max_err = 0.0

    def compare(case: str, mode: str, x, aux, got, **kw):
        want = sk.scan_plain(mode, x, aux, **kw)
        err = float((got - want).abs().max()) if got.dtype.is_floating_point else float((got != want).sum())
        if mode in ("seg_max", "seg_min") or not got.dtype.is_floating_point:
            if not torch.equal(got, want):
                raise AssertionError(f"scan {case}: != scan_plain")
            return err, "exact"
        # a product of m factors rounds m - 1 times in any association:
        # 2 n u of the product of |x| bounds the two versions' difference
        f = 2 * x.shape[0] * U64 if mode == "seg_mul" else factor
        if mode == "linear":
            z = sk.scan_plain("linear", x.abs(), aux.abs(), **kw)
        else:
            z = sk.scan_plain(mode, x.abs(), aux, **kw)
        bad = int(((got - want).abs() > f * z).sum())
        if bad:
            raise AssertionError(f"scan {case}: {bad} values beyond {f:.3g} x the scan of |x|")
        return err, f"|kernel - plain| <= {f:.3g} * scan(|x|)"

    def check(case: str, mode: str, x, aux, groups, **kw):
        nonlocal max_err
        got = sk.scan(mode, x, aux, **kw)
        for _ in range(SCAN_REPEATS - 1):
            again = sk.scan(mode, x, aux, **kw)
            if got.dtype.is_floating_point:
                same = torch.equal(got.view(torch.int64), again.view(torch.int64))
            else:
                same = torch.equal(got, again)
            if not same:
                raise AssertionError(f"scan {case}: {SCAN_REPEATS} launches differ")
            del again
        torch.cuda.synchronize()
        err, tol = compare(case, mode, x, aux, got, **kw)
        max_err = max(max_err, err)
        del got
        n = x.shape[0]
        cumsum_ms = None if mode == "linear" else cuda_ms(lambda: torch.cumsum(x, 0))
        # one torch call computes the same function: cumsum without codes,
        # and forward blocks of w rows as the rows of an [n / w, w] view
        w = kw.get("width", 0)
        library_ms = library = None
        if mode == "seg_add" and aux is None and not kw.get("reverse", False):
            if w == 0:
                library_ms, library = cumsum_ms, "torch.cumsum (the same function)"
            elif n % w == 0:
                library_ms = cuda_ms(lambda: torch.cumsum(x.view(-1, w), 1))
                library = f"torch.cumsum over [n / {w}, {w}] along dim 1 (the same function)"
        rec = {
            "phase": "kernel", "kernel": "scan", "case": case, "mode": mode, "n": n,
            "groups": groups, "dtype": str(x.dtype).replace("torch.", ""), "tolerance": tol,
            "width": w, "reverse": kw.get("reverse", False),
            "max_abs_err": err, "bitwise_repeat": SCAN_REPEATS,
            "kernel_ms": cuda_ms(lambda: sk.scan(mode, x, aux, **kw)),
            "plain_ms": cuda_ms(lambda: sk.scan_plain(mode, x, aux, **kw)),
            "library_ms": library_ms,
            "library": library,
            "cumsum_ms": cumsum_ms,
            "bytes_per_row": scan_bytes_per_row(mode, aux),
            "bound_ms": scan_bytes_per_row(mode, aux) * n / HBM_BYTES_PER_S * 1e3,
        }
        emit(rec)
        by_case[case] = rec

    a = 1.0 - torch.rand(rows, dtype=torch.float64, device=dev, generator=gen)
    b = torch.randn(rows, dtype=torch.float64, device=dev, generator=gen)
    check("linear_f64", "linear", a, b, None)
    del a, b
    free_device_memory()
    xi = torch.randint(-(2**40), 2**40, (rows,), device=dev, generator=gen)
    xf = torch.randn(rows, dtype=torch.float64, device=dev, generator=gen)
    for groups in (100, 10_000):
        codes = torch.sort(torch.randint(0, groups, (rows,), device=dev, generator=gen)).values
        for mode in ("seg_add", "seg_max"):
            check(f"{mode}_i64_g{groups}", mode, xi, codes, groups)
            check(f"{mode}_f64_g{groups}", mode, xf, codes, groups)
        del codes
        free_device_memory()
    check("seg_add_f64_nocodes", "seg_add", xf, None, 1)
    check("seg_add_i64_nocodes", "seg_add", xi, None, 1)
    # rank's first-of-tie and last-of-tie passes, without codes
    check("seg_max_i64_nocodes", "seg_max", xi, None, 1)
    check("seg_min_i64_nocodes_rev", "seg_min", xi, None, 1, reverse=True)
    for w in (10, 1000):
        check(f"seg_add_f64_w{w}", "seg_add", xf, None, None, width=w)
        check(f"seg_add_f64_w{w}_rev", "seg_add", xf, None, None, width=w, reverse=True)
    check("seg_max_f64_w1000_rev", "seg_max", xf, None, None, width=1000, reverse=True)
    del xi, xf
    free_device_memory()
    edges = scan_edge_check(seed, compare)
    return {"by_case": by_case, "max_abs_err": max(max_err, edges), "edges": True}


def scan_edge_check(seed: int, compare) -> float:
    """Ragged lengths around the kernel's tile (``scan_tile_rows()``) and inputs that
    start 8 bytes past a 16-byte boundary (the bulk copy's edge rows), in
    every mode, forward and reverse, with codes and block widths."""
    import torch

    from modin_tpu_torch.ops.cuda import scan_kernels as sk

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    worst, cases = 0.0, 0
    tile = int(sk._lib().scan_tile_rows())
    for n in (1, 2, 3, tile - 1, tile, tile + 1, 2 * tile + 1, 1_000_003):
        for offset in (0, 1):
            m = n + offset
            xf = torch.randn(m, dtype=torch.float64, device=dev, generator=gen)[offset:]
            xi = torch.randint(-(2**40), 2**40, (m,), device=dev, generator=gen)[offset:]
            a = (1.0 - torch.rand(m, dtype=torch.float64, device=dev, generator=gen))[offset:]
            codes = torch.sort(torch.randint(0, 7, (m + 1,), device=dev, generator=gen)).values[1:][offset:]
            runs = [("linear", a, xf, {}), ("linear", a, xf, {"reverse": True})]
            for mode in sk.MODES[1:]:
                for x in (xi, xf if mode != "seg_mul" else 1.0 + 1e-3 * xf):
                    runs += [(mode, x, codes, {}), (mode, x, None, {"reverse": True}),
                             (mode, x, codes, {"width": 5, "reverse": True}), (mode, x, None, {"width": tile})]
            for mode, x, aux, kw in runs:
                case = f"edge {mode} n={n} offset={offset} {kw}"
                got = sk.scan(mode, x, aux, **kw)
                torch.cuda.synchronize()
                worst = max(worst, compare(case, mode, x, aux, got, **kw)[0])
                cases += 1
    emit({"phase": "kernel", "kernel": "scan", "case": "edges", "checked": cases, "max_abs_err": worst})
    return worst


# ---------------------------------------------------------------------- #
# 3c. the fused elementwise kernel against its plain version
# ---------------------------------------------------------------------- #

# H100 SXM float64 rate outside the tensor cores (NVIDIA data sheet), for
# the operations bound of a float64 program
F64_FLOPS = 34e12
FUSED_REPEATS = 10


def fused_program_150(leaves):
    """A 150-node float64 chain over 8 leaf columns (120 column ops, 30 by
    a scalar): one program of 151 instructions, near the kernel's caps."""
    from modin_tpu_torch.ops import elementwise as ew

    e = ew.binary_op_columns("mul", [leaves[0]], [leaves[1]])[0]
    ops = ("add", "sub", "mul", "add")
    for k in range(1, 150):
        if k % 5 == 0:
            e = ew.binary_op_columns("mul", [e], 0.5)[0]
        else:
            e = ew.binary_op_columns(ops[k % 4], [e], [leaves[k % 8]])[0]
    return e


GRID_ROWS = 4099
GRID_DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "float32", "float64")
GRID_BINARY = ("add", "sub", "mul", "truediv", "floordiv", "mod", "pow", "eq", "ne", "lt", "le", "gt", "ge",
               "__and__", "__or__", "__xor__", "radd", "rsub", "rtruediv", "rfloordiv", "rmod", "rpow")
GRID_SCALARS = (2, -3, 2.5, 0.1, 0.5, -1, 3, -0.5, -2, True, np.float32(1.5), np.int8(3))


def fused_grid_check(seed: int) -> dict:
    """One node of every op the fused kernel takes, over columns of every
    dtype (NaN, +/-inf, +/-0.0 and the int extremes among them) against a
    column of every dtype or a scalar: the kernel against
    ``run_program_plain`` on the card, bit for bit.  Pairs the eager op
    refuses (``bool - bool``, bitwise ops of floats) are skipped, as the
    deferred op refuses them too."""
    import torch

    from modin_tpu_torch.ops import elementwise as ew
    from modin_tpu_torch.ops import lazy
    from modin_tpu_torch.ops.cuda import fused_kernels as fk

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(seed + 11)

    def column(dt):
        if dt == "bool":
            return rng.random(GRID_ROWS) < 0.5
        if dt.startswith("float"):
            x = rng.normal(0, 10, GRID_ROWS)
            x[rng.random(GRID_ROWS) < 0.1] = np.nan
            x[:8] = [np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.5, 2.0]
            return x.astype(dt)
        info = np.iinfo(dt)
        x = rng.integers(max(info.min, -100), min(info.max, 100), GRID_ROWS).astype(dt)
        x[:4] = [info.min, info.max, 0, 1 if info.min == 0 else -1]
        return x

    cols = {dt: torch.as_tensor(column(dt)).to(dev) for dt in GRID_DTYPES}
    cases = 0

    def check(op, *args, static=()):
        nonlocal cases
        try:
            expr = lazy.lazy_op(op, *args, static=static)
        except (RuntimeError, TypeError, OverflowError):
            return
        if not isinstance(expr, lazy.LazyExpr):
            return  # a barrier: the eager op itself
        lin, plan = lazy._plan([expr], None)
        leaves = lazy._leaf_args(lin, plan[0])
        got = fk.run_program(plan[0], leaves, lin.scalars, GRID_ROWS)[0][0]
        want = fk.run_program_plain(plan[0], leaves, lin.scalars, GRID_ROWS)[0][0]
        g, w = (t.view(torch.int64 if t.element_size() == 8 else torch.int32) if t.is_floating_point() else t
                for t in (got, want))
        if got.dtype != want.dtype or not torch.equal(g, w):
            raise AssertionError(f"fused grid: {op} {[getattr(a, 'dtype', a) for a in args]} {static}: "
                                 "the kernel differs from run_program_plain")
        cases += 1

    for op in GRID_BINARY:
        for dx in GRID_DTYPES:
            for dy in GRID_DTYPES:
                check(op, cols[dx], cols[dy])
            for sc in GRID_SCALARS:
                check(op, cols[dx], sc)
    for dx in GRID_DTYPES:
        x = cols[dx]
        for op in ("abs", "negative", "invert", "isna", "notna", *sorted(ew.MATH_UNARY)):
            check(op, x)
        for d in (-2, -1, 0, 1, 2, 3):
            check("round", x, static=(("decimals", d),))
        for target in GRID_DTYPES:
            check("astype", x, static=(("dtype", target),))
        for v in (0, 1.5, -2):
            try:
                v = ew.cast_scalar(v, x.dtype)
            except OverflowError:
                continue
            for op in ("fillna", "clip_lower", "clip_upper"):
                check(op, x, v)
    nat = cols["int64"].clone()
    nat[::7] = np.iinfo(np.int64).min
    check("isna_nat", nat)
    check("notna_nat", nat)
    rec = {"phase": "kernel", "kernel": "fused", "case": "op_grid", "n": GRID_ROWS, "cases": cases,
           "exact": True, "max_abs_err": 0.0}
    emit(rec)
    return rec


# the cases whose launch shape is timed at every rows-per-thread choice,
# and with and without the prefetch
FUSED_SWEEP = ("axpb_f64", "program_150")
# rows of the cases forced onto the small blocks (32 outputs each: 32 input
# columns, 8 GB at 1e8 rows, and a plain version of many passes)
FUSED_SMALL_BLOCK_ROWS = 2**22 + 37


def parent_fused_times(parent: str, rows: int, seed: int) -> dict:
    """``kernel_ms`` of each case of ``fused_check`` run by the checkout at
    ``parent`` (an earlier commit's ``git archive``) in a process of its
    own, with its own package and kernel build: the same inputs, from the
    same seed, through the parent's ``fused_check`` (its op grid left out)."""
    code = ("import sys; sys.path.insert(0, {p!r}); import chip_smoke as c; "
            "c.fused_grid_check = lambda seed: {{'cases': 0}}; "
            "import modin_tpu_torch; modin_tpu_torch.set_device('cuda'); "
            "c.fused_check({r}, {s})").format(p=parent, r=rows, s=seed)
    free_device_memory()
    proc = subprocess.run([sys.executable, "-c", code], cwd=parent, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the parent's fused check failed:\n{proc.stderr[-4000:]}")
    times = {}
    for ln in proc.stdout.splitlines():
        rec = json.loads(ln) if ln.startswith("{") else {}
        if rec.get("kernel") == "fused" and "kernel_ms" in rec:
            times[rec["case"]] = rec["kernel_ms"]
    return times


def parent_groupagg_times(parent: str, rows: int, seed: int) -> dict:
    """``kernel_ms`` of each case of ``groupagg_check`` run by the checkout
    at ``parent`` in a process of its own, with its own package and kernel
    build, on inputs from the same seed (the cases both checkouts have)."""
    code = ("import sys; sys.path.insert(0, {p!r}); import chip_smoke as c; "
            "import modin_tpu_torch; modin_tpu_torch.set_device('cuda'); "
            "c.groupagg_check({r}, {s})").format(p=parent, r=rows, s=seed)
    free_device_memory()
    proc = subprocess.run([sys.executable, "-c", code], cwd=parent, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the parent's groupagg check failed:\n{proc.stderr[-4000:]}")
    times = {}
    for ln in proc.stdout.splitlines():
        rec = json.loads(ln) if ln.startswith("{") else {}
        if rec.get("kernel") == "groupagg" and "kernel_ms" in rec:
            times[rec["case"]] = rec["kernel_ms"]
    return times


def fused_check(rows: int, seed: int, parent: str = None) -> dict:
    """``fused.cu`` against ``run_program_plain`` on the card at ``rows``
    rows, bit for bit (the plain version takes the kernel's reduction
    order, so a tail's accumulators match too), ten launches repeating bit
    for bit; the times of the kernel, the plain version and, where one
    torch call computes the same function, that call (``torch.addcmul``
    for ``a * b + c`` over float64 and over float32), beside the bound:
    each input read and each output written once at 3.35 TB/s, or the
    float64 operations at 34 TFLOP/s, whichever is larger.  Each case's
    launch shape (threads, rows a thread, shared memory) is printed; the
    ``FUSED_SWEEP`` cases are also checked and timed at 1, 2 and 4 rows a
    thread and with the prefetch on and off (``shape_ms``); the cases
    ``tail32_t64`` and ``tail32_t32`` force a sum tail of 32 outputs onto
    the 64- and 32-thread builds, whose block partials outnumber their
    threads.  With ``parent`` (a checkout of an earlier commit), that
    commit's kernel is timed on the same cases before and after this one's
    (``parent_ms``), and the build's ptxas report of the kernel is
    printed first."""
    import torch

    from modin_tpu_torch.ops.cuda import build

    from modin_tpu_torch.ops import elementwise as ew
    from modin_tpu_torch.ops import lazy
    from modin_tpu_torch.ops.cuda import fused_kernels as fk
    from modin_tpu_torch.ops.cuda import fused_program as fp

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 7)

    def f64():
        return torch.randn(rows, dtype=torch.float64, device=dev, generator=gen)

    def bits(t):
        return t.view(torch.int64) if t.dtype == torch.float64 else t

    emit({"phase": "kernel", "kernel": "fused", "ptxas": ptxas_by_kernel(build.BUILD_LOGS.get("fused", "")),
          "note": "registers, shared memory, stack and spills of each instantiation (empty when this "
                  "process found the build already made)"})
    parent_before = parent_fused_times(parent, rows, seed) if parent else {}
    by_case, worst = {}, 0.0

    def case(name, expr, tail, bytes_per_row, flops_per_row, library=None, library_name=None, n=None,
             shape=None):
        nonlocal worst
        rows_ = n or rows
        lin, plan = lazy._plan(expr if isinstance(expr, list) else [expr], tail)
        if len(plan) != 1:
            raise AssertionError(f"fused {name}: {len(plan)} programs, expected one")
        program = plan[0]
        leaves = lazy._leaf_args(lin, program)
        second = tail is not None and tail[1] in ("var", "std")

        def run(shape=shape):
            outs, acc = fk.run_program(program, leaves, lin.scalars, rows_, _shape=shape)
            if second:
                return fk.run_program(program, leaves, lin.scalars, rows_, second_pass=True, first=acc,
                                      _shape=shape)[1]
            return outs[0] if outs else acc

        def plain():
            outs, acc = fk.run_program_plain(program, leaves, lin.scalars, rows_, _shape=shape)
            if second:
                return fk.run_program_plain(program, leaves, lin.scalars, rows_, second_pass=True, first=acc,
                                            _shape=shape)[1]
            return outs[0] if outs else acc

        got, want = run(), plain()
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"fused {name}: {got.dtype}{tuple(got.shape)} != {want.dtype}{tuple(want.shape)}")
        if tail is None and got.dtype.is_floating_point:
            err = float(torch.nan_to_num((got - want).abs(), nan=0.0).max())
        else:
            gv = got[:, 0].contiguous().view(torch.float64) if tail is not None else got.double()
            wv = want[:, 0].contiguous().view(torch.float64) if tail is not None else want.double()
            err = float((gv - wv).abs().max())
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"fused {name}: the kernel differs from run_program_plain (max abs err {err})")
        err = 0.0  # bit for bit (an int tail's bits read as float64 would give NaN)
        for _ in range(FUSED_REPEATS):
            if not torch.equal(bits(run()), bits(got)):
                raise AssertionError(f"fused {name}: a launch did not repeat bit for bit")
        worst = max(worst, err)
        bound = max(bytes_per_row * rows_ / HBM_BYTES_PER_S, flops_per_row * rows_ / F64_FLOPS) * 1e3
        low = fp.relower(program, **(shape or {}))
        rec = {
            "phase": "kernel", "kernel": "fused", "case": name, "n": rows_,
            "instructions": len(program.instrs), "registers": program.n_regs, "leaves": len(leaves),
            "kernel_instructions": low.n_code, "slots": low.n_slots, "threads": low.threads,
            "rows_per_thread": low.rows_per_thread, "smem_bytes": low.smem_bytes,
            "prefetch": low.prefetch, "long_routines": low.slow,
            "exact": True, "max_abs_err": err,
            "kernel_ms": cuda_ms(run),
            "plain_ms": cuda_ms(plain, reps=3),
            "library_ms": cuda_ms(library) if library is not None else None, "library": library_name,
            "bound_ms": bound, "bytes_per_row": bytes_per_row,
            "bound_by": "bytes" if bytes_per_row / HBM_BYTES_PER_S >= flops_per_row / F64_FLOPS else "operations",
        }
        if name in FUSED_SWEEP:
            k0 = low.rows_per_thread
            shapes = {f"rows_per_thread={k}": {"rows_per_thread": k} for k in fp.ROWS_PER_THREAD}
            for pre in (True, False):
                shapes[f"prefetch={pre}"] = {"rows_per_thread": k0, "prefetch": pre}
            sweep = {}
            for label, sh in shapes.items():
                if not torch.equal(bits(run(sh)), bits(want)):
                    raise AssertionError(f"fused {name}: the launch {sh} differs from run_program_plain")
                s_low = fp.relower(program, **sh)
                sweep[label] = {"kernel_ms": cuda_ms(lambda: run(sh)), "threads": s_low.threads,
                                "rows_per_thread": s_low.rows_per_thread, "prefetch": s_low.prefetch,
                                "smem_bytes": s_low.smem_bytes}
            rec["shape_ms"] = sweep
        emit(rec)
        by_case[name] = rec

    a, b, c = f64(), f64(), f64()

    def chain():
        return ew.binary_op_columns("add", ew.binary_op_columns("mul", [a], [b]), [c])[0]

    case("axpb_f64", chain(), None, 32, 2, lambda: torch.addcmul(c, a, b), "torch.addcmul(c, a, b)")
    case("axpb_f64_sum", chain(), ("reduce", "sum", True, 1, False), 24, 3)
    # two launches read the inputs twice; the function itself needs them once
    case("axpb_f64_var", chain(), ("reduce", "var", True, 1, False), 24, 8)
    del a, b, c
    free_device_memory()
    x = torch.randint(-2**62, 2**62, (rows,), dtype=torch.int64, device=dev, generator=gen)
    y = torch.randint(1, 1000, (rows,), dtype=torch.int64, device=dev, generator=gen)
    mixed = ew.binary_op_columns("add", ew.binary_op_columns("mul", [x], 6364136223846793005), [y])[0]
    wrapped = ew.binary_op_columns("mod", ew.binary_op_columns("floordiv", [mixed], -97), 1000)[0]
    case("int64_floordiv_mod_wrap", ew.binary_op_columns("sub", [wrapped], ew.binary_op_columns("mul", [x], 3))[0],
         None, 24, 0)
    del x, y, mixed, wrapped
    free_device_memory()
    leaves = [f64() for _ in range(8)]
    case("program_150", fused_program_150(leaves), None, 72, 150)
    del leaves
    free_device_memory()
    # float32: 16 B a row, beside torch.addcmul in float32
    a32, b32, c32 = (f64().to(torch.float32) for _ in range(3))
    case("axpb_f32", ew.binary_op_columns("add", ew.binary_op_columns("mul", [a32], [b32]), [c32])[0], None,
         16, 2, lambda: torch.addcmul(c32, a32, b32), "torch.addcmul(c, a, b) in float32")
    del a32, b32, c32
    free_device_memory()
    # int32 and float32 leaves cast into a float64 result: typed loads and casts
    i32 = torch.randint(-10**6, 10**6, (rows,), dtype=torch.int32, device=dev, generator=gen)
    g32 = f64().to(torch.float32)
    mixed = ew.binary_op_columns("add", ew.binary_op_columns("mul", [i32], 0.5), [g32])[0]
    case("mixed_i32_f32_to_f64", mixed, None, 16, 2)
    del i32, g32, mixed
    free_device_memory()
    # a sum tail of 32 outputs, 3 * 32 block partials, on blocks of 64 and
    # 32 threads (the launch a program past 227 KB of shared memory takes)
    cols = [torch.randn(FUSED_SMALL_BLOCK_ROWS, dtype=torch.float64, device=dev, generator=gen)
            for _ in range(32)]
    roots = [ew.binary_op_columns("add", ew.binary_op_columns("mul", [cols[j]], 0.5),
                                  [cols[(j + 1) % 32]])[0] for j in range(32)]
    for t in (64, 32):
        case(f"tail32_t{t}", roots, ("reduce", "sum", True, 1, False), 8 * 32, 2 * 32 + 32,
             n=FUSED_SMALL_BLOCK_ROWS, shape={"threads": t})
    del cols, roots
    free_device_memory()
    # the masked accumulator mode at phase 13's shapes: its filtered
    # reduction ``[b, c]`` under the deferred mask ``a > 0`` (about half the
    # rows; a, b, c read, 24 B a row), beside torch's reduction of the
    # compacted rows; the kept-row count is one more output.  Then the
    # fused groupby's probe and slot launches as ``fused_group_probe`` and
    # ``fused_group_agg`` build them over the key ``d`` under that mask
    t_masked = time.perf_counter()
    from modin_tpu_torch.ops import groupby as gb_ops

    cols = plan_columns(rows, seed, dev)
    b, c, d = cols["b"], cols["c"], cols["d"]
    keep = ew.binary_op_columns("gt", [cols["a"]], 0)[0]
    m = cols["a"] > 0
    bc = torch.stack([b, c], 1)
    masked_library = {
        "sum": (lambda: torch.sum(bc[m], 0), "torch.sum(bc[mask], 0)"),
        "mean": (lambda: torch.mean(bc[m], 0), "torch.mean(bc[mask], 0)"),
        "var": (lambda: torch.var(bc[m], 0), "torch.var(bc[mask], 0)"),
        "min": (lambda: torch.amin(bc[m], 0), "torch.amin(bc[mask], 0)"),
        "max": (lambda: torch.amax(bc[m], 0), "torch.amax(bc[mask], 0)"),
        "count": (lambda: torch.count_nonzero(m), "torch.count_nonzero(mask)"),
    }
    for op, (library, library_name) in masked_library.items():
        case(f"masked_{op}", [b, c, keep], ("reduce", op, True, 1, False, True), 24, 3, library, library_name)
    del bc
    roots, tail = gb_ops.fused_probe_program(d, keep)
    case("masked_probe", roots, tail, 16, 4, lambda: torch.aminmax(d[m]), "torch.aminmax(key[mask])")
    kmin, kmax, _ = gb_ops.fused_group_probe(d, keep, rows)
    G = gb_ops.fused_groups_bucket(kmax - kmin + 1)
    case("slot", gb_ops.fused_slot_expr(d, keep, kmin, G), None, 20, 3,
         lambda: torch.where(m, d - kmin, G).to(torch.int32), "torch.where(mask, key - kmin, G).to(int32)")
    del cols, b, c, d, keep, m, roots
    free_device_memory()
    emit({"phase": "kernel", "kernel": "fused", "note": "masked mode, probe and slot cases",
          "seconds": time.perf_counter() - t_masked})
    grid = fused_grid_check(seed)
    if parent:
        after = parent_fused_times(parent, rows, seed)
        for name, rec in by_case.items():
            if name in parent_before:
                rec["parent_ms"] = [parent_before[name], after.get(name)]
        emit({"phase": "kernel", "kernel": "fused", "parent": parent,
              "parent_ms": {k: v.get("parent_ms") for k, v in by_case.items()},
              "kernel_ms": {k: v["kernel_ms"] for k, v in by_case.items()}})
    return {"by_case": by_case, "max_abs_err": worst, "grid_cases": grid["cases"]}


# ---------------------------------------------------------------------- #
# 4-5. the main path and the float path
# ---------------------------------------------------------------------- #


MAIN_QUERIES = {
    "add": lambda d, d2: d.add(2),
    "mul": lambda d, d2: d.mul(2),
    "mod": lambda d, d2: d.mod(2),
    "abs": lambda d, d2: d.abs(),
    "df_plus_df": lambda d, d2: d + d2,
    "gt": lambda d, d2: d > 50,
    "sum": lambda d, d2: d.sum(),
    "mean": lambda d, d2: d.mean(),
    "count": lambda d, d2: d.count(),
    "groupby_count": lambda d, d2: d.groupby("groupby_col").count(),
    "groupby_size": lambda d, d2: d.groupby("groupby_col").size(),
    "groupby_sum": lambda d, d2: d.groupby("groupby_col").sum(),
    "groupby_mean": lambda d, d2: d.groupby("groupby_col").mean(),
}


def assert_same_values(got: np.ndarray, want: np.ndarray, what: str, exact: bool = False) -> None:
    """Equal values: floats to ``FLOAT_RTOL`` (NaN where NaN), or exactly."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    if exact:
        # NaN and NaT at equal positions are equal values
        if not np.array_equal(got, want, equal_nan=got.dtype.kind in "fmM"):
            raise AssertionError(f"{what}: values differ")
    elif got.dtype.kind == "f" or want.dtype.kind == "f":
        g, w = got.astype(np.float64), want.astype(np.float64)
        if not np.array_equal(np.isnan(g), np.isnan(w)):
            raise AssertionError(f"{what}: NaN positions differ")
        inf = np.isinf(w)
        if not np.array_equal(g[inf], w[inf]):
            raise AssertionError(f"{what}: infinities differ")
        ok = ~np.isnan(w) & ~inf
        bad = np.abs(g[ok] - w[ok]) > FLOAT_RTOL * np.abs(w[ok])
        if bad.any():
            raise AssertionError(f"{what}: {int(bad.sum())} values beyond rtol {FLOAT_RTOL}")
    elif not np.array_equal(got, want):
        raise AssertionError(f"{what}: values differ")


def assert_same_pandas(got, want, what: str, exact: bool = False) -> None:
    import pandas

    if type(got) is not type(want):
        raise AssertionError(f"{what}: {type(got).__name__} != {type(want).__name__}")
    if not got.index.equals(want.index):
        raise AssertionError(f"{what}: index differs")
    if isinstance(want, pandas.Series):
        got, want = got.to_frame(), want.to_frame()
    if list(got.columns) != list(want.columns):
        raise AssertionError(f"{what}: columns differ")
    dtypes = set(want.dtypes)
    if (want.shape[1] > len(want) and len(dtypes) == 1 and isinstance(next(iter(dtypes)), np.dtype)
            and list(got.dtypes) == list(want.dtypes)):
        # more columns than rows, of one numpy dtype: they compare as one
        # array (a transpose of 1e6 rows has 1e6 columns, which a loop over
        # them takes minutes for; a long frame's copy would cost more)
        assert_same_values(got.to_numpy(), want.to_numpy(), what, exact)
        return
    for i, label in enumerate(want.columns):
        g, w = got.iloc[:, i], want.iloc[:, i]
        if g.dtype != w.dtype:
            raise AssertionError(f"{what}[{label}]: dtype {g.dtype} != {w.dtype}")
        if not isinstance(w.dtype, np.dtype):
            # extension arrays (strings) compare in their own storage,
            # missing values equal at equal positions
            if not g.array.equals(w.array):
                raise AssertionError(f"{what}[{label}]: values differ")
            continue
        assert_same_values(g.to_numpy(), w.to_numpy(), f"{what}[{label}]", exact)


def assert_on_cuda(qc, what: str) -> None:
    for col in qc._modin_frame._columns:
        # the column's device, a deferred one's without computing it
        if not col.is_device or col.device.type != "cuda":
            raise AssertionError(f"{what}: a value column is not on cuda")


def run_main_pandas(rows: int, seed: int) -> None:
    import pandas

    import modin_tpu_torch.pandas as tpd

    for g in (100, 10_000):
        p1 = pandas.DataFrame(make_frame_data(rows, seed, ngroups=g))
        p2 = pandas.DataFrame(make_frame_data(rows, seed + 1, ngroups=g))
        t1, from_ms = host_ms(lambda: tpd.from_pandas(p1))
        t2 = tpd.from_pandas(p2)
        assert_on_cuda(t1._query_compiler, "from_pandas")
        assert_on_cuda(t2._query_compiler, "from_pandas")
        emit({"phase": "main", "ngroups": g, "rows": rows, "query": "from_pandas",
              "port_ms": from_ms, "pandas_ms": None})
        for name, fn in MAIN_QUERIES.items():
            result, port_ms = host_ms(lambda: fn(t1, t2))
            assert_on_cuda(result._query_compiler, name)
            got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(result))
            t0 = time.perf_counter()
            want = fn(p1, p2)
            pandas_ms = (time.perf_counter() - t0) * 1e3
            assert_same_pandas(got, want, f"{name} (ngroups {g})")
            emit({"phase": "main", "ngroups": g, "rows": rows, "query": name,
                  "port_ms": port_ms, "pandas_ms": pandas_ms,
                  "to_pandas_ms": to_pandas_ms, "match": True})
            del result, got, want
        del p1, p2, t1, t2
        free_device_memory()
    # a key of range 1e6: wider than the shared-memory cap, so the
    # factorization histogram takes the kernel's global mode
    rng = np.random.default_rng(seed + 2)
    p = pandas.DataFrame({"key": rng.integers(0, 10**6, rows), "col0": rng.integers(0, 100, rows)})
    t = tpd.from_pandas(p)
    for name, fn in {"groupby_wide_sum": lambda d: d.groupby("key").sum(),
                     "groupby_wide_size": lambda d: d.groupby("key").size()}.items():
        result, port_ms = host_ms(lambda: fn(t))
        got = tpd.to_pandas(result)
        t0 = time.perf_counter()
        want = fn(p)
        pandas_ms = (time.perf_counter() - t0) * 1e3
        assert_same_pandas(got, want, name)
        emit({"phase": "main", "ngroups": int(len(want)), "rows": rows, "query": name,
              "port_ms": port_ms, "pandas_ms": pandas_ms, "match": True})
    del p, t
    free_device_memory()


def _np_groupby(key: np.ndarray, col: np.ndarray, agg: str):
    """numpy reference of an int-key groupby (sorted keys, present only)."""
    uniq, inv = np.unique(key, return_inverse=True)
    counts = np.bincount(inv)
    if agg in ("count", "size"):
        return counts
    sums = np.bincount(inv, weights=col)
    return sums if agg == "sum" else sums / counts


def run_main_numpy(rows: int, seed: int) -> None:
    """The main-path queries below the pandas API, against numpy."""
    from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
        TorchQueryCompiler,
    )

    def values(qc) -> list:
        frame = qc._modin_frame
        return [frame.get_column(i).to_numpy() for i in range(frame.num_cols)]

    def gb(agg):
        return lambda q, q2: q.groupby_agg(
            ["groupby_col"], agg, groupby_kwargs={}, agg_kwargs={}, drop=True
        )

    qc_queries = {
        "add": lambda q, q2: q.add(2), "mul": lambda q, q2: q.mul(2),
        "mod": lambda q, q2: q.mod(2), "abs": lambda q, q2: q.abs(),
        "df_plus_df": lambda q, q2: q.add(q2), "gt": lambda q, q2: q.gt(50),
        "sum": lambda q, q2: q.sum(), "mean": lambda q, q2: q.mean(),
        "count": lambda q, q2: q.count(),
        "groupby_count": gb("count"), "groupby_size": gb("size"),
        "groupby_sum": gb("sum"), "groupby_mean": gb("mean"),
    }
    for g in (100, 10_000):
        d1 = make_frame_data(rows, seed, ngroups=g)
        d2 = make_frame_data(rows, seed + 1, ngroups=g)
        labels = list(d1)
        np_refs = {
            "add": lambda: [d1[k] + 2 for k in labels],
            "mul": lambda: [d1[k] * 2 for k in labels],
            "mod": lambda: [d1[k] % 2 for k in labels],
            "abs": lambda: [np.abs(d1[k]) for k in labels],
            "df_plus_df": lambda: [d1[k] + d2[k] for k in labels],
            "gt": lambda: [d1[k] > 50 for k in labels],
            "sum": lambda: [np.array([d1[k].sum() for k in labels])],
            "mean": lambda: [np.array([d1[k].mean() for k in labels])],
            "count": lambda: [np.full(len(labels), rows)],
            "groupby_size": lambda: [_np_groupby(d1["groupby_col"], None, "size")],
        }
        for agg in ("count", "sum", "mean"):
            np_refs[f"groupby_{agg}"] = lambda agg=agg: [
                _np_groupby(d1["groupby_col"], d1[k], agg) for k in labels[:-1]
            ]
        q1, from_ms = host_ms(lambda: TorchQueryCompiler.from_numpy_columns(d1))
        q2 = TorchQueryCompiler.from_numpy_columns(d2)
        assert_on_cuda(q1, "from_numpy_columns")
        emit({"phase": "main", "api": "query_compiler+numpy", "ngroups": g, "rows": rows,
              "query": "from_numpy_columns", "port_ms": from_ms, "numpy_ms": None})
        for name, fn in qc_queries.items():
            result, port_ms = host_ms(lambda: fn(q1, q2))
            assert_on_cuda(result, name)
            got = values(result)
            t0 = time.perf_counter()
            want = np_refs[name]()
            numpy_ms = (time.perf_counter() - t0) * 1e3
            if len(got) != len(want):
                raise AssertionError(f"{name}: {len(got)} columns != {len(want)}")
            for j, (a, b) in enumerate(zip(got, want)):
                assert_same_values(np.asarray(a), np.asarray(b), f"{name}[{j}] (ngroups {g})")
            emit({"phase": "main", "api": "query_compiler+numpy", "ngroups": g,
                  "rows": rows, "query": name, "port_ms": port_ms,
                  "numpy_ms": numpy_ms, "match": True})
            del result, got, want
        del q1, q2, d1, d2
        free_device_memory()


def main_groupagg_predicted(rows: int) -> bool:
    """Whether the route gate sends one of phase 4's grouped sums or means
    (ten int64 columns by 100 or 10 000 groups of ``rows`` rows) to
    ``groupagg`` (``ops/groupby.takes_groupagg``)."""
    import torch

    from modin_tpu_torch.ops import groupby as gb_ops

    return any(gb_ops.takes_groupagg(agg, [torch.int64] * 10, g, rows)
               for agg in ("sum", "mean") for g in (100, 10_000))


def phase_main(rows: int, seed: int, have_pandas: bool) -> dict:
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops.cuda import groupagg_kernels as ga
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk

    gk.LAUNCHES = ga.LAUNCHES = 0
    tqc.DEFAULTS_TO_PANDAS = 0
    if have_pandas:
        run_main_pandas(rows, seed)
    else:
        emit({"phase": "main", "note": "pandas is not importable: the queries run "
              "through TorchQueryCompiler.from_numpy_columns against numpy"})
        run_main_numpy(rows, seed)
    launches, ga_launches, defaults = gk.LAUNCHES, ga.LAUNCHES, tqc.DEFAULTS_TO_PANDAS
    predicted = main_groupagg_predicted(rows)
    emit({"phase": "main", "bincount_launches": launches, "groupagg_launches": ga_launches,
          "groupagg_predicted": predicted, "defaults_to_pandas": defaults})
    if launches == 0:
        raise AssertionError("the main path never launched the bincount kernel")
    if predicted and ga_launches == 0:
        raise AssertionError("the route gate sends the main path's grouped sums to groupagg, "
                             "but the main path never launched it")
    if defaults != 0:
        raise AssertionError(f"{defaults} main-path queries defaulted to pandas")
    return {"bincount": launches, "groupagg": ga_launches}


def float_frame(rows: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 1000, rows) / 8.0
    key[rng.random(rows) < 0.01] = np.nan
    # positive values: no cancellation in the group sums, so rtol 1e-12
    # measures the summation order and nothing else
    val = rng.uniform(0, 100, rows)
    val[rng.random(rows) < 0.01] = np.nan
    return {"key": key, "val": val, "ival": rng.integers(0, 100, rows)}


def phase_float(rows: int, seed: int, have_pandas: bool) -> None:
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk

    gk.LAUNCHES = 0
    tqc.DEFAULTS_TO_PANDAS = 0
    data = float_frame(rows, seed + 3)
    if have_pandas:
        import pandas

        import modin_tpu_torch.pandas as tpd

        p = pandas.DataFrame(data)
        t = tpd.from_pandas(p)
        queries = {}
        for dropna in (True, False):
            for agg in ("sum", "mean", "count"):
                queries[f"groupby_{agg}_dropna{dropna}"] = (
                    lambda d, agg=agg, dropna=dropna: getattr(d.groupby("key", dropna=dropna), agg)()
                )
        for skipna in (True, False):
            for op in ("sum", "mean", "min", "max"):
                queries[f"{op}_skipna{skipna}"] = (
                    lambda d, op=op, skipna=skipna: getattr(d, op)(skipna=skipna)
                )
        for name, fn in queries.items():
            result, port_ms = host_ms(lambda: fn(t))
            got = tpd.to_pandas(result)
            t0 = time.perf_counter()
            want = fn(p)
            pandas_ms = (time.perf_counter() - t0) * 1e3
            assert_same_pandas(got, want, name)
            emit({"phase": "float", "rows": rows, "query": name, "port_ms": port_ms,
                  "pandas_ms": pandas_ms, "match": True})
        first = tpd.to_pandas(t.groupby("key").mean())
        second = tpd.to_pandas(t.groupby("key").mean())
        a, b = first.to_numpy(), second.to_numpy()
    else:
        from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
            TorchQueryCompiler,
        )

        q = TorchQueryCompiler.from_numpy_columns(data)
        key, val = data["key"], data["val"]
        ok = ~np.isnan(key)
        uniq, inv = np.unique(key[ok], return_inverse=True)
        v = val[ok]
        vcount = np.bincount(inv, weights=~np.isnan(v))
        vsum = np.bincount(inv, weights=np.where(np.isnan(v), 0.0, v))
        refs = {"count": vcount, "sum": vsum, "mean": vsum / vcount}
        for agg, want in refs.items():
            r = q.groupby_agg(["key"], agg, groupby_kwargs={}, agg_kwargs={}, drop=True)
            got = r._modin_frame.get_column(0).to_numpy()
            assert_same_values(got, want, f"groupby_{agg} (numpy reference)")
            np.testing.assert_array_equal(r._modin_frame._index.arrays[0], uniq)
            emit({"phase": "float", "api": "query_compiler+numpy", "rows": rows,
                  "query": f"groupby_{agg}", "match": True})

        def mean_values():
            r = q.groupby_agg(["key"], "mean", groupby_kwargs={}, agg_kwargs={}, drop=True)
            return np.stack([c.to_numpy() for c in r._modin_frame._columns])

        a, b = mean_values(), mean_values()
    bitwise = bool(np.array_equal(a.view(np.int64), b.view(np.int64)))
    emit({"phase": "float", "group_mean_bitwise_repeat": bitwise,
          "bincount_launches": gk.LAUNCHES, "defaults_to_pandas": tqc.DEFAULTS_TO_PANDAS})
    if not bitwise:
        raise AssertionError("the float group mean differs between two runs")
    if tqc.DEFAULTS_TO_PANDAS != 0:
        raise AssertionError("a float-path query defaulted to pandas")
    free_device_memory()


# ---------------------------------------------------------------------- #
# 6. the relational queries
# ---------------------------------------------------------------------- #


def _pandas_frame(data: dict):
    import pandas

    df = pandas.DataFrame(data)
    data.clear()  # the frame holds its own copy
    return df


def dim_frame(n_dim: int, key_range: int, seed: int) -> dict:
    """The star schema's dimension: a unique shuffled key drawn from
    ``[0, key_range)`` and three int64 value columns."""
    rng = np.random.default_rng(seed)
    return {
        "key": rng.permutation(key_range)[:n_dim],
        "d0": rng.integers(0, 1000, n_dim),
        "d1": rng.integers(0, 1000, n_dim),
        "d2": rng.integers(0, 1000, n_dim),
    }


def _set_groupby_col2(df):
    df["groupby_col2"] = df["col0"] % 5
    return df


RELATIONAL_QUERIES = {
    # asv TimeQuery, and the same filter as a boolean mask
    "query": lambda pd, d, d2: d.query("col0 > 50 & col1 < 30"),
    "filter_mask": lambda pd, d, d2: d[(d.col0 > 50) & (d.col1 < 30)],
    # asv TimeArithmetic.time_is_in
    "isin": lambda pd, d, d2: d.isin([0, 2]),
    # asv TimeSortValues, and two keys in opposite directions
    "sort_values": lambda pd, d, d2: d.sort_values("col0", kind="stable"),
    "sort_values_two_keys": lambda pd, d, d2: d.sort_values(["col0", "col1"], ascending=[True, False]),
    # asv TimeConcat
    "concat": lambda pd, d, d2: pd.concat([d, d2]),
}


def _relational_run(name: str, fn, rows: int) -> None:
    """Run ``fn(port module)`` and ``fn(pandas)``, hold the results equal
    exactly, and print one line of times."""
    import pandas
    import torch

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc

    defaults = tqc.DEFAULTS_TO_PANDAS
    torch.cuda.reset_peak_memory_stats()
    result, port_ms = host_ms(lambda: fn(tpd))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if tqc.DEFAULTS_TO_PANDAS != defaults:
        raise AssertionError(f"{name}: the query defaulted to pandas")
    assert_on_cuda(result._query_compiler, name)
    got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(result))
    del result
    free_device_memory()
    t0 = time.perf_counter()
    want = fn(pandas)
    pandas_ms = (time.perf_counter() - t0) * 1e3
    assert_same_pandas(got, want, name, exact=True)
    emit({"phase": "relational", "query": name, "rows": rows, "out_rows": len(want),
          "out_cols": int(want.shape[1]), "port_ms": port_ms, "pandas_ms": pandas_ms,
          "to_pandas_ms": to_pandas_ms, "device_peak_gib": round(peak_gib, 3),
          "match": True})
    del got, want
    gc.collect()


def phase_relational(rows: int, seed: int) -> int:
    """The asv relational suite at ``rows`` rows through
    ``modin_tpu_torch.pandas``, each result equal to pandas'; returns the
    bincount launches of the phase (the multi-key groupby's)."""
    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk

    t_phase = time.perf_counter()
    gk.LAUNCHES = 0
    tqc.DEFAULTS_TO_PANDAS = 0

    # one asv frame (TimeQuery's seed) serves the filters, isin and sorts,
    # and is the first half of the concat
    p1 = _pandas_frame(make_frame_data(rows, seed + 8))
    p2 = _pandas_frame(make_frame_data(rows, seed + 6))
    t1, t2 = tpd.from_pandas(p1), tpd.from_pandas(p2)
    frames = {tpd: (t1, t2)}
    for name, fn in RELATIONAL_QUERIES.items():
        _relational_run(
            name, lambda pd: fn(pd, *frames.get(pd, (p1, p2))), rows
        )
    del t2, frames
    p2 = None
    free_device_memory()

    # asv TimeGroupByMultiColumn: make_frame(ngroups=20), then the
    # __setitem__ of a computed column and a two-key groupby
    groupby_col = np.random.default_rng(seed + 20).integers(0, 20, rows)
    p1["groupby_col"] = groupby_col
    t1["groupby_col"] = groupby_col
    del groupby_col
    _relational_run(
        "setitem_groupby_multi_sum",
        lambda pd: _set_groupby_col2(t1 if pd is tpd else p1).groupby(
            ["groupby_col", "groupby_col2"]).sum(),
        rows,
    )
    del t1, p1
    free_device_memory()

    # the star schema: a fact frame (the recipe plus a key uniform in
    # [0, 1.1 rows/10)) joined to a dimension of rows/10 unique keys; about
    # 9% of the fact rows miss, so the left join promotes the dimension's
    # int columns to float64
    n_dim = rows // 10
    key_range = n_dim * 11 // 10
    fact_data = make_frame_data(rows, seed + 12)
    fact_data["key"] = np.random.default_rng(seed + 13).integers(0, key_range, rows)
    pf = _pandas_frame(fact_data)
    pd_dim = _pandas_frame(dim_frame(n_dim, key_range, seed + 14))
    tf, td = tpd.from_pandas(pf), tpd.from_pandas(pd_dim)
    for how in ("inner", "left"):
        _relational_run(
            f"merge_star_{how}",
            lambda pd, how=how: (tf if pd is tpd else pf).merge(
                td if pd is tpd else pd_dim, on="key", how=how),
            rows,
        )
    del tf, td, pf, pd_dim
    free_device_memory()

    # the asv TimeMerge recipe itself: many-to-many on 100 key values,
    # 125 000 rows x 5002 columns out (at 1e8 rows it would give 5e13)
    pl = _pandas_frame(make_frame_data(5000, 3, cols=5000))
    pr = _pandas_frame(make_frame_data(2500, 4, cols=3))
    tl, tr = tpd.from_pandas(pl), tpd.from_pandas(pr)
    for how in ("inner", "left"):
        _relational_run(
            f"merge_asv_{how}",
            lambda pd, how=how: (tl if pd is tpd else pl).merge(
                tr if pd is tpd else pr, on="col0", how=how),
            5000,
        )
    del tl, tr, pl, pr
    free_device_memory()

    launches, defaults = gk.LAUNCHES, tqc.DEFAULTS_TO_PANDAS
    emit({"phase": "relational", "bincount_launches": launches,
          "defaults_to_pandas": defaults,
          "seconds": time.perf_counter() - t_phase})
    if launches == 0:
        raise AssertionError("the relational path never launched the bincount kernel")
    if defaults != 0:
        raise AssertionError(f"{defaults} relational queries defaulted to pandas")
    return launches


# ---------------------------------------------------------------------- #
# 7. the rest of asv TimeArithmetic, the pandas defaults, indexing
# ---------------------------------------------------------------------- #

# per-row pandas loops: the row-wise nunique/mode are held against pandas on
# this many leading rows (and against numpy at full size)
PANDAS_ROW_SLICE = 100_000
# asv's Big unary shape (asv_bench/benchmarks/utils.py: UNARY_SHAPES)
DEFAULTED_ROWS = 1_000_000
NUMPY_CHUNK_ROWS = 5_000_000

ARITHMETIC_QUERIES = {
    # nunique and mode before median: a column with a sorted representation
    # (median, quantile and describe build one) answers them from it, and
    # the histogram path with the bincount kernel is for a fresh column
    **{f"{op}_axis{a}": (lambda d, op=op, a=a: getattr(d, op)(axis=a))
       for op in ("sum", "count", "nunique", "mode", "median", "mean") for a in (0, 1)},
    **{f"{op}_axis{a}": (lambda d, op=op, a=a: getattr(d, op)(2, axis=a))
       for op in ("add", "mul", "mod") for a in (0, 1)},
    # abs and isin take no axis: asv's two axis params run the same query
    "abs": lambda d: d.abs(),
    "isin": lambda d: d.isin([0, 2]),
    "quantile": lambda d: d.quantile([0.1, 0.5, 0.9]),
    "describe": lambda d: d.describe(),
}
# pandas answers these with a Python loop over the rows (nunique and mode
# apply a Series method per row; median(axis=1) goes through numpy's
# nanmedian, which applies itself along the axis): numpy holds them at full
# size, pandas on the first PANDAS_ROW_SLICE rows
NUMPY_REFERENCED = ("nunique_axis1", "mode_axis1", "median_axis1")


def row_reference(name: str, block: np.ndarray, ncols_out: int) -> np.ndarray:
    """numpy's answer for one block of rows of an int frame: ``np.sort``
    along the rows, then adjacent differences (nunique) or, for the mode,
    how often each sorted value occurs in its row."""
    if name == "median_axis1":
        return np.median(block, axis=1)
    xs = np.ascontiguousarray(np.sort(block, axis=1).T)  # (columns, rows)
    k = len(xs)
    new = [np.ones(xs.shape[1], dtype=bool)] + [xs[j] != xs[j - 1] for j in range(1, k)]
    if name == "nunique_axis1":
        return np.sum(new, axis=0)
    count = []
    for j in range(k):
        c = np.zeros(xs.shape[1], dtype=np.int16)
        for q in range(k):
            c += xs[q] == xs[j]
        count.append(c)
    best = np.max(count, axis=0)
    want = np.full((xs.shape[1], ncols_out), np.nan)
    slot = np.zeros(xs.shape[1], dtype=np.int64)
    for j in range(k):
        # the modal values of each row, ascending, then NaN
        rows = np.flatnonzero(new[j] & (count[j] == best))
        want[rows, slot[rows]] = xs[j][rows]
        slot[rows] += 1
    return want


def check_rows_numpy(name: str, got, values: np.ndarray) -> float:
    """Hold a row-wise result of the port against numpy,
    ``NUMPY_CHUNK_ROWS`` rows at a time; returns numpy's ms."""
    if values.dtype.kind not in "iu":
        raise AssertionError(f"{name}: the numpy reference takes int columns")
    out = got.to_numpy()
    numpy_s = 0.0
    for start in range(0, len(values), NUMPY_CHUNK_ROWS):
        block = values[start:start + NUMPY_CHUNK_ROWS]
        t0 = time.perf_counter()
        want = row_reference(name, block, out.shape[1] if out.ndim == 2 else 0)
        numpy_s += time.perf_counter() - t0
        assert_same_values(out[start:start + len(block)], want, f"{name} rows {start}+",
                           exact=name != "median_axis1")
    return numpy_s * 1e3


def check_rows_pandas(name: str, got, p) -> None:
    """The first ``PANDAS_ROW_SLICE`` rows against pandas' own loop."""
    head = p.iloc[:PANDAS_ROW_SLICE]
    if name != "mode_axis1":
        want = getattr(head, name[: -len("_axis1")])(axis=1)
        assert_same_pandas(got.iloc[:PANDAS_ROW_SLICE], want, name)
        return
    want = head.mode(axis=1)
    part = got.iloc[:PANDAS_ROW_SLICE]
    if part.iloc[:, want.shape[1]:].notna().to_numpy().any():
        raise AssertionError(f"{name}: modes beyond pandas' on the first rows")
    assert_same_values(part.iloc[:, : want.shape[1]].to_numpy(np.float64),
                       want.to_numpy(np.float64), name, exact=True)


def phase_arithmetic(rows: int, seed: int) -> int:
    """asv TimeArithmetic at ``rows`` x 10 on the device against pandas (and
    numpy for the row-wise loops), indexing reads, and the three queries
    that default to pandas; returns the phase's bincount launches."""
    import pandas
    import torch

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk

    t_phase = time.perf_counter()
    gk.LAUNCHES = 0
    tqc.DEFAULTS_TO_PANDAS = 0
    p = _pandas_frame(make_frame_data(rows, seed + 30))
    t, from_ms = host_ms(lambda: tpd.from_pandas(p))
    assert_on_cuda(t._query_compiler, "from_pandas")
    emit({"phase": "arithmetic", "rows": rows, "query": "from_pandas", "port_ms": from_ms})
    values = None
    for name, fn in ARITHMETIC_QUERIES.items():
        launches = gk.LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        result, port_ms = host_ms(lambda: fn(t))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launched = gk.LAUNCHES - launches
        if tqc.DEFAULTS_TO_PANDAS != 0:
            raise AssertionError(f"{name}: the query defaulted to pandas")
        assert_on_cuda(result._query_compiler, name)
        if name in ("nunique_axis0", "mode_axis0") and launched < p.shape[1]:
            raise AssertionError(f"{name}: {launched} bincount launches for {p.shape[1]} columns")
        got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(result))
        del result
        free_device_memory()
        rec = {"phase": "arithmetic", "query": name, "rows": rows, "out_shape": list(got.shape),
               "port_ms": port_ms, "to_pandas_ms": to_pandas_ms,
               "device_peak_gib": round(peak_gib, 3), "bincount_launches": launched}
        if name in NUMPY_REFERENCED:
            if values is None:
                values = np.ascontiguousarray(p.to_numpy())
            rec["numpy_ms"] = check_rows_numpy(name, got, values)
            check_rows_pandas(name, got, p)
            rec["pandas_ms"] = None
            rec["pandas_rows_checked"] = PANDAS_ROW_SLICE
        else:
            t0 = time.perf_counter()
            want = fn(p)
            rec["pandas_ms"] = (time.perf_counter() - t0) * 1e3
            assert_same_pandas(got, want, name)
            del want
        rec["match"] = True
        emit(rec)
        del got
        gc.collect()
    del values
    launches = gk.LAUNCHES

    # indexing reads at full size: positional and boolean, on the device
    reads = {
        "iloc_step_cols": lambda d: d.iloc[::7, [0, 3]],
        "loc_mask_cols": lambda d: d.loc[d.col0 > 50, ["col1", "col2"]],
        "head": lambda d: d.head(),
    }
    for name, fn in reads.items():
        torch.cuda.reset_peak_memory_stats()
        result, port_ms = host_ms(lambda: fn(t))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if tqc.DEFAULTS_TO_PANDAS != 0:
            raise AssertionError(f"{name}: the read defaulted to pandas")
        assert_on_cuda(result._query_compiler, name)
        got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(result))
        del result
        t0 = time.perf_counter()
        want = fn(p)
        pandas_ms = (time.perf_counter() - t0) * 1e3
        assert_same_pandas(got, want, name, exact=True)
        emit({"phase": "arithmetic", "query": name, "rows": rows, "out_shape": list(got.shape),
              "port_ms": port_ms, "pandas_ms": pandas_ms, "to_pandas_ms": to_pandas_ms,
              "device_peak_gib": round(peak_gib, 3), "match": True})
        del got, want
    del t, p
    free_device_memory()

    # the three queries that default to pandas, once each
    small = make_frame_data(DEFAULTED_ROWS, seed + 31)
    defaulted = {
        "apply_axis0": (lambda d: d.apply(lambda c: c.sum(), axis=0), DEFAULTED_ROWS),
        "aggregate_axis0": (lambda d: d.aggregate(lambda c: c.sum(), axis=0), DEFAULTED_ROWS),
        "transpose": (lambda d: d.transpose(), DEFAULTED_ROWS),
        "apply_axis1": (lambda d: d.apply(lambda c: c.sum(), axis=1), PANDAS_ROW_SLICE),
        "aggregate_axis1": (lambda d: d.aggregate(lambda c: c.sum(), axis=1), PANDAS_ROW_SLICE),
    }
    for name, (fn, n) in defaulted.items():
        p = pandas.DataFrame({k: v[:n] for k, v in small.items()})
        t = tpd.from_pandas(p)
        before = tqc.DEFAULTS_TO_PANDAS
        result, port_ms = host_ms(lambda: fn(t))
        counted = tqc.DEFAULTS_TO_PANDAS - before
        if counted != 1:
            raise AssertionError(f"{name}: {counted} defaults to pandas, not 1")
        compiler = type(result._query_compiler).__name__
        got = tpd.to_pandas(result)
        t0 = time.perf_counter()
        want = fn(p)
        pandas_ms = (time.perf_counter() - t0) * 1e3
        assert_same_pandas(got, want, name, exact=True)
        emit({"phase": "arithmetic", "query": name, "rows": n, "out_shape": list(got.shape),
              "compiler": compiler, "defaults_to_pandas": counted,
              "port_ms": port_ms, "pandas_ms": pandas_ms, "match": True})
        del t, p, result, got, want
    free_device_memory()
    emit({"phase": "arithmetic", "bincount_launches": launches,
          "defaults_to_pandas_on_device_queries": 0,
          "seconds": time.perf_counter() - t_phase})
    if launches == 0:
        raise AssertionError("the arithmetic path never launched the bincount kernel")
    return launches


# ---------------------------------------------------------------------- #
# 8. files in and strings on the card
# ---------------------------------------------------------------------- #

STRINGS = ("alpha", "beta", "gamma-delta")


def str_int_frame_data(rows: int, seed: int) -> dict:
    """asv's ``str_int`` CSV recipe (asv_bench/benchmarks/utils.py::
    prepare_csv): 10 columns, every third from the second a choice of three
    strings, the rest int64 in [0, 100)."""
    rng = np.random.default_rng(seed)
    return {
        f"col{i}": rng.choice(STRINGS, rows) if i % 3 == 2 else rng.integers(0, 100, rows)
        for i in range(10)
    }


def _readme_pipeline(d):
    d["total"] = d.col0 * d.col1
    return d[d.total > 50].groupby("col2")[["col0", "col1", "total"]].sum().sort_values("total")


IO_QUERIES = {
    # the README's pipeline: a computed column, a filter, a string-key
    # groupby and a sort
    "readme_pipeline": _readme_pipeline,
    "groupby_two_str_keys_size": lambda d, dim: d.groupby(["col2", "col5"]).size(),
    "groupby_as_index_false_mean": lambda d, dim: d.groupby("col2", as_index=False)[["col0", "col3"]].mean(),
    "groupby_str_value_max": lambda d, dim: d.groupby("col2")["col5"].max(),
    "value_counts": lambda d, dim: d.col8.value_counts(),
    "nunique": lambda d, dim: d[["col2", "col5", "col8"]].nunique(),
    "unique": lambda d, dim: d.col2.unique(),
    "filter_eq": lambda d, dim: d[d.col5 == "beta"],
    "lt_sum": lambda d, dim: (d.col8 < "beta").sum(),
    "str_startswith": lambda d, dim: d.col8.str.startswith("gamma"),
    "str_len": lambda d, dim: d.col2.str.len(),
    "isin": lambda d, dim: d.col2.isin(["alpha", "gamma-delta"]),
    "sort_str_then_int": lambda d, dim: d.sort_values(["col2", "col0"]),
    "merge_left_dim": lambda d, dim: d.merge(dim, on="col2", how="left"),
}


def _materialized_read(df):
    """A read's frame parsed now (a read defers into a plan under the
    default ``MODIN_TPU_TORCH_PLAN=Auto``)."""
    df._query_compiler._modin_frame
    return df


def _same_result(got, want, what: str) -> None:
    """pandas objects as ``assert_same_pandas`` holds them (strings and
    ints exactly, float means to ``FLOAT_RTOL``); arrays by type and
    values; scalars by value."""
    import pandas

    if isinstance(want, (pandas.DataFrame, pandas.Series)):
        assert_same_pandas(got, want, what)
    elif hasattr(want, "__len__"):
        if type(got) is not type(want) or got.dtype != want.dtype:
            raise AssertionError(f"{what}: {type(got).__name__}[{got.dtype}] != "
                                 f"{type(want).__name__}[{want.dtype}]")
        if list(got) != list(want):
            raise AssertionError(f"{what}: values differ")
    elif got != want:
        raise AssertionError(f"{what}: {got!r} != {want!r}")


def _io_record(name: str, rows: int, port_ms, pandas_ms, to_pandas_ms, peak_gib, **extra) -> dict:
    rec = {"phase": "io", "query": name, "rows": rows, "port_ms": port_ms,
           "pandas_ms": pandas_ms, "to_pandas_ms": to_pandas_ms,
           "device_peak_gib": round(peak_gib, 3), **extra, "match": True}
    emit(rec)
    return rec


def phase_io(rows: int, seed: int, workdir: str) -> int:
    """asv's CSV and Parquet IO and the string queries at ``rows`` rows
    through ``modin_tpu_torch.pandas``, each equal to pandas' answer, no
    query defaulting to pandas; returns the phase's bincount launches."""
    import filecmp

    import pandas
    import torch

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.core.io import chunker, file_dispatcher
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops import dictionary
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk

    t_phase = time.perf_counter()
    gk.LAUNCHES = 0
    tqc.DEFAULTS_TO_PANDAS = 0
    chunker.NATIVE_SPLITS = 0
    file_dispatcher.PARALLEL_READS = 0

    def port_call(fn):
        torch.cuda.reset_peak_memory_stats()
        out, ms = host_ms(fn)
        return out, ms, torch.cuda.max_memory_allocated() / 2**30

    # asv TimeToCsv: the uploaded frame to a CSV file, byte for byte pandas'
    p0 = _pandas_frame(str_int_frame_data(rows, seed + 40))
    t0, upload_ms = host_ms(lambda: tpd.from_pandas(p0))
    emit({"phase": "io", "query": "from_pandas", "rows": rows, "port_ms": upload_ms})
    port_csv, pandas_csv = os.path.join(workdir, "port.csv"), os.path.join(workdir, "pandas.csv")
    _, port_ms, peak = port_call(lambda: t0.to_csv(port_csv, index=False))
    t1 = time.perf_counter()
    p0.to_csv(pandas_csv, index=False)
    pandas_ms = (time.perf_counter() - t1) * 1e3
    if not filecmp.cmp(port_csv, pandas_csv, shallow=False):
        raise AssertionError("to_csv: the port's file differs from pandas'")
    _io_record("to_csv", rows, port_ms, pandas_ms, None, peak,
               file_bytes=os.path.getsize(pandas_csv))
    os.unlink(port_csv)
    del t0, p0
    free_device_memory()

    # pd.read_csv of that file: the native splitter and the parallel parse
    # (a deferred read: the parse runs at its first materialization, here)
    t, port_ms, peak = port_call(lambda: _materialized_read(tpd.read_csv(pandas_csv)))
    t1 = time.perf_counter()
    p = pandas.read_csv(pandas_csv)
    pandas_ms = (time.perf_counter() - t1) * 1e3
    got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(t))
    assert_same_pandas(got, p, "read_csv", exact=True)
    del got
    if chunker.NATIVE_SPLITS == 0 or file_dispatcher.PARALLEL_READS == 0:
        raise AssertionError(f"read_csv: native splits {chunker.NATIVE_SPLITS}, "
                             f"parallel reads {file_dispatcher.PARALLEL_READS}")
    numeric = [c for c in t._query_compiler._modin_frame._columns if c.pandas_dtype.kind in "iuf"]
    if not all(c.is_device and c.data.device.type == "cuda" for c in numeric):
        raise AssertionError("read_csv: a numeric column is not on cuda")
    _io_record("read_csv", rows, port_ms, pandas_ms, to_pandas_ms, peak,
               native_splits=chunker.NATIVE_SPLITS, parallel_reads=file_dispatcher.PARALLEL_READS)
    os.unlink(pandas_csv)

    # the dictionary encoding of each string column (pandas' factorize on
    # the host, the codes to the device), timed apart from the queries
    frame = t._query_compiler._modin_frame
    encode_ms = {}
    for label in ("col2", "col5", "col8"):
        col = frame.get_column(frame.column_position(label)[0])
        _, encode_ms[label] = host_ms(lambda: dictionary.encode_host_column(col))
    emit({"phase": "io", "query": "dictionary_encode", "rows": rows, "port_ms": encode_ms})

    dim_data = {"col2": list(STRINGS), "w": [1.5, 2.5, 3.5], "tag": ["a", "bb", "ccc"]}
    tdim, pdim = tpd.DataFrame(dim_data), pandas.DataFrame(dim_data)
    for name, fn in IO_QUERIES.items():
        if name == "readme_pipeline":
            run = {tpd: lambda: fn(t), pandas: lambda: fn(p)}
        else:
            run = {tpd: lambda: fn(t, tdim), pandas: lambda: fn(p, pdim)}
        result, port_ms, peak = port_call(run[tpd])
        if tqc.DEFAULTS_TO_PANDAS != 0:
            raise AssertionError(f"{name}: the query defaulted to pandas")
        if hasattr(result, "_query_compiler"):
            got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(result))
        else:
            got, to_pandas_ms = result, None
        del result
        t1 = time.perf_counter()
        want = run[pandas]()
        pandas_ms = (time.perf_counter() - t1) * 1e3
        _same_result(got, want, name)
        _io_record(name, rows, port_ms, pandas_ms, to_pandas_ms, peak,
                   out_shape=list(getattr(want, "shape", ())))
        if name == "readme_pipeline":
            del t["total"], p["total"]
        del got, want
        free_device_memory()

    # asv TimeToParquet and TimeReadParquet: each package's round trip
    try:
        import pyarrow
    except ImportError:
        emit({"phase": "io", "note": "pyarrow does not import here: Parquet unverified"})
    else:
        port_pq, pandas_pq = os.path.join(workdir, "port.parquet"), os.path.join(workdir, "pandas.parquet")
        _, port_ms, peak = port_call(lambda: t.to_parquet(port_pq))
        t1 = time.perf_counter()
        p.to_parquet(pandas_pq)
        pandas_ms = (time.perf_counter() - t1) * 1e3
        _io_record("to_parquet", rows, port_ms, pandas_ms, None, peak, pyarrow=pyarrow.__version__)
        del t, p
        free_device_memory()
        back, port_ms, peak = port_call(lambda: tpd.read_parquet(port_pq))
        t1 = time.perf_counter()
        want = pandas.read_parquet(pandas_pq)
        pandas_ms = (time.perf_counter() - t1) * 1e3
        got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(back))
        assert_same_pandas(got, want, "parquet round trip", exact=True)
        _io_record("read_parquet", rows, port_ms, pandas_ms, to_pandas_ms, peak)
        del back, got, want
    if tqc.DEFAULTS_TO_PANDAS != 0:
        raise AssertionError(f"{tqc.DEFAULTS_TO_PANDAS} IO calls defaulted to pandas")
    free_device_memory()
    launches = gk.LAUNCHES
    emit({"phase": "io", "bincount_launches": launches, "defaults_to_pandas": 0,
          "native_splits": chunker.NATIVE_SPLITS, "parallel_reads": file_dispatcher.PARALLEL_READS,
          "seconds": time.perf_counter() - t_phase})
    if launches == 0:
        raise AssertionError("the io path never launched the bincount kernel")
    return launches


# ---------------------------------------------------------------------- #
# 9. windows, cumulative ops and the rest of groupby
# ---------------------------------------------------------------------- #

# float64 machine epsilon
EPS64 = 2.0 ** -52


class Tol:
    """How one query's floats are held to pandas: ``kind`` names the rule,
    ``atol``/``rtol`` give |port - pandas| <= atol + rtol |pandas| per
    column (``atol`` may be an array per row), ``squared`` compares squares
    (std against the variance's bound)."""

    def __init__(self, kind: str, rtol: float = 0.0, atol=None, squared: bool = False, why: str = ""):
        self.kind, self.rtol, self.atol, self.squared, self.why = kind, rtol, atol, squared, why

    def describe(self) -> str:
        return f"{self.kind}: {self.why}" if self.why else self.kind


EXACT = Tol("exact", why="equal values (ints, moved or exactly rounded floats)")
RTOL = Tol("rtol", rtol=FLOAT_RTOL, why=f"rtol {FLOAT_RTOL}: sums taken in another order")
# the JAX package's grid tolerance for ewm against pandas; the recurrences
# decay (|a| <= 1), so their error does not grow with the length
EWM_TOL = Tol("ewm", rtol=1e-9, atol=1e-12, why="rtol 1e-9 + atol 1e-12: decaying recurrences, another order")


def centred_square_prefix(p) -> dict:
    """Per column, P_i: the prefix sums of squared globally centred values
    (the scale of pandas' running-update drift)."""
    out = {}
    for label in p.columns:
        x = p[label].to_numpy(np.float64)
        xc = x - x.mean()
        out[label] = np.cumsum(xc * xc)
    return out


def window_own_squares(p, window) -> dict:
    """Per column of ints, each window's own centred sum of squares,
    (k sum x^2 - (sum x)^2) / k, from exact int64 window sums (``window``
    None: expanding)."""
    out = {}
    for label in p.columns:
        x = p[label].to_numpy(np.int64)
        c1 = np.concatenate([[0], np.cumsum(x)])
        c2 = np.concatenate([[0], np.cumsum(x * x)])
        i = np.arange(len(x))
        lo = np.zeros_like(i) if window is None else np.maximum(i - window + 1, 0)
        k = i - lo + 1
        s1, s2 = c1[i + 1] - c1[lo], c2[i + 1] - c2[lo]
        out[label] = (k * s2 - s1 * s1).astype(np.float64) / k
    return out


def window_var_tol(prefix: dict, own: dict, window, ddof: int = 1) -> dict:
    """Per-row bound of a rolling (``window``) or expanding (None) variance
    against pandas: the port's partials are block-local sums shifted by a
    value of the window, so its error scales with the window's own sum of
    squares Q_i (1024 eps Q_i); pandas' running update drifts with the
    prefix P_i of squared centred values (2048 eps P_i; at most 484 eps P_i
    measured on 5e6 int rows on the CPU), each over (rows - ddof).  Q_i <=
    P_i, so this is tighter on every row than the earlier bound, 4096 eps
    P_i / (rows - ddof), which the prefix-sum windows needed."""
    out = {}
    for label, pre in prefix.items():
        rows = np.arange(1, len(pre) + 1)
        if window is not None:
            rows = np.minimum(rows, window)
        out[label] = (1024 * own[label] + 2048 * pre) * EPS64 / np.maximum(rows - ddof, 1)
    return out


def precision_frame(rows: int, seed: int) -> dict:
    """Series whose values differ in scale along the column: ``spike``, ten
    values of 1e15 then N(0, 1); ``trend``, t * 1e3 + N(0, 1)."""
    rng = np.random.default_rng(seed)
    spike = np.concatenate([np.full(10, 1e15), rng.normal(0, 1, rows - 10)])
    trend = np.arange(rows, dtype=np.float64) * 1e3 + rng.normal(0, 1, rows)
    return {"spike": spike, "trend": trend}


def exact_rolling(x: np.ndarray, w: int) -> dict:
    """Per full window of w rows (row i >= w-1; 0 before): the sum, mean and
    M2 in long double (two-pass about the window's mean), and the window's
    k, S = sum|x|, R = max - min, M = max|x|."""
    from numpy.lib.stride_tricks import sliding_window_view

    n = len(x)
    out = {key: np.zeros(n) for key in ("sum", "mean", "m2", "S", "R", "M")}
    win = sliding_window_view(x.astype(np.longdouble), w)
    step = 1 << 20
    for lo in range(0, len(win), step):
        v = win[lo:lo + step]
        total = v.sum(axis=1)
        mean = total / w
        d = v - mean[:, None]
        rows = slice(lo + w - 1, lo + w - 1 + len(v))
        out["sum"][rows] = total
        out["mean"][rows] = mean
        out["m2"][rows] = (d * d).sum(axis=1) - d.sum(axis=1) ** 2 / w
        out["S"][rows] = np.abs(v).sum(axis=1)
        out["R"][rows] = v.max(axis=1) - v.min(axis=1)
        out["M"][rows] = np.abs(v).max(axis=1)
    out["k"] = np.full(n, float(w))
    return out


def precision_queries(pp, w: int = 10) -> dict:
    """name -> (query over one frame, tolerance) for the spike and trend
    series: the port's error against the exact window may exceed pandas'
    own by the block-partial bound, g = (ceil(log2 n) + 58) eps the scan
    kernel's depth and one merge: sum g S, mean g S / k, var 4 k (g R^2 +
    eps R M) / (k - 1), each plus 8 eps of the exact variance for the
    rounding of the division and the square root."""
    n = len(pp)
    g = (int(np.ceil(np.log2(max(n, 2)))) + 58) * EPS64
    ops = ("sum", "mean", "var", "std")
    atol = {op: {} for op in ops}
    for label in pp.columns:
        x = pp[label].to_numpy(np.float64)
        ex = exact_rolling(x, w)
        want = {op: getattr(pp[label].rolling(w), op)().to_numpy() for op in ops}
        k = ex["k"]
        exact = {"sum": ex["sum"], "mean": ex["mean"], "var": ex["m2"] / (k - 1)}
        var_bound = 4 * k * (g * ex["R"] ** 2 + EPS64 * ex["R"] * ex["M"]) / (k - 1) + 8 * EPS64 * exact["var"]
        pandas_err = lambda got, e: np.nan_to_num(np.abs(got - e), nan=0.0)  # noqa: E731
        atol["sum"][label] = (pandas_err(want["sum"], exact["sum"]) + g * ex["S"]).astype(np.float64)
        atol["mean"][label] = (pandas_err(want["mean"], exact["mean"]) + g * ex["S"] / k
                               + EPS64 * np.abs(exact["mean"])).astype(np.float64)
        atol["var"][label] = (pandas_err(want["var"], exact["var"]) + var_bound).astype(np.float64)
        atol["std"][label] = (pandas_err(want["std"] ** 2, exact["var"]) + var_bound).astype(np.float64)
    why = "|pandas - exact| + the block-partial bound (g S, g S / k, 4 k (g R^2 + eps R M) / (k - 1))"
    return {
        f"precision_rolling_{w}_{op}": ((lambda d, op=op: getattr(d.rolling(w), op)()),
                                        Tol("exact window", atol=atol[op], squared=op == "std", why=why))
        for op in ops
    }


def finite_abs(x: np.ndarray) -> np.ndarray:
    """|x| where x is finite, else 0 (NaN and +/-inf: missing or absorbing)."""
    return np.where(np.isfinite(x), np.abs(x), 0.0)


def moment_tol(p, k: int) -> float:
    """Bound of a standardized k-th moment of n values summed in another
    order: 2 n eps sum|d|^k / n / m2^(k/2)."""
    worst = 0.0
    for label in p.columns:
        x = p[label].to_numpy(np.float64)
        x = x[~np.isnan(x)]
        d = x - x.mean()
        m2 = np.mean(d * d)
        if m2 > 0:
            worst = max(worst, 2 * len(x) * EPS64 * np.mean(np.abs(d) ** k) / m2 ** (k / 2))
    return worst


def assert_close_pandas(got, want, what: str, tol: Tol) -> None:
    """Same type, index, labels, dtypes and NaN positions; values within
    ``tol``."""
    import pandas

    if tol.kind == "exact":
        assert_same_pandas(got, want, what, exact=True)
        return
    if tol.kind == "rtol":
        assert_same_pandas(got, want, what)
        return
    if type(got) is not type(want):
        raise AssertionError(f"{what}: {type(got).__name__} != {type(want).__name__}")
    if not got.index.equals(want.index):
        raise AssertionError(f"{what}: index differs")
    if isinstance(want, pandas.Series):
        got, want = got.to_frame(), want.to_frame()
    if list(got.columns) != list(want.columns):
        raise AssertionError(f"{what}: columns differ")
    for i, label in enumerate(want.columns):
        g, w = got.iloc[:, i], want.iloc[:, i]
        if g.dtype != w.dtype:
            raise AssertionError(f"{what}[{label}]: dtype {g.dtype} != {w.dtype}")
        g, w = g.to_numpy(np.float64), w.to_numpy(np.float64)
        if not np.array_equal(np.isnan(g), np.isnan(w)):
            raise AssertionError(f"{what}[{label}]: NaN positions differ")
        if not np.array_equal(np.isinf(g), np.isinf(w)) or not np.array_equal(g[np.isinf(g)], w[np.isinf(w)]):
            raise AssertionError(f"{what}[{label}]: infinities differ")
        atol = tol.atol.get(label, 0.0) if isinstance(tol.atol, dict) else (tol.atol or 0.0)
        finite = np.isfinite(w)
        g, w = g[finite], w[finite]
        if isinstance(atol, np.ndarray):
            atol = atol[finite]
        if tol.squared:
            g, w = g * g, w * w
        bad = np.abs(g - w) > atol + tol.rtol * np.abs(w)
        if bad.any():
            raise AssertionError(f"{what}[{label}]: {int(bad.sum())} values beyond {tol.describe()}")


def window_queries(p, f) -> dict:
    """name -> (query over (frame, float frame), tolerance).  ``p`` and ``f``
    are the pandas frames (the tolerances read their values)."""
    nf = len(f)
    groups = int(p["groupby_col"].value_counts().max())
    grp_tol = Tol("group", rtol=max(FLOAT_RTOL, 4 * groups * EPS64),
                  why=f"rtol 4 m eps with m = {groups} rows in the largest group: pandas updates a running variance")
    prefix = centred_square_prefix(p)
    std_tol = {
        w: Tol("window var", atol=window_var_tol(prefix, window_own_squares(p, w), w), squared=True,
               why="(1024 eps Q_i + 2048 eps P_i) / (rows - 1) on the squares, Q_i the window's own "
                   "centred sum of squares, P_i the prefix sum of squared centred values")
        for w in (10, 1000, None)
    }
    del prefix
    fsum = {label: np.cumsum(finite_abs(f[label].to_numpy(np.float64))) for label in f.columns}
    cum_f = Tol("cumsum", atol={k: 2 * nf * EPS64 * v for k, v in fsum.items()},
                why="2 n eps sum|x|: two orders of n additions")
    roll_f = Tol("window sum", rtol=FLOAT_RTOL, atol={k: 4096 * EPS64 * v / 10 for k, v in fsum.items()},
                 why="4096 eps sum|x| / 10 of the prefix sums")
    gcum_f = Tol("cumsum", atol=2 * nf * EPS64 * float(fsum["val"][-1]), why="2 n eps sum|x|")
    del fsum
    return {
        # the asv frame: cumulative ops, shift/diff, pow and the moments
        "cumsum": (lambda d, e: d.cumsum(), EXACT),
        "cummax": (lambda d, e: d.cummax(), EXACT),
        "shift_1": (lambda d, e: d.shift(1), EXACT),
        "diff": (lambda d, e: d.diff(), EXACT),
        "pow_half": (lambda d, e: d ** 0.5, RTOL),
        "skew": (lambda d, e: d.skew(), Tol("moment", atol=moment_tol(p, 3), why="2 n eps E|d|^3 / m2^1.5")),
        "kurt": (lambda d, e: d.kurt(), Tol("moment", atol=4 * moment_tol(p, 4), why="4 x 2 n eps E|d|^4 / m2^2")),
        # rolling windows of 10 and 1000 rows (asv rolling.Methods), expanding
        **{f"rolling_{w}_{op}": ((lambda d, e, w=w, op=op: getattr(d.rolling(w), op)()),
                                 std_tol[w] if op == "std" else RTOL)
           for w in (10, 1000) for op in ("sum", "mean", "std", "min", "max", "count")},
        "expanding_mean": (lambda d, e: d.expanding().mean(), RTOL),
        "expanding_std": (lambda d, e: d.expanding().std(), std_tol[None]),
        # exponentially weighted (asv rolling.EWMMethods)
        "ewm_halflife10_mean": (lambda d, e: d.ewm(halflife=10).mean(), EWM_TOL),
        "ewm_halflife10_std": (lambda d, e: d.ewm(halflife=10).std(), EWM_TOL),
        "ewm_alpha01_noadjust_mean": (lambda d, e: d.ewm(alpha=0.1, adjust=False).mean(), EWM_TOL),
        "ewm_span20_corr": (lambda d, e: d["col0"].ewm(span=20).corr(d["col1"]), EWM_TOL),
        # the rest of groupby (asv groupby.GroupByMethods, Cumulative, Transform)
        "groupby_median": (lambda d, e: d.groupby("groupby_col").median(), RTOL),
        "groupby_quantile_09": (lambda d, e: d.groupby("groupby_col").quantile(0.9), RTOL),
        "groupby_nunique": (lambda d, e: d.groupby("groupby_col").nunique(), EXACT),
        "groupby_first": (lambda d, e: d.groupby("groupby_col").first(), EXACT),
        "groupby_last": (lambda d, e: d.groupby("groupby_col").last(), EXACT),
        "groupby_var": (lambda d, e: d.groupby("groupby_col").var(), grp_tol),
        # values of +/-1: a product over 2e5 rows that does not overflow
        "groupby_prod": (lambda d, e: (1 - 2 * (d[["col0", "col1"]] % 2)).groupby(d["groupby_col"]).prod(), EXACT),
        "groupby_cumsum": (lambda d, e: d.groupby("groupby_col").cumsum(), EXACT),
        "groupby_cummax": (lambda d, e: d.groupby("groupby_col").cummax(), EXACT),
        "groupby_cumcount": (lambda d, e: d.groupby("groupby_col").cumcount(), EXACT),
        "groupby_transform_mean": (lambda d, e: d.groupby("groupby_col").transform("mean"), RTOL),
        "groupby_agg_list": (lambda d, e: d.groupby("groupby_col").agg(["sum", "mean", "max"]), RTOL),
        "groupby_agg_dict": (lambda d, e: d.groupby("groupby_col").agg(
            {"col0": "sum", "col1": "median", "col2": "nunique", "col3": "std"}), grp_tol),
        "groupby_describe": (lambda d, e: d.groupby("groupby_col").describe(), grp_tol),
        # the NaN float frame of phase 5: NaN skipped, +/-inf missing in windows
        "float_cumsum": (lambda d, e: e.cumsum(), cum_f),
        "float_cumprod": (lambda d, e: (1 + e[["val"]] * 1e-7).cumprod(),
                          Tol("cumprod", rtol=2 * nf * EPS64, why="2 n eps: two orders of n products")),
        "float_pow_2": (lambda d, e: e ** 2, RTOL),
        "float_diff": (lambda d, e: e.diff(), EXACT),
        "float_rolling_10_mean": (lambda d, e: e.rolling(10).mean(), roll_f),
        "float_ewm_mean": (lambda d, e: e.ewm(halflife=10).mean(), EWM_TOL),
        "float_groupby_median": (lambda d, e: e.groupby("key").median(), RTOL),
        "float_groupby_first": (lambda d, e: e.groupby("key").first(), EXACT),
        "float_groupby_cumsum": (lambda d, e: e.groupby("ival")["val"].cumsum(), gcum_f),
    }


def phase_window(rows: int, float_rows: int, seed: int) -> dict:
    """Windows, cumulative ops, shift/diff, pow, skew/kurt and the rest of
    groupby through ``modin_tpu_torch.pandas`` on ``make_frame((rows, 10),
    ngroups=100)`` and the NaN float frame, each against pandas within its
    stated tolerance; no query defaults to pandas, and the scan and
    bincount kernels both launch.  Returns the phase's launches."""
    import pandas
    import torch

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk
    from modin_tpu_torch.ops.cuda import scan_kernels as sk
    from modin_tpu_torch.ops.groupby import clear_factorize_cache

    t_phase = time.perf_counter()
    p = _pandas_frame(make_frame_data(rows, seed + 40, ngroups=100))
    f = pandas.DataFrame(float_frame(float_rows, seed + 41))
    # +/-inf rows: missing in every window aggregation (pandas' rule)
    f.loc[f.index[5::100_003], "val"] = np.inf
    f.loc[f.index[7::100_019], "val"] = -np.inf
    pp = pandas.DataFrame(precision_frame(rows, seed + 42))
    t, tf, tp = tpd.from_pandas(p), tpd.from_pandas(f), tpd.from_pandas(pp)
    runs = [(name, (lambda fn=fn: fn(t, tf)), (lambda fn=fn: fn(p, f)), tol,
             float_rows if name.startswith("float_") else rows)
            for name, (fn, tol) in window_queries(p, f).items()]
    runs += [(name, (lambda fn=fn: fn(tp)), (lambda fn=fn: fn(pp)), tol, rows)
             for name, (fn, tol) in precision_queries(pp).items()]
    clear_factorize_cache()
    gk.LAUNCHES = 0
    sk.LAUNCHES = 0
    tqc.DEFAULTS_TO_PANDAS = 0
    for name, port_fn, pandas_fn, tol, frame_rows in runs:
        scans, bins = sk.LAUNCHES, gk.LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        result, port_ms = host_ms(port_fn)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if tqc.DEFAULTS_TO_PANDAS != 0:
            raise AssertionError(f"{name}: the query defaulted to pandas")
        assert_on_cuda(result._query_compiler, name)
        got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(result))
        del result
        t0 = time.perf_counter()
        want = pandas_fn()
        pandas_ms = (time.perf_counter() - t0) * 1e3
        assert_close_pandas(got, want, name, tol)
        emit({"phase": "window", "query": name, "rows": frame_rows, "out_shape": list(got.shape),
              "port_ms": port_ms, "pandas_ms": pandas_ms, "to_pandas_ms": to_pandas_ms,
              "device_peak_gib": round(peak_gib, 3), "tolerance": tol.describe(),
              "scan_launches": sk.LAUNCHES - scans, "bincount_launches": gk.LAUNCHES - bins,
              "match": True})
        del got, want
        gc.collect()
    launches = {"scan": sk.LAUNCHES, "bincount": gk.LAUNCHES}
    # bit-for-bit repeats of two scan-kernel queries
    repeats = {}
    for name, fn in {"ewm_halflife10_mean": lambda d: d.ewm(halflife=10).mean(),
                     "rolling_10_std": lambda d: d.rolling(10).std()}.items():
        first, second = fn(t), fn(t)
        same = all(
            torch.equal(a.data.view(torch.int64), b.data.view(torch.int64))
            for a, b in zip(first._query_compiler._modin_frame._columns,
                            second._query_compiler._modin_frame._columns)
        )
        repeats[name] = same
        del first, second
        if not same:
            raise AssertionError(f"{name}: two runs differ")
    del t, tf, tp, p, f, pp, runs
    free_device_memory()
    emit({"phase": "window", "scan_launches": launches["scan"], "bincount_launches": launches["bincount"],
          "defaults_to_pandas": 0, "bitwise_repeat": repeats, "seconds": time.perf_counter() - t_phase})
    if launches["scan"] == 0:
        raise AssertionError("the window path never launched the scan kernel")
    if launches["bincount"] == 0:
        raise AssertionError("the window path never launched the bincount kernel")
    return launches


def phase_window_times(rows: int, seed: int, repeats: int) -> None:
    """Host times of phase 9's rolling, expanding and ewm queries on its asv
    frame and of the spike and trend queries: one warm-up call, then the
    median and the least of ``repeats`` calls.  Public API only and no
    reference, so that it times an earlier checkout of the port as well."""
    import pandas
    import torch

    import modin_tpu_torch.pandas as tpd

    p = _pandas_frame(make_frame_data(rows, seed + 40, ngroups=100))
    pp = pandas.DataFrame(precision_frame(rows, seed + 42))
    t, tp = tpd.from_pandas(p), tpd.from_pandas(pp)
    queries = {f"rolling_{w}_{op}": (lambda w=w, op=op: getattr(t.rolling(w), op)())
               for w in (10, 1000) for op in ("sum", "mean", "std", "min", "max", "count")}
    queries.update({
        "expanding_mean": lambda: t.expanding().mean(),
        "expanding_std": lambda: t.expanding().std(),
        "ewm_halflife10_mean": lambda: t.ewm(halflife=10).mean(),
        "ewm_halflife10_std": lambda: t.ewm(halflife=10).std(),
        **{f"precision_rolling_10_{op}": (lambda op=op: getattr(tp.rolling(10), op)())
           for op in ("sum", "mean", "var", "std")},
    })
    for name, fn in queries.items():
        times = []
        for _ in range(repeats + 1):
            result, ms = host_ms(fn)
            del result
            times.append(ms)
        emit({"phase": "window_times", "query": name, "rows": rows, "repeats": repeats,
              "first_ms": times[0], "median_ms": statistics.median(times[1:]), "min_ms": min(times[1:])})
    del t, tp
    free_device_memory()
    torch.cuda.synchronize()


# ---------------------------------------------------------------------- #
# 10. missing data, dtypes, masked assignment and the sort-shaped breadth
# ---------------------------------------------------------------------- #


def clean_frames(rows: int, seed: int):
    """(the asv frame ``make_frame((rows, 10), ngroups=100)``, phase 5's
    float frame with +/-inf rows, the same float frame with a string column
    of three values and missing ones), as pandas frames."""
    import pandas

    p = _pandas_frame(make_frame_data(rows, seed + 50, ngroups=100))
    f = pandas.DataFrame(float_frame(rows, seed + 51))
    f.loc[f.index[5::100_003], "val"] = np.inf
    f.loc[f.index[7::100_019], "val"] = -np.inf
    rng = np.random.default_rng(seed + 52)
    cat = rng.choice(np.array(STRINGS, dtype=object), rows)
    cat[rng.random(rows) < 0.01] = None
    fm = f.assign(cat=cat)
    return p, f, fm


def _loc_set(frame: int, col: str, mask_col: str, value):
    """``df.loc[df[mask_col] > 50, col] = value`` on a copy of frame
    ``frame`` of the three."""
    def fn(*frames):
        d = frames[frame].copy()
        d.loc[d[mask_col] > 50, col] = value
        return d

    return fn


def clean_queries(rows: int) -> dict:
    """name -> fn(asv frame, float frame, mixed frame, pandas module)."""
    k_past_valid = rows - rows // 200  # past the ~99 % valid rows of ``val``
    q = {
        "isna": lambda d, e, m: d.isna(),
        "notna_float": lambda d, e, m: e.notna(),
        "isna_mixed": lambda d, e, m: m.isna(),
        "fillna_0": lambda d, e, m: e.fillna(0),
        "fillna_dict": lambda d, e, m: e.fillna({"key": -1.0, "val": 0.5}),
        "fillna_0_mixed": lambda d, e, m: m.fillna(0),
        "dropna": lambda d, e, m: e.dropna(),
        "dropna_subset_all": lambda d, e, m: e.dropna(subset=["key", "val"], how="all"),
        "astype_float64": lambda d, e, m: d.astype("float64"),
        "astype_float32": lambda d, e, m: d.astype("float32"),
        "astype_int32": lambda d, e, m: d.astype("int32"),
        "round_2": lambda d, e, m: e.round(2),
        "round_-1_ints": lambda d, e, m: d.round(-1),
        "round_2_mixed": lambda d, e, m: m.round(2),
        "clip": lambda d, e, m: e.clip(-1, 1),
        "clip_ints_float_bounds": lambda d, e, m: d.clip(10.5, 50.5),
        "loc_set_int": _loc_set(0, "col1", "col0", 7),
        "loc_set_float": _loc_set(1, "val", "ival", 0.0),
        "loc_set_mixed": _loc_set(2, "val", "ival", -1.5),
        "idxmin": lambda d, e, m: d.idxmin(),
        "idxmax_float": lambda d, e, m: e.idxmax(),
        "series_idxmin": lambda d, e, m: e["val"].idxmin(),
        "series_idxmax": lambda d, e, m: d["col3"].idxmax(),
        "nlargest": lambda d, e, m: d.nlargest(100, "col0"),
        "nsmallest_past_valid": lambda d, e, m: e.nsmallest(k_past_valid, "val"),
        "series_nlargest": lambda d, e, m: e["val"].nlargest(1000),
        "series_nsmallest_past_valid": lambda d, e, m: e["key"].nsmallest(k_past_valid),
    }
    for method in ("average", "min", "max", "first", "dense"):
        for na in ("keep", "top", "bottom"):
            q[f"rank_{method}_{na}_pct"] = (
                lambda d, e, m, method=method, na=na: e[["key"]].rank(method=method, na_option=na, pct=True))
            q[f"rank_{method}_{na}_descending"] = (
                lambda d, e, m, method=method, na=na: e[["key"]].rank(method=method, na_option=na, ascending=False))
    for keep in ("first", "last", False):
        for label, subset, frame in (("col0", ["col0"], 0), ("col0_col1", ["col0", "col1"], 0),
                                     ("str", ["cat"], 2)):
            q[f"duplicated_{label}_{keep}"] = (
                lambda d, e, m, subset=subset, frame=frame, keep=keep:
                (d, e, m)[frame].duplicated(subset, keep=keep))
            q[f"drop_duplicates_{label}_{keep}"] = (
                lambda d, e, m, subset=subset, frame=frame, keep=keep:
                (d, e, m)[frame].drop_duplicates(subset, keep=keep))
    q["drop_duplicates_ignore_index"] = lambda d, e, m: d.drop_duplicates(["col0", "col1"], ignore_index=True)
    return q


def assert_bitwise_pandas(got, want, what: str) -> None:
    """``assert_same_pandas`` with exact values, and float values equal bit
    for bit (-0.0 is not 0.0) where they are not NaN."""
    import pandas

    assert_same_pandas(got, want, what, exact=True)
    if isinstance(want, pandas.Series):
        got, want = got.to_frame(), want.to_frame()
    for i, label in enumerate(want.columns):
        w = want.iloc[:, i].to_numpy()
        if w.dtype.kind != "f":
            continue
        g = got.iloc[:, i].to_numpy()
        ok = ~np.isnan(w)
        ints = f"i{w.dtype.itemsize}"
        if not np.array_equal(g[ok].view(ints), w[ok].view(ints)):
            raise AssertionError(f"{what}[{label}]: float values differ in their bits")


def assert_device_values_on_cuda(qc, what: str) -> None:
    """Every column of a dtype that can live on the card is on ``cuda``
    (string columns stay on the host)."""
    from modin_tpu_torch.core.dataframe.torch.dataframe import _is_device_dtype

    for col in qc._modin_frame._columns:
        if _is_device_dtype(col.pandas_dtype) and (not col.is_device or col.device.type != "cuda"):
            raise AssertionError(f"{what}: a value column is not on cuda")


def phase_clean(rows: int, seed: int) -> dict:
    """isna/notna, fillna, dropna, astype, round, clip, masked ``loc``
    assignment, idxmin/idxmax, nlargest/nsmallest, every rank method and
    ``na_option`` and duplicated/drop_duplicates through
    ``modin_tpu_torch.pandas`` on the asv frame, the NaN float frame and
    the float frame with a string column at ``rows`` rows: each result equals
    pandas' exactly (floats bit for bit), no query defaults to pandas,
    every value column stays on ``cuda``, and ``rank`` launches the scan
    kernel.  ``fillna(df.mean())`` fills the port's means (the means
    themselves sum in another order, so they are held to rtol 1e-12) and
    is held to pandas' fill of the same values.  Returns the launches."""
    import pandas
    import torch

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk
    from modin_tpu_torch.ops.cuda import scan_kernels as sk

    t_phase = time.perf_counter()
    p, f, fm = clean_frames(rows, seed)
    t, tf, tm = tpd.from_pandas(p), tpd.from_pandas(f), tpd.from_pandas(fm)
    runs = [(name, (lambda fn=fn: fn(t, tf, tm)), (lambda fn=fn: fn(p, f, fm)))
            for name, fn in clean_queries(rows).items()]
    gk.LAUNCHES = 0
    sk.LAUNCHES = 0
    tqc.DEFAULTS_TO_PANDAS = 0
    rank_scans = 0

    def run_one(name, port_fn, pandas_fn, reference=None):
        nonlocal rank_scans
        scans = sk.LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        result, port_ms = host_ms(port_fn)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if tqc.DEFAULTS_TO_PANDAS != 0:
            raise AssertionError(f"{name}: the query defaulted to pandas")
        if hasattr(result, "_query_compiler"):
            assert_device_values_on_cuda(result._query_compiler, name)
            got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(result))
        else:
            got, to_pandas_ms = result, 0.0
        del result
        t0 = time.perf_counter()
        want = pandas_fn()
        pandas_ms = (time.perf_counter() - t0) * 1e3
        if isinstance(want, (pandas.DataFrame, pandas.Series)):
            assert_bitwise_pandas(got, want, name)
        elif got != want:
            raise AssertionError(f"{name}: {got!r} != {want!r}")
        if name.startswith("rank_"):
            rank_scans += sk.LAUNCHES - scans
        emit({"phase": "clean", "query": name, "rows": rows,
              "out_shape": list(getattr(got, "shape", ())), "port_ms": port_ms,
              "pandas_ms": pandas_ms, "to_pandas_ms": to_pandas_ms,
              "device_peak_gib": round(peak_gib, 3), "scan_launches": sk.LAUNCHES - scans,
              "match": True})
        del got, want
        gc.collect()

    for name, port_fn, pandas_fn in runs:
        run_one(name, port_fn, pandas_fn)
    # fillna(df.mean()): the port's means, held to pandas' within rtol
    means = tpd.to_pandas(tf.mean())
    assert_same_values(means.to_numpy(), f.mean().to_numpy(), "mean")
    run_one("fillna_mean", lambda: tf.fillna(tf.mean()), lambda: f.fillna(means))
    launches = {"scan": sk.LAUNCHES, "bincount": gk.LAUNCHES, "rank_scan": rank_scans}
    del t, tf, tm, p, f, fm, runs
    free_device_memory()
    emit({"phase": "clean", "scan_launches": launches["scan"], "rank_scan_launches": rank_scans,
          "bincount_launches": launches["bincount"], "defaults_to_pandas": 0,
          "seconds": time.perf_counter() - t_phase})
    if rank_scans == 0:
        raise AssertionError("rank never launched the scan kernel")
    return launches


# ---------------------------------------------------------------------- #
# 11. datetimes, bool keys, statistics and encodings
# ---------------------------------------------------------------------- #

DATES_CSV_ROWS = 10**6
# (label, rule, keyword arguments) of the resample queries
RESAMPLE_RULES = (("h", "h", {}), ("D", "D", {}), ("W", "W", {}), ("ME", "ME", {}), ("QE", "QE", {}),
                  ("h_right", "h", {"closed": "right", "label": "right"}))
# corr/cov sum n products of each pair in another order than pandas; at the
# phase's 1e7 rows the port and pandas' two-pass cov agree to ~1e-12
CORR_RTOL = 1e-10
DT_FIELDS = ("year", "month", "day", "hour", "minute", "second", "microsecond", "nanosecond", "dayofweek",
             "weekday", "day_of_week", "dayofyear", "day_of_year", "quarter", "daysinmonth", "days_in_month",
             "is_leap_year", "is_month_start", "is_month_end", "is_quarter_start", "is_quarter_end",
             "is_year_start", "is_year_end")
TD_FIELDS = ("days", "seconds", "microseconds", "nanoseconds", "total_seconds")


def dates_frames(rows: int, seed: int) -> dict:
    """The pandas inputs of the dates phase, by name: ``dated`` (a
    datetime64[us] column from 1900 to 2100 with 1 % NaT, the same instants
    as datetime64[ns], their difference from 2000-01-01 as timedelta64, a
    float and an int value column), ``timed`` (a sorted one-minute
    DatetimeIndex with 4 float columns with 1 % NaN, an int and a bool
    column), ``strings`` (phase 10's 3-value string column with 1 % missing,
    as str and as a categorical with an unobserved category), ``asv`` (a
    ``make_frame`` block with an offset column 1e8 + N(0, 1)) and ``dim`` (a
    bool-keyed 2-row dimension)."""
    import pandas

    rng = np.random.default_rng(seed + 60)
    lo, hi = (np.datetime64(d, "us").astype(np.int64) for d in ("1900-01-01", "2100-01-01"))
    ticks = rng.integers(lo, hi, rows)
    ticks[rng.random(rows) < 0.01] = np.iinfo(np.int64).min
    ts = ticks.view("datetime64[us]")
    dated = pandas.DataFrame({
        "ts": ts, "ts_ns": ts.astype("datetime64[ns]"), "td": ts - np.datetime64("2000-01-01", "us"),
        "v": rng.uniform(0, 100, rows), "q": rng.integers(0, 100, rows),
    })
    # positive values: no cancellation in the group and bucket sums, so rtol
    # 1e-12 measures the summation order and nothing else
    timed = pandas.DataFrame(
        {f"f{i}": np.where(rng.random(rows) < 0.01, np.nan, rng.uniform(0, 100, rows)) for i in range(4)},
        index=pandas.date_range("2000-01-01", periods=rows, freq="min"),
    )
    timed["i"] = rng.integers(0, 1000, rows)
    timed["b"] = rng.random(rows) < 0.3
    codes = np.where(rng.random(rows) < 0.01, -1, rng.integers(0, len(STRINGS), rows))
    cat = np.array([*STRINGS, None], dtype=object)[codes]
    strings = pandas.DataFrame({"s": cat})
    strings["c"] = pandas.Categorical.from_codes(np.where(codes < 0, -1, codes + 1),
                                                 categories=["unobserved", *STRINGS])
    asv = _pandas_frame(make_frame_data(rows, seed + 61))
    asv["off"] = 1e8 + rng.normal(size=rows)
    dim = pandas.DataFrame({"b": [False, True], "w": [0.25, 1.75]})
    return {"dated": dated, "timed": timed, "strings": strings, "asv": asv, "dim": dim}


def block_frame(frames: dict):
    """The ``make_frame`` block without the offset column."""
    return frames["asv"][[f"col{i}" for i in range(10)]]


def offset_frame(frames: dict):
    """Two asv columns and the offset column."""
    return frames["asv"][["col0", "col1", "off"]]


# the corr queries without missing values, held to the correlations of
# pandas' two-pass cov (np.cov) of the same frame: pandas' own corr (a
# Welford loop) drifts in its entries near 0 and at the offset, and the
# phase prints how far (pandas_rel_diff_to_reference)
TWO_PASS_CORR = {"corr": block_frame, "corr_offset": offset_frame}


def dates_queries() -> dict:
    """name -> (fn(frames by name, pandas module), check): ``exact``,
    ``rtol`` (FLOAT_RTOL) or ``corr`` (CORR_RTOL; against the correlations
    of pandas' two-pass ``cov`` for the queries of ``TWO_PASS_CORR``)."""
    q = {}
    for col in ("ts", "ts_ns"):
        for name in DT_FIELDS:
            q[f"dt_{name}_{col}"] = (lambda f, pd, col=col, name=name: getattr(f["dated"][col].dt, name), "exact")
    for name in TD_FIELDS[:-1]:
        q[f"td_{name}"] = (lambda f, pd, name=name: getattr(f["dated"]["td"].dt, name), "exact")
    q["td_total_seconds"] = (lambda f, pd: f["dated"]["td"].dt.total_seconds(), "exact")
    for agg in ("sum", "mean", "count"):
        q[f"groupby_year_{agg}"] = (
            lambda f, pd, agg=agg: getattr(f["dated"][["v", "q"]].groupby(f["dated"]["ts"].dt.year), agg)(), "rtol")
        q[f"groupby_year_month_{agg}"] = (
            lambda f, pd, agg=agg: getattr(f["dated"][["v", "q"]].groupby(
                [f["dated"]["ts"].dt.year, f["dated"]["ts"].dt.month]), agg)(), "rtol")
    for label, rule, kwargs in RESAMPLE_RULES:
        for op in ("sum", "mean", "count", "min", "max", "var", "std", "size"):
            q[f"resample_{label}_{op}"] = (
                lambda f, pd, rule=rule, kwargs=kwargs, op=op: getattr(f["timed"].resample(rule, **kwargs), op)(),
                "rtol")
    q["sort_bool"] = (lambda f, pd: f["timed"].sort_values("b", kind="stable"), "exact")
    q["sort_bool_desc_int"] = (lambda f, pd: f["timed"].sort_values(["b", "i"], ascending=[False, True]), "exact")
    q["merge_bool"] = (lambda f, pd: f["timed"].merge(f["dim"], on="b"), "exact")
    q["corr"] = (lambda f, pd: block_frame(f).corr(), "corr")
    q["cov"] = (lambda f, pd: block_frame(f).cov(), "corr")
    q["corr_nan"] = (lambda f, pd: f["timed"].corr(), "corr")
    q["cov_nan"] = (lambda f, pd: f["timed"].cov(), "corr")
    q["corr_offset"] = (lambda f, pd: offset_frame(f).corr(), "corr")
    q["cov_offset"] = (lambda f, pd: offset_frame(f).cov(), "corr")
    q["get_dummies_str"] = (lambda f, pd: pd.get_dummies(f["strings"]["s"]), "exact")
    q["get_dummies_categorical"] = (lambda f, pd: pd.get_dummies(f["strings"]["c"], dummy_na=True), "exact")
    q["map_str"] = (lambda f, pd: f["strings"]["s"].map({"alpha": 1, "beta": 2, "gamma-delta": 3}), "exact")
    q["map_int"] = (lambda f, pd: f["timed"]["i"].map({k: k / 4 for k in range(0, 1000, 3)}), "exact")
    for name in ("sqrt", "log", "floor"):
        q[f"np_{name}"] = (lambda f, pd, name=name: getattr(np, name)(f["timed"][["f0", "f1", "f2", "f3", "i"]]),
                           "exact" if name == "floor" else "rtol")
    return q


def assert_dates_pandas(got, want, what: str, check: str) -> dict:
    """``assert_same_pandas`` (exact or FLOAT_RTOL) with the index and
    Series names, or for corr/cov labels exactly and values to CORR_RTOL;
    returns the largest relative difference to pandas' result found."""
    import pandas

    if check in ("exact", "rtol"):
        assert_same_pandas(got, want, what, exact=check == "exact")
        if list(got.index.names) != list(want.index.names) or (
                isinstance(want, pandas.Series) and got.name != want.name):
            raise AssertionError(f"{what}: names differ")
        return {}
    g, w = got.to_numpy(), want.to_numpy()
    if not (got.index.equals(want.index) and got.columns.equals(want.columns)):
        raise AssertionError(f"{what}: labels differ")
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        raise AssertionError(f"{what}: NaN positions differ")
    ok = ~np.isnan(w)
    rel = float(np.max(np.abs(g[ok] - w[ok]) / np.abs(w[ok]), initial=0.0))
    if rel > CORR_RTOL:
        raise AssertionError(f"{what}: relative difference {rel} beyond {CORR_RTOL}")
    return {"max_rel_diff": rel}


def phase_dates(rows: int, seed: int, workdir: str) -> dict:
    """``.dt`` fields (both units) and timedelta fields, groupby on ``.dt``
    keys, resample in every device op, bool sort and merge keys, corr/cov
    (with and without NaN, and at a large offset), get_dummies, dict
    ``Series.map`` and ``np.sqrt``/``np.log``/``np.floor`` through
    ``modin_tpu_torch.pandas`` at ``rows`` rows, then a 1e6-row
    ``read_csv(parse_dates=...)``: each result equals pandas' (floats to
    FLOAT_RTOL, corr/cov to CORR_RTOL), no query defaults to pandas, the
    value columns stay on ``cuda``, and the path launches the bincount
    kernel.  ``corr`` and ``corr_offset`` are held to the correlations of
    pandas' two-pass ``cov`` (``TWO_PASS_CORR``), and pandas' own ``corr``'s
    distance from them is printed.  Returns the launches."""
    import pandas
    import torch

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk
    from modin_tpu_torch.ops.cuda import scan_kernels as sk

    t_phase = time.perf_counter()
    frames = dates_frames(rows, seed)
    port_frames = {k: tpd.from_pandas(v) for k, v in frames.items()}
    emit({"phase": "dates", "setup_seconds": time.perf_counter() - t_phase, "rows": rows})
    gk.LAUNCHES = 0
    sk.LAUNCHES = 0
    tqc.DEFAULTS_TO_PANDAS = 0
    totals = {"port_s": 0.0, "pandas_s": 0.0, "to_pandas_s": 0.0}

    def run_one(name, port_fn, pandas_fn, check, reference=None):
        """Run, time and check one query; ``reference`` replaces pandas'
        result as the value the port is held to."""
        launches = gk.LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        result, port_ms = host_ms(port_fn)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if tqc.DEFAULTS_TO_PANDAS != 0:
            raise AssertionError(f"{name}: the query defaulted to pandas")
        assert_device_values_on_cuda(result._query_compiler, name)
        got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(result))
        del result
        t0 = time.perf_counter()
        want = pandas_fn()
        pandas_ms = (time.perf_counter() - t0) * 1e3
        extra = assert_dates_pandas(got, want if reference is None else reference, name, check)
        if reference is not None:
            ok = ~np.isnan(reference.to_numpy())
            extra["pandas_rel_diff_to_reference"] = float(np.max(
                np.abs(want.to_numpy() - reference.to_numpy())[ok] / np.abs(reference.to_numpy()[ok])))
        for key, ms in (("port_s", port_ms), ("pandas_s", pandas_ms), ("to_pandas_s", to_pandas_ms)):
            totals[key] += ms / 1e3
        emit({"phase": "dates", "query": name, "rows": rows, "out_shape": list(got.shape),
              "port_ms": port_ms, "pandas_ms": pandas_ms, "to_pandas_ms": to_pandas_ms,
              "device_peak_gib": round(peak_gib, 3), "bincount_launches": gk.LAUNCHES - launches,
              "check": check, **extra, "match": True})

    for name, (fn, check) in dates_queries().items():
        reference = None
        if name in TWO_PASS_CORR:
            # pandas' two-pass cov (np.cov) normalised by its diagonal
            cov = TWO_PASS_CORR[name](frames).cov()
            sd = np.sqrt(np.diag(cov.to_numpy()))
            reference = cov / np.outer(sd, sd)
        run_one(name, lambda fn=fn: fn(port_frames, tpd), lambda fn=fn: fn(frames, pandas), check, reference)

    # read_csv(parse_dates=...): the parsed column lands on the card as ticks
    path = os.path.join(workdir, "dated.csv")
    n_csv = min(DATES_CSV_ROWS, rows)
    frames["dated"].iloc[:n_csv][["ts", "v", "q"]].to_csv(path, index=False)
    result, port_ms = host_ms(lambda: _materialized_read(tpd.read_csv(path, parse_dates=["ts"])))
    col = result._query_compiler._modin_frame.get_column(0)
    if not (col.is_device and col.data.device.type == "cuda" and col.data.dtype == torch.int64):
        raise AssertionError("read_csv(parse_dates): the datetime column is not int64 ticks on cuda")
    got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(result))
    t0 = time.perf_counter()
    want = pandas.read_csv(path, parse_dates=["ts"])
    pandas_ms = (time.perf_counter() - t0) * 1e3
    assert_dates_pandas(got, want, "read_csv_parse_dates", "exact")
    if tqc.DEFAULTS_TO_PANDAS != 0:
        raise AssertionError("read_csv_parse_dates: defaulted to pandas")
    emit({"phase": "dates", "query": "read_csv_parse_dates", "rows": n_csv, "port_ms": port_ms,
          "pandas_ms": pandas_ms, "to_pandas_ms": to_pandas_ms, "dtype": str(col.pandas_dtype),
          "device": str(col.data.device), "match": True})
    os.unlink(path)
    launches = {"bincount": gk.LAUNCHES, "scan": sk.LAUNCHES}
    del result, got, want, col, port_frames, frames
    free_device_memory()
    emit({"phase": "dates", "bincount_launches": launches["bincount"], "scan_launches": launches["scan"],
          "defaults_to_pandas": 0, **totals, "seconds": time.perf_counter() - t_phase})
    if launches["bincount"] == 0:
        raise AssertionError("the dates path never launched the bincount kernel")
    return launches


# ---------------------------------------------------------------------- #
# 12. lazy fusion: deferred chains, one fused launch per consumer
# ---------------------------------------------------------------------- #

FUSION_TAILS = ("sum", "mean", "count", "min", "max", "prod", "var", "std", "sem", "skew", "kurt", "any", "all")
# fused launches of the 161-node chain: past lazy._MAX_NODES it materializes,
# and its 160 scalars need five programs of at most 32 scalar slots (the
# planner is deterministic: the count is the same on the CPU and the card)
CHAIN_161_LAUNCHES = 6


def fusion_frames(rows: int, seed: int) -> dict:
    """The fusion phase's pandas frames: two asv int frames (``p``,
    ``p2``), phase 5's NaN float frame with +/-inf rows plus a float32, an
    int8, a uint8 and a bool column (``f``), and three float columns with
    1 % NaN whose ``a * b + c`` is 1 +/- ~3e-3: its product stays finite at
    2e7 rows (about exp(-n * 3.6e-6)), and its second to fourth moments lie
    far above pandas' 1e-14 round-off thresholds (``m``)."""
    import pandas

    p = _pandas_frame(make_frame_data(rows, seed + 90))
    p2 = _pandas_frame(make_frame_data(rows, seed + 91))
    f = pandas.DataFrame(float_frame(rows, seed + 92))
    f.loc[f.index[5::100_003], "val"] = np.inf
    f.loc[f.index[7::100_019], "val"] = -np.inf
    rng = np.random.default_rng(seed + 93)
    f32 = rng.normal(0, 10, rows).astype(np.float32)
    f32[rng.random(rows) < 0.01] = np.nan
    f["f32"] = f32
    f["i8"] = rng.integers(-128, 128, rows).astype(np.int8)
    f["u8"] = rng.integers(0, 256, rows).astype(np.uint8)
    f["flag"] = rng.random(rows) < 0.5
    m = {}
    for name, loc, scale in (("a", 0.0, 0.05), ("b", 0.0, 0.05), ("c", 1.0, 1e-3)):
        v = rng.normal(loc, scale, rows)
        v[rng.random(rows) < 0.01] = np.nan
        m[name] = v
    return {"p": p, "p2": p2, "f": f, "m": pandas.DataFrame(m)}


def _chain_161(d):
    s = d["f"]["i8"]  # int8 wraps as numpy does (and pandas' 161 adds stay cheap)
    for i in range(161):
        s = s + (i % 3)
    return s


# ``(x - mean) / std`` subtracts a sum taken in another order: near the mean
# one ulp of the mean is more than 1e-12 of the result (pandas' own result
# is up to 7.6e-11 from the exact one at 1e7 rows), so the chain is held bit
# for bit to pandas' elementwise ops over the port's own mean and std, and
# those to pandas' within rtol 1e-12
OWN_REDUCTIONS = Tol("own reductions", rtol=FLOAT_RTOL,
                     why=f"bit for bit over the port's mean and std, those within rtol {FLOAT_RTOL} of pandas'")


def fusion_queries(pandas_frames: dict) -> dict:
    """name -> (query over a dict of frames, tolerance, predicted fused
    launches): one per materialized chain, one per reduction tail (two for
    var/std/sem/skew/kurt, whose second pass sums powers about the first
    pass's means), CHAIN_161_LAUNCHES for the chain past the depth cap."""
    floats = ["key", "val", "f32"]
    queries = {
        "mul2_add1": (lambda d: d["p"] * 2 + 1, EXACT, 1),
        "standardize": (lambda d: (d["m"] - d["m"].mean()) / d["m"].std(), OWN_REDUCTIONS, 1),
        "df1_plus_df2_times_df1": (lambda d: d["p"] + d["p2"] * d["p"], EXACT, 1),
        "sum_axis1": (lambda d: (d["p"] * 2 + 1).sum(axis=1), EXACT, 1),
        "filter_and": (lambda d: d["p"][(d["p"]["col0"] > 50) & (d["p"]["col1"] < 5)], EXACT, 1),
        "sqrt_abs_plus1": (lambda d: np.sqrt(d["f"][floats].abs()) + 1, EXACT, 1),
        "fillna_clip_round": (lambda d: d["f"][floats].fillna(0).clip(-1, 1).round(2), EXACT, 1),
        "f32_chain": (lambda d: d["f"]["f32"] * 0.1 + 2, EXACT, 1),
        "i8_wrap": (lambda d: d["f"]["i8"] * 3 + 100, EXACT, 1),
        "u8_wrap": (lambda d: d["f"]["u8"] - 200, EXACT, 1),
        "i8_plus_u8": (lambda d: d["f"]["i8"] + d["f"]["u8"], EXACT, 1),
        "int_floordiv_mod": (lambda d: d["p"] // 7 + (d["p"] % -5) * 1000, EXACT, 1),
        "float_floordiv": (lambda d: d["f"]["val"] // 0.1, EXACT, 1),
        "float_mod": (lambda d: d["f"]["val"] % 0.3, EXACT, 1),
        "diamond": (lambda d: (lambda x: x * x - x)(d["m"]["a"] + d["m"]["b"]), EXACT, 1),
        "bool_chain": (lambda d: (d["f"]["flag"] & (d["f"]["key"] > 50)) | (d["f"]["i8"] < 0), EXACT, 1),
        "chain_161": (_chain_161, EXACT, CHAIN_161_LAUNCHES),
        "mul2": (lambda d: d["p"] * 2, EXACT, 1),
        "mul3": (lambda d: d["p"] * 3, EXACT, 1),
    }
    m = pandas_frames["m"]
    axpb = (m["a"] * m["b"] + m["c"]).to_frame()
    for op in FUSION_TAILS:
        for skipna in ((True,) if op == "count" else (True, False)):
            if op in ("skew", "kurt"):
                k = 3 if op == "skew" else 4
                tol = Tol(op, rtol=FLOAT_RTOL, atol=moment_tol(axpb, k),
                          why=f"rtol {FLOAT_RTOL} + the bound of a standardized {k}-th moment summed in another order")
            elif op in ("min", "max", "count", "any", "all"):
                tol = EXACT
            elif op == "prod":
                n = len(axpb)
                tol = Tol("prod", rtol=2 * n * EPS64, why=f"rtol 2 n eps = {2 * n * EPS64:.3g}: a product of "
                          f"n factors in another order")
            else:
                tol = RTOL
            kw = {} if op == "count" else {"skipna": skipna}
            queries[f"axpb_{op}" + ("" if skipna else "_noskip")] = (
                lambda d, op=op, kw=kw: getattr(d["m"]["a"] * d["m"]["b"] + d["m"]["c"], op)(**kw),
                tol, 2 if op in ("var", "std", "sem", "skew", "kurt") else 1)
    return queries


def _same_device_values(got, want, what: str) -> None:
    """Two port results with equal columns on the device, bit for bit."""
    import torch

    def bits(t):
        return t.view(torch.int64 if t.element_size() == 8 else torch.int32) if t.is_floating_point() else t

    if hasattr(want, "_query_compiler"):
        gcols, wcols = got._query_compiler._modin_frame._columns, want._query_compiler._modin_frame._columns
        if len(gcols) != len(wcols):
            raise AssertionError(f"{what}: {len(gcols)} columns != {len(wcols)}")
        for g, w in zip(gcols, wcols):
            if g.dtype != w.dtype or not torch.equal(bits(g.data), bits(w.data)):
                raise AssertionError(f"{what}: a column differs")
    else:
        _scalar_close(got, want, what, EXACT)


def _scalar_close(got, want, what: str, tol) -> None:
    g, w = np.asarray(got), np.asarray(want)
    if g.dtype != w.dtype:
        raise AssertionError(f"{what}: dtype {g.dtype} != {w.dtype}")
    if w.dtype.kind != "f" or tol.kind == "exact":
        if not np.array_equal(g, w, equal_nan=w.dtype.kind == "f"):
            raise AssertionError(f"{what}: {got!r} != {want!r}")
        return
    atol = tol.atol or 0.0
    if np.isnan(w) != np.isnan(g) or (np.isfinite(w) and abs(float(g) - float(w)) > atol + tol.rtol * abs(float(w))):
        raise AssertionError(f"{what}: {got!r} != {want!r} within {tol.describe()}")


class _PlainRoute:
    """Within the block, a fused program runs through ``run_program_plain``
    on the card (the eager torch ops the fused launch replaces)."""

    def __enter__(self):
        from modin_tpu_torch.ops.cuda import fused_kernels as fk

        self.fk, self.launch = fk, fk.run_program

        def plain(program, leaves, scalars, n, *, second_pass=False, first=None, device=None):
            return fk.run_program_plain(program, leaves, scalars, n, second_pass=second_pass, first=first)

        fk.run_program = plain
        return self

    def __exit__(self, *exc):
        self.fk.run_program = self.launch


def phase_fusion(rows: int, seed: int) -> int:
    """Deferred chains through ``modin_tpu_torch.pandas`` at ``rows`` rows
    (``--fusion-rows``): elementwise chains, a chain with each reduction
    tail, a row-wise sum, a filter on a lazy mask, the maps, float32 and
    int8/uint8 wrapping, int and float floor division and modulo, a
    diamond, a chain past the depth cap and one program run with two
    scalars.  Each result equals pandas' (bit for bit, rtol 1e-12 where
    sums reorder, the moment bound for skew/kurt) and the same programs
    through ``run_program_plain`` on the card bit for bit; no query
    defaults to pandas; each query launches the fused kernel as often as
    predicted.  Returns the fused launches."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops import lazy
    from modin_tpu_torch.ops.cuda import fused_kernels as fk

    t_phase = time.perf_counter()
    frames = fusion_frames(rows, seed)
    port = {k: tpd.from_pandas(v) for k, v in frames.items()}
    queries = fusion_queries(frames)
    fk.LAUNCHES = 0
    tqc.DEFAULTS_TO_PANDAS = 0
    totals = {"port_ms": 0.0, "pandas_ms": 0.0, "plain_ms": 0.0}

    def materialized(x):
        if hasattr(x, "_query_compiler"):
            x._query_compiler.execute()
        return x

    def fetch(x):
        return tpd.to_pandas(x) if hasattr(x, "_query_compiler") else x

    for name, (fn, tol, predicted) in queries.items():
        cached = lazy.fused_cache_len()
        launches = fk.LAUNCHES
        result, port_ms = host_ms(lambda: materialized(fn(port)))
        launches = fk.LAUNCHES - launches
        if tqc.DEFAULTS_TO_PANDAS != 0:
            raise AssertionError(f"fusion {name}: the query defaulted to pandas")
        if launches != predicted:
            raise AssertionError(f"fusion {name}: {launches} fused launches, predicted {predicted}")
        if name == "mul3" and lazy.fused_cache_len() != cached:
            raise AssertionError("fusion mul3: df * 3 compiled a program where df * 2's serves")
        if hasattr(result, "_query_compiler"):
            assert_on_cuda(result._query_compiler, name)
        with _PlainRoute():
            plain, plain_ms = host_ms(lambda: materialized(fn(port)))
        _same_device_values(result, plain, f"fusion {name} (kernel against plain)")
        del plain
        got, to_pandas_ms = host_ms(lambda: fetch(result))
        del result
        t0 = time.perf_counter()
        want = fn(frames)
        pandas_ms = (time.perf_counter() - t0) * 1e3
        if tol is OWN_REDUCTIONS:
            mean, std = fetch(port["m"].mean()), fetch(port["m"].std())
            assert_same_pandas(mean, frames["m"].mean(), f"fusion {name} mean")
            assert_same_pandas(std, frames["m"].std(), f"fusion {name} std")
            assert_bitwise_pandas(got, (frames["m"] - mean) / std, f"fusion {name}")
        elif isinstance(want, (pandas.DataFrame, pandas.Series)):
            if tol.kind == "exact":
                assert_bitwise_pandas(got, want, f"fusion {name}")
            else:
                assert_close_pandas(got, want, f"fusion {name}", tol)
        else:
            _scalar_close(got, want, f"fusion {name}", tol)
        totals["port_ms"] += port_ms
        totals["pandas_ms"] += pandas_ms
        totals["plain_ms"] += plain_ms
        emit({"phase": "fusion", "query": name, "rows": rows, "out_shape": list(getattr(got, "shape", ())),
              "port_ms": port_ms, "plain_ms": plain_ms, "pandas_ms": pandas_ms, "to_pandas_ms": to_pandas_ms,
              "fused_launches": launches, "predicted_launches": predicted, "tolerance": tol.describe(),
              "match": True})
        if isinstance(want, (pandas.DataFrame, pandas.Series)):
            del got, want
            gc.collect()
    launched = fk.LAUNCHES
    del port, frames
    free_device_memory()
    emit({"phase": "fusion", "fused_launches": launched, "barriers": lazy.BARRIERS, "defaults_to_pandas": 0,
          **totals, "seconds": time.perf_counter() - t_phase})
    return launched


# ---------------------------------------------------------------------- #
# 13. the whole-query planner
# ---------------------------------------------------------------------- #

PLAN_WIDE_ROWS = 10**6


def write_csv(path: str, columns: dict) -> None:
    """A CSV of numpy ``columns`` through pyarrow's threaded writer (pandas'
    took 45 s for the plan phase's files on an H100 host; 4.6 s this way).
    Both readers under test parse the same file."""
    import pyarrow
    import pyarrow.csv

    pyarrow.csv.write_csv(pyarrow.table(columns), path)


def plan_csv(path: str, rows: int, seed: int) -> None:
    """``scripts/plan_smoke.py``'s CSV shape: ints, uniforms, a 0/1 column."""
    rng = np.random.default_rng(seed + 70)
    write_csv(path, {
        "a": rng.integers(-50, 50, rows),
        "b": rng.uniform(0.0, 1.0, rows),
        "c": rng.uniform(-1.0, 1.0, rows),
        "d": rng.integers(0, 1000, rows),
        "e": rng.uniform(0.0, 100.0, rows),
        "f": rng.integers(0, 2, rows),
    })


def _group_magnitude(agg: str, cols: list):
    """The scale of a filtered groupby sum (or mean) of the plan CSV: per
    group, the sum (mean) of the values' magnitudes.  No summation order
    bounds a sum's error by its own size where it cancels (a group of 2500
    values in [-1, 1] sums to 6e-3 beside a magnitude of ~1250); every order
    bounds it by this magnitude."""

    def scale(df):
        kept = df[df["a"] > 0][cols]
        mag = kept.abs().assign(d=kept["d"]).groupby("d").sum()
        return mag if agg == "sum" else mag / kept.groupby("d").count()

    return scale


PLAN_SMALL_ROWS = 2 * 10**5


def plan_files(workdir: str, rows: int, seed: int) -> dict:
    """Phase 13's CSV files: ``main`` (``rows`` rows of the plan shape),
    ``wide`` (a key spanning 2^40, past ``FUSED_MAX_GROUPS``), ``mid``
    (the plan shape at ``PLAN_SMALL_ROWS``), ``cap`` (keys ``k`` spanning
    exactly ``FUSED_MAX_GROUPS`` values and ``k1`` one more, the first rows
    kept by ``v > 0.5``), and ``floor_below``/``floor_at`` (the plan shape
    at ``FuseMinRows`` - 1 and ``FuseMinRows`` rows)."""
    from modin_tpu_torch.config import FuseMinRows
    from modin_tpu_torch.ops import groupby as gb_ops

    paths = {name: os.path.join(workdir, f"{name}.csv")
             for name in ("main", "wide", "mid", "cap", "floor_below", "floor_at")}
    plan_csv(paths["main"], rows, seed)
    rng = np.random.default_rng(seed + 71)
    write_csv(paths["wide"], {"k": rng.integers(0, 2**40, PLAN_WIDE_ROWS),
                              "v": rng.uniform(0.0, 1.0, PLAN_WIDE_ROWS)})
    plan_csv(paths["mid"], PLAN_SMALL_ROWS, seed + 1)
    cap = gb_ops.FUSED_MAX_GROUPS
    k, k1 = rng.integers(0, cap, PLAN_SMALL_ROWS), rng.integers(0, cap + 1, PLAN_SMALL_ROWS)
    v = rng.uniform(0.0, 1.0, PLAN_SMALL_ROWS)
    k[:2], k1[:2], v[:2] = (0, cap - 1), (0, cap), 0.9
    write_csv(paths["cap"], {"k": k, "k1": k1, "v": v})
    floor = int(FuseMinRows.get())
    plan_csv(paths["floor_below"], floor - 1, seed + 2)
    plan_csv(paths["floor_at"], floor, seed + 3)
    return paths


def _eager_groupagg_launches(agg: str, cols: list, by: str, where: str):
    """The groupagg launches predicted for the eager groupby that the staged
    lowering runs for ``query(where)[cols].groupby(by).agg(agg)`` of a
    frame: one where the route gate (``ops/groupby.takes_groupagg``, under
    the query's ``FuseMode``) takes the kernel for the kept rows, their
    group count and the value columns' dtypes, else none."""

    def predict(df) -> int:
        import torch

        from modin_tpu_torch.ops import groupby as gb_ops

        kept = df.query(where)
        dtypes = [torch.from_numpy(np.zeros(0, kept[c].dtype)).dtype for c in cols if c != by]
        return int(gb_ops.takes_groupagg(agg, dtypes, int(kept[by].nunique()), len(kept)))

    return predict


def plan_queries(paths: dict) -> dict:
    """name -> (pipeline(pd), file, FuseMode, route, fused-kernel launches,
    groupagg launches, columns parsed, the scale of its float results or
    None).  ``route`` is the fused leg's outcome: ``fused`` (one dispatch),
    ``declined`` (one decline) or ``staged`` (the gate kept it staged:
    neither).  A masked reduce is one launch (two for a moments op), a fused
    groupby three: the probe and the slot launch of the fused kernel, then
    groupagg; a declined or staged query's fused launches are the staged
    path's (not predicted), and its groupagg launches are the eager
    groupby's, where the route gate takes the kernel
    (``_eager_groupagg_launches``).  The groupbys by ``d`` (1000 keys, 1025
    slots) keep ``groupagg``'s whole table in one block's shared memory with
    two and with five value columns; ``cap``'s key ``k`` (65 537 slots)
    splits it into slot ranges, where Auto declines and Fused takes them;
    ``cap`` puts the key range on each side of ``FUSED_MAX_GROUPS`` and
    ``floor_*`` the rows on each side of ``FuseMinRows``."""
    main = paths["main"]
    queries = {}
    for agg, launches in (("sum", 1), ("mean", 1), ("var", 2), ("min", 1), ("max", 1), ("count", 1)):
        queries[f"filter_project_{agg}"] = (
            lambda pd, agg=agg: pd.read_csv(main).query("a > 0")[["b", "c"]].agg(agg), main, "Auto", "fused",
            launches, 0, 3, None)

    def map_chain(pd):
        df = pd.read_csv(main)
        kept = df[df["a"] > 0]
        return ((kept["b"] * 2 + kept["c"]) * kept["e"]).sum()

    def stacked(pd):
        df = pd.read_csv(main)
        kept = df[df["a"] > 0]
        kept = kept[kept["b"] > 0.5]
        return kept[kept["e"] < 60.0][["c", "e"]].agg("sum")

    def groupby(path, cols, agg, by="d", where="a > 0"):
        return lambda pd: pd.read_csv(path).query(where)[list(cols)].groupby(by).agg(agg)

    queries["map_chain_sum"] = (map_chain, main, "Auto", "fused", 1, 0, 4, None)
    queries["stacked_filters_sum"] = (stacked, main, "Auto", "fused", 1, 0, 4, None)
    for agg in ("sum", "mean", "count", "min", "max", "prod"):
        cols = ["d", "b", "f"] if agg == "prod" else ["a", "c", "d"]
        queries[f"groupby_{agg}"] = (
            groupby(main, cols, agg), main, "Auto", "fused", 2, 1, 4 if agg == "prod" else 3,
            _group_magnitude(agg, cols) if agg in ("sum", "mean") else None)
    five = ["a", "b", "c", "d", "e", "f"]
    queries["groupby_sum_five_columns_fused"] = (
        groupby(paths["mid"], five, "sum"), paths["mid"], "Auto", "fused", 2, 1, 6,
        _group_magnitude("sum", five))
    queries["groupby_sum_slot_ranges_declines"] = (
        groupby(paths["cap"], ["k", "v"], "sum", "k", "v > 0.5"), paths["cap"], "Auto", "declined", None,
        _eager_groupagg_launches("sum", ["k", "v"], "k", "v > 0.5"), 2, None)
    queries["groupby_sum_key_range_at_cap_fused"] = (
        groupby(paths["cap"], ["k", "v"], "sum", "k", "v > 0.5"), paths["cap"], "Fused", "fused", 2, 1, 2, None)
    queries["groupby_sum_key_range_past_cap_declines"] = (
        groupby(paths["cap"], ["k1", "v"], "sum", "k1", "v > 0.5"), paths["cap"], "Fused", "declined", None,
        _eager_groupagg_launches("sum", ["k1", "v"], "k1", "v > 0.5"), 2, None)
    queries["groupby_wide_key_declines"] = (
        lambda pd: pd.read_csv(paths["wide"]).query("v > 0.5").groupby("k").agg("sum"), paths["wide"], "Auto",
        "declined", None, _eager_groupagg_launches("sum", ["k", "v"], "k", "v > 0.5"), 2, None)
    queries["filter_sum_below_min_rows_staged"] = (
        lambda pd: pd.read_csv(paths["floor_below"]).query("a > 0")[["b", "c"]].agg("sum"), paths["floor_below"],
        "Auto", "staged", None, 0, 3, None)
    queries["filter_sum_at_min_rows_fused"] = (
        lambda pd: pd.read_csv(paths["floor_at"]).query("a > 0")[["b", "c"]].agg("sum"), paths["floor_at"],
        "Auto", "fused", 1, 0, 3, None)
    return queries


def _plan_same(got, want, what: str, agg: str, scale=None) -> None:
    """Ints, counts and order-free results exactly; float sums, means and
    variances to rtol 1e-12 (another summation order), a grouped sum or
    mean to 1e-12 of its group's magnitude (``scale``)."""
    import pandas

    exact = agg in ("min", "max", "count")
    if scale is None:
        if isinstance(want, (pandas.DataFrame, pandas.Series)):
            assert_same_pandas(got, want, what, exact=exact)
        else:
            _scalar_close(got, want, what, EXACT if exact else RTOL)
        return
    if type(got) is not type(want) or not got.index.equals(want.index) or list(got.columns) != list(want.columns):
        raise AssertionError(f"{what}: type, index or columns differ")
    for label in want.columns:
        g, w = got[label], want[label]
        if g.dtype != w.dtype:
            raise AssertionError(f"{what}[{label}]: dtype {g.dtype} != {w.dtype}")
        if w.dtype.kind != "f":
            assert_same_values(g.to_numpy(), w.to_numpy(), f"{what}[{label}]", exact=True)
            continue
        bound = FLOAT_RTOL * scale[label].to_numpy(np.float64)
        if not (np.abs(g.to_numpy(np.float64) - w.to_numpy(np.float64)) <= bound).all():
            raise AssertionError(f"{what}[{label}]: values beyond 1e-12 of their groups' magnitudes")


def plan_breakdown(path: str) -> dict:
    """Where the acceptance pipeline's port time goes: the eager parse of
    all six columns and of the three that survive (``PlanMode=Off``), the
    deferred read's header sniff, the whole pipeline under ``Auto``, and
    EXPLAIN ANALYZE's per-node wall times of its plan, re-run with the scan
    cache off so that the Scan parses again."""
    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import PlanMode, PlanScanCacheBytes
    from modin_tpu_torch.plan import explain, ir, runtime

    with PlanMode.context("Off"):
        _, parse_all_ms = host_ms(lambda: _materialized_read(tpd.read_csv(path)))
        _, parse_abc_ms = host_ms(lambda: _materialized_read(tpd.read_csv(path, usecols=["a", "b", "c"])))
    with PlanMode.context("Auto"), PlanScanCacheBytes.context(0):
        df, sniff_ms = host_ms(lambda: tpd.read_csv(path))
        pending = df.query("a > 0")[["b", "c"]]
        _, run_ms = host_ms(lambda: pending.agg("sum"))
        qc = pending._query_compiler
        t0 = time.perf_counter()
        actuals, (root, optimized, applied) = runtime.explain_analyze(qc)
        analyze_ms = (time.perf_counter() - t0) * 1e3
    nodes = [{"node": n.label(), "total_ms": actuals[id(n)]["total_s"] * 1e3,
              "self_ms": actuals[id(n)]["self_s"] * 1e3, "launches": actuals[id(n)]["launches"]}
             for n in ir.walk(optimized) if id(n) in actuals]
    rec = {"phase": "plan", "query": "breakdown", "pipeline": 'read_csv(p).query("a > 0")[["b", "c"]].agg("sum")',
           "off_parse_6_columns_ms": parse_all_ms, "off_parse_3_columns_ms": parse_abc_ms,
           "auto_sniff_ms": sniff_ms, "auto_pipeline_ms": run_ms, "analyze_ms": analyze_ms, "nodes": nodes}
    emit(rec)
    emit({"phase": "plan", "query": "explain_analyze",
          "text": explain.explain_plan(root, optimized, applied, actuals).splitlines()})
    del df, pending, qc
    return rec


PLAN_SWEEP_WIDTHS = (100, 1000, 4000, 10_000, 65_536)
# the eager groupby's cases of the route sweep: case -> (aggregation, value
# columns), the staged path's two kinds (atomics: int sums, min and max;
# code-sorted segments: float sums, every mean) over one, two and five columns
EAGER_SWEEP_CASES = {
    "sum_int64": ("sum", ("a",)), "sum_int64x2": ("sum", ("a", "f")), "min_int64": ("min", ("a",)),
    "max_float64": ("max", ("b",)), "sum_float64": ("sum", ("b",)), "mean_int64": ("mean", ("a",)),
    "sum_five_columns": ("sum", ("a", "b", "c", "e", "f")),
}
PLAN_SWEEP_ROWS = (4096, 32_768, 262_144, 2_097_152)
PLAN_SWEEP_REPEATS = 3


def _fused_and_staged(fn, what: str, agg: str, scale=None, eager: bool = False) -> dict:
    """Median wall ms of ``fn`` under ``FuseMode=Fused`` and ``Staged`` (one
    warm-up each, then ``PLAN_SWEEP_REPEATS`` runs alternating), the Fused
    runs taking the fused leg (``eager``: the eager groupby's ``groupagg``
    launch) and the Staged runs not, and the two results held to each other
    as phase 13 holds a query to pandas.  No budget is set, so no run
    donates and none pays a restore: each is the repeated query a user
    pays."""
    from modin_tpu_torch.config import FuseMode
    from modin_tpu_torch.ops.cuda import groupagg_kernels as ga
    from modin_tpu_torch.plan import fuse

    out, times = {}, {"Fused": [], "Staged": []}
    for rep in range(PLAN_SWEEP_REPEATS + 1):
        for mode in ("Fused", "Staged"):
            d0, g0 = fuse.DISPATCHES, ga.LAUNCHES
            with FuseMode.context(mode):
                got, ms = host_ms(fn)
            taken = (ga.LAUNCHES - g0) > 0 if eager else (fuse.DISPATCHES - d0) == 1
            if taken != (mode == "Fused") or (eager and fuse.DISPATCHES != d0):
                raise AssertionError(f"{what}: {fuse.DISPATCHES - d0} fused legs and {ga.LAUNCHES - g0} "
                                     f"groupagg launches under FuseMode={mode}")
            if rep:
                times[mode].append(ms)
            else:
                out[mode] = got
    _plan_same(out["Fused"], out["Staged"], f"{what} (Fused against Staged)", agg, scale)
    return {"fused_ms": statistics.median(times["Fused"]), "staged_ms": statistics.median(times["Staged"]),
            "fused_runs_ms": times["Fused"], "staged_runs_ms": times["Staged"]}


def plan_route_sweep(rows: int, seed: int) -> list:
    """The thresholds of the route between ``groupagg`` and the staged
    leg, measured: a filtered groupby (``a > 0``, by ``d``) at ``rows`` rows
    by key ranges of ``PLAN_SWEEP_WIDTHS``, the sum of one and of five value
    columns through the planner's fused leg (``groupby_width``) and each
    case of ``EAGER_SWEEP_CASES`` through the eager groupby
    (``eager_groupby_width``: the same query on the frame itself,
    ``groupby_reduce`` taking ``groupagg`` or not), and a filtered sum of
    ``[b, c]`` and a one-column groupby of 100 keys at ``PLAN_SWEEP_ROWS``
    rows (the row floor), each under ``FuseMode=Fused`` and ``Staged`` on
    in-memory frames (no parse).  Each record carries ``groupagg``'s launch
    geometry (table copies and slot ranges) and the route ``Auto`` takes,
    which ``decide_groupby`` rules on."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.ops import groupby as gb_ops
    from modin_tpu_torch.ops.cuda import groupagg_kernels as ga
    from modin_tpu_torch.ops.route import decide_groupby
    from modin_tpu_torch.plan import defer_frame

    def groupby(df, cols, deferred=True, agg="sum"):
        def fn():
            p = defer_frame(df) if deferred else df
            return tpd.to_pandas(p[p["a"] > 0][[*cols, "d"]].groupby("d").agg(agg))
        return fn

    def reduce(df):
        def fn():
            p = defer_frame(df)
            return tpd.to_pandas(p[p["a"] > 0][["b", "c"]].agg("sum"))
        return fn

    def sweep(what, sweep_name, df, pdf, width, agg, cols, deferred, slots, n):
        geo = ga.launch_geometry(n, slots, len(cols))
        scale = _group_magnitude(agg, [*cols, "d"])(pdf) if agg in ("sum", "mean") else None
        any_float = any(pdf[c].dtype.kind == "f" for c in cols)
        rec = {"phase": "plan", "sweep": sweep_name, "case": what, "agg": agg, "rows": rows, "width": width,
               "value_columns": len(cols), "slots": slots, "copies": geo.copies, "ranges": geo.ranges,
               "auto_takes_groupagg": decide_groupby(n, slots, agg, len(cols), any_float),
               **_fused_and_staged(groupby(df, cols, deferred, agg), f"plan sweep {sweep_name} {what} {width}",
                                   agg, scale, eager=not deferred)}
        emit(rec)
        return rec

    records = []
    for width in PLAN_SWEEP_WIDTHS:
        rng = np.random.default_rng(seed + 72 + width)
        pdf = pandas.DataFrame({"a": rng.integers(-50, 50, rows), "b": rng.uniform(0.0, 1.0, rows),
                                "c": rng.uniform(-1.0, 1.0, rows), "d": rng.integers(0, width, rows),
                                "e": rng.uniform(0.0, 100.0, rows), "f": rng.integers(0, 2, rows)})
        kept = int((pdf["a"] > 0).sum())
        df = tpd.from_pandas(pdf)
        for cols in (("b",), ("a", "b", "c", "e", "f")):
            records.append(sweep(f"sum_x{len(cols)}", "groupby_width", df, pdf, width, "sum", cols, True,
                                 gb_ops.fused_groups_bucket(width) + 1, rows))
        for case, (agg, cols) in EAGER_SWEEP_CASES.items():
            records.append(sweep(case, "eager_groupby_width", df, pdf, width, agg, cols, False, width + 1, kept))
        if width == 100:
            for n in PLAN_SWEEP_ROWS:
                small = tpd.from_pandas(pdf.iloc[:n].copy())
                for name, fn, agg, scale in (
                        ("reduce", reduce(small), "sum", None),
                        ("groupby", groupby(small, ("b",)), "sum",
                         _group_magnitude("sum", ["b", "d"])(pdf.iloc[:n]))):
                    rec = {"phase": "plan", "sweep": "rows", "query": name, "rows": n,
                           **_fused_and_staged(fn, f"plan sweep {name} at {n} rows", agg, scale)}
                    emit(rec)
                    records.append(rec)
                del small
        del df, pdf
        gc.collect()
        free_device_memory()
    return records


def phase_plan(rows: int, seed: int, workdir: str) -> dict:
    """The whole-query planner through ``modin_tpu_torch.pandas``:
    ``read_csv(p).query("a > 0")[["b", "c"]].agg(...)`` in six reductions,
    a map chain into a sum, stacked filters and ``query(...).groupby("d")``
    in six aggregations, on ``rows`` rows of the ``scripts/plan_smoke.py``
    CSV shape; then, on smaller files (``plan_files``), a query on each
    side of each threshold the route selects on: ``groupagg``'s tables in
    device memory (Auto declines, Fused takes them), the key range at and
    one past ``FUSED_MAX_GROUPS`` (Fused takes it, then declines), a key
    spanning 2^40, and the rows on each side of ``FuseMinRows``.  Each runs
    under ``MODIN_TPU_TORCH_PLAN=Auto`` with its ``FuseMode`` (Auto unless
    the query pins Fused) and under ``Off``, and through pandas: results
    equal (ints and order-free results exactly, a float reduction to rtol
    1e-12, a grouped float sum or mean to 1e-12 of its group's magnitude,
    the sum of the values' magnitudes: ``_group_magnitude``), the parse sees
    only the surviving columns (``file_dispatcher.PARSED_COLUMNS``), EXPLAIN
    attributes the pushdown, the fused leg takes its predicted route, each
    fused query launches the fused and groupagg kernels as predicted, and
    nothing defaults to pandas.  Before the queries, the acceptance
    pipeline's time breakdown (``plan_breakdown``) and the route sweep
    (``plan_route_sweep``).  Returns the launches of the Auto runs."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import FuseMode, PlanMode
    from modin_tpu_torch.core.io import file_dispatcher
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops.cuda import fused_kernels as fk
    from modin_tpu_torch.ops.cuda import groupagg_kernels as ga
    from modin_tpu_torch.plan import fuse

    t_phase = time.perf_counter()
    paths = plan_files(workdir, rows, seed)
    path = paths["main"]
    emit({"phase": "plan", "note": "files written", "rows": rows, "wide_rows": PLAN_WIDE_ROWS,
          "small_rows": PLAN_SMALL_ROWS, "seconds": time.perf_counter() - t_phase})
    # pandas reads each file once (timed); a query's pandas_ms is that read
    # plus the query on a copy of the frame
    read_ms, frames = {}, {}
    for p_ in paths.values():
        t0 = time.perf_counter()
        frames[p_] = pandas.read_csv(p_)
        read_ms[p_] = (time.perf_counter() - t0) * 1e3

    class _ReadOnce:
        @staticmethod
        def read_csv(p_):
            return frames[p_].copy()
    tqc.DEFAULTS_TO_PANDAS = 0
    fk.LAUNCHES = ga.LAUNCHES = 0

    def value(x):
        return tpd.to_pandas(x) if hasattr(x, "_query_compiler") else x

    # EXPLAIN of the acceptance pipeline, before and after its run
    with PlanMode.context("Auto"):
        pending = tpd.read_csv(path).query("a > 0")[["b", "c"]]
        before = pending._query_compiler.explain()
        for needle in ("status: deferred", "pushdown-project-into-scan: 1 application(s)",
                       "3/6 cols (pruned, usecols pushed into reader)"):
            if needle not in before:
                raise AssertionError(f"plan explain: {needle!r} missing from\n{before}")
        pending._query_compiler.execute()
        after = pending._query_compiler.explain()
        if "status: materialized" not in after or "pushdown-project-into-scan" not in after:
            raise AssertionError(f"plan explain after the run:\n{after}")
        del pending
    emit({"phase": "plan", "query": "explain", "before": before.splitlines(), "after": after.splitlines()})
    t_sweep = time.perf_counter()
    plan_breakdown(path)
    plan_route_sweep(rows, seed)
    emit({"phase": "plan", "note": "breakdown and route sweep", "seconds": time.perf_counter() - t_sweep})
    totals = {"port_ms": 0.0, "port_off_ms": 0.0, "pandas_ms": 0.0}
    fused_total = groupagg_total = 0
    aggs = ("sum", "mean", "var", "min", "max", "count", "prod")
    for name, (fn, qpath, fuse_mode, route, predicted, predicted_ga, parsed_cols, scale_of) in \
            plan_queries(paths).items():
        agg = next((t for t in name.split("_") if t in aggs), "sum")
        d0, dec0 = fuse.DISPATCHES, fuse.DECLINES
        f0, g0, c0 = fk.LAUNCHES, ga.LAUNCHES, file_dispatcher.PARSED_COLUMNS
        with PlanMode.context("Auto"), FuseMode.context(fuse_mode):
            if callable(predicted_ga):
                predicted_ga = predicted_ga(frames[qpath])
            got, port_ms = host_ms(lambda: value(fn(tpd)))
        launches, ga_launches = fk.LAUNCHES - f0, ga.LAUNCHES - g0
        parsed = file_dispatcher.PARSED_COLUMNS - c0
        fused_total += launches
        groupagg_total += ga_launches
        taken = (fuse.DISPATCHES - d0, fuse.DECLINES - dec0)
        if taken != {"fused": (1, 0), "declined": (0, 1), "staged": (0, 0)}[route]:
            raise AssertionError(f"plan {name}: {taken[0]} fused legs and {taken[1]} declines, "
                                 f"predicted the route {route!r}")
        if ga_launches != predicted_ga or (predicted is not None and launches != predicted):
            raise AssertionError(f"plan {name}: {launches} fused launches (predicted {predicted}), "
                                 f"{ga_launches} groupagg launches (predicted {predicted_ga})")
        if parsed != parsed_cols:
            raise AssertionError(f"plan {name}: the parse saw {parsed} columns, {parsed_cols} survive")
        with PlanMode.context("Off"):
            off, port_off_ms = host_ms(lambda: value(fn(tpd)))
        t0 = time.perf_counter()
        want = fn(_ReadOnce)
        pandas_ms = (time.perf_counter() - t0) * 1e3 + read_ms[qpath]
        if tqc.DEFAULTS_TO_PANDAS != 0:
            raise AssertionError(f"plan {name}: a query defaulted to pandas")
        scale = scale_of(frames[qpath]) if scale_of is not None else None
        _plan_same(got, want, f"plan {name} (Auto against pandas)", agg, scale)
        _plan_same(off, want, f"plan {name} (Off against pandas)", agg, scale)
        _plan_same(got, off, f"plan {name} (Auto against Off)", agg, scale)
        totals["port_ms"] += port_ms
        totals["port_off_ms"] += port_off_ms
        totals["pandas_ms"] += pandas_ms
        emit({"phase": "plan", "query": name, "rows": len(frames[qpath]), "fuse_mode": fuse_mode, "route": route,
              "port_ms": port_ms, "port_off_ms": port_off_ms, "pandas_ms": pandas_ms,
              "fused_launches": launches, "predicted_fused_launches": predicted,
              "groupagg_launches": ga_launches, "predicted_groupagg_launches": predicted_ga,
              "parsed_columns": parsed, "match": True,
              "pandas_ms_is": "one timed pandas.read_csv of the file plus the query on a copy of its frame",
              "tolerance": "exact" if agg in ("min", "max", "count") else
              ("1e-12 of each group's magnitude" if scale is not None else f"rtol {FLOAT_RTOL}")})
        del got, off, want
        gc.collect()
    del frames
    free_device_memory()
    emit({"phase": "plan", "fused_launches": fused_total, "groupagg_launches": groupagg_total,
          "defaults_to_pandas": 0, **totals, "seconds": time.perf_counter() - t_phase})
    return {"fused": fused_total, "groupagg": groupagg_total}


# ---------------------------------------------------------------------- #
# 14. the remaining IO formats and the interchange producer
# ---------------------------------------------------------------------- #

FORMATS_JSON_ROWS = 10**6
FORMATS_FWF_ROWS = 5 * 10**5
FORMATS_SQL_ROWS = 10**6
FORMATS_EXCEL_ROWS = 10**5
FORMATS_XCHG_ROWS = 10**7
FORMATS_KEYS = 100
FORMATS_WORDS = ("alpha", "beta", "gamma-delta", "epsilon", "zeta")
# the fixed-width file's fields: name, printf format, width
FWF_FIELDS = (("k", "%-6d", 6), ("a", "%-14d", 14), ("b", "%-16.6f", 16), ("c", "%-16.6f", 16), ("s", "%-12s", 12))


def formats_columns(rows: int, seed: int, names: str) -> dict:
    """Columns named by the letters of ``names`` from a seed: ``k`` an int64
    key of ``FORMATS_KEYS`` values, ``a`` a wide int64, ``b`` a normal and
    ``c`` a uniform float64, ``s`` a word, ``t`` a bool."""
    rng = np.random.default_rng(seed)
    make = {
        "k": lambda: rng.integers(0, FORMATS_KEYS, rows),
        "a": lambda: rng.integers(-10**9, 10**9, rows),
        "b": lambda: rng.normal(size=rows) * 1e3,
        "c": lambda: rng.uniform(0, 1, rows),
        "s": lambda: np.array(FORMATS_WORDS)[rng.integers(0, len(FORMATS_WORDS), rows)],
        "t": lambda: rng.random(rows) < 0.5,
    }
    return {name: make[name]() for name in names}


def write_fwf(path: str, cols: dict) -> None:
    """A fixed-width file of ``cols`` in ``FWF_FIELDS``' formats, one
    printf a row (``DataFrame.to_string`` took 5.7 s for 2e5 rows)."""
    row_fmt = "".join(f for _, f, _ in FWF_FIELDS) + "\n"
    header = "".join(f"%-{w}s" % name for name, _, w in FWF_FIELDS) + "\n"
    values = zip(*(cols[name].tolist() for name, _, _ in FWF_FIELDS))
    with open(path, "w") as f:
        f.write(header)
        f.writelines(row_fmt % v for v in values)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


class _Formats:
    """The phase's counters, timers and records."""

    def __init__(self):
        from modin_tpu_torch.ops.cuda import fused_kernels as fk
        from modin_tpu_torch.ops.cuda import groupagg_kernels as ga
        from modin_tpu_torch.ops.cuda import groupby_kernels as gk
        from modin_tpu_torch.ops.cuda import scan_kernels as sk

        self.kernels = {"groupagg": ga, "fused": fk, "bincount": gk, "scan": sk}
        self.records = []

    def launches(self) -> dict:
        return {name: mod.LAUNCHES for name, mod in self.kernels.items()}

    @staticmethod
    def port_call(fn):
        """(result, ms, device peak GiB) of a port call ended by a device
        synchronise."""
        import torch

        torch.cuda.reset_peak_memory_stats()
        out, ms = host_ms(fn)
        return out, ms, torch.cuda.max_memory_allocated() / 2**30

    def record(self, name: str, rows: int, port_ms, pandas_ms, to_pandas_ms, peak_gib, **extra) -> None:
        rec = {"phase": "formats", "query": name, "rows": rows, "port_ms": port_ms, "pandas_ms": pandas_ms,
               "to_pandas_ms": to_pandas_ms, "device_peak_gib": round(peak_gib, 3), **extra, "match": True}
        self.records.append(rec)
        emit(rec)

    def after_read(self, what: str, t, p) -> None:
        """The frame a read produced (``t``, and pandas' read ``p``):
        ``groupby("k")`` sum and mean of its value columns (``groupagg``),
        ``(b * c + 1).sum()`` (the fused kernel) and ``k.nunique()``
        (``bincount``), each against pandas, each launching its kernel."""
        import modin_tpu_torch.pandas as tpd

        cols = [c for c in ("a", "b", "c") if c in p.columns]
        kept = p[cols]
        magnitude = kept.abs().groupby(p["k"]).sum()
        queries = {
            "groupby_sum": ("groupagg", lambda d: d.groupby("k")[cols].sum(), magnitude, "sum"),
            "groupby_mean": ("groupagg", lambda d: d.groupby("k")[cols].mean(),
                             magnitude.div(kept.groupby(p["k"]).count()), "mean"),
            "fused_sum": ("fused", lambda d: (d.b * d.c + 1).sum(), None, "sum"),
            "nunique": ("bincount", lambda d: d.k.nunique(), None, "count"),
        }
        for name, (kernel, fn, scale, agg) in queries.items():
            before = self.launches()[kernel]
            result, port_ms, peak = self.port_call(lambda: fn(t))
            launched = self.launches()[kernel] - before
            if hasattr(result, "_query_compiler"):
                got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(result))
            else:
                got, to_pandas_ms = result, None
            want, pandas_ms = _timed(lambda: fn(p))
            _plan_same(got, want, f"formats {what} {name}", agg, scale)
            if launched == 0:
                raise AssertionError(f"formats {what} {name}: the {kernel} kernel never launched")
            self.record(f"{what}_{name}", len(p), port_ms, pandas_ms, to_pandas_ms, peak,
                        kernel=kernel, launches=launched)


def _same_read(got, want, what: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} records != pandas' {len(want)}")
    assert_same_pandas(got, want, what, exact=True)


def _numeric_on_cuda(t, what: str) -> None:
    numeric = [c for c in t._query_compiler._modin_frame._columns if c.pandas_dtype.kind in "biuf"]
    if not numeric or not all(c.is_device and c.device.type == "cuda" for c in numeric):
        raise AssertionError(f"{what}: a numeric column is not on cuda")


def formats_text(fm: _Formats, seed: int, workdir: str) -> None:
    """JSON lines and fixed width: each read (one parse) against pandas',
    the streamed ``to_json``."""
    import filecmp

    import pandas

    import modin_tpu_torch.pandas as tpd

    # JSON lines: 1e6 records of 2 int64, 2 float64, a str and a bool
    rows = FORMATS_JSON_ROWS
    path = os.path.join(workdir, "data.jsonl")
    p0 = pandas.DataFrame(formats_columns(rows, seed + 60, "kabcst"))
    _, write_ms = _timed(lambda: p0.to_json(path, orient="records", lines=True))
    del p0
    t, port_ms, peak = fm.port_call(lambda: tpd.read_json(path, lines=True))
    p, pandas_ms = _timed(lambda: pandas.read_json(path, lines=True))
    got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(t))
    _same_read(got, p, "read_json")
    _numeric_on_cuda(t, "read_json")
    del got
    fm.record("read_json", rows, port_ms, pandas_ms, to_pandas_ms, peak,
              file_bytes=os.path.getsize(path), pandas_write_ms=write_ms)
    fm.after_read("json", t, p)
    port_out, pandas_out = os.path.join(workdir, "port.jsonl"), os.path.join(workdir, "pandas.jsonl")
    _, port_ms, peak = fm.port_call(lambda: t.to_json(port_out, orient="records", lines=True))
    _, pandas_ms = _timed(lambda: p.to_json(pandas_out, orient="records", lines=True))
    if not filecmp.cmp(port_out, pandas_out, shallow=False):
        raise AssertionError("to_json: the port's file differs from pandas'")
    fm.record("to_json", rows, port_ms, pandas_ms, None, peak, file_bytes=os.path.getsize(pandas_out))
    for f in (path, port_out, pandas_out):
        os.unlink(f)
    del t, p
    free_device_memory()

    # fixed width: 5e5 rows of 5 columns, the spans inferred and explicit
    rows = FORMATS_FWF_ROWS
    path = os.path.join(workdir, "data.txt")
    _, write_ms = _timed(lambda: write_fwf(path, formats_columns(rows, seed + 61, "kabcs")))
    starts = np.cumsum([0] + [w for _, _, w in FWF_FIELDS])
    for spans, kwargs in (("inferred", {}), ("explicit", {"colspecs": list(zip(starts[:-1].tolist(),
                                                                               starts[1:].tolist()))})):
        t, port_ms, peak = fm.port_call(lambda: tpd.read_fwf(path, **kwargs))
        p, pandas_ms = _timed(lambda: pandas.read_fwf(path, **kwargs))
        got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(t))
        _same_read(got, p, f"read_fwf {spans}")
        _numeric_on_cuda(t, f"read_fwf {spans}")
        del got
        fm.record(f"read_fwf_{spans}", rows, port_ms, pandas_ms, to_pandas_ms, peak,
                  file_bytes=os.path.getsize(path), numpy_write_ms=write_ms)
        fm.after_read(f"fwf_{spans}", t, p)
        del t, p
        free_device_memory()
    os.unlink(path)


def formats_sql(fm: _Formats, seed: int, workdir: str) -> None:
    """A sqlite3 file of 1e6 rows: ``read_sql`` through a plain connection
    and through a ``ModinDatabaseConnection``, and the ``to_sql`` round
    trip."""
    import sqlite3

    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.db_conn import ModinDatabaseConnection

    rows = FORMATS_SQL_ROWS
    path = os.path.join(workdir, "data.db")
    query = "SELECT * FROM items"
    conn = sqlite3.connect(path)
    try:
        p0 = pandas.DataFrame(formats_columns(rows, seed + 62, "kabcs"))
        _, pandas_write_ms = _timed(lambda: p0.to_sql("items", conn, index=False))
        del p0
        p, pandas_ms = _timed(lambda: pandas.read_sql(query, conn))
        for how, con in (("plain", conn), ("descriptor", ModinDatabaseConnection("sqlite3", path))):
            t, port_ms, peak = fm.port_call(lambda: tpd.read_sql(query, con))
            got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(t))
            _same_read(got, p, f"read_sql {how}")
            _numeric_on_cuda(t, f"read_sql {how}")
            del got
            fm.record(f"read_sql_{how}", rows, port_ms, pandas_ms, to_pandas_ms, peak)
            fm.after_read(f"sql_{how}", t, p)
        _, port_ms, peak = fm.port_call(lambda: t.to_sql("port_items", conn, index=False))
        back = pandas.read_sql("SELECT * FROM port_items", conn)
        _same_read(back, p, "to_sql round trip")
        fm.record("to_sql", rows, port_ms, pandas_write_ms, None, peak,
                  pandas_ms_is="pandas' to_sql of the same frame into the same file")
        del t, p, back
    finally:
        conn.close()
    os.unlink(path)
    free_device_memory()


def formats_excel(fm: _Formats, seed: int, workdir: str) -> int:
    """1e5 rows of int64, float64, float64 and str: ``to_excel`` then
    ``read_excel``, through the port's xlsx codec where no Excel engine is
    installed (pandas' own otherwise).  The reference is the original frame,
    and pandas' read of the port's file where an engine imports.  Returns
    the defaults an engine's pandas path counted."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.core.io.io import _no_excel_engine_installed

    rows = FORMATS_EXCEL_ROWS
    native = _no_excel_engine_installed()
    path = os.path.join(workdir, "port.xlsx")
    p = pandas.DataFrame(formats_columns(rows, seed + 63, "kbcs"))
    t0 = tpd.from_pandas(p)
    _, port_ms, peak = fm.port_call(lambda: t0.to_excel(path, index=False))
    fm.record("to_excel", rows, port_ms, None, None, peak, codec="native" if native else "engine",
              pandas_ms_is="not measured: no Excel engine here" if native else None,
              file_bytes=os.path.getsize(path))
    del t0
    t, port_ms, peak = fm.port_call(lambda: tpd.read_excel(path))
    got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(t))
    if [str(d) for d in got.dtypes] != ["int64", "float64", "float64", "str"]:
        raise AssertionError(f"read_excel: dtypes {list(got.dtypes)}")
    _same_read(got, p, "read_excel against the original frame")
    pandas_ms = None
    if not native:
        want, pandas_ms = _timed(lambda: pandas.read_excel(path))
        _same_read(got, want, "read_excel against pandas' read")
    _numeric_on_cuda(t, "read_excel")
    del got
    fm.record("read_excel", rows, port_ms, pandas_ms, to_pandas_ms, peak, codec="native" if native else "engine")
    fm.after_read("excel", t, p)
    os.unlink(path)
    return 0 if native else 2


def formats_hdf(fm: _Formats, seed: int, workdir: str) -> None:
    """An HDF5 round trip where PyTables imports; else the port raises
    pandas' own ``ImportError`` and the phase says HDF is unverified."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.core.io.column_stores.hdf_dispatcher import _pytables_available

    p = pandas.DataFrame(formats_columns(FORMATS_SQL_ROWS, seed + 64, "kabc"))
    t0 = tpd.from_pandas(p)
    path = os.path.join(workdir, "port.h5")
    if not _pytables_available():
        try:
            p.to_hdf(os.path.join(workdir, "pandas.h5"), key="k")
        except ImportError as err:
            want = str(err)
        try:
            t0.to_hdf(path, key="k")
        except ImportError as err:
            if str(err) != want:
                raise AssertionError(f"to_hdf: {err} != pandas' {want}") from err
        else:
            raise AssertionError("to_hdf without PyTables did not raise")
        emit({"phase": "formats", "note": "PyTables does not import here: HDF unverified on the card "
              "(the port raised pandas' own ImportError)"})
        return
    _, port_ms, peak = fm.port_call(lambda: t0.to_hdf(path, key="k", format="table", mode="w"))
    _, pandas_ms = _timed(lambda: p.to_hdf(os.path.join(workdir, "pandas.h5"), key="k", format="table", mode="w"))
    fm.record("to_hdf", len(p), port_ms, pandas_ms, None, peak)
    t, port_ms, peak = fm.port_call(lambda: tpd.read_hdf(path, key="k"))
    want, pandas_ms = _timed(lambda: pandas.read_hdf(path, key="k"))
    got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(t))
    _same_read(got, want, "read_hdf")
    _same_read(got, p, "HDF round trip")
    fm.record("read_hdf", len(p), port_ms, pandas_ms, to_pandas_ms, peak)
    fm.after_read("hdf", t, want)


def formats_interchange(fm: _Formats, seed: int) -> None:
    """``make_frame((1e7, 10))`` plus one, deferred: pandas' consumer over
    the port's producer against pandas' own producer, a selection of 2 of
    the 10 columns fetching 2, and ``to_numpy`` in one device-to-host copy
    against pandas'."""
    import warnings

    import pandas
    from pandas.api.interchange import from_dataframe

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.core.dataframe.torch.interchange import dataframe as xchg
    from modin_tpu_torch.parallel.engine import TorchWrapper

    rows = FORMATS_XCHG_ROWS
    p = pandas.DataFrame(make_frame_data(rows, seed + 65)) + 1
    t = tpd.from_pandas(pandas.DataFrame(make_frame_data(rows, seed + 65))) + 1
    with warnings.catch_warnings():
        # pandas 3 deprecates the protocol; the deprecation is not under test
        warnings.simplefilter("ignore")
        for name, cols in (("from_dataframe", None), ("select_2_of_10", [2, 7])):
            xchg.COLUMN_FETCHES = 0

            def port():
                producer = t.__dataframe__()
                return from_dataframe(producer if cols is None else producer.select_columns(cols))

            got, port_ms, peak = fm.port_call(port)
            want, pandas_ms = _timed(lambda: from_dataframe(
                p.__dataframe__() if cols is None else p.__dataframe__().select_columns(cols)))
            assert_same_pandas(got, want, f"interchange {name}", exact=True)
            expect = 10 if cols is None else len(cols)
            if xchg.COLUMN_FETCHES != expect:
                raise AssertionError(f"interchange {name}: {xchg.COLUMN_FETCHES} column fetches, not {expect}")
            fm.record(f"interchange_{name}", rows, port_ms, pandas_ms, None, peak,
                      column_fetches=xchg.COLUMN_FETCHES)
            del got, want
    copies = []
    materialize = TorchWrapper.__dict__["materialize"]

    def counting(cls, obj):
        copies.append(tuple(getattr(obj, "shape", ())))
        return materialize.__func__(cls, obj)

    TorchWrapper.materialize = classmethod(counting)
    try:
        got, port_ms, peak = fm.port_call(lambda: t.to_numpy())
    finally:
        TorchWrapper.materialize = materialize
    want, pandas_ms = _timed(lambda: p.to_numpy())
    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise AssertionError(f"to_numpy: {got.dtype} {got.shape} != pandas' {want.dtype} {want.shape}")
    if copies != [(rows, 10)]:
        raise AssertionError(f"to_numpy: device-to-host copies {copies}")
    fm.record("to_numpy", rows, port_ms, pandas_ms, None, peak, device_to_host_copies=len(copies),
              bytes=got.nbytes)
    del t, p, got, want
    free_device_memory()


def phase_formats(seed: int, workdir: str) -> dict:
    """The remaining IO through ``modin_tpu_torch.pandas`` at the sizes
    users hold such files: JSON lines (1e6 records) and fixed width (5e5
    rows), the streamed ``to_json``; SQL (1e6 rows, through a plain
    connection and a ``ModinDatabaseConnection``, ``to_sql``); Excel
    (1e5 rows, the port's codec); HDF (a round trip where PyTables
    imports); the interchange producer and ``to_numpy`` at 1e7 x 10.  Each
    read equals pandas' (records, dtypes, values exactly), and on its frame
    ``groupby("k")`` sum/mean, ``(b * c + 1).sum()`` and ``k.nunique()``
    equal pandas' and launch ``groupagg``, the fused kernel and
    ``bincount``; nothing defaults to pandas.  Returns the launches."""
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc

    t_phase = time.perf_counter()
    fm = _Formats()
    start = fm.launches()
    tqc.DEFAULTS_TO_PANDAS = 0
    formats_text(fm, seed, workdir)
    formats_sql(fm, seed, workdir)
    engine_defaults = formats_excel(fm, seed, workdir)
    formats_hdf(fm, seed, workdir)
    formats_interchange(fm, seed)
    if tqc.DEFAULTS_TO_PANDAS != engine_defaults:
        raise AssertionError(f"{tqc.DEFAULTS_TO_PANDAS} formats calls defaulted to pandas")
    launches = {k: v - start[k] for k, v in fm.launches().items()}
    never = [k for k in ("groupagg", "fused", "bincount") if launches[k] == 0]
    if never:
        raise AssertionError(f"the formats path never launched {never}")
    emit({"phase": "formats", "launches": launches, "defaults_to_pandas": tqc.DEFAULTS_TO_PANDAS,
          "excel_engine_defaults": engine_defaults, "queries": len(fm.records),
          "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------- #
# 15. memory: the router's calibration, budgeted spill, donation, optimizer
# ---------------------------------------------------------------------- #

MEMORY_SWEEP_ROWS = (10**5, 10**6, 10**7, 10**8)
# the sweep's many-valued columns: values in [0, 2^21), past the histogram's
# 2^20 bound (the sort strategy); at 1e8 rows pandas' nunique took 25.8 s
# over all-distinct values (2^40) and 7.3 s over 2^24 on an H100 host, too
# much of the phase's share
MEMORY_WIDE_VALUES = 1 << 21
MEMORY_BUDGET_BYTES = 20 * 2**30
MEMORY_GROUP_KEY = "col0"
# phase 13's pipelines the optimizer legs are held on (Auto against Off)
MEMORY_OPT_QUERIES = ("filter_project_sum", "map_chain_sum", "groupby_sum")


def memory_calibration() -> dict:
    """The router's table measured on this card (``get_calibration`` with
    its cache file removed), then resolved again from the file."""
    from modin_tpu_torch.ops import router

    router.set_calibration(None)
    path = router._cache_path(router._platform(), router._device_key())
    if path and os.path.exists(path):
        os.remove(path)
    calibrations = router.CALIBRATIONS
    t0 = time.perf_counter()
    table = router.get_calibration()
    wall_s = time.perf_counter() - t0
    if table is None:
        raise AssertionError(f"the router's calibration failed on the card: {router.CALIBRATION_ERROR}")
    router.set_calibration(None)
    t0 = time.perf_counter()
    again = router.get_calibration()
    hit_s = time.perf_counter() - t0
    if again != table or router.CALIBRATIONS != calibrations + 1:
        raise AssertionError("the second resolution did not come from the cached table")
    rec = {"phase": "memory", "part": "calibration", "table": table, "calibration_s": wall_s,
           "cache_hit_s": hit_s, "cache_file": os.path.relpath(path, HERE) if path else None}
    emit(rec)
    return table


def router_crossover_rows(op: str, strategies: list, table: dict):
    """The fewest rows, on a grid of ``2^(k/4)`` from 1e5 to 1e9, at which
    the router's model sends ``op`` to pandas (predicted device less
    predicted pandas over ``MIN_SAVINGS_S``), or None where it never does."""
    from modin_tpu_torch.ops import router

    n = 1e5
    while n <= 1e9:
        costs = router.predicted_costs(op, int(n), strategies, table)
        if costs["device_s"] - costs["host_s"] > router.MIN_SAVINGS_S:
            return int(n)
        n *= 2 ** 0.25
    return None


def memory_router_sweep(seed: int, table: dict) -> list:
    """median, quantile(0.5), nunique of few (1024) and of many
    (``MEMORY_WIDE_VALUES``) values and mode of int64 columns at
    ``MEMORY_SWEEP_ROWS`` rows, and at the rows where the model predicts
    each case to cross over to pandas (``router_crossover_rows``) where
    that lies inside the sweep's range: the router's verdict with its
    predicted costs beside the port's time on the device
    (``KernelRouterMode=Device``, the sorted representation dropped before
    each call) and pandas'.  A verdict whose side measured slower than the
    other by more than ``MIN_SAVINGS_S`` fails the phase; so does an answer
    that differs from pandas'."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import KernelRouterMode
    from modin_tpu_torch.ops import reductions, router, sorted_cache

    cases = (("median", "wide", lambda d: d.median()), ("quantile", "wide", lambda d: d.quantile(0.5)),
             ("nunique", "narrow", lambda d: d.nunique()), ("nunique", "wide", lambda d: d.nunique()),
             ("mode", "narrow", lambda d: d.mode()))
    records = []

    def run(n, chosen):
        rng = np.random.default_rng(seed + 150 + n % 997)
        pdfs = {"wide": pandas.DataFrame({"x": rng.integers(0, MEMORY_WIDE_VALUES, n)}),
                "narrow": pandas.DataFrame({"x": rng.integers(0, 1024, n)})}
        dfs = {k: tpd.from_pandas(v) for k, v in pdfs.items()}
        for op, data, call in chosen:
            df, pdf = dfs[data], pdfs[data]
            col = df._query_compiler._modin_frame._columns[0]
            sorted_cache.invalidate(col)
            plan = reductions.plan_sort_reduce(op, [{"col": col}], n)
            strategies = [p.strategy for p in plan]
            verdict = router.verdict(op, n, strategies)
            with KernelRouterMode.context("Device"):
                got, device_ms = host_ms(lambda: tpd.to_pandas(call(df)))
            sorted_cache.invalidate(col)
            want, pandas_ms = host_ms(lambda: call(pdf))
            assert_same_pandas(got, want, f"router sweep {op} {data} at {n} rows",
                               exact=op not in ("median", "quantile"))
            slack_ms = router.MIN_SAVINGS_S * 1e3
            wrong = (verdict["choice"] == "host" and device_ms < pandas_ms - slack_ms) or (
                verdict["choice"] == "device" and pandas_ms < device_ms - slack_ms)
            rec = {"phase": "memory", "part": "router_sweep", "op": op, "values": data, "rows": n,
                   "strategies": strategies, "verdict": verdict["choice"], "reason": verdict["reason"],
                   "predicted_device_ms": verdict.get("device_s", float("nan")) * 1e3,
                   "predicted_host_ms": verdict.get("host_s", float("nan")) * 1e3,
                   "device_ms": device_ms, "pandas_ms": pandas_ms,
                   "predicted_crossover_rows": router_crossover_rows(op, strategies, table),
                   "verdict_on_slower_side": wrong}
            emit(rec)
            records.append(rec)
            if wrong:
                raise AssertionError(f"router sweep: {op} over {n} {data} rows chose {verdict['choice']} "
                                     f"(predicted {verdict}) where it measured {device_ms:.1f} ms on the "
                                     f"device and {pandas_ms:.1f} ms in pandas")
        del dfs, pdfs
        gc.collect()
        free_device_memory()

    for n in MEMORY_SWEEP_ROWS:
        run(n, cases)
    # the model's own crossovers, each measured once where it falls inside
    # the sweep's range (the strategies of the largest size)
    last = {(r["op"], r["values"]): r for r in records}
    extra = {}
    for op, data, call in cases:
        n_x = last[(op, data)]["predicted_crossover_rows"]
        if n_x is not None and MEMORY_SWEEP_ROWS[0] < n_x <= MEMORY_SWEEP_ROWS[-1]:
            extra.setdefault(n_x, []).append((op, data, call))
    emit({"phase": "memory", "part": "router_crossovers",
          "cases": {f"{op}/{data}": last[(op, data)]["predicted_crossover_rows"] for op, data, _ in cases},
          "measured_at": sorted(extra)})
    for n_x, chosen in sorted(extra.items()):
        run(n_x, chosen)
    return records


def memory_frame_data(rows: int, seed: int, cols: int = 10):
    """``make_frame_data``'s columns (int64 in [0, 100)), drawn on the card
    by a seeded generator and fetched, kept off the host's slower
    generator; and, from the same tensors before they leave the card, the
    references ``memory_spill`` holds its answers to: each column's sum,
    the rows of each ``MEMORY_GROUP_KEY`` value and each other column's
    sum within them (``torch.sum`` and ``torch.bincount``: int64 exact, and
    none of the port's code).  Returns ``(columns, references)``."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 151)
    dev = {f"col{i}": torch.randint(0, 100, (rows,), generator=gen, device="cuda") for i in range(cols)}
    key = dev[MEMORY_GROUP_KEY]
    weights = torch.arange(100, device="cuda")
    refs = {"sums": {c: int(t.sum()) for c, t in dev.items()},
            "key_counts": torch.bincount(key, minlength=100).cpu().numpy(),
            # each (key, value) pair's count, then the sum of value * count
            "group_sums": {c: (torch.bincount(key * 100 + t, minlength=100 * 100).reshape(100, 100)
                               * weights).sum(1).cpu().numpy()
                           for c, t in dev.items() if c != MEMORY_GROUP_KEY}}
    return {c: t.cpu().numpy() for c, t in dev.items()}, refs


def memory_spill(rows: int, seed: int) -> dict:
    """``DeviceMemoryBudget`` = 20 GiB over int64 frames of ``rows`` x 10
    (``make_frame_data``, 8 GB at 1e8): A from ``from_pandas``, B = A * 3 +
    1 and C = A - 7 materialized, D = B + C; then A's sum (restoring A,
    which D's admission spilled, pushes B out), B's sum and a 100-key
    groupby sum of B (by its ``col0``), which restore B, and D's ``col0``
    sum.  Every answer is held exactly to int64 references derived from
    A's data (``memory_frame_data``); the spills,
    restores and their rates, the ledger's resident bytes and the
    allocator's are printed after each step, and the allocated peak may
    pass the budget by one launch's new tensors (one frame) and no more."""
    import pandas
    import torch

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import DeviceMemoryBudget
    from modin_tpu_torch.core import memory

    t_setup = time.perf_counter()
    columns, refs = memory_frame_data(rows, seed)
    pdf = pandas.DataFrame(columns, copy=False)
    host = {c: pdf[c].to_numpy() for c in pdf.columns}
    sum_a = refs["sums"]
    setup_s = time.perf_counter() - t_setup
    frame_bytes = sum(v.nbytes for v in host.values())
    counts0, seconds0 = dict(memory.COUNTS), dict(memory.SECONDS)
    steps = []

    def step(name, t0):
        torch.cuda.synchronize()
        rec = {"step": name, "seconds": time.perf_counter() - t0,
               "ledger_resident_gb": memory.device_resident_bytes() / 1e9,
               "allocated_gb": torch.cuda.memory_allocated() / 1e9,
               "max_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
               **{k: memory.COUNTS[k] - counts0[k] for k in ("memory.device.spill", "memory.device.spill_bytes",
                                                           "memory.device.spill_copy", "memory.device.restore")}}
        steps.append(rec)
        emit({"phase": "memory", "part": "spill", **rec})

    def sums(df):
        return tpd.to_pandas(df.sum())

    gc.collect()
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    base_allocated = torch.cuda.memory_allocated()
    with DeviceMemoryBudget.context(MEMORY_BUDGET_BYTES):
        t0 = time.perf_counter()
        a = tpd.from_pandas(pdf)
        step("A = from_pandas", t0)
        t0 = time.perf_counter()
        b = a * 3 + 1
        b._query_compiler._modin_frame.materialize_device()
        step("B = A * 3 + 1", t0)
        t0 = time.perf_counter()
        c = a - 7
        c._query_compiler._modin_frame.materialize_device()
        step("C = A - 7", t0)
        t0 = time.perf_counter()
        d = b + c
        d._query_compiler._modin_frame.materialize_device()
        step("D = B + C", t0)
        t0 = time.perf_counter()
        got_a = sums(a)
        step("A.sum()", t0)
        r0 = memory.COUNTS["memory.device.restore"]
        t0 = time.perf_counter()
        got_b = sums(b)
        step("B.sum()", t0)
        b_sum_restores = memory.COUNTS["memory.device.restore"] - r0
        r0 = memory.COUNTS["memory.device.restore"]
        t0 = time.perf_counter()
        got_gb = tpd.to_pandas(b.groupby(MEMORY_GROUP_KEY).sum())
        step("B.groupby(col0).sum()", t0)
        b_groupby_restores = memory.COUNTS["memory.device.restore"] - r0
        t0 = time.perf_counter()
        got_d = tpd.to_pandas(d[["col0"]].sum())
        step("D[['col0']].sum()", t0)
        peak = torch.cuda.max_memory_allocated() - base_allocated
    n = rows
    wrap = np.int64
    want_a = pandas.Series([wrap(v) for v in sum_a.values()], index=pdf.columns)
    want_b = pandas.Series([wrap(3 * v + n) for v in sum_a.values()], index=pdf.columns)
    want_d = pandas.Series([wrap(4 * sum_a["col0"] - 6 * n)], index=pdf.columns[:1])
    for got, want, what in ((got_a, want_a, "A.sum()"), (got_b, want_b, "B.sum()"),
                            (got_d, want_d, "D[['col0']].sum()")):
        assert_same_pandas(got, want.astype(np.int64), f"memory spill {what}", exact=True)
    counts = refs["key_counts"]
    present = np.nonzero(counts)[0]
    want_gb = pandas.DataFrame({c: (3 * g + counts)[present] for c, g in refs["group_sums"].items()},
                               index=pandas.Index(3 * present + 1, name=MEMORY_GROUP_KEY))
    assert_same_pandas(got_gb, want_gb, "memory spill B.groupby(col0).sum()", exact=True)
    spilled = {k: memory.COUNTS[k] - counts0[k] for k in memory.COUNTS}
    copy_s = memory.SECONDS["memory.device.spill_copy"] - seconds0["memory.device.spill_copy"]
    restore_s = memory.SECONDS["memory.device.restore"] - seconds0["memory.device.restore"]
    slack = frame_bytes
    rec = {"phase": "memory", "part": "spill_summary", "rows": rows, "frame_gb": frame_bytes / 1e9,
           "budget_gb": MEMORY_BUDGET_BYTES / 1e9, "peak_allocated_gb": peak / 1e9,
           "peak_over_budget_gb": (peak - MEMORY_BUDGET_BYTES) / 1e9, "allowed_over_budget_gb": slack / 1e9,
           "counts": spilled, "spill_copy_s": copy_s, "restore_s": restore_s,
           "spill_copy_gb_per_s": spilled["memory.device.spill_copy_bytes"] / copy_s / 1e9 if copy_s else None,
           "restore_gb_per_s": spilled["memory.device.restore_bytes"] / restore_s / 1e9 if restore_s else None,
           "b_sum_restores": b_sum_restores, "b_groupby_restores": b_groupby_restores,
           "setup_s": setup_s}
    emit(rec)
    if not (spilled["memory.device.spill"] and spilled["memory.device.spill_copy"] and
            spilled["memory.device.restore"]):
        raise AssertionError(f"the budgeted run did not spill, copy and restore: {spilled}")
    if peak > MEMORY_BUDGET_BYTES + slack:
        raise AssertionError(f"allocated peak {peak / 1e9:.2f} GB passes the budget by more than one frame")
    del a, b, c, d, pdf, host
    gc.collect()
    free_device_memory()
    return rec


def memory_donation(path: str) -> dict:
    """Phase 13's ``read_csv(p).query("a > 0")[["b", "c"]].agg("sum")`` and
    its ``query("a > 0")[["a", "c", "d"]].groupby("d").agg("sum")`` (1000
    keys), both through the fused leg (``FuseMode=Fused``).  First with no
    budget, each query twice on the deferred read and twice on the same
    data as an in-memory frame (``from_pandas``): nothing is donated and
    the second run restores nothing (the repeated query pays no upload).
    Then
    under ``DeviceMemoryBudget`` (``MEMORY_BUDGET_BYTES``, far above the
    file), once with the scan's columns donated and once with a second
    reference pinning every scan column (no donation); the file is parsed
    (all columns) before each pair, outside the measured span.  The answers
    are bit-equal, and a read of a donated column afterwards restores it."""
    import torch

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import DeviceMemoryBudget, FuseMode
    from modin_tpu_torch.core import memory
    from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn
    from modin_tpu_torch.plan import defer_frame, fuse, lowering

    def queries(md, frame=lambda md: md):
        reduce_, reduce_ms = host_ms(lambda: tpd.to_pandas(frame(md).query("a > 0")[["b", "c"]].agg("sum")))
        groupby, groupby_ms = host_ms(
            lambda: tpd.to_pandas(frame(md).query("a > 0")[["a", "c", "d"]].groupby("d").agg("sum")))
        return reduce_, groupby, reduce_ms, groupby_ms

    # no budget: the deferred read, and the same data as an in-memory frame
    # (each query deferred over it, as phase 13's route sweep runs them)
    md = tpd.read_csv(path)
    in_memory = tpd.from_pandas(lowering._lower(md._query_compiler._plan, {}).to_pandas())
    for what, frame, deferred in (("read_csv", md, lambda d: d), ("from_pandas", in_memory, defer_frame)):
        c0, d0 = dict(memory.COUNTS), fuse.DISPATCHES
        with FuseMode.context("Fused"):
            first = queries(frame, deferred)
            second = queries(frame, deferred)
        delta = {k: memory.COUNTS[k] - c0[k] for k in ("fuse.donated", "memory.device.restore")}
        rec = {"phase": "memory", "part": "donation", "budget_gb": None, "frame": what,
               "fused_legs": fuse.DISPATCHES - d0, "reduce_first_ms": first[2], "reduce_second_ms": second[2],
               "groupby_first_ms": first[3], "groupby_second_ms": second[3], **delta}
        emit(rec)
        if delta["fuse.donated"] or delta["memory.device.restore"] or rec["fused_legs"] != 4:
            raise AssertionError(f"with no budget ({what}): {rec['fused_legs']} fused legs of 4, and the fused leg "
                                 f"donated or a repeated query restored: {delta}")
        for i, query in enumerate(("reduction", "groupby")):
            assert_same_pandas(second[i], first[i], f"donation {query} ({what}, repeated, no budget)", exact=True)
    del md, in_memory
    gc.collect()

    out = {}
    for pinned in (False, True):
        with DeviceMemoryBudget.context(MEMORY_BUDGET_BYTES):
            md = tpd.read_csv(path)
            scan_qc = lowering._lower(md._query_compiler._plan, {})
            cols = [c for c in scan_qc._modin_frame._columns if c.is_device]
            pins = [DeviceColumn(c.data, c.pandas_dtype, length=c.length) for c in cols] if pinned else []
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            c0 = dict(memory.COUNTS)
            with FuseMode.context("Fused"):
                reduce_, groupby, reduce_ms, groupby_ms = queries(md)
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            peak = torch.cuda.max_memory_allocated()
            delta = {k: memory.COUNTS[k] - c0[k] for k in ("fuse.donated", "fuse.donated_bytes",
                                                           "fuse.donated_restore")}
            donated_now = [i for i, c in enumerate(cols) if c.donated]
            restore0 = memory.COUNTS["fuse.donated_restore"]
            later = float(md["b"].sum())
        rec = {"phase": "memory", "part": "donation", "budget_gb": MEMORY_BUDGET_BYTES / 1e9, "pinned": pinned,
               "rows_file": path, "reduce_ms": reduce_ms, "groupby_ms": groupby_ms, **delta,
               "donated_columns_after": len(donated_now), "allocated_before_gb": before / 1e9,
               "allocated_after_gb": after / 1e9, "max_allocated_gb": peak / 1e9,
               "later_read_restores": memory.COUNTS["fuse.donated_restore"] - restore0}
        emit(rec)
        if pinned and delta["fuse.donated"]:
            raise AssertionError("a pinned scan column was donated")
        if not pinned and (not delta["fuse.donated"] or not rec["later_read_restores"]):
            raise AssertionError(f"donation: {delta}, a later read restored {rec['later_read_restores']}")
        out[pinned] = (reduce_, groupby, later, rec)
        del md, scan_qc, cols, pins
        gc.collect()
    for i, what in enumerate(("reduction", "groupby", "later read")):
        a, b = out[False][i], out[True][i]
        if isinstance(a, float):
            if a != b:
                raise AssertionError(f"donation: the {what} differs pinned ({b!r}) and donated ({a!r})")
        else:
            assert_same_pandas(a, b, f"donation {what} (donated against pinned)", exact=True)
    return {"donated": out[False][3], "pinned": out[True][3]}


def memory_optimizer(path: str) -> list:
    """``MEMORY_OPT_QUERIES`` of phase 13 (``plan_queries``) under
    ``OptMode`` Auto and Off: bit-equal answers, the wall of each, its
    re-plans and the optimizer's allocations (none under Off)."""
    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import OptMode
    from modin_tpu_torch.plan import optimizer

    queries = plan_queries({"main": path, "wide": path, "mid": path, "cap": path, "floor_below": path,
                            "floor_at": path})
    records = []
    for name in MEMORY_OPT_QUERIES:
        pipeline = queries[name][0]
        got = {}
        rec = {"phase": "memory", "part": "optimizer", "query": name}
        for mode in ("Auto", "Off"):
            replans0, allocs0 = sum(optimizer.REPLANS.values()), optimizer.opt_alloc_count()
            with OptMode.context(mode):
                out, ms = host_ms(lambda: pipeline(tpd))
                got[mode] = tpd.to_pandas(out) if hasattr(out, "_query_compiler") else out
            key = mode.lower()
            rec[f"port_{key}_ms"] = ms
            rec[f"replans_{key}"] = sum(optimizer.REPLANS.values()) - replans0
            rec[f"strategy_sets_{key}"] = optimizer.opt_alloc_count() - allocs0
        emit(rec)
        records.append(rec)
        if rec["strategy_sets_off"] or not rec["strategy_sets_auto"]:
            raise AssertionError(f"optimizer {name}: strategy sets built Auto {rec['strategy_sets_auto']}, "
                                 f"Off {rec['strategy_sets_off']}")
        if isinstance(got["Auto"], float):
            if got["Auto"] != got["Off"]:
                raise AssertionError(f"optimizer {name}: Auto {got['Auto']!r} != Off {got['Off']!r}")
        else:
            assert_same_pandas(got["Auto"], got["Off"], f"optimizer {name} (Auto against Off)", exact=True)
    return records


def phase_memory(rows: int, plan_rows: int, seed: int, workdir: str) -> dict:
    """Routing and memory on the card: the router's calibration and its
    sweep (``memory_calibration``, ``memory_router_sweep``), the budgeted
    spill and restore at ``rows`` x 10 (``memory_spill``), donation in the
    fused leg (``memory_donation``) and the optimizer's Auto against Off
    (``memory_optimizer``) on phase 13's CSV at ``plan_rows`` rows.  Nothing
    defaults to pandas.  Returns the launches."""
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops.cuda import fused_kernels as fk
    from modin_tpu_torch.ops.cuda import groupagg_kernels as ga
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk

    t_phase = time.perf_counter()
    tqc.DEFAULTS_TO_PANDAS = 0
    b0 = gk.LAUNCHES
    seconds = {}
    t0 = time.perf_counter()
    table = memory_calibration()
    seconds["calibration"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    memory_router_sweep(seed, table)
    seconds["router_sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    memory_spill(rows, seed)
    seconds["spill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path = os.path.join(workdir, "memory.csv")
    plan_csv(path, plan_rows, seed)
    seconds["csv"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    memory_donation(path)
    seconds["donation"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    memory_optimizer(path)
    seconds["optimizer"] = time.perf_counter() - t0
    if tqc.DEFAULTS_TO_PANDAS:
        raise AssertionError(f"{tqc.DEFAULTS_TO_PANDAS} memory calls defaulted to pandas")
    launches = {"bincount": gk.LAUNCHES - b0, "fused": fk.LAUNCHES, "groupagg": ga.LAUNCHES}
    if not launches["bincount"]:
        raise AssertionError("the memory path never launched bincount (calibration, hist strategy)")
    emit({"phase": "memory", "launches": launches, "device_hist_s": table["device_hist_s"],
          "defaults_to_pandas": tqc.DEFAULTS_TO_PANDAS, "seconds_by_part": seconds,
          "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------- #
# 16. views: whole-result reuse and append-only folds
# ---------------------------------------------------------------------- #

VIEWS_WORDS = ("alpha", "beta", "gamma-delta", "epsilon", "zeta")
VIEWS_KEYS = 1000
VIEWS_APPENDS = 3
VIEWS_TIME_APPENDS = 10
VIEWS_NUM = ["i", "f", "b", "k"]
# the reductions and groupbys of (a): (query, result kind); "fold" kinds are
# the ones whose artifacts absorb an append
VIEWS_QUERIES = {
    "sum": (lambda d: d[VIEWS_NUM].sum(), "sum"),
    "mean": (lambda d: d[VIEWS_NUM].mean(), "mean"),
    "min": (lambda d: d[VIEWS_NUM].min(), "min"),
    "max": (lambda d: d[VIEWS_NUM].max(), "max"),
    "count": (lambda d: d[VIEWS_NUM].count(), "count"),
    "prod_b": (lambda d: d[["b"]].prod(), "prod"),
    "any": (lambda d: d[VIEWS_NUM].any(), "any"),
    "all": (lambda d: d[VIEWS_NUM].all(), "all"),
    "var": (lambda d: d[VIEWS_NUM].var(), "var"),
    "median": (lambda d: d[VIEWS_NUM].median(), "median"),
    "nunique": (lambda d: d.nunique(), "nunique"),
    "mode": (lambda d: d[["i", "b", "k"]].mode(), "mode"),
    "groupby_k_sum": (lambda d: d.groupby("k")[["i", "f", "b"]].sum(), "sum"),
    "groupby_k_mean": (lambda d: d.groupby("k")[["i", "f", "b"]].mean(), "mean"),
    "groupby_k_count": (lambda d: d.groupby("k")[["i", "f", "b"]].count(), "count"),
    "groupby_k_size": (lambda d: d[VIEWS_NUM].groupby("k").size(), "count"),
    "groupby_k_min": (lambda d: d.groupby("k")[["i", "f", "b"]].min(), "min"),
    "groupby_k_max": (lambda d: d.groupby("k")[["i", "f", "b"]].max(), "max"),
    "groupby_s_sum": (lambda d: d.groupby("s")[["i", "f"]].sum(), "sum"),
}
VIEWS_FOLDABLE = {"sum", "mean", "min", "max", "count", "prod_b", "any", "all"} | {
    q for q in VIEWS_QUERIES if q.startswith("groupby_k_")}
# the timed queries of (b), over i, f and k
VIEWS_TIME_QUERIES = {
    "sum": lambda d: d.sum(),
    "mean": lambda d: d.mean(),
    "min": lambda d: d.min(),
    "groupby_k_sum": lambda d: d.groupby("k")[["i", "f"]].sum(),
    "groupby_k_mean": lambda d: d.groupby("k")[["i", "f"]].mean(),
    "groupby_k_count": lambda d: d.groupby("k")[["i", "f"]].count(),
    "nunique_k": lambda d: d[["k"]].nunique(),
}


def views_data(rows: int, seed: int, strings: bool = True) -> dict:
    """int64 ``i``, float64 ``f`` with 20 % NaN, bool ``b``, an int key ``k``
    in [0, 1000) and a str column ``s`` of five words; (b)'s frames have
    ``i``, ``f`` and ``k`` only."""
    rng = np.random.default_rng(seed)
    data = {"i": rng.integers(-1000, 1000, rows),
            "f": np.where(rng.random(rows) < 0.2, np.nan, rng.standard_normal(rows))}
    if strings:
        data["b"] = rng.random(rows) < 0.5
    data["k"] = rng.integers(0, VIEWS_KEYS, rows)
    if strings:
        data["s"] = rng.choice(np.array(VIEWS_WORDS, dtype=object), rows)
    return data


def _view_counts() -> dict:
    from modin_tpu_torch.views import registry

    return {k: registry.COUNTS.get(k, 0) for k in ("view.hit", "view.fold", "view.miss", "view.build")}


def _kernel_marks() -> dict:
    from modin_tpu_torch.ops.cuda import fused_kernels as fk
    from modin_tpu_torch.ops.cuda import groupagg_kernels as ga
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk

    return {name: (m.LAUNCHES, m.ROWS) for name, m in (("bincount", gk), ("groupagg", ga), ("fused", fk))}


def _since(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def _kernel_since(before: dict) -> dict:
    after = _kernel_marks()
    return {k: {"launches": after[k][0] - before[k][0], "rows": after[k][1] - before[k][1]} for k in before}


def _views_same(got, want, what: str, kind: str, frame, by=None) -> None:
    """The port's tolerances: ints, bools, min, max, counts and order-free
    answers exactly; float reductions to rtol 1e-12; a grouped float sum or
    mean to 1e-12 of its group's sum (mean) of |x| (``frame`` the pandas
    data, ``by`` the key)."""
    if kind == "mode":
        import pandas

        # bools padded with NaN are object columns: pandas' own exact check
        pandas.testing.assert_frame_equal(got, want, check_exact=True, obj=what)
        return
    if by is None or kind not in ("sum", "mean"):
        assert_same_pandas(got, want, what, exact=kind not in ("sum", "mean", "var"))
        return
    values = frame[[c for c in want.columns if want[c].dtype.kind == "f"]]
    mag = values.astype(np.float64).abs().groupby(frame[by]).sum()
    if kind == "mean":
        mag = mag / values.groupby(frame[by]).count()
    _plan_same(got, want, what, kind, scale=mag.reindex(want.index))


def views_correctness(rows: int, seed: int) -> dict:
    """(a): each query of ``VIEWS_QUERIES`` cold, again (a hit), after each
    of 3 chained appends of rows / 10 (a fold where the artifact folds),
    on a branch appended to the same parent, and under ``ViewsMode`` Off,
    against pandas; the hit, fold and miss counts of each stage."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import ViewsMode

    tail_rows = rows // 10
    base = pandas.DataFrame(views_data(rows, seed))
    tails = [pandas.DataFrame(views_data(tail_rows, seed + 1 + j)) for j in range(VIEWS_APPENDS + 1)]
    t0 = time.perf_counter()
    frames = {"cold": (tpd.DataFrame(base), base)}
    frames["hit"] = frames["cold"]
    t, p = frames["cold"]
    for j in range(VIEWS_APPENDS):
        t = tpd.concat([t, tpd.DataFrame(tails[j])], ignore_index=True)
        p = pandas.concat([p, tails[j]], ignore_index=True)
        frames[f"fold{j + 1}"] = (t, p)
    frames["branch"] = (tpd.concat([frames["cold"][0], tpd.DataFrame(tails[-1])], ignore_index=True),
                        pandas.concat([base, tails[-1]], ignore_index=True))
    concat_s = time.perf_counter() - t0
    stages = ["cold", "hit"] + [f"fold{j + 1}" for j in range(VIEWS_APPENDS)] + ["branch"]
    counts = {}
    for name, (query, kind) in VIEWS_QUERIES.items():
        by = "k" if name.startswith("groupby_k") else ("s" if name.startswith("groupby_s") else None)
        counts[name] = {}
        for stage in stages:
            tdf, pdf = frames[stage]
            c0 = _view_counts()
            got = tpd.to_pandas(query(tdf))
            counts[name][stage] = _since(c0, _view_counts())
            _views_same(got, query(pdf), f"views {name} {stage}", kind, pdf, by)
        seen = counts[name]
        if seen["hit"]["view.hit"] == 0 or seen["hit"]["view.miss"] or seen["hit"]["view.build"]:
            raise AssertionError(f"views {name}: the repeat was no hit: {seen['hit']}")
        if name in VIEWS_FOLDABLE:
            for stage in stages[2:]:
                if seen[stage]["view.fold"] == 0 or seen[stage]["view.miss"]:
                    raise AssertionError(f"views {name} {stage}: no fold: {seen[stage]}")
        tdf, pdf = frames[stages[-2]]
        with ViewsMode.context("Off"):
            c0 = _view_counts()
            off = tpd.to_pandas(query(tdf))
            if any(_since(c0, _view_counts()).values()):
                raise AssertionError(f"views {name}: Off touched the registry")
        _views_same(off, query(pdf), f"views {name} off", kind, pdf, by)
    return {"rows": rows, "tail_rows": tail_rows, "concat_s": concat_s, "counts": counts}


def _views_fold_ok(name: str, j: int, kern: dict, n0: int, n_tail: int) -> None:
    """A fold's launches read only tail rows; the first fold of a grouped
    mean also reads the prefix once, for the per-group valid counts its
    cold query did not keep (written back to the artifact)."""
    for kernel, got in kern.items():
        extra = got["rows"] - got["launches"] * n_tail
        prefix_launches, rem = divmod(extra, max(n0 - n_tail, 1))
        allowed = name.endswith("_mean") and j == 0
        if rem or prefix_launches < 0 or (prefix_launches and not allowed):
            raise AssertionError(f"views {name} fold {j + 1}: {kernel} read {got['rows']} rows in "
                                 f"{got['launches']} launches beyond the {n_tail}-row tail")


def views_times(rows: int, seed: int) -> dict:
    """(b): ``VIEWS_TIME_QUERIES`` over ``i, f, k`` at ``rows``, cold and hit,
    then after each of 10 appends of rows / 100 (fold, or the miss of a
    sort-shaped answer), then the final frame under ``ViewsMode`` Off; the
    port's times (ended by a device synchronise), each stage's launches and
    rows per kernel, and the hit, fold and miss counts.  The last fold's
    answers equal Off's: ints bit for bit, floats to rtol 1e-12 (a grouped
    float sum or mean to 1e-12 of its group's sum (mean) of |x|, from
    torch on the card)."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import ViewsMode

    tail_rows = rows // 100
    t0 = time.perf_counter()
    df = tpd.DataFrame(pandas.DataFrame(views_data(rows, seed, strings=False)))
    tails = [pandas.DataFrame(views_data(tail_rows, seed + 100 + j, strings=False))
             for j in range(VIEWS_TIME_APPENDS)]
    build_s = time.perf_counter() - t0
    out = {q: {"fold_ms": [], "fold_to_pandas_ms": [], "fold_kernels": [], "fold_counts": []}
           for q in VIEWS_TIME_QUERIES}

    def timed(q, frame):
        c0, k0 = _view_counts(), _kernel_marks()
        res, ms = host_ms(lambda: VIEWS_TIME_QUERIES[q](frame))
        kern = _kernel_since(k0)
        counts = _since(c0, _view_counts())
        got, tp_ms = host_ms(lambda: tpd.to_pandas(res))
        return got, ms, tp_ms, kern, counts

    for stage in ("cold", "hit"):
        for q in VIEWS_TIME_QUERIES:
            _, ms, tp_ms, kern, counts = timed(q, df)
            out[q][f"{stage}_ms"], out[q][f"{stage}_to_pandas_ms"] = ms, tp_ms
            out[q][f"{stage}_kernels"], out[q][f"{stage}_counts"] = kern, counts
            if stage == "hit" and (any(v["launches"] for v in kern.values()) or not counts["view.hit"]):
                raise AssertionError(f"views {q} hit: {counts}, launches {kern}")
    concat_ms = []
    last = {}
    for j, tail in enumerate(tails):
        n0 = len(df)
        df, ms = host_ms(lambda parent=df: tpd.concat([parent, tpd.DataFrame(tail)], ignore_index=True))
        concat_ms.append(ms)
        for q in VIEWS_TIME_QUERIES:
            got, ms, tp_ms, kern, counts = timed(q, df)
            rec = out[q]
            rec["fold_ms"].append(ms)
            rec["fold_to_pandas_ms"].append(tp_ms)
            rec["fold_kernels"].append(kern)
            rec["fold_counts"].append(counts)
            if q == "nunique_k":
                if not counts["view.miss"] and not counts["view.build"]:
                    raise AssertionError(f"views {q}: an appended frame answered from the parent")
            else:
                if not counts["view.fold"] or counts["view.miss"]:
                    raise AssertionError(f"views {q} fold {j + 1}: {counts}")
                _views_fold_ok(q, j, kern, n0, tail_rows)
            last[q] = got
    with ViewsMode.context("Off"):
        for q in VIEWS_TIME_QUERIES:
            c0, k0 = _view_counts(), _kernel_marks()
            res, ms = host_ms(lambda: VIEWS_TIME_QUERIES[q](df))
            out[q]["off_kernels"] = _kernel_since(k0)
            off, tp_ms = host_ms(lambda: tpd.to_pandas(res))
            out[q]["off_ms"], out[q]["off_to_pandas_ms"] = ms, tp_ms
            if any(_since(c0, _view_counts()).values()):
                raise AssertionError(f"views {q}: Off touched the registry")
            _views_same_off(last[q], off, q, df)
    for q, rec in out.items():
        folds = sorted(rec["fold_ms"])
        rec["fold_median_ms"] = folds[len(folds) // 2]
        rec["fold_beats_off"] = rec["fold_median_ms"] < rec["off_ms"]
    return {"rows": rows, "tail_rows": tail_rows, "appends": VIEWS_TIME_APPENDS, "build_s": build_s,
            "concat_ms": concat_ms, "final_rows": len(df), "queries": out}


def _views_same_off(fold, off, q: str, df) -> None:
    """The last fold's answer against Off's on the same frame."""
    import torch

    what = f"views {q} fold against off"
    if not q.startswith("groupby_k_") or q.endswith("_count"):
        assert_same_pandas(fold, off, what, exact=q in ("min", "nunique_k", "groupby_k_count"))
        return
    # the groups' magnitudes on the card, from the frame's own tensors
    frame = df._query_compiler._modin_frame
    cols = {lab: frame.get_column(i).data for i, lab in enumerate(frame.columns)}
    k = cols["k"]
    mag = {}
    for lab in ("i", "f"):
        x = cols[lab].to(torch.float64)
        valid = ~torch.isnan(x)
        s = torch.zeros(VIEWS_KEYS, dtype=torch.float64, device=x.device).index_add_(0, k, torch.where(valid, x.abs(), 0.0))
        if q.endswith("_mean"):
            s = s / torch.zeros(VIEWS_KEYS, dtype=torch.float64, device=x.device).index_add_(0, k, valid.to(torch.float64))
        mag[lab] = s.cpu().numpy()
    import pandas

    scale = pandas.DataFrame(mag, index=pandas.RangeIndex(VIEWS_KEYS, name="k")).reindex(off.index)
    _plan_same(fold, off, what, "sum", scale=scale)


def phase_views(rows: int, time_rows: int, seed: int) -> dict:
    """The derived-artifact cache (``views/``) on the card: (a) every query
    of ``VIEWS_QUERIES`` against pandas at ``rows`` through hits, chained
    folds, a branch and Off; (b) the times of ``VIEWS_TIME_QUERIES`` at
    ``time_rows`` cold, hit, folded over 10 appends and recomputed under
    Off.  Nothing defaults to pandas; a hit launches no kernel; a fold's
    launches read only the tail.  Returns the launches."""
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.views import registry

    t_phase = time.perf_counter()
    tqc.DEFAULTS_TO_PANDAS = 0
    k0 = _kernel_marks()
    registry.reset()
    t0 = time.perf_counter()
    correct = views_correctness(rows, seed)
    correct["seconds"] = time.perf_counter() - t0
    emit({"phase": "views", "part": "correctness", **correct})
    registry.reset()
    free_device_memory()
    t0 = time.perf_counter()
    times = views_times(time_rows, seed)
    times["seconds"] = time.perf_counter() - t0
    emit({"phase": "views", "part": "times", **times})
    registry.reset()
    free_device_memory()
    if tqc.DEFAULTS_TO_PANDAS:
        raise AssertionError(f"{tqc.DEFAULTS_TO_PANDAS} views calls defaulted to pandas")
    launches = {k: v["launches"] for k, v in _kernel_since(k0).items()}
    if not launches["bincount"] or not launches["groupagg"]:
        raise AssertionError(f"the views path never launched bincount or groupagg: {launches}")
    summary = {q: {f: r[f] for f in ("cold_ms", "hit_ms", "fold_median_ms", "off_ms", "fold_beats_off")}
               for q, r in times["queries"].items()}
    emit({"phase": "views", "launches": launches, "defaults_to_pandas": tqc.DEFAULTS_TO_PANDAS,
          "summary_ms": summary, "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------- #
# 17. robust: fault-tolerant execution on the card
# ---------------------------------------------------------------------- #

#: (a)'s queries: a groupby mean and a fused sum at the main path's width
ROBUST_OOM_ROWS = 10**8
#: (a)'s cold frames: ROBUST_COLD_FRAMES frames of ROBUST_COLD_ROWS x 10
#: float64 columns (2 GB each), resident and never read by the queries
ROBUST_COLD_FRAMES = 3
ROBUST_COLD_ROWS = 25 * 10**6
#: (a)'s cap sits this share of the cold bytes above the query's own peak:
#: below the resident bytes plus the peak, above the peak alone; the
#: evictor's first round spills half the resident bytes, more than this
ROBUST_CAP_SHARE = 0.45
#: (b)'s frames and CSV
ROBUST_FAULT_ROWS = 2 * 10**6
ROBUST_CSV_ROWS = 10**6
#: (c): the phase-4 queries timed with the layer on and off
ROBUST_COST_QUERIES = ("df_plus_df", "sum", "mean", "groupby_sum", "groupby_mean")
ROBUST_COST_ROUNDS = 5


def _resilience_marks() -> dict:
    from modin_tpu_torch.core import memory
    from modin_tpu_torch.core.execution import resilience

    return {"counts": dict(resilience.COUNTS), "memory": dict(memory.COUNTS),
            "fallbacks": resilience.fallback_count()}


def _resilience_since(before: dict) -> dict:
    from modin_tpu_torch.core import memory
    from modin_tpu_torch.core.execution import resilience

    counts = {k: v - before["counts"].get(k, 0) for k, v in resilience.COUNTS.items()
              if v != before["counts"].get(k, 0)}
    spills = {k: memory.COUNTS[k] - before["memory"][k] for k in ("memory.device.spill", "memory.device.spill_bytes",
                                                                  "memory.device.restore")}
    return {"counts": counts, "memory": spills, "fallbacks": resilience.fallback_count() - before["fallbacks"]}


def robust_oom_case(name: str, make_query_frame, query, reference, make_cold, exact: bool, seam: str) -> dict:
    """One real OOM absorbed by evict-then-retry: ``query``'s peak measured
    on a frame of its own with nothing else resident, then the same query on
    a fresh frame beside the cold frames ``make_cold()`` returns, ``(frames,
    their host values)``, under a cap between that peak and the peak plus
    the cold bytes; then every cold column that spilled restores exactly.
    ``seam`` (``device_path`` or ``engine_call``) is the leg that must
    absorb it.  Returns the case's record."""
    import torch

    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc

    from modin_tpu_torch.ops import groupby as gb_ops

    free_device_memory()
    probe = make_query_frame()
    torch.cuda.reset_peak_memory_stats()
    _, alone_ms = host_ms(lambda: query(probe))
    peak = torch.cuda.max_memory_allocated()
    del probe
    gb_ops._FACTORIZE_CACHE.clear()  # it holds the probe's key and codes
    free_device_memory()
    cold_frames, cold_values = make_cold()
    frame = make_query_frame()
    cold_bytes = sum(c.data.numel() * c.data.element_size()
                     for f in cold_frames for c in f._query_compiler._modin_frame._columns)
    total = torch.cuda.get_device_properties(0).total_memory
    cap = peak + int(ROBUST_CAP_SHARE * cold_bytes)
    resident = torch.cuda.memory_allocated()
    k0, r0 = _kernel_marks(), _resilience_marks()
    ooms0 = torch.cuda.memory_stats().get("num_ooms", 0)
    defaults0 = tqc.DEFAULTS_TO_PANDAS
    torch.cuda.empty_cache()  # the query's allocations need new segments under the cap
    torch.cuda.set_per_process_memory_fraction(cap / total, 0)
    try:
        got, ms = host_ms(lambda: query(frame))
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, 0)
    ooms = torch.cuda.memory_stats().get("num_ooms", 0) - ooms0
    since = _resilience_since(r0)
    launches = {k: v["launches"] for k, v in _kernel_since(k0).items()}
    want = reference()
    if np.isscalar(want):
        if (got != want) if exact else not np.isclose(got, want, rtol=FLOAT_RTOL, atol=0):
            raise AssertionError(f"{name}: {got} != pandas' {want}")
    else:
        import modin_tpu_torch.pandas as tpd

        assert_same_pandas(tpd.to_pandas(got), want, name, exact=exact)
        gb_ops._FACTORIZE_CACHE.clear()
    record = {"case": name, "peak_alone_bytes": peak, "cold_bytes": cold_bytes, "cap_bytes": cap,
              "resident_before_bytes": resident, "alone_ms": alone_ms, "oom_run_ms": ms, "torch_ooms": ooms,
              "retry_oom": since["counts"].get("recovery.retry.oom", 0),
              "engine_oom": sum(v for k, v in since["counts"].items()
                                if k.startswith("resilience.engine.") and k.endswith(".oom")),
              "spills": since["memory"]["memory.device.spill"], "spill_bytes": since["memory"]["memory.device.spill_bytes"],
              "fallbacks": since["fallbacks"], "defaults": tqc.DEFAULTS_TO_PANDAS - defaults0,
              "launches": launches, "counts": since["counts"]}
    if ooms < 1 or record["retry_oom"] < 1:
        raise AssertionError(f"{name}: no real OOM was absorbed: {record}")
    if seam == "device_path" and record["engine_oom"]:
        raise AssertionError(f"{name}: the OOM met the engine seam, not device_path: {record}")
    if seam == "engine_call" and record["engine_oom"] < 1:
        raise AssertionError(f"{name}: the OOM did not meet the engine seam: {record}")
    if record["spills"] < 1 or record["fallbacks"] or record["defaults"]:
        raise AssertionError(f"{name}: the OOM went to pandas or spilled nothing: {record}")
    del frame, got
    restored = 0
    t0 = time.perf_counter()
    for f, values in zip(cold_frames, cold_values):
        for col, v in zip(f._query_compiler._modin_frame._columns, values.values()):
            if col.is_spilled:
                if not np.array_equal(col.data.cpu().numpy(), v):
                    raise AssertionError(f"{name}: a spilled cold column did not restore exactly")
                restored += 1
    if not restored:
        raise AssertionError(f"{name}: the OOM spilled no cold column")
    record["cold_restored_exactly"] = restored
    record["restore_check_s"] = time.perf_counter() - t0
    del cold_frames
    free_device_memory()
    return record


def robust_real_oom(seed: int) -> dict:
    """(a): a real ``torch.cuda.OutOfMemoryError`` at full width, absorbed
    in the ``device_path`` leg (a 1e8-row int-key groupby mean on
    ``groupagg.cu``) and in the ``engine_call`` leg (``(a * b + c).sum()``
    at 1e8 rows, one fused launch through ``deploy``); the cold frames
    spilled restore exactly afterwards."""
    import pandas
    import torch

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import ViewsMode
    from modin_tpu_torch.core.storage_formats.torch.query_compiler import TorchQueryCompiler

    rows = ROBUST_OOM_ROWS
    rng = np.random.default_rng(seed + 1700)
    gb_data = {"key": rng.integers(0, 100, rows), "v0": rng.integers(0, 100, rows), "v1": rng.integers(0, 100, rows)}
    # integer-valued floats: every sum below 2^53 is exact in any order
    ch_data = {c: rng.integers(0, 100, rows).astype(np.float64) for c in "abc"}
    base = rng.standard_normal(ROBUST_COLD_ROWS)
    cold_values = [{f"c{j}": base + (10 * f + j) for j in range(10)} for f in range(ROBUST_COLD_FRAMES)]
    del base

    def frame_of(data):
        return tpd.DataFrame(query_compiler=TorchQueryCompiler.from_numpy_columns(data))

    def make_cold():
        return [frame_of(v) for v in cold_values], cold_values

    out = {}
    with ViewsMode.context("Off"):  # a cached answer would allocate nothing
        out["groupby_mean"] = robust_oom_case(
            "groupby_mean_1e8", lambda: frame_of(gb_data), lambda d: d.groupby("key").mean(),
            lambda: pandas.DataFrame(gb_data).groupby("key").mean(), make_cold, exact=False, seam="device_path")
        if out["groupby_mean"]["launches"]["groupagg"] < 1:
            raise AssertionError(f"the OOM groupby never launched groupagg: {out['groupby_mean']}")
        out["sum_chain"] = robust_oom_case(
            "axpb_sum_1e8", lambda: frame_of(ch_data), lambda d: (d["a"] * d["b"] + d["c"]).sum(),
            lambda: float((ch_data["a"] * ch_data["b"] + ch_data["c"]).sum()), make_cold, exact=True,
            seam="engine_call")
        if out["sum_chain"]["launches"]["fused"] < 1:
            raise AssertionError(f"the chain's OOM run never launched fused: {out['sum_chain']}")
    del cold_values, gb_data, ch_data
    free_device_memory()
    return out


def robust_injected(seed: int, workdir: str) -> dict:
    """(b): injected faults on the card.  A transient fault at ``put`` and at
    ``materialize`` retried to success; a loss in the middle of a fused
    chain and of a filter -> groupby -> merge re-seats host, io (a CSV
    read whose host copies were dropped) and op lineage bit for bit, with
    nothing unrecoverable, and a views artifact of before the loss misses;
    threshold-many losses raise ``DeviceLost`` and open the ``reduce``
    family's breaker, the next call raises ``BreakerOpen`` without touching
    the card, and after the cooldown a clean probe closes it.  Nothing goes
    to pandas."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import ResilienceBreakerCooldownS, ResilienceBreakerThreshold
    from modin_tpu_torch.core import memory
    from modin_tpu_torch.core.execution import recovery, resilience
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.parallel.engine import TorchWrapper
    from modin_tpu_torch.testing import inject_faults, midquery_device_loss
    from modin_tpu_torch.views import registry

    rows = ROBUST_FAULT_ROWS
    rng = np.random.default_rng(seed + 1701)
    pdf = pandas.DataFrame({"key": rng.integers(0, 50, rows), "a": rng.integers(0, 100, rows).astype(np.float64),
                            "b": rng.integers(0, 100, rows), "c": rng.integers(0, 100, rows).astype(np.float64)})
    out = {}
    # transient faults at put and at materialize
    r0 = _resilience_marks()
    with inject_faults("transient", ops=("put",), times=1) as inj:
        hdf = tpd.DataFrame(pdf)
    assert_on_cuda(hdf._query_compiler, "robust put retry")
    with inject_faults("transient", ops=("materialize",), times=1) as inj2:
        got = tpd.to_pandas(hdf.groupby("key").sum())
    assert_same_pandas(got, pdf.groupby("key").sum(), "robust materialize retry", exact=True)
    since = _resilience_since(r0)
    out["transient"] = {"injected": inj.injected + inj2.injected, "counts": since["counts"]}
    if (since["counts"].get("resilience.engine.put.retry") != 1
            or since["counts"].get("resilience.engine.materialize.retry") != 1 or since["fallbacks"]):
        raise AssertionError(f"a transient fault was not retried to success: {out['transient']}")
    # the lineage kinds: host (hdf), io (a CSV read), op (a fused column)
    path = os.path.join(workdir, "robust.csv")
    pdf.iloc[:ROBUST_CSV_ROWS].to_csv(path, index=False)
    io_df = tpd.read_csv(path)
    io_cols = [c for c in io_df._query_compiler._modin_frame._columns if c.is_device]
    io_values = [c.to_numpy().copy() for c in io_cols]
    for c in io_cols:  # the host copies go: only the file can make them again
        memory.ledger.forget(c)
        c.host_cache = None
    op_series = hdf["a"] * 2 + hdf["c"]
    op_col = op_series._query_compiler._modin_frame._columns[0]
    op_values = TorchWrapper.materialize(op_col.data)
    kinds = {"host": hdf._query_compiler._modin_frame._columns[0].lineage.kind,
             "io": io_cols[0].lineage.kind, "op": op_col.lineage.kind}
    if kinds != {"host": "host", "io": "io", "op": "op"}:
        raise AssertionError(f"unexpected lineage kinds {kinds}")
    import weakref

    old_tensors = [weakref.ref(c._data) for c in io_cols + [op_col]]
    gc.collect()
    sum_want = pdf.sum()
    got = tpd.to_pandas(hdf.sum())  # a views artifact of before the loss
    assert_same_pandas(got, sum_want, "robust sum before the loss", exact=True)
    r0 = _resilience_marks()
    v0 = dict(registry.COUNTS)
    with midquery_device_loss(after_deploys=0, times=1) as inj:
        got = (hdf["a"] * 3 - hdf["c"]).sum()
    want = float((pdf["a"] * 3 - pdf["c"]).sum())
    if got != want:
        raise AssertionError(f"the fused chain after the loss: {got} != {want}")
    filt = pdf[pdf.a > 50]
    merge_want = filt.groupby("key", as_index=False).sum().merge(
        filt.groupby("key", as_index=False).mean(), on="key", suffixes=("_s", "_m"))
    with midquery_device_loss(after_deploys=0, times=1) as inj2:
        f = hdf[hdf.a > 50]
        got = tpd.to_pandas(f.groupby("key", as_index=False).sum().merge(
            f.groupby("key", as_index=False).mean(), on="key", suffixes=("_s", "_m")))
    assert_same_pandas(got, merge_want, "robust groupby -> merge after the loss")
    since = _resilience_since(r0)
    for c, v in zip(io_cols, io_values):
        if not np.array_equal(TorchWrapper.materialize(c.data), v):
            raise AssertionError("an io column did not re-seat bit for bit")
    if not np.array_equal(TorchWrapper.materialize(op_col.data), op_values):
        raise AssertionError("the op column did not re-seat bit for bit")
    for c in hdf._query_compiler._modin_frame._columns:
        if not np.array_equal(TorchWrapper.materialize(c.data), c.host_cache):
            raise AssertionError("a host column did not re-seat bit for bit")
    fresh = [c for c, old in zip(io_cols + [op_col], old_tensors) if old() is c._data]
    got = tpd.to_pandas(hdf.sum())
    assert_same_pandas(got, sum_want, "robust sum after the loss", exact=True)
    views_after = {k: registry.COUNTS[k] - v0.get(k, 0) for k in ("view.hit", "view.miss")}
    out["loss"] = {"injected": inj.injected + inj2.injected, "counts": since["counts"], "lineage": kinds,
                   "epoch": recovery.current_epoch(), "views": views_after, "tensors_not_reseated": len(fresh)}
    c = since["counts"]
    if (c.get("recovery.device_lost") != 2 or c.get("recovery.unrecoverable", 0)
            or not all(c.get(f"recovery.reseat.{k}", 0) for k in ("host", "io", "op"))
            or since["fallbacks"] or fresh or views_after["view.hit"] or not views_after["view.miss"]):
        raise AssertionError(f"the loss did not re-seat cleanly: {out['loss']}")
    # threshold-many losses raise and open the reduce family's breaker
    threshold = 3
    defaults0 = tqc.DEFAULTS_TO_PANDAS
    r0 = _resilience_marks()
    median_want = pdf.median()
    states, raised, injected = [], [], []
    with ResilienceBreakerThreshold.context(threshold), ResilienceBreakerCooldownS.context(30.0):
        with inject_faults("device_lost", ops=("materialize",), times=None) as inj:
            for _ in range(threshold + 1):
                try:
                    tpd.to_pandas(hdf.median())
                except resilience.DeviceFailure as err:
                    raised.append(type(err).__name__)
                else:
                    raised.append(None)
                states.append(resilience.get_breaker("reduce").state)
                injected.append(inj.injected)
        real_now = resilience._now
        resilience._now = lambda: real_now() + 31.0
        try:
            assert_same_pandas(tpd.to_pandas(hdf.median()), median_want, "robust median, probe")
        finally:
            resilience._now = real_now
        states.append(resilience.get_breaker("reduce").state)
    since = _resilience_since(r0)
    c = since["counts"]
    out["breaker"] = {"states": states, "raised": raised, "injected": injected,
                      "fallbacks": since["fallbacks"], "defaults": tqc.DEFAULTS_TO_PANDAS - defaults0, "counts": c}
    if (raised != ["DeviceLost"] * threshold + ["BreakerOpen"]
            or injected[-1] != injected[-2]  # the open breaker stopped the call before the card
            or states != ["closed"] * (threshold - 1) + ["open", "open", "closed"]
            or c.get("resilience.raised.reduce.device_lost") != threshold
            or c.get("resilience.breaker.reduce.short_circuit") != 1
            or c.get("resilience.breaker.reduce.half_open") != 1
            or since["fallbacks"] or out["breaker"]["defaults"]):
        raise AssertionError(f"the breaker did not raise, open, stop a call and close: {out['breaker']}")
    del hdf, io_df, io_cols, op_series, op_col, f
    free_device_memory()
    return out


def _layer_call_costs(calls: int = 20000) -> dict:
    """The layer's own cost per call on this host, in microseconds: each
    entry point with a trivial body, ``Enable`` less ``Disable`` (the best
    of three timings of ``calls`` calls each)."""
    import torch

    import modin_tpu_torch
    from modin_tpu_torch.config import RecoveryMode, ResilienceMode
    from modin_tpu_torch.core.execution import resilience
    from modin_tpu_torch.parallel.engine import TorchWrapper

    class Probe:
        _frame = None

        @resilience.device_path("reduce")
        def _try(self):
            return None

    probe, t = Probe(), torch.zeros(1, device=modin_tpu_torch.get_device())
    cases = {
        "engine_call": lambda: resilience.engine_call("wait", _noop),
        "device_path": probe._try,
        "deploy": lambda: TorchWrapper.deploy(_identity, (t,)),
    }
    out = {}
    for name, fn in cases.items():
        best = {}
        for mode in ("Enable", "Disable"):
            with ResilienceMode.context(mode), RecoveryMode.context(mode):
                walls = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn()
                    walls.append(time.perf_counter() - t0)
                best[mode] = min(walls) / calls * 1e6
        out[name] = {"enable_us": best["Enable"], "disable_us": best["Disable"],
                     "layer_us": best["Enable"] - best["Disable"]}
    return out


def _noop():
    return None


def _identity(x):
    return x


#: the layer's entry points whose calls ``_layer_calls`` counts
_LAYER_FUNCTIONS = {("resilience.py", "engine_call"), ("resilience.py", "wrapper"),
                    ("recovery.py", "record_deploy"), ("recovery.py", "record_put"),
                    ("recovery.py", "note_column_data"), ("recovery.py", "attach_lineage")}


def _layer_calls(fn) -> dict:
    """Calls of the layer's entry points in one run of ``fn`` (traced with
    ``sys.setprofile``, so not timed)."""
    import collections

    seen = collections.Counter()

    def tracer(frame, event, arg):
        if event == "call":
            code = frame.f_code
            key = (os.path.basename(code.co_filename), code.co_name)
            if key in _LAYER_FUNCTIONS and "modin_tpu_torch" in code.co_filename:
                seen[key[1] if key[1] != "wrapper" else "device_path"] += 1

    sys.setprofile(tracer)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return dict(seen)


def robust_cost(rows: int, seed: int) -> dict:
    """(c): five phase-4 queries at ``rows`` with ``ResilienceMode`` and
    ``RecoveryMode`` Enable against Disable (views off, so each run
    computes), each query's port and ``to_pandas`` wall in
    ``ROBUST_COST_ROUNDS`` rounds of Enable, Disable, Disable, Enable: every
    run, the medians by mode and their difference, each round's difference
    of means; the calls of the layer one Enable run makes, and the layer's
    cost per call (``_layer_call_costs``).  Recorded, not claimed."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import RecoveryMode, ResilienceMode, ViewsMode

    p1 = pandas.DataFrame(make_frame_data(rows, seed, ngroups=100))
    p2 = pandas.DataFrame(make_frame_data(rows, seed + 1, ngroups=100))
    times = {q: {"Enable": [], "Disable": []} for q in ROBUST_COST_QUERIES}
    rounds = {q: [] for q in ROBUST_COST_QUERIES}
    with ViewsMode.context("Off"):
        t1, t2 = tpd.from_pandas(p1), tpd.from_pandas(p2)
        for q in ROBUST_COST_QUERIES:
            tpd.to_pandas(MAIN_QUERIES[q](t1, t2))  # warm-up
        for _ in range(ROBUST_COST_ROUNDS):
            this = {q: {"Enable": [], "Disable": []} for q in ROBUST_COST_QUERIES}
            for mode in ("Enable", "Disable", "Disable", "Enable"):
                with ResilienceMode.context(mode), RecoveryMode.context(mode):
                    for q in ROBUST_COST_QUERIES:
                        _, ms = host_ms(lambda: tpd.to_pandas(MAIN_QUERIES[q](t1, t2)))
                        times[q][mode].append(ms)
                        this[q][mode].append(ms)
            for q in ROBUST_COST_QUERIES:
                rounds[q].append(statistics.mean(this[q]["Enable"]) - statistics.mean(this[q]["Disable"]))
        calls = {}
        with ResilienceMode.context("Enable"), RecoveryMode.context("Enable"):
            for q in ROBUST_COST_QUERIES:
                calls[q] = _layer_calls(lambda: tpd.to_pandas(MAIN_QUERIES[q](t1, t2)))
    del t1, t2
    free_device_memory()
    per_call = _layer_call_costs()
    out = {"per_call_us": per_call}
    for q, by in times.items():
        med = {m: statistics.median(v) for m, v in by.items()}
        out[q] = med | {"delta_ms": med["Enable"] - med["Disable"], "round_deltas_ms": rounds[q],
                        "runs_ms": by, "layer_calls": calls[q]}
    return out


def phase_robust(seed: int, cost_rows: int, workdir: str) -> dict:
    """Phase 17 (``robust``): (a) ``robust_real_oom``, (b)
    ``robust_injected``, (c) ``robust_cost``.  Returns its launches and the
    phase's record for the ``{"resilience": ...}`` line."""
    from modin_tpu_torch.core.execution import resilience
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc

    t_phase = time.perf_counter()
    tqc.DEFAULTS_TO_PANDAS = 0
    k0 = _kernel_marks()
    record = {}
    for part, fn, fn_args in (("real_oom", robust_real_oom, (seed,)),
                              ("injected", robust_injected, (seed, workdir)),
                              ("cost", robust_cost, (cost_rows, seed))):
        t0 = time.perf_counter()
        record[part] = fn(*fn_args)
        record[part + "_seconds"] = time.perf_counter() - t0
        emit({"phase": "robust", "part": part, **record[part], "seconds": record[part + "_seconds"]})
    if tqc.DEFAULTS_TO_PANDAS:
        raise AssertionError(f"{tqc.DEFAULTS_TO_PANDAS} robust calls defaulted to pandas")
    resilience.reset_breakers()
    launches = {k: v["launches"] for k, v in _kernel_since(k0).items()}
    record["launches"] = launches
    record["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "robust", "launches": launches, "seconds": record["seconds"]})
    return launches, record


# ---------------------------------------------------------------------- #
# 18. observability: spans, the launch ledger, meters, costs, the recorder
# ---------------------------------------------------------------------- #

#: phase 18's profiled queries: phase 4's queries on each of the four
#: kernels (``groupagg``: the grouped sums and means; ``bincount``: size;
#: ``fused``: the chain with a var tail, two launches; ``scan``: cumsum)
TRACE_QUERIES = {
    "df_plus_df": lambda d, d2: d + d2,
    "sum": lambda d, d2: d.sum(),
    "mean": lambda d, d2: d.mean(),
    "groupby_sum": lambda d, d2: d.groupby("groupby_col").sum(),
    "groupby_mean": lambda d, d2: d.groupby("groupby_col").mean(),
    "groupby_size": lambda d, d2: d.groupby("groupby_col").size(),
    "chain_var": lambda d, d2: (d * 2 + d2).var(),
    "cumsum": lambda d, d2: d.cumsum(),
}
TRACE_COST_ROUNDS = 5
TRACE_CALLS = 20000
TRACE_KERNELS = ("bincount", "scan", "fused", "groupagg")


def _wrapper_launches() -> dict:
    from modin_tpu_torch.ops.cuda import fused_kernels as fk
    from modin_tpu_torch.ops.cuda import groupagg_kernels as ga
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk
    from modin_tpu_torch.ops.cuda import scan_kernels as sk

    return {"bincount": gk.LAUNCHES, "scan": sk.LAUNCHES, "fused": fk.LAUNCHES, "groupagg": ga.LAUNCHES}


def _subtree_launches(node: dict, totals: dict) -> dict:
    """Per kernel, the launches and event ms of a span and its descendants."""
    for kernel, rec in node["span"].attrs.get("launches", {}).items():
        t = totals.setdefault(kernel, {"launches": 0, "device_ms": 0.0})
        t["launches"] += rec["launches"]
        t["device_ms"] += rec["device_ms"]
    for child in node["children"]:
        _subtree_launches(child, totals)
    return totals


def trace_profile(t1, t2, p1, p2, workdir: str) -> dict:
    """(a): the main path under ``profile()``.  Each query and its
    ``to_pandas`` run under one root span (the fetch waits for the card, so
    the root's wall covers its launches' device time); the rollup, each
    kernel's launches, event ms, bytes, achieved GB/s and roofline fraction;
    the ledger's counts against the wrappers' ``LAUNCHES``; the Chrome trace
    written and read back; every answer against pandas."""
    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch import observability as obs
    from modin_tpu_torch.observability import compile_ledger, costs, spans

    ledger = compile_ledger.get_compile_ledger()
    ledger.reset()
    costs.get_cost_ledger().reset()
    before = _wrapper_launches()
    got = {}
    t0 = time.perf_counter()
    with obs.profile() as prof:
        for name, fn in TRACE_QUERIES.items():
            with spans.layer_span(f"query.{name}", "APP"):
                got[name] = tpd.to_pandas(fn(t1, t2))
    wall_s = time.perf_counter() - t0
    deltas = {k: v - before[k] for k, v in _wrapper_launches().items()}
    snap = ledger.launch_snapshot()
    ledger_counts = {k: snap.get(k, {}).get("launches", 0) for k in TRACE_KERNELS}
    if ledger_counts != deltas:
        raise AssertionError(f"the launch ledger's counts {ledger_counts} differ from the wrappers' {deltas}")
    missing = [k for k in TRACE_KERNELS if not ledger_counts[k]]
    if missing:
        raise AssertionError(f"the profiled main path never launched {missing}")
    for name, fn in TRACE_QUERIES.items():
        assert_same_pandas(got[name], fn(p1, p2), f"trace {name}")
    rollup = prof.rollup()
    kernels = {}
    for k in TRACE_KERNELS:
        rec = snap[k]
        device_s = rec["device_ms"] / 1e3
        if rec["timed"] != rec["launches"] or device_s <= 0:
            raise AssertionError(f"{k}: {rec['timed']} of {rec['launches']} launches were event-timed")
        fraction = costs.roofline_fraction(rec["flops"] or None, rec["bytes"], device_s)
        # beside it, the share of the published peaks (H100 SXM data sheet)
        published = max(rec["bytes"] / HBM_BYTES_PER_S, rec["flops"] / F64_FLOPS) / device_s
        kernels[k] = {"launches": rec["launches"], "device_ms": rec["device_ms"], "bytes": rec["bytes"],
                      "flops": rec["flops"], "achieved_gb_s": rec["bytes"] / device_s / 1e9,
                      "roofline_fraction": fraction, "roofline_fraction_published": published,
                      "signatures": {s: {f: r[f] for f in ("launches", "device_ms", "bytes")}
                                     for s, r in rec["signatures"].items()}}
        if fraction is None:
            raise AssertionError(f"{k}: no roofline fraction")
    roots = {}
    for node in prof.tree():
        sp = node["span"]
        totals = _subtree_launches(node, {})
        roots[sp.name] = {"wall_ms": sp.dur_us / 1e3, "device_interval_ms": sp.attrs.get("device_interval_ms"),
                          "launches": totals}
        for k, t in totals.items():
            if t["device_ms"] > sp.dur_us / 1e3:
                raise AssertionError(f"{sp.name}: {k}'s event time {t['device_ms']} ms passes its root's "
                                     f"wall {sp.dur_us / 1e3} ms")
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    complete = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    if len(complete) != len(prof.spans) or "rollup" not in trace.get("otherData", {}):
        raise AssertionError(f"the Chrome trace holds {len(complete)} spans of {len(prof.spans)}")
    return {"rows": len(p1), "wall_s": wall_s, "rollup": {k: v for k, v in rollup.items() if k != "kernels"},
            "kernels": kernels, "ledger_launches": ledger_counts, "wrapper_launches": deltas,
            "roots": roots, "chrome_trace_events": len(trace["traceEvents"]),
            "compiles": ledger.snapshot()["total_compiles"]}


def trace_peaks() -> dict:
    """(b): this card's peaks, measured now (the roofline's basis for the
    rest of the phase), beside the published figures."""
    from modin_tpu_torch.observability import costs

    peaks = costs.measure_substrate_peaks()
    return {**peaks, "copy_gb_s": peaks["bytes_per_s"] / 1e9, "fma_f64_tflop_s": peaks["flops_per_s"] / 1e12}


def _observed(on: bool):
    """Tracing and meters on (cost capture follows the meters) or off."""
    import contextlib

    from modin_tpu_torch.config import MetersEnabled, TraceEnabled

    stack = contextlib.ExitStack()
    stack.enter_context(TraceEnabled.context(on))
    stack.enter_context(MetersEnabled.context(on))
    return stack


def _wrapped_calls(fn) -> int:
    """Calls of ``ClassLogger``-wrapped methods in one run of ``fn`` (traced
    with ``sys.setprofile``, so not timed)."""
    seen = [0]

    def tracer(frame, event, arg):
        if event == "call":
            code = frame.f_code
            if code.co_name == "run_and_log" and code.co_filename.endswith("logger_decorator.py"):
                seen[0] += 1

    sys.setprofile(tracer)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return seen[0]


def _observability_call_costs(calls: int = TRACE_CALLS) -> dict:
    """Cost per call, microseconds, Enable less Disable, best of 3 x
    ``calls``: a ``ClassLogger``-wrapped method with a trivial body, and a
    span around nothing; and, with everything off, the wrapped method less
    the same method on a class without the wrapper (``off_over_bare_us``:
    what the wrapper costs a call when nothing observes it)."""
    from modin_tpu_torch.logging import ClassLogger
    from modin_tpu_torch.observability import spans

    class Probe(ClassLogger, modin_layer="PANDAS-API"):
        def ping(self):
            return None

    class Bare:
        def ping(self):
            return None

    probe, bare = Probe(), Bare()

    def best_us(fn):
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            walls.append(time.perf_counter() - t0)
        return min(walls) / calls * 1e6

    def span_call():
        with spans.layer_span("probe", "APP"):
            pass

    out = {}
    for name, fn in (("wrapped_method", probe.ping), ("span", span_call)):
        best = {}
        for mode, on in (("Enable", True), ("Disable", False)):
            with _observed(on):
                best[mode] = best_us(fn)
        out[name] = {"enable_us": best["Enable"], "disable_us": best["Disable"],
                     "delta_us": best["Enable"] - best["Disable"]}
    with _observed(False):
        wrapped_off, bare_us = best_us(probe.ping), best_us(bare.ping)
    out["wrapped_method"] |= {"off_us": wrapped_off, "bare_us": bare_us, "off_over_bare_us": wrapped_off - bare_us}
    return out


def trace_cost(t1, t2) -> dict:
    """(c): five phase-4 queries with tracing and meters on and off in
    ``TRACE_COST_ROUNDS`` rounds of on, off, off, on (views off, so each
    run computes): the medians by mode, their difference and each round's;
    the per-call costs; and, with everything off, the span, meter and
    ledger counts over the queries (all must stay 0) and each query's calls
    of wrapped methods, times the wrapper's cost over a bare call
    (``wrappers_off_ms``: the wrappers' cost to the query when nothing
    observes)."""
    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import ViewsMode
    from modin_tpu_torch.observability import compile_ledger, meters, spans

    times = {q: {"Enable": [], "Disable": []} for q in ROBUST_COST_QUERIES}
    rounds = {q: [] for q in ROBUST_COST_QUERIES}
    with ViewsMode.context("Off"):
        for q in ROBUST_COST_QUERIES:
            tpd.to_pandas(MAIN_QUERIES[q](t1, t2))  # warm-up
        for _ in range(TRACE_COST_ROUNDS):
            this = {q: {"Enable": [], "Disable": []} for q in ROBUST_COST_QUERIES}
            for mode in ("Enable", "Disable", "Disable", "Enable"):
                with _observed(mode == "Enable"):
                    for q in ROBUST_COST_QUERIES:
                        _, ms = host_ms(lambda: tpd.to_pandas(MAIN_QUERIES[q](t1, t2)))
                        times[q][mode].append(ms)
                        this[q][mode].append(ms)
            for q in ROBUST_COST_QUERIES:
                rounds[q].append(statistics.mean(this[q]["Enable"]) - statistics.mean(this[q]["Disable"]))
        with _observed(False):
            ledger = compile_ledger.get_compile_ledger()
            a0 = (spans.span_alloc_count(), meters.meter_alloc_count(), sum(ledger.launch_counts().values()),
                  ledger.totals()[0])
            for q in ROBUST_COST_QUERIES:
                tpd.to_pandas(MAIN_QUERIES[q](t1, t2))
            a1 = (spans.span_alloc_count(), meters.meter_alloc_count(), sum(ledger.launch_counts().values()),
                  ledger.totals()[0])
            wrapped = {q: _wrapped_calls(lambda: tpd.to_pandas(MAIN_QUERIES[q](t1, t2))) for q in ROBUST_COST_QUERIES}
    allocs = dict(zip(("spans", "meters", "ledger_launches", "ledger_compiles"), (b - a for a, b in zip(a0, a1))))
    if any(allocs.values()):
        raise AssertionError(f"with everything off the main path made observability objects: {allocs}")
    per_call = _observability_call_costs()
    off_us = per_call["wrapped_method"]["off_over_bare_us"]
    out = {"per_call_us": per_call, "off_allocations": allocs}
    for q, by in times.items():
        med = {m: statistics.median(v) for m, v in by.items()}
        out[q] = med | {"delta_ms": med["Enable"] - med["Disable"], "round_deltas_ms": rounds[q],
                        "spread_ms": max(rounds[q]) - min(rounds[q]), "wrapped_calls": wrapped[q],
                        "wrappers_off_ms": wrapped[q] * off_us / 1e3}
    return out


TRACE_EXPLAIN_ROWS = 10**6
_COST_LEG = re.compile(r"launches=(\d+) moved=\S+ ops=\S+ bw(~host)?=(\S+) padding=\S+ roofline(~host)?=(\S+)\)")


def trace_explain(seed: int, workdir: str) -> dict:
    """(e): EXPLAIN ANALYZE of a deferred CSV query with tracing on, then
    off, its filter on the masked fused leg (``FuseMode`` Fused, so that it
    launches).  On, a node whose launches ran shows its bandwidth and
    roofline fraction over their event time (``bw=``); off, over its host
    wall (``bw~host=``)."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import FuseMode, PlanMode

    rng = np.random.default_rng(seed + 1802)
    n = TRACE_EXPLAIN_ROWS
    path = os.path.join(workdir, "explain.csv")
    pandas.DataFrame({"a": rng.integers(-50, 50, n), "b": rng.random(n), "c": rng.random(n)}).to_csv(path, index=False)
    texts, legs = {}, {}
    with PlanMode.context("Auto"), FuseMode.context("Fused"):
        for mode in ("on", "off"):
            with _observed(mode == "on"):
                texts[mode] = tpd.read_csv(path).query("a > 0")[["b", "c"]]._query_compiler.explain(analyze=True)
            legs[mode] = [{"launches": int(m.group(1)), "clock": "host" if m.group(2) else "events",
                           "bw": m.group(3), "roofline": m.group(5)}
                          for m in _COST_LEG.finditer(texts[mode])]
    launched = [leg for leg in legs["on"] if leg["launches"]]
    if not launched or any(leg["clock"] != "events" or leg["bw"] == "?" for leg in launched):
        raise AssertionError(f"EXPLAIN ANALYZE with tracing on did not time its launches by events:\n{texts['on']}")
    if any(leg["clock"] != "host" for leg in legs["off"]):
        raise AssertionError(f"EXPLAIN ANALYZE with tracing off claimed an event clock:\n{texts['off']}")
    return {"rows": n, "on": legs["on"], "off": legs["off"], "text_on": texts["on"].splitlines()}


def trace_flight_record(seed: int, workdir: str) -> dict:
    """(d): tracing on, a breaker opened by injected losses at
    ``materialize``; the next call raises ``BreakerOpen``, and the flight
    recorder has written its ring to a temporary ``TraceDir``: the spans
    that led there and a meter snapshot."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import ResilienceBreakerCooldownS, ResilienceBreakerThreshold, TraceDir
    from modin_tpu_torch.core.execution import resilience
    from modin_tpu_torch.observability import flight_recorder, meters
    from modin_tpu_torch.testing import inject_faults

    rng = np.random.default_rng(seed + 1801)
    pdf = pandas.DataFrame({"a": rng.integers(0, 100, 10**5).astype(np.float64), "b": rng.integers(0, 100, 10**5)})
    tdir = os.path.join(workdir, "traces")
    threshold = 2
    raised = []
    flight_recorder.reset_for_tests()
    meters.reset()
    with _observed(True), TraceDir.context(tdir), ResilienceBreakerThreshold.context(threshold), \
            ResilienceBreakerCooldownS.context(30.0):
        old_interval, flight_recorder.MIN_DUMP_INTERVAL_S = flight_recorder.MIN_DUMP_INTERVAL_S, 0.0
        try:
            hdf = tpd.DataFrame(pdf)
            with inject_faults("device_lost", ops=("materialize",), times=None):
                for _ in range(threshold + 1):
                    try:
                        tpd.to_pandas(hdf.median())
                    except resilience.DeviceFailure as err:
                        raised.append(type(err).__name__)
                    else:
                        raised.append(None)
        finally:
            flight_recorder.MIN_DUMP_INTERVAL_S = old_interval
            resilience.reset_breakers()
    dumps = sorted(os.listdir(tdir)) if os.path.isdir(tdir) else []
    if raised != ["DeviceLost"] * threshold + ["BreakerOpen"]:
        raise AssertionError(f"the breaker did not open and raise: {raised}")
    opened = [d for d in dumps if "breaker_open" in d]
    if not opened:
        raise AssertionError(f"no flight record of the breaker opening: {dumps}")
    with open(os.path.join(tdir, opened[-1])) as f:
        record = json.load(f)
    names = {e["name"] for e in record["traceEvents"] if e.get("ph") == "X"}
    metrics = (record.get("otherData") or {}).get("metrics") or {}
    if not any(n.startswith("engine.materialize.attempt") for n in names) or not metrics.get("series"):
        raise AssertionError(f"the flight record lacks the spans or the meter snapshot: {sorted(names)[:20]}")
    return {"raised": raised, "dumps": dumps, "record_spans": record["otherData"]["spans"],
            "record_reason": record["otherData"]["reason"],
            "record_metric_series": len(metrics["series"]),
            "breaker_series": {k: v.get("total") for k, v in metrics["series"].items()
                               if k.startswith("resilience.breaker.reduce")}}


def phase_trace(rows: int, seed: int, workdir: str) -> dict:
    """Phase 18 (``trace``): (b) the peaks, (a) the profiled main path,
    (c) the cost of observing, (e) EXPLAIN ANALYZE's clocks, (d) the flight
    recorder.  Returns its
    launches and the phase's record."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc

    t_phase = time.perf_counter()
    tqc.DEFAULTS_TO_PANDAS = 0
    k0 = _wrapper_launches()
    record = {}
    t0 = time.perf_counter()
    record["peaks"] = trace_peaks()
    emit({"phase": "trace", "part": "peaks", **record["peaks"], "seconds": time.perf_counter() - t0})
    p1 = pandas.DataFrame(make_frame_data(rows, seed, ngroups=100))
    p2 = pandas.DataFrame(make_frame_data(rows, seed + 1, ngroups=100))
    t1, t2 = tpd.from_pandas(p1), tpd.from_pandas(p2)
    parts = [("profile", trace_profile, (t1, t2, p1, p2, workdir)), ("cost", trace_cost, (t1, t2)),
             ("explain", trace_explain, (seed, workdir))]
    for part, fn, fn_args in parts:
        t0 = time.perf_counter()
        record[part] = fn(*fn_args)
        record[part + "_seconds"] = time.perf_counter() - t0
        emit({"phase": "trace", "part": part, **record[part], "seconds": record[part + "_seconds"]})
    # the frames go before the losses: a re-seat re-uploads every live column
    del t1, t2, p1, p2, fn_args, parts
    free_device_memory()
    t0 = time.perf_counter()
    record["flight"] = trace_flight_record(seed, workdir)
    record["flight_seconds"] = time.perf_counter() - t0
    emit({"phase": "trace", "part": "flight", **record["flight"], "seconds": record["flight_seconds"]})
    if tqc.DEFAULTS_TO_PANDAS:
        raise AssertionError(f"{tqc.DEFAULTS_TO_PANDAS} trace-phase queries defaulted to pandas")
    launches = {k: v - k0[k] for k, v in _wrapper_launches().items()}
    record["launches"] = launches
    record["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "trace", "launches": launches, "seconds": record["seconds"]})
    return launches, record


# ---------------------------------------------------------------------- #
# 19. stream: out-of-core windows, the external sort and the merge-join
# ---------------------------------------------------------------------- #

# The phase's sizes were cut from 1e7 CSV rows under 256 MiB, a 4e7-row sort
# under 512 MiB and a 1e7 x 2e6 merge under 128 MiB (182.2 s of phase on an
# H100 host, pandas' sorts 60 s of it) to an eighth of the sort and half of
# the rest, each budget cut with its data so that every query still streams
#: (a)'s device budget: under the 5e6-row CSV's 154 MB (``i`` spans 2e9 so
#: that its text passes the budget), over one window
STREAM_BUDGET_BYTES = 128 << 20
#: (b)'s budget, under the 5e6-row sorted frame's 4 x 8 bytes a row
STREAM_SORT_BUDGET_BYTES = 64 << 20
#: (c)'s budget, under the two frames' 16 bytes a row
STREAM_MERGE_BUDGET_BYTES = 32 << 20
STREAM_KEYS = 1000
#: (d)'s CSV rows, its budget (under the 74 MB CSV), and the window whose
#: consume loses the device
STREAM_LOSS_ROWS = 2 * 10**6
STREAM_LOSS_BUDGET_BYTES = 32 << 20
STREAM_LOSS_WINDOW = 3
# the queries of (a) over the CSV's i (int64), f (float64, 20 % NaN) and k
STREAM_QUERIES = {
    "filtered_sum": lambda m: m[m["i"] > 0][["f", "i"]].sum(),
    "filtered_mean": lambda m: m[m["i"] > 0][["f", "i"]].mean(),
    "grouped_sum": lambda m: m[m["i"] > 0].groupby("k").sum(),
    "grouped_mean": lambda m: m[m["i"] > 0].groupby("k").mean(),
}
# each query's scale of rounding: sums of magnitudes, means of magnitudes
STREAM_SCALES = {
    "filtered_sum": lambda p: p[p["i"] > 0][["f", "i"]].abs().sum(),
    "filtered_mean": lambda p: p[p["i"] > 0][["f", "i"]].abs().mean(),
    "grouped_sum": lambda p: p[p["i"] > 0].abs().assign(k=p["k"]).groupby("k").sum(),
    "grouped_mean": lambda p: p[p["i"] > 0].abs().assign(k=p["k"]).groupby("k").mean(),
}


def stream_columns(rows: int, seed: int) -> dict:
    rng = np.random.default_rng(seed + 90)
    return {"i": rng.integers(-10**9, 10**9, rows),
            "f": np.where(rng.random(rows) < 0.2, np.nan, rng.standard_normal(rows)),
            "k": rng.integers(0, STREAM_KEYS, rows)}


def _stream_same(got, want, what: str, scale=None) -> None:
    """Labels, dtypes, ints and NaN positions exactly; floats exactly, or,
    where sums reorder across windows, to 1e-12 of ``scale`` (the sum or
    mean of the magnitudes, per column or group)."""
    import pandas

    if isinstance(want, pandas.Series):
        got, want = got.to_frame(), want.to_frame()
        scale = None if scale is None else scale.to_frame()
    if not got.index.equals(want.index) or list(got.columns) != list(want.columns):
        raise AssertionError(f"{what}: index or columns differ")
    for j, label in enumerate(want.columns):
        g, w = got.iloc[:, j], want.iloc[:, j]
        if g.dtype != w.dtype:
            raise AssertionError(f"{what}[{label}]: dtype {g.dtype} != {w.dtype}")
        if w.dtype.kind != "f" or scale is None:
            assert_same_values(g.to_numpy(), w.to_numpy(), f"{what}[{label}]", exact=True)
            continue
        gv, wv = g.to_numpy(np.float64), w.to_numpy(np.float64)
        if not np.array_equal(np.isnan(gv), np.isnan(wv)):
            raise AssertionError(f"{what}[{label}]: NaN positions differ")
        bound = FLOAT_RTOL * scale.iloc[:, j].to_numpy(np.float64)
        ok = np.isnan(wv) | (np.abs(gv - wv) <= bound)
        if not ok.all():
            raise AssertionError(f"{what}[{label}]: values beyond 1e-12 of their magnitudes")


def _stream_marks() -> dict:
    from modin_tpu_torch.core.execution import resilience
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.streaming import executor

    counts = {k: executor.COUNTS.get(k, 0) for k in ("stream.window.count", "stream.window.replay",
                                                     "stream.prefetch.overlap_s", "stream.prefetch.wait_s",
                                                     "stream.spill.run_bytes", "stream.degrade")}
    counts["fallbacks"] = resilience.fallback_count()
    counts["defaults"] = tqc.DEFAULTS_TO_PANDAS
    return counts


def _stream_delta(before: dict) -> dict:
    after = _stream_marks()
    return {k.replace("stream.", "").replace("prefetch.", "").replace(".", "_"): after[k] - before[k]
            for k in before}


def _streamed(fn, budget: int, what: str) -> tuple:
    """``fn()`` under ``budget`` (``StreamMode`` Auto): (result, wall ms, its
    stream counts, the device peak).  The peak leaves out what the device
    ledger did not hold when the query started (earlier phases' tensors the
    collector has not reached), so it is the ledger's residents, which the
    budget bounds, and the query's own working set."""
    import torch

    from modin_tpu_torch.config import DeviceMemoryBudget
    from modin_tpu_torch.core import memory

    with DeviceMemoryBudget.context(budget):
        # the ledger within the budget first: the resident reference run of
        # an earlier case restored the inputs with no budget
        memory.device_ledger.admit(0)
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        untracked = max(torch.cuda.memory_allocated() - memory.device_ledger.total_bytes(), 0)
        marks = _stream_marks()
        out, ms = host_ms(fn)
    counts = _stream_delta(marks)
    peak = torch.cuda.max_memory_allocated() - untracked
    if counts["window_count"] <= 0:
        raise AssertionError(f"{what}: the residency router kept it resident under {budget} bytes")
    if counts["fallbacks"] or counts["defaults"]:
        raise AssertionError(f"{what}: {counts['fallbacks']} fallbacks, {counts['defaults']} defaults to pandas")
    return out, ms, counts, peak


def _peak_bound(budget: int) -> int:
    """The budget plus one window's launch: by the window sizing a window's
    device working set is at most ``budget / (1 + prefetch)``."""
    from modin_tpu_torch.config import StreamPrefetch

    return budget + budget // (1 + int(StreamPrefetch.get()))


def stream_pipeline(rows: int, seed: int, workdir: str) -> dict:
    """(a): the window loop over a ``rows``-row CSV under
    ``STREAM_BUDGET_BYTES``, each query against the resident port (no
    budget) and pandas, in a ``query_stats`` scope whose launch ledger
    counts each kernel's launches."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.observability import compile_ledger, meters

    path = os.path.join(workdir, "stream.csv")
    t0 = time.perf_counter()
    write_csv(path, stream_columns(rows, seed))
    csv_s = time.perf_counter() - t0
    ledger = compile_ledger.get_compile_ledger()
    before = {k: v["launches"] for k, v in ledger.launch_snapshot().items()}
    queries = {}
    with meters.query_stats("stream") as stats:
        for name, query in STREAM_QUERIES.items():
            got, ms, counts, peak = _streamed(lambda: tpd.to_pandas(query(tpd.read_csv(path))),
                                              STREAM_BUDGET_BYTES, name)
            queries[name] = {"port_ms": ms, "peak_bytes": peak, **counts}
            if peak > _peak_bound(STREAM_BUDGET_BYTES):
                raise AssertionError(f"{name}: device peak {peak} past the budget plus one window")
            queries[name]["got"] = got
    launches = {k: v["launches"] - before.get(k, 0) for k, v in ledger.launch_snapshot().items()}
    for kernel in ("bincount", "groupagg", "fused"):
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"the streamed queries never launched {kernel}: {launches}")
    t0 = time.perf_counter()
    md = tpd.read_csv(path)
    md._query_compiler._modin_frame
    resident_read_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pdf = pandas.read_csv(path)
    pandas_read_ms = (time.perf_counter() - t0) * 1e3
    for name, query in STREAM_QUERIES.items():
        got = queries[name].pop("got")
        resident, ms = host_ms(lambda: tpd.to_pandas(query(md)))
        want, pandas_ms = host_ms(lambda: query(pdf))
        scale = STREAM_SCALES[name](pdf)
        _stream_same(got, resident, f"{name} (streamed vs resident)", scale)
        _stream_same(got, want, f"{name} (streamed vs pandas)", scale)
        queries[name].update(resident_ms=resident_read_ms + ms, pandas_ms=pandas_read_ms + pandas_ms)
    del md, pdf
    return {"rows": rows, "budget_bytes": STREAM_BUDGET_BYTES, "peak_bound_bytes": _peak_bound(STREAM_BUDGET_BYTES),
            "csv_bytes": os.path.getsize(path), "csv_s": csv_s, "queries": queries, "launches": launches,
            "stats": {k: stats.as_dict()[k] for k in ("stream_windows", "stream_replays", "stream_overlap_s",
                                                    "stream_wait_s", "bytes_parsed", "hbm_high_water")}}


def stream_sort(rows: int, seed: int) -> dict:
    """(b): ``sort_values`` of a ``rows``-row frame (an int64 key with ties,
    a float64 key with 5 % NaN, an int64 and a float64 payload) by each key
    in both directions under ``STREAM_SORT_BUDGET_BYTES``: the external
    sort against the resident port's (no budget) and pandas' stable sort,
    exactly."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import DeviceMemoryBudget, StreamMode

    rng = np.random.default_rng(seed + 91)
    kf = rng.integers(0, max(rows // 8, 1), rows).astype(np.float64) * 0.5
    kf[rng.random(rows) < 0.05] = np.nan
    pdf = pandas.DataFrame({"ki": rng.integers(0, max(rows // 16, 1), rows), "kf": kf,
                            "p": rng.integers(-10**9, 10**9, rows), "q": rng.standard_normal(rows)})
    with DeviceMemoryBudget.context(STREAM_SORT_BUDGET_BYTES):
        md = tpd.DataFrame(pdf)  # made under the budget, as a user's would be
    cases = {}
    for key in ("ki", "kf"):
        for ascending in (True, False):
            name = f"{key}_{'asc' if ascending else 'desc'}"
            got, ms, counts, peak = _streamed(lambda: tpd.to_pandas(md.sort_values(key, ascending=ascending)),
                                              STREAM_SORT_BUDGET_BYTES, name)
            if peak > _peak_bound(STREAM_SORT_BUDGET_BYTES):
                raise AssertionError(f"sort {name}: device peak {peak} past the budget plus one window")
            with StreamMode.context("Resident"):
                resident, resident_ms = host_ms(lambda: tpd.to_pandas(md.sort_values(key, ascending=ascending)))
            want, pandas_ms = host_ms(lambda: pdf.sort_values(key, ascending=ascending, kind="stable"))
            _stream_same(got, resident, f"sort {name} (external vs resident)")
            _stream_same(got, want, f"sort {name} (external vs pandas)")
            cases[name] = {"port_ms": ms, "resident_ms": resident_ms, "pandas_ms": pandas_ms, "peak_bytes": peak,
                           **counts}
            del got, resident, want
    del md, pdf
    return {"rows": rows, "budget_bytes": STREAM_SORT_BUDGET_BYTES,
            "peak_bound_bytes": _peak_bound(STREAM_SORT_BUDGET_BYTES), "cases": cases}


def stream_merge(left_rows: int, right_rows: int, seed: int) -> dict:
    """(c): an inner and a left ``merge`` of ``left_rows`` x ``right_rows``
    (int64 keys in twice the right side's range: ties and misses) under
    ``STREAM_MERGE_BUDGET_BYTES``, against the resident port's merge (no
    budget) and pandas', exactly."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import DeviceMemoryBudget, StreamMode

    rng = np.random.default_rng(seed + 92)
    left = pandas.DataFrame({"k": rng.integers(0, 2 * right_rows, left_rows),
                             "lv": rng.integers(0, 1000, left_rows)})
    right = pandas.DataFrame({"k": rng.integers(0, 2 * right_rows, right_rows),
                              "rv": rng.standard_normal(right_rows)})
    with DeviceMemoryBudget.context(STREAM_MERGE_BUDGET_BYTES):
        ml, mr = tpd.DataFrame(left), tpd.DataFrame(right)
    cases = {}
    for how in ("inner", "left"):
        got, ms, counts, peak = _streamed(lambda: tpd.to_pandas(ml.merge(mr, on="k", how=how)),
                                          STREAM_MERGE_BUDGET_BYTES, how)
        if peak > _peak_bound(STREAM_MERGE_BUDGET_BYTES):
            raise AssertionError(f"merge {how}: device peak {peak} past the budget plus one window")
        with StreamMode.context("Resident"):
            resident, resident_ms = host_ms(lambda: tpd.to_pandas(ml.merge(mr, on="k", how=how)))
        want, pandas_ms = host_ms(lambda: left.merge(right, on="k", how=how))
        _stream_same(got, resident, f"merge {how} (external vs resident)")
        _stream_same(got, want, f"merge {how} (external vs pandas)")
        cases[how] = {"port_ms": ms, "resident_ms": resident_ms, "pandas_ms": pandas_ms, "peak_bytes": peak,
                      "out_rows": len(got), "misses": int(got["rv"].isna().sum()), **counts}
        del got, resident, want
    del ml, mr
    return {"rows": [left_rows, right_rows], "budget_bytes": STREAM_MERGE_BUDGET_BYTES,
            "peak_bound_bytes": _peak_bound(STREAM_MERGE_BUDGET_BYTES), "cases": cases}


def stream_loss(seed: int, workdir: str) -> dict:
    """(d): a device loss injected into window ``STREAM_LOSS_WINDOW``'s
    consume of a ``STREAM_LOSS_ROWS``-row stream (the filtered grouped
    sum under ``STREAM_LOSS_BUDGET_BYTES``): six failed deploys in a row,
    past the seam's re-seat and the deploy's rebind, so it raises on the
    card, and the window loop replays that one window; the answer equals
    pandas'.  A clean run first finds the deploys each window makes."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import DeviceMemoryBudget, ResilienceBackoffS
    from modin_tpu_torch.core.execution import resilience
    from modin_tpu_torch.logging import metrics
    from modin_tpu_torch.testing.faults import midquery_device_loss

    path = os.path.join(workdir, "loss.csv")
    write_csv(path, stream_columns(STREAM_LOSS_ROWS, seed + 1))
    query = STREAM_QUERIES["grouped_sum"]
    pdf = pandas.read_csv(path)
    want = query(pdf)
    scale = STREAM_SCALES["grouped_sum"](pdf)
    boundaries = []
    probe = midquery_device_loss(after_deploys=10**12, times=1)

    def at_window_end(name, value):
        if name.endswith("stream.window.count"):
            boundaries.append(probe.calls)

    metrics.add_metric_handler(at_window_end)
    try:
        with probe, DeviceMemoryBudget.context(STREAM_LOSS_BUDGET_BYTES):
            clean = tpd.to_pandas(query(tpd.read_csv(path)))
    finally:
        metrics.clear_metric_handler(at_window_end)
    _stream_same(clean, want, "loss run, clean", scale)
    if len(boundaries) <= STREAM_LOSS_WINDOW + 1:
        raise AssertionError(f"the loss stream has {len(boundaries)} windows")
    marks = _stream_marks()
    with ResilienceBackoffS.context(0.0), \
            midquery_device_loss(after_deploys=boundaries[STREAM_LOSS_WINDOW - 1], times=6) as inj, \
            DeviceMemoryBudget.context(STREAM_LOSS_BUDGET_BYTES):
        got, ms = host_ms(lambda: tpd.to_pandas(query(tpd.read_csv(path))))
    counts = _stream_delta(marks)
    _stream_same(got, want, "loss run, injected", scale)
    breakers = resilience.breaker_snapshot()
    resilience.reset_breakers()  # the strikes were this case's own
    if inj.injected != 6 or counts["window_replay"] != 1:
        raise AssertionError(f"the injected loss: {inj.injected} failures, {counts['window_replay']} replays")
    if counts["fallbacks"] or counts["defaults"]:
        raise AssertionError(f"the injected loss: {counts['fallbacks']} fallbacks, {counts['defaults']} defaults")
    return {"rows": STREAM_LOSS_ROWS, "windows": len(boundaries), "deploys_by_window": boundaries,
            "loss_window": STREAM_LOSS_WINDOW, "injected": inj.injected, "port_ms": ms,
            "breakers_after": {k: v for k, v in breakers.items() if v != "closed"}, **counts}


def phase_stream(rows: int, sort_rows: int, seed: int, workdir: str) -> dict:
    """Out-of-core streaming on the card: (a) ``stream_pipeline``, (b)
    ``stream_sort``, (c) ``stream_merge`` at ``rows / 2`` x ``rows / 10``,
    (d) ``stream_loss``.  Nothing defaults to pandas.  Returns the
    launches."""
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc

    t_phase = time.perf_counter()
    tqc.DEFAULTS_TO_PANDAS = 0
    marks = _kernel_marks()
    seconds, parts = {}, {}
    for name, fn, fn_args in (("pipeline", stream_pipeline, (rows, seed, workdir)),
                              ("sort", stream_sort, (sort_rows, seed)),
                              ("merge", stream_merge, (rows // 2, rows // 10, seed)),
                              ("loss", stream_loss, (seed, workdir))):
        t0 = time.perf_counter()
        parts[name] = fn(*fn_args)
        seconds[name] = time.perf_counter() - t0
        free_device_memory()
    if tqc.DEFAULTS_TO_PANDAS:
        raise AssertionError(f"{tqc.DEFAULTS_TO_PANDAS} stream calls defaulted to pandas")
    launches = {k: v["launches"] for k, v in _kernel_since(marks).items()}
    emit({"phase": "stream", **parts, "launches": launches, "defaults_to_pandas": tqc.DEFAULTS_TO_PANDAS,
          "seconds_by_part": seconds, "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------- #
# 20. the row-shard mesh and the range shuffle
# ---------------------------------------------------------------------- #

MESH_SHARDS = 4
#: (c)'s right side: a fifth of the left's rows
MESH_RIGHT_SHARE = 5
MESH_APPLY_ROWS = 10**6
MESH_APPLY_KEYS = 1000
#: the int key's range against the rows (ties); the wide int column takes
#: a quarter as many values as rows, spaced past the histogram's bound (its
#: nunique and mode sort) with repeats (a mode set of a few values)
MESH_TIE_SHARE = 10
MESH_WIDE_STEP = 1 << 21
MESH_REDUCTIONS = {
    "median": lambda s: s.median(),
    "quantile": lambda s: s.quantile([0.1, 0.5, 0.9]),
    "nunique": lambda s: s.nunique(),
    "mode": lambda s: s.mode(),
}


def mesh_frame(rows: int, seed: int) -> dict:
    """(a)'s ten columns: an int64 key with ties, a float64 key with 5 % NaN
    and 0.1 % each of +inf and -inf, and eight payload columns (``w`` a wide
    int64, then float64 and int64 in turn)."""
    rng = np.random.default_rng(seed + 100)
    kf = rng.standard_normal(rows)
    kf[rng.random(rows) < 0.05] = np.nan
    kf[rng.random(rows) < 0.001] = np.inf
    kf[rng.random(rows) < 0.001] = -np.inf
    data = {"ki": rng.integers(0, max(rows // MESH_TIE_SHARE, 1), rows), "kf": kf,
            "w": rng.integers(0, max(rows // 4, 1), rows) * MESH_WIDE_STEP}
    for j in range(7):
        data[f"p{j}"] = rng.integers(-10**9, 10**9, rows) if j % 2 else rng.standard_normal(rows)
    return data


def _mesh_marks() -> dict:
    from modin_tpu_torch.core.execution import resilience
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc

    return {"defaults": tqc.DEFAULTS_TO_PANDAS, "fallbacks": resilience.fallback_count(),
            "skew_fallbacks": resilience.COUNTS.get("resilience.shuffle.skew_fallback", 0)}


def _mesh_run(fn, sharded: bool, prepare=None) -> dict:
    """``fn()`` (ended by a synchronise) under ``SpmdMode`` Sharded or
    Local, once to warm up (the kernels loaded, the allocator's blocks
    cached) and once timed: its result, wall ms, the device peak and,
    sharded, the shuffle's last stages and sizes and ``collective_bytes``;
    a sharded query that ran no shuffle, counted no collective bytes,
    defaulted to pandas or declined fails, and so does any fallback.
    ``prepare()``, where given, makes each run's ``fn`` (a frame of its
    own, so the timed run reads no artifact of the warm-up)."""
    import torch

    from modin_tpu_torch.config import SpmdMode
    from modin_tpu_torch.observability import meters
    from modin_tpu_torch.parallel import shuffle

    mode = "Sharded" if sharded else "Local"
    with SpmdMode.context(mode):
        (prepare() if prepare is not None else fn)()
    fn = prepare() if prepare is not None else fn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    marks = _mesh_marks()
    shuffle.LAST_RUN.clear()
    shuffle.LAST_STAGES_MS = {}
    shuffle.TIME_STAGES = sharded
    try:
        with SpmdMode.context(mode), meters.query_stats("mesh") as stats:
            out, ms = host_ms(fn)
    finally:
        shuffle.TIME_STAGES = False
    after = _mesh_marks()
    run = {"ms": ms, "peak_bytes": torch.cuda.max_memory_allocated() - base,
           **{k: after[k] - marks[k] for k in marks}, "collective_bytes": stats.collective_bytes}
    if sharded:
        last = dict(shuffle.LAST_RUN)
        if not last:
            raise AssertionError("a sharded query ran no shuffle")
        if stats.collective_bytes <= 0:
            raise AssertionError("a sharded query counted no collective bytes")
        stages = dict(shuffle.LAST_STAGES_MS)
        exchange_ms = stages.get("exchange") or float("nan")
        run.update(shards=last["shards"], rows_per_shard=last["counts"], capacity=last["capacity"],
                   slack_retries=last["slack_retries"], exchange_bytes=last["exchange_bytes"], stages_ms=stages,
                   # read and written once, PR 17's copy-rate convention
                   exchange_gb_s=2 * last["exchange_bytes"] / exchange_ms / 1e6)
    if run["fallbacks"] or run["skew_fallbacks"] or (sharded and run["defaults"]):
        raise AssertionError(f"a {'sharded' if sharded else 'local'} query fell back or declined: {run}")
    return {"out": out, **run}


def _same_device_frames(a, b, what: str) -> None:
    """Two port results bit for bit: every column's bytes and the index."""
    import torch

    fa, fb = a._query_compiler._modin_frame, b._query_compiler._modin_frame
    if list(fa.columns) != list(fb.columns) or len(fa) != len(fb):
        raise AssertionError(f"{what}: shapes or labels differ")
    for label, ca, cb in zip(fa.columns, fa._columns, fb._columns):
        if ca.pandas_dtype != cb.pandas_dtype:
            raise AssertionError(f"{what}[{label}]: dtypes differ")
        if ca.is_device:
            ta, tb = ca.data.contiguous(), cb.data.contiguous()
            if ta.dtype != tb.dtype or not torch.equal(ta.view(torch.uint8), tb.view(torch.uint8)):
                raise AssertionError(f"{what}[{label}]: bytes differ")
        elif not np.array_equal(ca.to_numpy(), cb.to_numpy()):
            raise AssertionError(f"{what}[{label}]: host values differ")
    if not fa.index.equals(fb.index):
        raise AssertionError(f"{what}: index differs")


def _mesh_record(sharded: dict, local: dict, pandas_ms: float) -> dict:
    return {"port_ms": sharded["ms"], "local_ms": local["ms"], "pandas_ms": pandas_ms,
            "sharded_over_local": sharded["ms"] / local["ms"],
            **{k: v for k, v in sharded.items() if k not in ("out", "ms")},
            "local_peak_bytes": local["peak_bytes"], "local_defaults": local["defaults"]}


def mesh_calibration(rows: int) -> dict:
    """(e): the table measured on this mesh and the Auto verdicts of the
    phase's own queries with their predicted costs."""
    from modin_tpu_torch.config import SpmdMode
    from modin_tpu_torch.ops import router

    t0 = time.perf_counter()
    table = router.get_calibration()
    if table is None or "device_shuffle_s" not in table:
        raise AssertionError(f"no sharded calibration on this mesh: {router.CALIBRATION_ERROR}")
    seconds = time.perf_counter() - t0
    verdicts = {}
    with SpmdMode.context("Auto"):
        for name, op, n, payload in (("sort", "sort", rows, 10), ("rep_build", "sort", rows, 0),
                                     ("merge", "merge", rows // MESH_RIGHT_SHARE, 1),
                                     ("apply", "apply", MESH_APPLY_ROWS, 1)):
            verdicts[name] = router.layout_verdict(op, n, payload_cols=payload)
    return {"seconds": seconds, "verdicts": verdicts,
            "entries": {k: v for k, v in table.items()
                        if k.startswith(("device_sort", "device_shuffle", "collective", "mesh", "rows"))}}


def mesh_sorts(rows: int, seed: int) -> dict:
    """(a): the ten-column frame by each key in each direction."""
    import pandas

    import modin_tpu_torch.pandas as tpd

    data = mesh_frame(rows, seed)
    pdf = pandas.DataFrame(data)
    md = tpd.DataFrame(data)
    cases = {}
    for key in ("ki", "kf"):
        for ascending in (True, False):
            name = f"{key}_{'asc' if ascending else 'desc'}"
            sharded = _mesh_run(lambda: md.sort_values(key, ascending=ascending), True)
            local = _mesh_run(lambda: md.sort_values(key, ascending=ascending), False)
            _same_device_frames(sharded["out"], local["out"], f"sort {name} (sharded vs local)")
            want, pandas_ms = host_ms(lambda: pdf.sort_values(key, ascending=ascending, kind="stable"))
            assert_same_pandas(tpd.to_pandas(sharded["out"]), want, f"sort {name} (sharded vs pandas)", exact=True)
            cases[name] = _mesh_record(sharded, local, pandas_ms)
            del sharded, local, want
    del md, pdf
    return cases


def mesh_reductions(rows: int, seed: int) -> dict:
    """(b): the sort-shaped reductions of the float key and the wide int
    column; each side on a frame of its own, so neither reads the other's
    sorted representation or cached result.  ``KernelRouterMode`` Device:
    the layout leg is what is measured here."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import KernelRouterMode

    data = mesh_frame(rows, seed)
    cols = {"kf": data["kf"], "w": data["w"]}
    pdf = pandas.DataFrame(cols)
    cases = {}

    def reduce(col: str, call, sharded: bool) -> dict:
        def prepare():
            # a frame of its own: the reduction builds its representation
            md = tpd.DataFrame({col: cols[col]})
            return lambda: call(md[col])

        out = _mesh_run(None, sharded, prepare)
        if hasattr(out["out"], "_query_compiler"):
            out["out"] = tpd.to_pandas(out["out"])
        return out

    with KernelRouterMode.context("Device"):
        for col in cols:
            for op, call in MESH_REDUCTIONS.items():
                got, local = reduce(col, call, True), reduce(col, call, False)
                want, pandas_ms = host_ms(lambda: call(pdf[col]))
                for other, what in ((local["out"], "local"), (want, "pandas")):
                    if isinstance(want, pandas.Series):
                        assert_same_pandas(got["out"], other, f"{op}({col}) (sharded vs {what})", exact=True)
                    elif not (got["out"] == other or (np.isnan(got["out"]) and np.isnan(other))):
                        raise AssertionError(f"{op}({col}): {got['out']} != {other} ({what})")
                cases[f"{op}_{col}"] = _mesh_record(got, local, pandas_ms)
    return cases


def mesh_merges(rows: int, seed: int) -> dict:
    """(c): inner, left and outer merges; left keys over twice the right's
    unique keys' range (misses), the right keys shuffled."""
    import pandas

    import modin_tpu_torch.pandas as tpd

    rng = np.random.default_rng(seed + 101)
    right_rows = max(rows // MESH_RIGHT_SHARE, 1)
    left = {"k": rng.integers(0, 2 * right_rows, rows), "a": rng.integers(0, 1000, rows)}
    right = {"k": rng.permutation(right_rows) * 2, "b": rng.standard_normal(right_rows)}
    pl, pr = pandas.DataFrame(left), pandas.DataFrame(right)
    ml, mr = tpd.DataFrame(left), tpd.DataFrame(right)
    cases = {}
    for how in ("inner", "left", "outer"):
        sharded = _mesh_run(lambda: ml.merge(mr, on="k", how=how), True)
        local = _mesh_run(lambda: ml.merge(mr, on="k", how=how), False)
        _same_device_frames(sharded["out"], local["out"], f"merge {how} (sharded vs local)")
        want, pandas_ms = host_ms(lambda: pl.merge(pr, on="k", how=how))
        got = tpd.to_pandas(sharded["out"])
        assert_same_pandas(got, want, f"merge {how} (sharded vs pandas)", exact=True)
        cases[how] = {**_mesh_record(sharded, local, pandas_ms), "out_rows": len(got),
                      "misses": int(got["b"].isna().sum())}
        del sharded, local, want, got
    return cases


def _mesh_udf(g):
    return g["a"].max() - g["b"].mean()


def mesh_apply(seed: int) -> dict:
    """(d): ``groupby(k).apply(udf)`` through the shuffle; its local side is
    the default one-shard mesh, where pandas answers (counted)."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch.config import MeshShape

    rng = np.random.default_rng(seed + 102)
    data = {"k": rng.integers(0, MESH_APPLY_KEYS, MESH_APPLY_ROWS), "a": rng.standard_normal(MESH_APPLY_ROWS),
            "b": rng.integers(0, 100, MESH_APPLY_ROWS)}
    pdf, md = pandas.DataFrame(data), tpd.DataFrame(data)
    sharded = _mesh_run(lambda: tpd.to_pandas(md.groupby("k").apply(_mesh_udf)), True)
    with MeshShape.context((1, 1)):
        one = _mesh_run(lambda: tpd.to_pandas(md.groupby("k").apply(_mesh_udf)), False)
    if one["defaults"] != 1:
        raise AssertionError(f"the one-shard apply did not default to pandas once: {one['defaults']}")
    want, pandas_ms = host_ms(lambda: pdf.groupby("k").apply(_mesh_udf))
    assert_same_pandas(sharded["out"], one["out"], "apply (sharded vs one shard)", exact=True)
    assert_same_pandas(sharded["out"], want, "apply (sharded vs pandas)", exact=True)
    return {"rows": MESH_APPLY_ROWS, "keys": MESH_APPLY_KEYS, **_mesh_record(sharded, one, pandas_ms)}


def phase_mesh(rows: int, seed: int) -> dict:
    """The row-shard mesh on the card: (e) ``mesh_calibration``, (a)
    ``mesh_sorts``, (b) ``mesh_reductions``, (c) ``mesh_merges``, (d)
    ``mesh_apply``, under ``MeshShape`` (``MESH_SHARDS``, 1); the mesh comes
    back to its default after.  Returns the launches."""
    import torch

    from modin_tpu_torch.config import MeshShape
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    placement = ("the four shards share cuda:0 (one card)" if cards < 2
                 else f"the four shards on {min(cards, MESH_SHARDS)} cards")
    emit({"phase": "mesh", "note": placement})
    defaults0 = tqc.DEFAULTS_TO_PANDAS
    marks = _kernel_marks()
    seconds, parts = {}, {}
    with MeshShape.context((MESH_SHARDS, 1)):
        devices = [str(d) for d in mesh.shard_devices()]
        for name, fn, fn_args in (("calibration", mesh_calibration, (rows,)),
                                  ("sort", mesh_sorts, (rows, seed)),
                                  ("reductions", mesh_reductions, (rows, seed)),
                                  ("merge", mesh_merges, (rows, seed)),
                                  ("apply", mesh_apply, (seed,))):
            t0 = time.perf_counter()
            parts[name] = fn(*fn_args)
            seconds[name] = time.perf_counter() - t0
            free_device_memory()
    if mesh.num_row_shards() != max(cards, 1):
        raise AssertionError("the mesh did not come back to its default")
    launches = {k: v["launches"] for k, v in _kernel_since(marks).items()}
    if launches["bincount"] <= 0:
        raise AssertionError("the shuffles never launched bincount")
    # the defaults expected: (d)'s one-shard side, warm-up and timed run
    defaults = tqc.DEFAULTS_TO_PANDAS - defaults0
    if defaults != 2:
        raise AssertionError(f"{defaults} mesh calls defaulted to pandas (the one-shard apply's 2 expected)")
    rates = {}
    for part in ("sort", "reductions", "merge", "apply"):
        records = [parts[part]] if part == "apply" else list(parts[part].values())
        got = [r["exchange_gb_s"] for r in records]
        rates[part] = {"min": min(got), "max": max(got)}
    emit({"phase": "mesh", "rows": rows, "shards": MESH_SHARDS, "devices": devices, **parts,
          "exchange_gb_s_by_part": rates, "launches": launches, "defaults_to_pandas_sharded": 0,
          "seconds_by_part": seconds, "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------- #
# 21. serving: concurrent queries from threads on one card
# ---------------------------------------------------------------------- #

SERVE_KEYS = 100
#: the tenants' weights 2 : 1 : 1, scaled by 64 as the JAX package's bench
#: scales its own: a bucket refills weight x ServingMaxConcurrent queries a
#: second, so at 2, 1, 1 bob would get one query a second at MaxConcurrent
#: 1 and the limiter, which the CPU tests cover, would be all the phase
#: measured
SERVE_WEIGHTS = "alice=128,bob=64,carol=64"
SERVE_TENANTS = ("alice", "bob", "carol")
SERVE_THREADS = 8
SERVE_QUERIES_TOTAL = 200
SERVE_CONCURRENCY = (1, 2, 4, 8)
#: (a)'s traced level: queries at MaxConcurrent 8 with tracing on
SERVE_TRACED_QUERIES = 48
#: (b): a burst of this many submits at MaxConcurrent 1 and QueueDepth 2
SERVE_BURST = 16
#: (c): the queued query's deadline; the mid-query deadline is a share of
#: its query's measured wall
SERVE_QUEUE_DEADLINE_MS = 50.0
SERVE_MID_SHARE = 0.3
SERVE_MID_STEPS = 10
#: (c) under load: deadline queries run one after another while the other
#: threads keep MaxConcurrent 8 saturated
SERVE_CONTENDED_QUERIES = 16
#: (d): the queries of a round, and the past-budget round's budget as a
#: share of the residency
SERVE_HEADROOM_QUERIES = 2 * SERVE_THREADS
SERVE_PAST_BUDGET_SHARE = 0.9
#: (f): calls of each side a round, rounds in the order off, on, on, off
SERVE_COST_CALLS = 40
#: (f): ``with lock: pass`` a timing, best of the repeats
SERVE_LOCK_ACQUIRES = 200_000
SERVE_LOCK_REPEATS = 5
#: (f) with ``--parent-checkout``: the hot path's frame, queries a round,
#: rounds a process and the sides' processes in order (twice parent,
#: this, this, parent, the second time mirrored)
SERVE_HOT_ROWS = 4096
SERVE_HOT_QUERIES = 500
SERVE_HOT_ROUNDS = 5
SERVE_HOT_ORDER = ("parent", "change", "change", "parent", "change", "parent", "parent", "change")


def serve_frame(rows: int, seed: int) -> dict:
    """``make_frame``-style columns: float64 ``a``, ``b``, ``c``, int64 ``i``
    and a key ``k`` of ``SERVE_KEYS`` values."""
    rng = np.random.default_rng(seed + 210)
    return {"a": rng.standard_normal(rows), "b": rng.standard_normal(rows), "c": rng.standard_normal(rows),
            "i": rng.integers(-1000, 1000, rows), "k": rng.integers(0, SERVE_KEYS, rows)}


def _host(x):
    """A query's result on the host: pandas objects, Python floats."""
    from modin_tpu_torch.pandas.utils import to_pandas

    return to_pandas(x) if hasattr(x, "_query_compiler") else x


#: the served mix: (query on a frame -> host result, pandas reference,
#: the scale of its rounding or None for an exact result, the kernel on its path)
SERVE_QUERIES = {
    "chain_sum": (lambda d: float((d["a"] * d["b"] + d["c"]).sum()),
                  lambda p: float((p["a"] * p["b"] + p["c"]).sum()),
                  lambda p: float((p["a"] * p["b"]).abs().sum() + p["c"].abs().sum()), "fused"),
    "filtered_mean": (lambda d: float(d[d["a"] > 0]["b"].mean()),
                      lambda p: float(p[p["a"] > 0]["b"].mean()),
                      lambda p: float(p[p["a"] > 0]["b"].abs().mean()), "fused"),
    "group_sum": (lambda d: _host(d.groupby("k").sum()), lambda p: p.groupby("k").sum(),
                  lambda p: p.abs().assign(k=p["k"]).groupby("k").sum(), "groupagg"),
    "group_mean": (lambda d: _host(d.groupby("k").mean()), lambda p: p.groupby("k").mean(),
                   lambda p: p.abs().assign(k=p["k"]).groupby("k").mean(), "groupagg"),
    # grouped by ``k % SERVE_KEYS`` (equal to ``k``, computed anew each
    # query): ``ops/groupby.py``'s factorization cache keeps a key
    # tensor's codes and sizes, so a repeated ``groupby("k").size()`` on
    # one frame would launch bincount only once
    "group_size": (lambda d: _host(d.groupby(d["k"] % SERVE_KEYS).size()),
                   lambda p: p.groupby(p["k"] % SERVE_KEYS).size(), None, "bincount"),
    "sort_head": (lambda d: _host(d.sort_values("a").head(10)), lambda p: p.sort_values("a").head(10), None, None),
}


def _bitwise_same(got, want, what: str) -> None:
    """The same bits: floats by their bit patterns, frames column by column
    with labels and dtypes."""
    import pandas

    if isinstance(want, float):
        if np.float64(got).view(np.int64) != np.float64(want).view(np.int64):
            raise AssertionError(f"{what}: {got!r} != {want!r} bit for bit")
        return
    if isinstance(want, pandas.Series):
        got, want = got.to_frame(), want.to_frame()
    if not got.index.equals(want.index) or list(got.columns) != list(want.columns):
        raise AssertionError(f"{what}: index or columns differ")
    for j, label in enumerate(want.columns):
        g, w = got.iloc[:, j].to_numpy(), want.iloc[:, j].to_numpy()
        if g.dtype != w.dtype or g.tobytes() != w.tobytes():
            raise AssertionError(f"{what}[{label}]: not bit for bit the serial result")


def _serve_same(got, want, scale, what: str) -> None:
    """Against pandas: exact, or floats to 1e-12 of the magnitudes summed."""
    if isinstance(want, float):
        if abs(got - want) > FLOAT_RTOL * scale:
            raise AssertionError(f"{what}: {got!r} against pandas' {want!r}, past 1e-12 of {scale!r}")
        return
    _stream_same(got, want, what, scale)


def _percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _serve_marks() -> dict:
    from modin_tpu_torch.core.execution import resilience
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc

    return {"defaults": tqc.DEFAULTS_TO_PANDAS, "fallbacks": resilience.fallback_count()}


class _TimedDispatchLock:
    """Stands in for ``serving.context.dispatch_lock`` during (a): the same
    lock, plus the seconds threads waited for it and held it (outermost
    acquisitions; it is reentrant)."""

    def __init__(self, inner):
        import threading

        self.inner = inner
        self._tls = threading.local()
        self._sum = threading.Lock()
        self.wait_s = self.hold_s = 0.0
        self.acquires = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        depth = getattr(self._tls, "depth", 0)
        t0 = time.perf_counter()
        if not self.inner.acquire(blocking, timeout):
            with self._sum:
                self.wait_s += time.perf_counter() - t0
            return False
        if depth == 0:
            self._tls.t1 = t1 = time.perf_counter()
            with self._sum:
                self.wait_s += t1 - t0
                self.acquires += 1
        self._tls.depth = depth + 1
        return True

    def release(self) -> None:
        self._tls.depth -= 1
        if self._tls.depth == 0:
            with self._sum:
                self.hold_s += time.perf_counter() - self._tls.t1
        self.inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc_info):
        self.release()
        return False


class _GcPauses:
    """The interpreter's garbage-collection pauses while it is entered
    (``gc.callbacks``): every thread stops for one."""

    def __enter__(self):
        self.count, self.total_s, self.max_s, self._t0 = 0, 0.0, 0.0, None
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            pause = time.perf_counter() - self._t0
            self.count += 1
            self.total_s += pause
            self.max_s = max(self.max_s, pause)

    def __exit__(self, *exc_info):
        gc.callbacks.remove(self._note)
        return False


def _serve_counts() -> dict:
    """The resilience and memory tallies (OOM legs, spills, restores)."""
    from modin_tpu_torch.core import memory
    from modin_tpu_torch.core.execution import resilience

    return {**dict(resilience.COUNTS), **dict(memory.COUNTS)}


def _serve_threads(jobs, threads: int) -> list:
    """Run ``jobs`` (callables) on ``threads`` worker threads, in order of
    the list; returns each job's (result or exception, submit wall s)."""
    import threading

    out = [None] * len(jobs)
    next_job = [0]
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next_job[0]
                next_job[0] += 1
            if i >= len(jobs):
                return
            t0 = time.perf_counter()
            try:
                got = jobs[i]()
            except Exception as err:  # noqa: BLE001 - the caller checks each outcome
                got = err
            out[i] = (got, time.perf_counter() - t0)

    pool = [threading.Thread(target=worker, name=f"serve-{t}", daemon=True) for t in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=600)
    if any(t.is_alive() for t in pool):
        raise AssertionError("a serving thread hung")
    return out


def serve_mixed(df, serial: dict, seed: int) -> dict:
    """(a): ``SERVE_QUERIES_TOTAL`` queries of the mix from
    ``SERVE_THREADS`` threads by three weighted tenants, at each
    ``ServingMaxConcurrent`` of ``SERVE_CONCURRENCY``; every result bit for
    bit the query's serial run (which was held to pandas).  The dispatch
    lock is timed (``_TimedDispatchLock``) to show how much of the level ran
    serialized under it.  Returns each
    level's rates, walls and launches."""
    import torch

    from modin_tpu_torch import serving
    from modin_tpu_torch.config import ServingMaxConcurrent, ServingQueueDepth
    from modin_tpu_torch.serving import context as serving_context
    from modin_tpu_torch.serving.gate import gate

    rng = np.random.default_rng(seed + 211)
    names = list(SERVE_QUERIES)
    plan = [(names[j], SERVE_TENANTS[t]) for j, t in zip(rng.integers(0, len(names), SERVE_QUERIES_TOTAL),
                                                           rng.integers(0, len(SERVE_TENANTS), SERVE_QUERIES_TOTAL))]
    levels = {}
    for level in SERVE_CONCURRENCY:
        ServingMaxConcurrent.put(level)
        ServingQueueDepth.put(SERVE_QUERIES_TOTAL)
        gate.reset_for_tests()
        exec_s = [0.0] * len(plan)

        def job(i, name, tenant):
            fn = SERVE_QUERIES[name][0]

            def run():
                t0 = time.perf_counter()
                try:
                    return fn(df)
                finally:
                    exec_s[i] = time.perf_counter() - t0
            return lambda: serving.submit(run, tenant=tenant, label=name)

        marks, k0, counts0 = _serve_marks(), _kernel_marks(), _serve_counts()
        timed = _TimedDispatchLock(serving_context.dispatch_lock)
        serving_context.dispatch_lock = timed
        try:
            torch.cuda.synchronize()
            allocated0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _GcPauses() as pauses:
                outcomes = _serve_threads([job(i, n, t) for i, (n, t) in enumerate(plan)], SERVE_THREADS)
            elapsed = time.perf_counter() - t0
        finally:
            serving_context.dispatch_lock = timed.inner
        counts = {k: v - counts0.get(k, 0) for k, v in _serve_counts().items() if v != counts0.get(k, 0)}
        launches = {k: v["launches"] for k, v in _kernel_since(k0).items()}
        after = _serve_marks()
        for (name, tenant), (got, _wall) in zip(plan, outcomes):
            if isinstance(got, BaseException):
                raise AssertionError(f"(a) {name} for {tenant} at MaxConcurrent {level}: {got!r}") from got
            _bitwise_same(got, serial[name], f"(a) {name} at MaxConcurrent {level}")
        if after != marks:
            raise AssertionError(f"(a) at MaxConcurrent {level}: defaults or fallbacks {marks} -> {after}")
        snap = gate.snapshot()
        if snap["shed"] or snap["completed"] != len(plan):
            raise AssertionError(f"(a) at MaxConcurrent {level}: {snap}")
        walls = [w for _got, w in outcomes]
        levels[str(level)] = {
            "queries": len(plan), "seconds": elapsed, "queries_per_s": len(plan) / elapsed,
            "p50_ms": _percentile(walls, 50) * 1e3, "p99_ms": _percentile(walls, 99) * 1e3,
            "exec_p50_ms": _percentile(exec_s, 50) * 1e3, "exec_p99_ms": _percentile(exec_s, 99) * 1e3,
            # queries executing at once, on average: their execution
            # seconds (inside the gate) over the level's elapsed seconds
            "mean_executing": sum(exec_s) / elapsed,
            # the dispatch lock: the share of the level's wall it was held
            # (the device paths' serialized part) and the mean wait for it
            "dispatch_held_share": timed.hold_s / elapsed, "dispatch_acquires": timed.acquires,
            "dispatch_wait_ms_mean": timed.wait_s / max(timed.acquires, 1) * 1e3,
            "ever_queued": snap["ever_queued"], "launches": launches,
            # what a slow tail is made of: the slowest query, the device
            # memory the level started with and its peak, the OOM and spill
            # tallies it moved, and the interpreter's GC pauses
            "slowest": {"query": plan[int(np.argmax(exec_s))][0], "exec_ms": max(exec_s) * 1e3},
            "device_allocated_start_bytes": allocated0, "device_peak_bytes": torch.cuda.max_memory_allocated(),
            "counts": counts, "gc": {"collections": pauses.count, "pause_s": pauses.total_s, "max_s": pauses.max_s},
        }
    for kernel in ("fused", "groupagg", "bincount"):
        if not all(lv["launches"][kernel] > 0 for lv in levels.values()):
            raise AssertionError(f"(a) the served queries never launched {kernel}: {levels}")
    mix = {name: sum(1 for n, _t in plan if n == name) for name in names}
    tenants = {t: sum(1 for _n, x in plan if x == t) for t in SERVE_TENANTS}
    return {"mix": mix, "tenants": tenants, "by_max_concurrent": levels, "defaults_to_pandas": 0}


def serve_traced(df, serial: dict, seed: int) -> dict:
    """(a), traced: ``SERVE_TRACED_QUERIES`` of the mix at MaxConcurrent 8
    with ``TraceEnabled`` on, so every kernel launch of the eight threads
    records a CUDA event pair in the launch ledger: the ledger's launches
    equal the wrappers' counts, each of them resolves to a device time, and
    every result is still bit for bit its serial run."""
    from modin_tpu_torch import serving
    from modin_tpu_torch.config import ServingMaxConcurrent, ServingQueueDepth, TraceEnabled
    from modin_tpu_torch.observability import compile_ledger
    from modin_tpu_torch.serving.gate import gate

    rng = np.random.default_rng(seed + 212)
    names = list(SERVE_QUERIES)
    plan = [names[j] for j in rng.integers(0, len(names), SERVE_TRACED_QUERIES)]
    ServingMaxConcurrent.put(SERVE_THREADS)
    ServingQueueDepth.put(SERVE_TRACED_QUERIES)
    gate.reset_for_tests()
    ledger = compile_ledger.get_compile_ledger()
    fields = ("launches", "timed", "device_ms")
    with TraceEnabled.context(True):
        before = {k: {f: v[f] for f in fields} for k, v in ledger.launch_snapshot().items()}
        k0 = _kernel_marks()
        t0 = time.perf_counter()
        outcomes = _serve_threads([lambda n=n, i=i: serving.submit(SERVE_QUERIES[n][0], df,
                                                                  tenant=SERVE_TENANTS[i % 3], label=n)
                                   for i, n in enumerate(plan)], SERVE_THREADS)
        elapsed = time.perf_counter() - t0
        wrappers = {k: v["launches"] for k, v in _kernel_since(k0).items()}
        after = ledger.launch_snapshot()
    for name, (got, _wall) in zip(plan, outcomes):
        if isinstance(got, BaseException):
            raise AssertionError(f"(a) traced {name}: {got!r}") from got
        _bitwise_same(got, serial[name], f"(a) traced {name}")
    kernels = {}
    for kernel, launched in wrappers.items():
        zero = {f: 0 for f in fields}
        delta = {f: after.get(kernel, zero)[f] - before.get(kernel, zero)[f] for f in fields}
        if delta["launches"] != launched or launched <= 0 or delta["timed"] != launched:
            raise AssertionError(f"(a) traced {kernel}: the ledger {delta}, the wrapper {launched} launches")
        kernels[kernel] = delta
    return {"queries": len(plan), "queries_per_s": len(plan) / elapsed, "kernels": kernels}


def serve_sheds(df) -> dict:
    """(b): a burst of ``SERVE_BURST`` submits at MaxConcurrent 1 and
    QueueDepth 2; each admitted query waits for a go signal that comes once
    every submit is running, queued or shed, so the counts are exact: one
    running, two queued, the rest typed ``queue_full`` sheds."""
    import threading

    from modin_tpu_torch import serving
    from modin_tpu_torch.config import ServingMaxConcurrent, ServingQueueDepth
    from modin_tpu_torch.serving.gate import gate

    ServingMaxConcurrent.put(1)
    ServingQueueDepth.put(2)
    gate.reset_for_tests()
    go = threading.Event()
    fn = SERVE_QUERIES["group_sum"][0]

    def query():
        if not go.wait(timeout=60):
            raise AssertionError("(b) no go signal")
        return fn(df)

    jobs = [lambda t=t: serving.submit(query, tenant=SERVE_TENANTS[t % 3], label="burst") for t in range(SERVE_BURST)]
    out = []
    runner = threading.Thread(target=lambda: out.extend(_serve_threads(jobs, SERVE_BURST)), daemon=True)
    runner.start()
    deadline = time.monotonic() + 30
    expected_shed = SERVE_BURST - 3
    while time.monotonic() < deadline:
        snap = gate.snapshot()
        if snap["running"] == 1 and snap["queued"] == 2 and snap["shed"] == expected_shed:
            break
        time.sleep(0.005)
    at_burst = gate.snapshot()
    go.set()
    runner.join(timeout=120)
    rejected = [g for g, _w in out if isinstance(g, serving.QueryRejected)]
    done = [g for g, _w in out if not isinstance(g, BaseException)]
    other = [g for g, _w in out if isinstance(g, BaseException) and not isinstance(g, serving.QueryRejected)]
    snap = serving.serving_snapshot()
    tenant_sheds = sum(t["shed"] for t in snap["tenants"].values())
    if other or len(rejected) != expected_shed or len(done) != 3:
        raise AssertionError(f"(b) {len(done)} done, {len(rejected)} shed, other {other!r}")
    if {r.reason for r in rejected} != {"queue_full"} or not all(r.retry_after_s > 0 for r in rejected):
        raise AssertionError("(b) the sheds are not typed queue_full with a retry hint")
    if (snap["shed"], tenant_sheds, snap["completed"]) != (expected_shed, expected_shed, 3):
        raise AssertionError(f"(b) the snapshot disagrees with the sheds: {snap}")
    return {"burst": SERVE_BURST, "at_burst": {k: at_burst[k] for k in ("running", "queued", "shed")},
            "shed": len(rejected), "completed": len(done), "snapshot_shed": snap["shed"],
            "tenant_sheds": tenant_sheds, "retry_after_ms": sorted(r.retry_after_s * 1e3 for r in rejected)[:3]}


def serve_deadlines(df, serial: dict) -> dict:
    """(c): a deadline that expires while the query is queued behind a held
    slot, and one that expires mid-query (a chain of ``SERVE_MID_STEPS``
    fused reductions under a deadline of ``SERVE_MID_SHARE`` of its measured
    wall): both raise ``DeadlineExceeded``; each one's overshoot past its
    deadline in ms."""
    import threading

    from modin_tpu_torch import serving
    from modin_tpu_torch.config import ServingMaxConcurrent, ServingQueueDepth

    ServingMaxConcurrent.put(1)
    ServingQueueDepth.put(4)
    release, started = threading.Event(), threading.Event()

    def holder():
        started.set()
        release.wait(timeout=60)
        return SERVE_QUERIES["chain_sum"][0](df)

    held = threading.Thread(target=lambda: serving.submit(holder, tenant="alice"), daemon=True)
    held.start()
    started.wait(timeout=60)
    t0 = time.perf_counter()
    try:
        serving.submit(SERVE_QUERIES["chain_sum"][0], df, tenant="bob", deadline_ms=SERVE_QUEUE_DEADLINE_MS)
        raise AssertionError("(c) the queued query outlived its deadline")
    except serving.DeadlineExceeded as err:
        queued = {"where": err.where, "deadline_ms": SERVE_QUEUE_DEADLINE_MS,
                  "overshoot_ms": (time.perf_counter() - t0) * 1e3 - SERVE_QUEUE_DEADLINE_MS}
    release.set()
    held.join(timeout=60)

    def steps(d):
        return [float((d["a"] * d["b"] + d["c"] * step).sum()) for step in range(SERVE_MID_STEPS)]

    steps(df)  # the programs lowered and cached, so the timed run is the served one's
    _, alone_ms = host_ms(lambda: steps(df))
    deadline_ms = max(alone_ms * SERVE_MID_SHARE, 1.0)
    t0 = time.perf_counter()
    try:
        serving.submit(steps, df, tenant="carol", deadline_ms=deadline_ms)
        raise AssertionError(f"(c) the query ran to its end past a {deadline_ms:.3f} ms deadline")
    except serving.DeadlineExceeded as err:
        wall_ms = (time.perf_counter() - t0) * 1e3
        mid = {"where": err.where, "deadline_ms": deadline_ms, "alone_ms": alone_ms, "wall_ms": wall_ms,
               "overshoot_ms": wall_ms - deadline_ms, "step_ms": alone_ms / SERVE_MID_STEPS}
    if queued["where"] != "serving.queue" or mid["where"] in ("", "serving.queue"):
        raise AssertionError(f"(c) deadlines seen at {queued['where']!r} and {mid['where']!r}")
    return {"queued": queued, "mid_query": mid, "contended": _serve_contended_deadlines(df, serial, steps, deadline_ms)}


def _serve_contended_deadlines(df, serial: dict, steps, deadline_ms: float) -> dict:
    """(c) under load: ``SERVE_THREADS - 1`` threads keep submitting the mix
    at MaxConcurrent ``SERVE_THREADS`` while ``SERVE_CONTENDED_QUERIES``
    runs of ``steps`` go one after another under the mid-query deadline.
    Each raises ``DeadlineExceeded``, at a seam or while it waits for the
    dispatch lock; their overshoots past the deadline, and where each was
    seen."""
    import threading

    from modin_tpu_torch import serving
    from modin_tpu_torch.config import ServingMaxConcurrent, ServingQueueDepth
    from modin_tpu_torch.serving.gate import gate

    ServingMaxConcurrent.put(SERVE_THREADS)
    ServingQueueDepth.put(4 * SERVE_THREADS)
    gate.reset_for_tests()
    names = list(SERVE_QUERIES)
    stop = threading.Event()
    served, failures = [], []

    def load(t):
        i = t
        while not stop.is_set():
            name = names[i % len(names)]
            i += 1
            try:
                got = serving.submit(SERVE_QUERIES[name][0], df, tenant=SERVE_TENANTS[t % 3], label=name)
            except Exception as err:  # noqa: BLE001 - raised below
                failures.append(err)
                return
            served.append((name, got))

    pool = [threading.Thread(target=load, args=(t,), name=f"load-{t}", daemon=True)
            for t in range(SERVE_THREADS - 1)]
    for t in pool:
        t.start()
    time.sleep(0.2)  # the load saturates the slots first
    overshoots, where, completed = [], {}, 0
    try:
        for _ in range(SERVE_CONTENDED_QUERIES):
            t0 = time.perf_counter()
            try:
                serving.submit(steps, df, tenant="carol", deadline_ms=deadline_ms)
                completed += 1
            except serving.DeadlineExceeded as err:
                overshoots.append((time.perf_counter() - t0) * 1e3 - deadline_ms)
                site = err.where.split(".")[0] if err.where.startswith("device_path.") else err.where
                where[site] = where.get(site, 0) + 1
    finally:
        stop.set()
        for t in pool:
            t.join(timeout=120)
    if failures or any(t.is_alive() for t in pool):
        raise AssertionError(f"(c) under load: the load failed or hung: {failures!r}")
    for name, got in served:
        _bitwise_same(got, serial[name], f"(c) load {name}")
    if completed:
        raise AssertionError(f"(c) under load: {completed} queries ran to their end past a {deadline_ms:.3f} ms deadline")
    return {"max_concurrent": SERVE_THREADS, "load_threads": len(pool), "load_queries": len(served),
            "queries": len(overshoots), "deadline_ms": deadline_ms, "where": where,
            "overshoot_ms": {"p50": _percentile(overshoots, 50), "p99": _percentile(overshoots, 99),
                             "max": max(overshoots), "all": overshoots}}


def serve_headroom(df, serial: dict) -> dict:
    """(d): under a ``DeviceMemoryBudget`` of the frame's residency plus two
    queries' working sets (the resident data past 0.9 of it: the CPU's
    degraded high water, which the card does not shed on), rounds of
    ``SERVE_HEADROOM_QUERIES`` grouped means from ``SERVE_THREADS`` threads,
    each query from a tenant of its own (so no query's billing moves
    another's estimate).  ``planted``: each tenant's cost set to half the
    budget, so byte headroom, not the eight slots, bounds the running
    queries at two.  ``billed``: each tenant's cost what the gate billed for
    its one earlier served run (``_finish_accounting``), so the budget over
    the smallest billed cost bounds them.  In both, admissions queue, none
    is shed or degraded, and the device peak stays within the budget plus
    one query's working set (measured alone).  ``past_budget``: the budget
    ``SERVE_PAST_BUDGET_SHARE`` of the residency; every query still answers
    on the card, bit for bit, through the ledger's spills."""
    import threading

    import torch

    from modin_tpu_torch import serving
    from modin_tpu_torch.config import DeviceMemoryBudget, ServingMaxConcurrent, ServingQueueDepth
    from modin_tpu_torch.core import memory
    from modin_tpu_torch.serving import tenants
    from modin_tpu_torch.serving.gate import gate

    fn = SERVE_QUERIES["group_mean"][0]
    free_device_memory()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(df)
    torch.cuda.synchronize()
    working = torch.cuda.max_memory_allocated() - base
    resident = memory.device_ledger.total_bytes()
    budget = resident + 2 * working
    ServingMaxConcurrent.put(SERVE_THREADS)
    ServingQueueDepth.put(4 * SERVE_THREADS)
    running = []
    lock = threading.Lock()

    def query():
        with lock:
            running.append(gate._running)
        return fn(df)

    def burst(prefix: str, round_budget: int) -> dict:
        """One round's queries from the threads, each checked; the round's
        gate snapshot, running counts, peak and spills."""
        gate.reset_for_tests()
        running.clear()
        with DeviceMemoryBudget.context(round_budget):
            memory.device_ledger.admit(0)
            free_device_memory()
            untracked = max(torch.cuda.memory_allocated() - memory.device_ledger.total_bytes(), 0)
            torch.cuda.reset_peak_memory_stats()
            marks, spills0 = _serve_marks(), memory.COUNTS.get("memory.device.spill", 0)
            jobs = [lambda t=t: serving.submit(query, tenant=f"{prefix}{t}") for t in range(SERVE_HEADROOM_QUERIES)]
            outcomes = _serve_threads(jobs, SERVE_THREADS)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - untracked
            snap = gate.snapshot()
        for got, _w in outcomes:
            if isinstance(got, BaseException):
                raise AssertionError(f"(d) {prefix}: {got!r}") from got
            _bitwise_same(got, serial["group_mean"], f"(d) {prefix}: group_mean under the budget")
        if _serve_marks() != marks:
            raise AssertionError(f"(d) {prefix}: a query defaulted to pandas or fell back")
        if snap["shed"] or snap["degraded"] or snap["completed"] != len(jobs):
            raise AssertionError(f"(d) {prefix}: {snap}")
        return {"budget_bytes": round_budget, "resident_share": resident / round_budget, "queries": len(jobs),
                "ever_queued": snap["ever_queued"], "shed": snap["shed"], "degraded": snap["degraded"],
                "max_running": max(running), "peak_bytes": peak,
                "spills": memory.COUNTS.get("memory.device.spill", 0) - spills0}

    bound = budget + working
    tenants.registry.reset()
    for t in range(SERVE_HEADROOM_QUERIES):
        tenants.registry.observe(f"planted{t}", budget / 2, 0.0)
    planted = burst("planted", budget)
    with DeviceMemoryBudget.context(budget):
        for t in range(SERVE_HEADROOM_QUERIES):
            _bitwise_same(serving.submit(fn, df, tenant=f"billed{t}"), serial["group_mean"], "(d) billed: the run billed")
    billed_costs = [tenants.registry.get(f"billed{t}").cost_ewma_bytes for t in range(SERVE_HEADROOM_QUERIES)]
    if None in billed_costs:
        raise AssertionError(f"(d) billed: a served run billed no cost: {billed_costs}")
    billed = burst("billed", budget)
    billed_cap = max(1, int(budget // min(billed_costs)))
    past = burst("past", int(resident * SERVE_PAST_BUDGET_SHARE))
    for name, rnd, cap in (("planted", planted, 2), ("billed", billed, billed_cap)):
        if (cap < SERVE_THREADS and not rnd["ever_queued"]) or rnd["max_running"] > cap or rnd["peak_bytes"] > bound:
            raise AssertionError(f"(d) {name}: queued {rnd['ever_queued']}, running at most {rnd['max_running']} "
                                 f"against {cap}, peak {rnd['peak_bytes']} against {bound}")
    if not past["spills"]:
        raise AssertionError(f"(d) past the budget, nothing spilled: {past}")
    return {"resident_bytes": resident, "working_bytes": working, "bound_bytes": bound, "planted": planted,
            "billed": {**billed, "billed_cost_bytes": {"min": min(billed_costs), "max": max(billed_costs)},
                       "cap": billed_cap},
            "past_budget": past}


def serve_degraded(df) -> dict:
    """(e): a device-path breaker opened by injected faults
    (``testing/faults.py``: transient errors at every ``deploy`` with no
    retry, threshold 1): a served query is shed, typed ``degraded`` with a
    retry hint; it never runs, nothing defaults to pandas or falls back."""
    from modin_tpu_torch import serving
    from modin_tpu_torch.config import ResilienceBreakerThreshold, ResilienceRetries
    from modin_tpu_torch.core.execution import resilience
    from modin_tpu_torch.serving.gate import gate
    from modin_tpu_torch.testing import inject_faults

    gate.reset_for_tests()
    marks = _serve_marks()
    with ResilienceBreakerThreshold.context(1), ResilienceRetries.context(0):
        with inject_faults("transient", ops=("deploy",), times=None) as inj:
            try:
                SERVE_QUERIES["chain_sum"][0](df)
                raise AssertionError("(e) the injected fault did not raise on the card")
            except resilience.DeviceFailure as err:
                raised = err.kind
    opened = {k: v for k, v in resilience.breaker_snapshot().items() if v == "open"}
    ran = []
    try:
        serving.submit(lambda: ran.append(SERVE_QUERIES["group_sum"][0](df)), tenant="alice")
        raise AssertionError("(e) a query was admitted into a sick device")
    except serving.QueryRejected as err:
        shed = {"reason": err.reason, "retry_after_s": err.retry_after_s}
    snap = gate.snapshot()
    resilience.reset_breakers()
    if not opened or shed["reason"] != "degraded" or ran or _serve_marks() != marks:
        raise AssertionError(f"(e) opened {opened}, shed {shed}, ran {len(ran)}, {marks} -> {_serve_marks()}")
    if (snap["degraded"], snap["shed"], snap["admitted"]) != (1, 1, 0):
        raise AssertionError(f"(e) the snapshot: {snap}")
    return {"injected": inj.injected, "raised": raised, "opened": sorted(opened), **shed,
            "snapshot": {k: snap[k] for k in ("degraded", "shed", "admitted")}}


def serve_cost(df) -> dict:
    """(f): one query alone, serving off against on (rounds off, on, on,
    off, ``SERVE_COST_CALLS`` calls each), in us a query, for a no-op and
    for the chain sum; with serving and lockdep off no context and no
    validator object is made."""
    import torch

    from modin_tpu_torch import serving
    from modin_tpu_torch.concurrency import lockdep
    from modin_tpu_torch.config import ServingEnabled, ServingMaxConcurrent

    ServingMaxConcurrent.put(SERVE_THREADS)
    query = SERVE_QUERIES["chain_sum"][0]
    out = {}
    for name, fn in (("noop", lambda: None), ("chain_sum", lambda: query(df))):
        times = {False: [], True: []}
        fn()
        for on in (False, True, True, False):
            ServingEnabled.put(on)
            allocs = (serving.context_alloc_count(), lockdep.lockdep_alloc_count())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SERVE_COST_CALLS):
                serving.submit(fn, tenant="alice")
            torch.cuda.synchronize()
            times[on].append((time.perf_counter() - t0) / SERVE_COST_CALLS * 1e6)
            if not on and (serving.context_alloc_count(), lockdep.lockdep_alloc_count()) != allocs:
                raise AssertionError("(f) serving off allocated a context or a validator object")
        out[name] = {"off_us": times[False], "on_us": times[True],
                     "delta_us": statistics.median(times[True]) - statistics.median(times[False])}
    ServingEnabled.put(True)
    return {**out, "calls_a_round": SERVE_COST_CALLS, "off_allocations": 0, "lock_ns": serve_lock_ns()}


def serve_lock_ns() -> dict:
    """(f): ns of one ``with lock: pass`` (best of ``SERVE_LOCK_REPEATS``
    timings of ``SERVE_LOCK_ACQUIRES``) with lockdep off: a bare
    ``threading.Lock``/``RLock``, a named lock/rlock on the raw methods the
    port installs while lockdep is off, and a named lock on the validating
    methods with no validator (each call checks ``_validator`` in Python:
    the off path before the raw methods were installed)."""
    import threading

    from modin_tpu_torch.concurrency import lockdep

    def ns(lock) -> float:
        best = float("inf")
        for _ in range(SERVE_LOCK_REPEATS):
            t0 = time.perf_counter()
            for _ in range(SERVE_LOCK_ACQUIRES):
                with lock:
                    pass
            best = min(best, time.perf_counter() - t0)
        return best / SERVE_LOCK_ACQUIRES * 1e9

    if lockdep.enabled():
        raise AssertionError("(f) the lock costs are lockdep-off costs")
    named, named_r = lockdep.named_lock("serving.gate"), lockdep.named_rlock("resilience.dispatch")
    out = {"threading_lock": ns(threading.Lock()), "threading_rlock": ns(threading.RLock()),
           "named_lock": ns(named), "named_rlock": ns(named_r)}
    lockdep._install(lockdep._CHECKED_METHODS)
    try:
        out["named_lock_checked_off"] = ns(named)
    finally:
        lockdep._install(lockdep._RAW_METHODS)
    return out


#: (f) with ``--parent-checkout``: the hot path a side times, run in a
#: process of its own at the side's checkout, serving and lockdep off
_HOT_PATH = """
import json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
modin_tpu_torch.set_device("cuda")
rng = np.random.default_rng({seed})
d = tpd.DataFrame({{c: rng.standard_normal({rows}) for c in "abc"}})
def q():
    return float((d["a"] * d["b"] + d["c"]).sum()), float(d[d["a"] > 0]["b"].mean())
want = q()
for _ in range(50):
    assert q() == want
rounds = []
for _ in range({rounds}):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range({queries}):
        q()
    torch.cuda.synchronize()
    rounds.append((time.perf_counter() - t0) / {queries} * 1e6)
print(json.dumps({{"us": rounds, "result": want}}))
"""


def serve_hot_path(parent: str, seed: int) -> dict:
    """(f) with ``--parent-checkout``: a host-bound hot path (the chain sum
    and the filtered mean on a ``SERVE_HOT_ROWS`` frame: fused launches,
    the engine seam, the launch ledger, the metric counters, every one of
    them taking the port's locks) in us a query, on the parent's checkout
    and on this one, each side in processes of its own in the order of
    ``SERVE_HOT_ORDER``; the two sides' results must be equal."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MODIN_TPU_TORCH_SERVING", "MODIN_TPU_TORCH_LOCKDEP"))}
    code = _HOT_PATH.format(seed=seed, rows=SERVE_HOT_ROWS, rounds=SERVE_HOT_ROUNDS, queries=SERVE_HOT_QUERIES)
    sides = {"parent": [], "change": []}
    results = {}
    for side in SERVE_HOT_ORDER:
        proc = subprocess.run([sys.executable, "-c", code], cwd=parent if side == "parent" else HERE, env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"(f) the {side}'s hot path failed:\n{proc.stderr[-4000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        sides[side].extend(got["us"])
        results.setdefault(side, got["result"])
    if results["parent"] != results["change"]:
        raise AssertionError(f"(f) the hot path's results differ: {results}")
    return {"rows": SERVE_HOT_ROWS, "queries_a_round": SERVE_HOT_QUERIES,
            "parent_us": sides["parent"], "change_us": sides["change"],
            "delta_us": statistics.median(sides["change"]) - statistics.median(sides["parent"])}


def phase_serve(rows: int, seed: int, parent: str = None) -> dict:
    """Phase 21 (``serve``): ``serving.submit`` from threads on one card.
    (f) the layer's cost first, with lockdep off; then, under strict
    lockdep, (a) ``serve_mixed`` and ``serve_traced``, (b) ``serve_sheds``, (c)
    ``serve_deadlines``, (d) ``serve_headroom``, (e) ``serve_degraded``.
    The serving settings come back to their defaults after.  Returns the
    launches."""
    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch import config
    from modin_tpu_torch.concurrency import lockdep
    from modin_tpu_torch.serving import tenants
    from modin_tpu_torch.serving.gate import gate

    t_phase = time.perf_counter()
    data = serve_frame(rows, seed)
    pdf = pandas.DataFrame(data)
    df = tpd.DataFrame(data)
    df._query_compiler._modin_frame
    assert_on_cuda(df._query_compiler, "serve frame")
    k0 = _kernel_marks()
    serial = {}
    for name, (fn, ref, scale, _kernel) in SERVE_QUERIES.items():
        serial[name] = fn(df)
        _serve_same(serial[name], ref(pdf), None if scale is None else scale(pdf), f"(a) {name} against pandas")
        _bitwise_same(fn(df), serial[name], f"{name} run twice")
    del pdf
    knobs = (config.ServingEnabled, config.ServingMaxConcurrent, config.ServingQueueDepth,
             config.ServingTenantWeights, config.ViewsMode)
    saved = [(k, k.get()) for k in knobs]
    parts, seconds = {}, {}
    try:
        config.ServingTenantWeights.put(SERVE_WEIGHTS)
        # every query recomputes on the kernels: the artifact cache would
        # answer the repeated groupbys from the host
        config.ViewsMode.put("Off")
        t0 = time.perf_counter()
        parts["cost"] = serve_cost(df)
        if parent:
            parts["cost"]["hot_path"] = serve_hot_path(parent, seed)
        seconds["cost"] = time.perf_counter() - t0
        lockdep.enable(strict=True)
        for name, fn, fn_args in (("mixed", serve_mixed, (df, serial, seed)),
                                  ("traced", serve_traced, (df, serial, seed)),
                                  ("sheds", serve_sheds, (df,)),
                                  ("deadlines", serve_deadlines, (df, serial)),
                                  ("headroom", serve_headroom, (df, serial)),
                                  ("degraded", serve_degraded, (df,))):
            t0 = time.perf_counter()
            parts[name] = fn(*fn_args)
            seconds[name] = time.perf_counter() - t0
            emit({"phase": "serve", "part": name, **parts[name], "seconds": seconds[name]})
        violations = [v.render() for v in lockdep.violations()]
        edges = sorted(f"{a} -> {b}" for a, b in lockdep.observed_edges())
    finally:
        lockdep.disable()
        for k, v in saved:
            k.put(v)
        gate.reset_for_tests()
        tenants.registry.reset()
    if violations:
        raise AssertionError(f"lockdep: {violations}")
    launches = {k: v["launches"] for k, v in _kernel_since(k0).items()}
    emit({"phase": "serve", "rows": rows, "cost": parts["cost"], "lockdep": {"violations": 0, "edges": edges},
          "launches": launches, "seconds_by_part": seconds, "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------- #
# 22. ingest
# ---------------------------------------------------------------------- #

#: (a): micro-batches after the bootstrap, their rows, the key's groups,
#: the windowed view's bucket and the top-k's k
INGEST_BATCHES = 100
INGEST_BATCH_ROWS = 10_000
INGEST_GROUPS = 1000
INGEST_BUCKET_S = 60.0
INGEST_TOPK = 10
#: (a): the views are held against pandas and recomputed on the card after
#: the bootstrap and after the last micro-batch; the ad-hoc queries run every
#: ``INGEST_ADHOC_EVERY`` micro-batches (on an H100 80GB HBM3 at 700 W,
#: phase 22 took 92.2 s with a check after 50 batches too, ad-hoc queries
#: every 10, (c) past 256 records and (d) on 1e6 rows x 100 batches; its
#: share of the run is about 40 s)
INGEST_ADHOC_EVERY = 20
#: (b): the keyed feed's rows (its retention too), bootstrapped in batches of
#: ``INGEST_UPSERT_ROWS``, and the upsert batches, half of their keys stored
INGEST_KEYED_ROWS = 10**6
INGEST_UPSERT_ROWS = 10_000
INGEST_UPSERTS = 10
#: (c): the durable feed's bootstrap, its micro-batches' rows, its
#: ``WalMaxReplayBatches`` (at the default 256 the child took 30.5 s on the
#: same H100 host) and the
#: records past it at which the torn write kills it
INGEST_CRASH_ROWS = 10**6
INGEST_CRASH_BATCH_ROWS = 1000
INGEST_CRASH_REPLAY = 64
INGEST_CRASH_PAST = 40
#: (d): threads, each appending this many micro-batches of
#: ``INGEST_BATCH_ROWS`` onto a durable feed of ``INGEST_THREAD_ROWS``
INGEST_THREADS = 4
INGEST_THREAD_BATCHES = 10
INGEST_THREAD_ROWS = 200_000

INGEST_SCHEMA = {"k": "int64", "i": "int64", "x": "float64", "g": "int64", "ts": "float64"}
INGEST_VIEWS = {
    "sum_x": {"kind": "scalar", "column": "x", "agg": "sum"},
    "mean_x_where_i_pos": {"kind": "filtered", "column": "x", "agg": "mean", "predicate": ("i", ">", 0)},
    "mean_x_by_g": {"kind": "groupby", "by": "g", "column": "x", "agg": "mean"},
    "top_x": {"kind": "topk", "column": "x", "k": INGEST_TOPK},
    "count_60s": {"kind": "windowed", "column": "x", "time_column": "ts", "agg": "count",
                  "bucket_s": INGEST_BUCKET_S},
}
#: (b): integer views and order-free ones, which an upsert's exact rebuild
#: and the folds keep bit for bit
INGEST_KEYED_VIEWS = {
    "sum_i": {"kind": "scalar", "column": "i", "agg": "sum"},
    "sum_i_where_x_pos": {"kind": "filtered", "column": "i", "agg": "sum", "predicate": ("x", ">", 0.0)},
    "sum_i_by_g": {"kind": "groupby", "by": "g", "column": "i", "agg": "sum"},
    "top_x": {"kind": "topk", "column": "x", "k": INGEST_TOPK},
    "count_60s": INGEST_VIEWS["count_60s"],
}

_INGEST_CRASH_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, os.environ["INGEST_HERE"])
import chip_smoke
import modin_tpu_torch
modin_tpu_torch.set_device(os.environ["INGEST_DEVICE"])
from modin_tpu_torch import config, ingest
from modin_tpu_torch.logging.metrics import add_metric_handler
from modin_tpu_torch.testing import DiskFaultInjector

config.IngestEnabled.put(True)
config.WalFsync.put("GroupCommit")
config.WalMaxReplayBatches.put(int(os.environ["INGEST_MAX_REPLAY"]))
seed = int(os.environ["INGEST_SEED"])
ckpt = {}
add_metric_handler(lambda name, value: ckpt.__setitem__(name, value) if name.startswith("modin_tpu_torch.checkpoint.") else None)
feed = ingest.open_feed("crash", schema=chip_smoke.INGEST_SCHEMA, durable=True,
                        durability_dir=os.environ["INGEST_DIR"])
for name, plan in chip_smoke.INGEST_VIEWS.items():
    feed.register_view(name, plan)
dur = feed._wal
checkpoint = dur.checkpoint

def say(line):
    # one write a line: the group-commit flusher's checkpoint prints too
    sys.stdout.write(line + "\n")
    sys.stdout.flush()

def timed_checkpoint():
    t0 = time.perf_counter()
    wrote = checkpoint()
    if wrote:
        say("CHECKPOINT " + json.dumps({"ms": (time.perf_counter() - t0) * 1e3,
            "bytes": ckpt.get("modin_tpu_torch.checkpoint.bytes"), "wal_seq": dur._ckpt_seq}))
    return wrote

dur.checkpoint = timed_checkpoint
boot_rows, rows = int(os.environ["INGEST_ROWS"]), int(os.environ["INGEST_BATCH_ROWS"])
feed.append(chip_smoke.ingest_batch(seed, -1, boot_rows, 0, 0.0))
say("BOOTSTRAPPED")
skip = config.WalMaxReplayBatches.get() + int(os.environ["INGEST_PAST"])
DiskFaultInjector("torn_write", ops=("wal.write",), times=1, skip=skip).__enter__()  # never exits
for b in range(10**6):
    feed.append(chip_smoke.ingest_batch(seed, b, rows, boot_rows + b * rows, 3600.0 + b))
    say(f"ACKED {b + 1}")
"""


def ingest_batch(seed: int, b: int, rows: int, key_start: int, t0: float):
    """Micro-batch ``b`` of a feed (``b == -1``: its bootstrap): unique keys
    from ``key_start``, ints, normal floats, ``INGEST_GROUPS`` groups and
    timestamps over the hour (the bootstrap) or the minute from ``t0``."""
    import pandas

    rng = np.random.default_rng([seed, 22, b + 1])
    span = 3600.0 if b < 0 else 60.0
    return pandas.DataFrame({
        "k": np.arange(key_start, key_start + rows, dtype=np.int64),
        "i": rng.integers(-1000, 1000, rows),
        "x": rng.standard_normal(rows),
        "g": rng.integers(0, INGEST_GROUPS, rows),
        "ts": t0 + rng.uniform(0.0, span, rows),
    })


def _ingest_mask(lhs, op: str, val):
    import operator

    return {">": operator.gt, ">=": operator.ge, "<": operator.lt, "<=": operator.le, "==": operator.eq,
            "!=": operator.ne}[op](lhs, val)


def ingest_truth(plan: dict, pdf):
    """A view's answer by pandas over the admitted rows ``pdf``, and the
    scale its float result may differ by 1e-12 of (None: exact)."""
    kind, col = plan["kind"], plan["column"]
    x = pdf[col]
    if kind == "filtered":
        x = x[_ingest_mask(pdf[plan["predicate"][0]], plan["predicate"][1], plan["predicate"][2])]
    agg = plan.get("agg")
    floats = x.dtype.kind == "f" and agg in ("sum", "mean")
    if kind in ("scalar", "filtered"):
        want = getattr(x, agg)()
        return want, (float(x.abs().sum() if agg == "sum" else x.abs().mean()) if floats else None)
    if kind == "groupby":
        grouped = x.groupby(pdf[plan["by"]])
        want = getattr(grouped, agg)()
        return want, (getattr(x.abs().groupby(pdf[plan["by"]]), agg)() if floats else None)
    if kind == "topk":
        return x.reset_index(drop=True).nlargest(plan["k"], keep="first"), None
    keys = np.floor(pdf[plan["time_column"]].to_numpy(np.float64) / plan["bucket_s"]).astype(np.int64)
    return getattr(x.groupby(keys), agg)(), None


def ingest_same(got, want, scale, what: str) -> None:
    """A view's answer against pandas: ints, counts, top-k rows and buckets
    exactly; float sums and means to 1e-12 of the magnitudes they sum."""
    import pandas

    if isinstance(want, pandas.Series):
        if not isinstance(got, pandas.Series):
            raise AssertionError(f"{what}: {type(got).__name__}, not a Series")
        _stream_same(got.rename("v"), want.rename("v"), what, None if scale is None else scale.rename("v"))
        return
    g, w = np.float64(got), np.float64(want)
    if scale is None:
        if not (g == w or (np.isnan(g) and np.isnan(w))) or np.asarray(got).dtype.kind != np.asarray(want).dtype.kind:
            raise AssertionError(f"{what}: {got!r} != pandas' {want!r}")
    elif not abs(g - w) <= FLOAT_RTOL * scale:
        raise AssertionError(f"{what}: {got!r} against pandas' {want!r}, past 1e-12 of {scale!r}")


def _sync() -> None:
    import torch

    torch.cuda.synchronize()


def _timed_method(obj, name: str, sink: list) -> None:
    """Replace ``obj.name`` (on the instance) by the same call timed to its
    device work's end, each call's ms appended to ``sink``."""
    inner = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        _sync()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, timed)


def _ms_stats(values) -> dict:
    values = list(values)
    if not values:
        return {"n": 0}
    return {"n": len(values), "p50": _percentile(values, 50), "p99": _percentile(values, 99),
            "max": float(max(values)), "sum": float(sum(values))}


def _ingest_check(feed, views: dict, pdf, what: str, recompute: bool = True) -> dict:
    """Every view's maintained read and its ``recompute`` on the card held
    to pandas over ``pdf``; the ms of each read, recompute and pandas."""
    out = {}
    for name, plan in views.items():
        t0 = time.perf_counter()
        want, scale = ingest_truth(plan, pdf)
        pandas_ms = (time.perf_counter() - t0) * 1e3
        reads = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = feed.read(name).value
            reads.append((time.perf_counter() - t0) * 1e3)
        ingest_same(got, want, scale, f"ingest {what}: {name} maintained")
        entry = {"read_ms": statistics.median(reads), "pandas_ms": pandas_ms}
        if recompute:
            again, entry["recompute_ms"] = host_ms(lambda: feed.recompute(name))
            ingest_same(again, want, scale, f"ingest {what}: {name} recomputed on the card")
        out[name] = entry
    return out


def ingest_live(rows: int, seed: int) -> dict:
    """(a): a feed of ``rows`` bootstrap rows and ``INGEST_BATCHES``
    micro-batches with the five live views, the ad-hoc folds and the
    append's time by part."""
    import pandas

    from modin_tpu_torch import ingest

    feed = ingest.create_feed("live", INGEST_SCHEMA)
    assert_on_cuda(feed.frame._query_compiler, "ingest (a) the zero-row frame")
    for name, plan in INGEST_VIEWS.items():
        feed.register_view(name, plan)
    boot = ingest_batch(seed, -1, rows, 0, 0.0)
    _, boot_ms = host_ms(lambda: feed.append(boot))
    assert_on_cuda(feed.frame._query_compiler, "ingest (a) the bootstrapped frame")
    host_cached = all(c.host_cache is not None for c in feed.frame._query_compiler._modin_frame._columns)
    checks = {"bootstrap": _ingest_check(feed, INGEST_VIEWS, boot, "after the bootstrap")}
    parts = {"mirror_concat": [], "upload": [], "device_concat": []}
    _timed_method(feed, "_concat_mirror_locked", parts["mirror_concat"])
    _timed_method(feed, "_upload", parts["upload"])
    _timed_method(feed, "_concat_frame_locked", parts["device_concat"])
    xs, gs, batches = [boot["x"].to_numpy()], [boot["g"].to_numpy()], [boot]
    adhoc = {"sum": [], "groupby_sum": [], "checks": 0}
    counts0 = _view_counts()
    # the artifacts the appends fold into
    feed.frame["x"].sum()
    feed.frame.groupby("g")["x"].sum()
    appends = []
    for b in range(INGEST_BATCHES):
        batch = ingest_batch(seed, b, INGEST_BATCH_ROWS, rows + b * INGEST_BATCH_ROWS, 3600.0 + 6.0 * b)
        _, ms = host_ms(lambda: feed.append(batch))
        appends.append(ms)
        batches.append(batch)
        xs.append(batch["x"].to_numpy())
        gs.append(batch["g"].to_numpy())
        if (b + 1) % INGEST_ADHOC_EVERY == 0:
            x, g = np.concatenate(xs), np.concatenate(gs)
            frame = feed.frame
            got, ms = host_ms(lambda: frame["x"].sum())
            adhoc["sum"].append(ms)
            ingest_same(got, float(x.sum()), float(np.abs(x).sum()), f"ingest (a) ad-hoc sum after {b + 1}")
            got, ms = host_ms(lambda: frame.groupby("g")["x"].sum()._to_pandas())
            adhoc["groupby_sum"].append(ms)
            sx = pandas.Series(x)
            ingest_same(got, sx.groupby(g).sum(), sx.abs().groupby(g).sum(),
                        f"ingest (a) ad-hoc groupby sum after {b + 1}")
            adhoc["checks"] += 1
    adhoc["views_registry"] = _since(counts0, _view_counts())
    if adhoc["views_registry"]["view.fold"] < adhoc["checks"]:
        raise AssertionError(f"ingest (a): the ad-hoc queries folded {adhoc['views_registry']}")
    assert_on_cuda(feed.frame._query_compiler, "ingest (a) the grown frame")
    pdf = pandas.concat(batches, ignore_index=True)
    checks[f"after_{INGEST_BATCHES}"] = _ingest_check(feed, INGEST_VIEWS, pdf, f"after {INGEST_BATCHES} micro-batches")
    got = feed.frame._to_pandas().reset_index(drop=True)
    assert_same_pandas(got, pdf.astype(INGEST_SCHEMA), "ingest (a) the feed's frame", exact=True)
    ingest.drop_feed("live")
    return {"rows": rows, "batches": INGEST_BATCHES, "batch_rows": INGEST_BATCH_ROWS, "bootstrap_ms": boot_ms,
            "host_cache_kept": host_cached, "append_ms": _ms_stats(appends),
            "append_parts_ms": {k: _ms_stats(v) for k, v in parts.items()}, "views": checks, "adhoc": adhoc}


def _keyed_reference(ref, batch_rows: list, up, retention: int):
    """The upsert's and the trim's semantics by pandas: the batch's last row
    of a key wins, stored keys update in place, new keys append as one
    batch, then whole oldest batches go while the rows pass ``retention``."""
    import pandas

    up = up.drop_duplicates(subset=["k"], keep="last").reset_index(drop=True)
    pos = pandas.Index(ref["k"]).get_indexer(up["k"])
    hit = pos >= 0
    ref = ref.copy()
    ref.iloc[pos[hit]] = up[hit].to_numpy()
    new = up[~hit]
    if len(new):
        ref = pandas.concat([ref, new], ignore_index=True)
        batch_rows.append(len(new))
    while len(batch_rows) > 1 and len(ref) > retention:
        ref = ref.iloc[batch_rows.pop(0):].reset_index(drop=True)
    return ref.astype(INGEST_SCHEMA)


def ingest_keyed(seed: int) -> dict:
    """(b): a keyed feed of ``INGEST_KEYED_ROWS`` under a retention of as
    many rows, and ``INGEST_UPSERTS`` upsert batches half of whose keys are
    stored: every view exactly pandas', the re-upload and the key-index
    rebuild timed per call."""
    import pandas

    from modin_tpu_torch import ingest

    feed = ingest.create_feed("keyed", INGEST_SCHEMA, key="k", retention_rows=INGEST_KEYED_ROWS)
    for name, plan in INGEST_KEYED_VIEWS.items():
        feed.register_view(name, plan)
    nboot = INGEST_KEYED_ROWS // INGEST_UPSERT_ROWS
    boots = [ingest_batch(seed + 1, b, INGEST_UPSERT_ROWS, b * INGEST_UPSERT_ROWS, 6.0 * b) for b in range(nboot)]
    for batch in boots:
        feed.append(batch)
    ref = pandas.concat(boots, ignore_index=True).astype(INGEST_SCHEMA)
    batch_rows = [len(b) for b in boots]
    timed = {"reupload": [], "key_index": [], "upsert": []}
    _timed_method(feed, "_rebuild_frame_locked", timed["reupload"])
    _timed_method(feed, "_rebuild_key_index_locked", timed["key_index"])
    rng = np.random.default_rng([seed, 22, 1000])
    next_key = INGEST_KEYED_ROWS
    for u in range(INGEST_UPSERTS):
        half = INGEST_UPSERT_ROWS // 2
        stored = rng.choice(ref["k"].to_numpy(), half, replace=False)
        keys = np.concatenate([stored, np.arange(next_key, next_key + half, dtype=np.int64)])
        next_key += half
        up = ingest_batch(seed + 2, u, INGEST_UPSERT_ROWS, 0, 3600.0 + 6.0 * u).assign(k=rng.permutation(keys))
        _, ms = host_ms(lambda: feed.upsert(up))
        timed["upsert"].append(ms)
        ref = _keyed_reference(ref, batch_rows, up, INGEST_KEYED_ROWS)
        if feed.rows != len(ref):
            raise AssertionError(f"ingest (b) upsert {u}: {feed.rows} rows, pandas {len(ref)}")
        for name, plan in INGEST_KEYED_VIEWS.items():
            want, _scale = ingest_truth(plan, ref)
            ingest_same(feed.read(name).value, want, None, f"ingest (b) upsert {u}: {name}")
    assert_on_cuda(feed.frame._query_compiler, "ingest (b) the keyed frame")
    got = feed.frame._to_pandas().reset_index(drop=True)
    assert_same_pandas(got, ref, "ingest (b) the keyed frame", exact=True)
    views = _ingest_check(feed, INGEST_KEYED_VIEWS, ref, "(b) after the upserts")
    ingest.drop_feed("keyed")
    return {"rows": INGEST_KEYED_ROWS, "upserts": INGEST_UPSERTS, "upsert_rows": INGEST_UPSERT_ROWS,
            "final_rows": len(ref), "ms": {k: _ms_stats(v) for k, v in timed.items()}, "views": views}


def ingest_crash(seed: int, workdir: str) -> dict:
    """(c): a child process on the card ingests into a durable GroupCommit
    feed until ``DiskFaultInjector("torn_write")`` SIGKILLs it past a
    checkpoint; this process recovers the directory: one torn tail, the
    checkpoint loaded, the tail replayed, the frame and every view pandas'
    over the admitted batches."""
    import pandas

    import modin_tpu_torch
    from modin_tpu_torch import ingest
    from modin_tpu_torch.logging.metrics import add_metric_handler, clear_metric_handler

    root = os.path.join(workdir, "wal")
    env = dict(os.environ, INGEST_HERE=HERE, INGEST_DIR=root, INGEST_SEED=str(seed),
               INGEST_DEVICE=str(modin_tpu_torch.get_device().type), INGEST_ROWS=str(INGEST_CRASH_ROWS),
               INGEST_BATCH_ROWS=str(INGEST_CRASH_BATCH_ROWS), INGEST_PAST=str(INGEST_CRASH_PAST),
               INGEST_MAX_REPLAY=str(INGEST_CRASH_REPLAY))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _INGEST_CRASH_CHILD], env=env, cwd=HERE, capture_output=True,
                          text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != -9 or "BOOTSTRAPPED" not in proc.stdout:
        raise AssertionError(f"ingest (c): the child ended with {proc.returncode}, not SIGKILL:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    acked = len(re.findall(r"^ACKED \d+$", proc.stdout, re.M))
    ckpts = [json.loads(m) for m in re.findall(r"CHECKPOINT (\{[^}]*\})", proc.stdout)]
    if not ckpts:
        raise AssertionError("ingest (c): the child wrote no checkpoint")
    seen = []
    handler = lambda name, value: seen.append((name, value))  # noqa: E731
    add_metric_handler(handler)
    try:
        feed, recovery_ms = host_ms(lambda: ingest.open_feed("crash", durable=True, durability_dir=root))
    finally:
        clear_metric_handler(handler)
    tally = {}
    for name, value in seen:
        short = name[len("modin_tpu_torch."):]
        if short.startswith(("wal.", "checkpoint.", "recovery.")):
            tally[short] = tally.get(short, 0) + value
    if tally.get("wal.torn_tail") != 1 or tally.get("checkpoint.load") != 1 or tally.get("recovery.feed") != 1:
        raise AssertionError(f"ingest (c): recovery's counts {tally}")
    extra = feed.rows - INGEST_CRASH_ROWS
    recovered = extra // INGEST_CRASH_BATCH_ROWS
    if extra % INGEST_CRASH_BATCH_ROWS or not acked <= recovered <= acked + 1:
        raise AssertionError(f"ingest (c): {feed.rows} rows recovered after {acked} acked batches")
    assert_on_cuda(feed.frame._query_compiler, "ingest (c) the recovered frame")
    pdf = pandas.concat([ingest_batch(seed, -1, INGEST_CRASH_ROWS, 0, 0.0)] + [
        ingest_batch(seed, b, INGEST_CRASH_BATCH_ROWS, INGEST_CRASH_ROWS + b * INGEST_CRASH_BATCH_ROWS, 3600.0 + b)
        for b in range(recovered)], ignore_index=True)
    got = feed.frame._to_pandas().reset_index(drop=True)
    assert_same_pandas(got, pdf.astype(INGEST_SCHEMA), "ingest (c) the recovered frame", exact=True)
    views = _ingest_check(feed, INGEST_VIEWS, pdf, "(c) after recovery")
    replayed = feed._wal.replayed_batches
    ckpt_files = [f for f in os.listdir(os.path.join(root, "crash")) if f.startswith("ckpt_")]
    ingest.drop_feed("crash")
    return {"acked": acked, "recovered_batches": recovered, "replayed_records": replayed,
            "max_replay": INGEST_CRASH_REPLAY, "checkpoints": ckpts, "checkpoint_files": ckpt_files,
            "recovery_ms": recovery_ms, "recovery_counts": tally, "child_s": child_s, "views": views}


def ingest_threads(seed: int, workdir: str) -> dict:
    """(d): ``INGEST_THREADS`` threads append to and read one durable feed
    through the serving gate at MaxConcurrent 4 under strict lockdep: no
    violation, the four ingest edges observed, the frame and the views
    pandas' over every batch."""
    import threading

    import pandas

    from modin_tpu_torch import config, ingest
    from modin_tpu_torch.concurrency import lockdep
    from modin_tpu_torch.serving import tenants
    from modin_tpu_torch.serving.gate import gate

    feed = ingest.open_feed("threads", schema=INGEST_SCHEMA, durable=True,
                            durability_dir=os.path.join(workdir, "threads"))
    for name, plan in INGEST_VIEWS.items():
        feed.register_view(name, plan)
    boot = ingest_batch(seed + 3, -1, INGEST_THREAD_ROWS, 0, 0.0)
    feed.append(boot)
    jobs = [[ingest_batch(seed + 3, t * INGEST_THREAD_BATCHES + j, INGEST_BATCH_ROWS,
                          INGEST_THREAD_ROWS + (t * INGEST_THREAD_BATCHES + j) * INGEST_BATCH_ROWS, 3600.0 + j)
             for j in range(INGEST_THREAD_BATCHES)] for t in range(INGEST_THREADS)]
    errors, walls = [], []
    views = list(INGEST_VIEWS)

    def worker(t):
        try:
            for j, batch in enumerate(jobs[t]):
                t0 = time.perf_counter()
                feed.append(batch, tenant=f"ingest{t}")
                feed.read(views[(t + j) % len(views)], fresh_within_ms=0.0, tenant=f"reader{t}")
                ingest.max_fold_lag_ms()
                walls.append((time.perf_counter() - t0) * 1e3)
        except BaseException as err:  # reported after the join
            errors.append(repr(err))

    saved = [(k, k.get()) for k in (config.ServingEnabled, config.ServingMaxConcurrent)]
    config.ServingEnabled.put(True)
    config.ServingMaxConcurrent.put(4)
    lockdep.enable(strict=True)
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(INGEST_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall_s = time.perf_counter() - t0
        violations = [v.render() for v in lockdep.violations()]
        edges = sorted(f"{a} -> {b}" for a, b in lockdep.observed_edges())
    finally:
        lockdep.disable()
        for k, v in saved:
            k.put(v)
        gate.reset_for_tests()
        tenants.registry.reset()
    if errors or violations:
        raise AssertionError(f"ingest (d): errors {errors}, lockdep {violations}")
    wanted = {"ingest.feeds -> ingest.feed", "ingest.feed -> views.registry", "ingest.feed -> resilience.dispatch",
              "ingest.feed -> durability.wal"}
    if not wanted <= set(edges):
        raise AssertionError(f"ingest (d): edges {sorted(wanted - set(edges))} not observed")
    pdf = pandas.concat([boot] + [b for job in jobs for b in job], ignore_index=True).astype(INGEST_SCHEMA)
    got = feed.frame._to_pandas().sort_values("k").reset_index(drop=True)
    assert_same_pandas(got, pdf, "ingest (d) the frame, by key", exact=True)
    checked = {}
    for name, plan in INGEST_VIEWS.items():
        if plan["kind"] == "topk":
            continue  # its row ids follow the threads' order; the values are checked by (a)-(c)
        want, scale = ingest_truth(plan, pdf)
        ingest_same(feed.read(name).value, want, scale, f"ingest (d) {name}")
        checked[name] = True
    ingest.drop_feed("threads")
    return {"threads": INGEST_THREADS, "batches": INGEST_THREADS * INGEST_THREAD_BATCHES, "wall_s": wall_s,
            "append_and_read_ms": _ms_stats(walls), "lockdep": {"violations": 0, "edges": edges},
            "views_checked": sorted(checked)}


def phase_ingest(rows: int, seed: int, workdir: str) -> dict:
    """Phase 22 (``ingest``): (a) ``ingest_live``, (b) ``ingest_keyed``, (c)
    ``ingest_crash``, (d) ``ingest_threads``.  Returns the launches."""
    from modin_tpu_torch import config, ingest
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc

    t_phase = time.perf_counter()
    saved = [(k, k.get()) for k in (config.IngestEnabled,)]
    config.IngestEnabled.put(True)
    k0 = _kernel_marks()
    tqc.DEFAULTS_TO_PANDAS = 0
    parts, seconds = {}, {}
    try:
        for name, fn, fn_args in (("live", ingest_live, (rows, seed)), ("keyed", ingest_keyed, (seed,)),
                                  ("crash", ingest_crash, (seed, workdir)),
                                  ("threads", ingest_threads, (seed, workdir))):
            t0 = time.perf_counter()
            parts[name] = fn(*fn_args)
            seconds[name] = time.perf_counter() - t0
            emit({"phase": "ingest", "part": name, **parts[name], "seconds": seconds[name]})
            free_device_memory()
    finally:
        ingest.reset()
        for k, v in saved:
            k.put(v)
    launches = {k: v["launches"] for k, v in _kernel_since(k0).items()}
    if tqc.DEFAULTS_TO_PANDAS:
        raise AssertionError(f"ingest: {tqc.DEFAULTS_TO_PANDAS} queries defaulted to pandas")
    missing = [k for k in ("bincount", "groupagg", "fused") if not launches[k]]
    if missing:
        raise AssertionError(f"ingest: {missing} never launched ({launches})")
    emit({"phase": "ingest", "rows": rows, "launches": launches, "defaults_to_pandas": 0,
          "seconds_by_part": seconds, "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------- #
# 23. fleet
# ---------------------------------------------------------------------- #

#: (b)-(d): replicas, tenants, client threads, queries, key groups, the
#: heartbeat, each query's deadline and each wait's own bound
FLEET_REPLICAS = 3
FLEET_TENANTS = ("t0", "t1", "t2")
FLEET_THREADS = 8
FLEET_QUERIES = 240
FLEET_GROUPS = 1000
FLEET_HEARTBEAT_S = 0.3
FLEET_DEADLINE_MS = 30_000.0
FLEET_JOIN_S = 120.0
FLEET_RESPAWN_S = 120.0
FLEET_RPC_S = 60.0
#: the replicas' tenant weights: each tenant's token bucket refills at
#: weight x ServingMaxConcurrent a second, so the load is never throttled
FLEET_WEIGHTS = "t0=128,t1=128,t2=128,warm_check=128"
#: (e): the watch-smoke shape on the card
WATCH_SESSIONS = 8
WATCH_QUERIES_PER_SESSION = 4
WATCH_ROWS = 4096
WATCH_SLO_MS = 25.0
WATCH_SLOW_S = 0.08
WATCH_WAIT_S = 30.0


def fleet_frame(rows: int, seed: int, workdir: str):
    """The Parquet file every replica reads: ``k`` int64 of
    ``FLEET_GROUPS`` groups, ``i`` int64, ``x`` float64; its path and
    pandas' read of it."""
    import pandas

    rng = np.random.default_rng(seed + 230)
    pdf = pandas.DataFrame({"k": rng.integers(0, FLEET_GROUPS, rows).astype(np.int64),
                            "i": rng.integers(-1000, 1000, rows).astype(np.int64),
                            "x": rng.standard_normal(rows)})
    path = os.path.join(workdir, "fleet.parquet")
    pdf.to_parquet(path)
    return path, pandas.read_parquet(path)


def fleet_expected(pdf) -> dict:
    """Per catalog query: pandas' answer and the scale of its rounding (the
    magnitudes summed; 0 for an int column, which must be exact; None for
    an exact answer)."""
    absd = pdf.abs()
    kept = pdf[pdf["i"] > 0]
    sum_scale, kept_scale = absd.sum(), kept.abs().sum()
    sum_scale[["k", "i"]] = kept_scale[["k", "i"]] = 0.0  # int sums: exactly
    return {
        "sum": (pdf.sum(), sum_scale),
        "mean": (pdf.mean(), absd.mean()),
        "count": (pdf.count(), None),
        "min": (pdf.min(), None),
        "max": (pdf.max(), None),
        "groupby_sum": (pdf.groupby("k").sum(), absd.assign(k=pdf["k"]).groupby("k").sum()),
        "filter_sum": (kept.sum(), kept_scale),
    }


def _fleet_same(got, expected: dict, name: str, what: str) -> None:
    want, scale = expected[name]
    _stream_same(got, want, f"{what} {name}", scale)


def _fleet_threads() -> list:
    import threading

    return [t.name for t in threading.enumerate() if t.name.startswith("modin-tpu-torch-fleet")]


def _fleet_wait(predicate, timeout_s: float, what: str) -> float:
    """Poll ``predicate`` until true; the seconds it took (raises past the
    bound)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if predicate():
            return time.perf_counter() - t0
        time.sleep(0.02)
    raise AssertionError(f"fleet: timed out after {timeout_s}s waiting for {what}")


#: (slot, generation) -> that replica process's wrapper launches at its
#: latest snapshot.  A killed generation keeps the one taken just before
#: its SIGKILL: launches in the moments between are not counted.
FLEET_GENERATION_LAUNCHES: dict = {}


def _replica_snapshot(coord, index: int) -> dict:
    generation = coord._replicas[index].generation
    reply = coord._call(coord._replicas[index], {"type": "snapshot"}, timeout=FLEET_RPC_S)
    if not reply.get("ok"):
        raise AssertionError(f"fleet: replica {index}'s snapshot failed: {reply}")
    series = reply["meters"]["series"]
    FLEET_GENERATION_LAUNCHES[(index, generation)] = reply["launches"]
    return {
        "device": reply["device"],
        "defaults_to_pandas": reply["defaults_to_pandas"],
        "lockdep": reply["lockdep"],
        "launches": reply["launches"],
        "ledger_launches": {k[len("kernel.launch."):]: v["total"] for k, v in series.items()
                            if k.startswith("kernel.launch.")},
        "view": {k: series.get(k, {}).get("total", 0) for k in ("view.hit", "view.miss", "view.ingest",
                                                                  "view.export", "view.build")},
    }


def _check_replica(snap: dict, index: int, need_kernels: bool) -> None:
    if not snap["device"].startswith("cuda"):
        raise AssertionError(f"fleet: replica {index} serves on {snap['device']}, not the card")
    if snap["defaults_to_pandas"]:
        raise AssertionError(f"fleet: replica {index} sent {snap['defaults_to_pandas']} queries to pandas")
    if snap["lockdep"] != {"enabled": True, "violations": 0}:
        raise AssertionError(f"fleet: replica {index}'s lockdep: {snap['lockdep']}")
    if need_kernels:
        missing = [k for k in ("bincount", "groupagg")
                   if not snap["launches"].get(k) or not snap["ledger_launches"].get(k)]
        if missing:
            raise AssertionError(f"fleet: replica {index} never launched {missing}: {snap}")


def _fleet_load(fleet, expected: dict, queries: int, on_progress=None) -> dict:
    """``queries`` catalog queries from ``FLEET_THREADS`` threads of the three
    tenants: every answer held to pandas; each outcome a result or a typed
    rejection; the routed walls, each query's (start, end) and the typed
    outcomes that answered nothing.  No thread outlives ``FLEET_JOIN_S``."""
    import threading

    from modin_tpu_torch.serving.errors import DeadlineExceeded, QueryRejected

    names = sorted(expected)
    lock = threading.Lock()
    walls, typed, errors, unanswered, spans = [], {"rejected": 0, "deadline": 0}, [], [], []
    done = [0]

    def worker(tid: int) -> None:
        tenant = FLEET_TENANTS[tid % len(FLEET_TENANTS)]
        for j in range(tid, queries, FLEET_THREADS):
            name = names[j % len(names)]
            t0 = time.perf_counter()
            try:
                got = fleet.submit("ds", name, tenant=tenant, deadline_ms=FLEET_DEADLINE_MS)
                wall = time.perf_counter() - t0
                _fleet_same(got, expected, name, f"routed {tenant}")
            except QueryRejected as err:
                with lock:
                    typed["rejected"] += 1
                    typed[f"rejected.{err.reason}"] = typed.get(f"rejected.{err.reason}", 0) + 1
                    unanswered.append({"kind": f"rejected.{err.reason}", "started": t0})
                    spans.append((t0, time.perf_counter()))
                continue
            except DeadlineExceeded:
                with lock:
                    typed["deadline"] += 1
                    unanswered.append({"kind": "deadline", "started": t0})
                    spans.append((t0, time.perf_counter()))
                continue
            except BaseException as err:  # noqa: BLE001 - recorded, then raised below
                with lock:
                    errors.append(f"{tenant}:{name}: {type(err).__name__}: {err}")
                continue
            with lock:
                spans.append((t0, t0 + wall))
                walls.append(wall)
                done[0] += 1
                n_done = done[0]
            if on_progress is not None:
                on_progress(n_done)

    threads = [threading.Thread(target=worker, args=(tid,), name=f"fleet-load-{tid}", daemon=True)
               for tid in range(FLEET_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(FLEET_JOIN_S - (time.perf_counter() - t0), 0.1))
    hung = [t.name for t in threads if t.is_alive()]
    if hung:
        raise AssertionError(f"fleet: {len(hung)} query threads still waiting after {FLEET_JOIN_S}s: {hung}")
    if errors:
        raise AssertionError("fleet: untyped failures or wrong answers:\n" + "\n".join(errors[:10]))
    return {"completed": done[0], "typed": typed, "unanswered": unanswered, "spans": spans,
            "seconds": time.perf_counter() - t0,
            "routed_p50_ms": _percentile(walls, 50) * 1e3 if walls else None,
            "routed_p99_ms": _percentile(walls, 99) * 1e3 if walls else None}


def fleet_off(fleet, path: str, expected: dict) -> dict:
    """(a) The fleet off: ``fleet.submit`` is the local serving path bit for
    bit, with no fleet object or thread made."""
    from modin_tpu_torch.fleet.queries import QUERIES
    from modin_tpu_torch.serving import gate as gate_mod

    allocs = fleet.fleet_alloc_count()
    if fleet.FLEET_ON:
        raise AssertionError("fleet: MODIN_TPU_TORCH_FLEET is on before leg (a)")
    fleet.register_dataset("ds", "read_parquet", path)
    frame = fleet._local_frames["ds"]
    assert_on_cuda(frame._query_compiler, "fleet (a) frame")
    for name, fn in QUERIES.items():
        got = fleet.submit("ds", name, tenant="t0")
        _bitwise_same(got, gate_mod.submit(fn, frame, tenant="t0"), f"(a) {name} against the local path")
        _fleet_same(got, expected, name, "(a)")
    if fleet.fleet_alloc_count() != allocs or _fleet_threads():
        raise AssertionError(f"fleet: off made {fleet.fleet_alloc_count() - allocs} objects, threads "
                             f"{_fleet_threads()}")
    return {"queries": len(QUERIES), "fleet_allocs": 0, "fleet_threads": 0}


def fleet_warm(fleet, coord, path: str, expected: dict) -> dict:
    """(b) Three replicas warm from the manifest; the mixed load; each
    replica's launches, defaults and lockdep."""
    t0 = time.perf_counter()
    fleet.register_dataset("ds", "read_parquet", path)
    register_s = time.perf_counter() - t0
    rows = coord.snapshot()["replicas"]
    if [r["state"] for r in rows] != ["up"] * FLEET_REPLICAS:
        raise AssertionError(f"fleet: replicas not up after the warm: {rows}")
    ports = [r["watch_port"] for r in rows]
    if not all(p > 0 for p in ports) or len(set(ports)) != FLEET_REPLICAS:
        raise AssertionError(f"fleet: watch ports unreported or shared: {ports}")
    load = _fleet_load(fleet, expected, FLEET_QUERIES)
    del load["spans"], load["unanswered"]
    if load["completed"] != FLEET_QUERIES:
        raise AssertionError(f"fleet: {load['completed']} of {FLEET_QUERIES} queries answered: {load}")
    snaps = {i: _replica_snapshot(coord, i) for i in range(FLEET_REPLICAS)}
    for i, snap in snaps.items():
        _check_replica(snap, i, need_kernels=True)
    return {"hello_s": [r["hello_s"] for r in rows], "register_s": register_s, "watch_ports": ports,
            "assignments": coord.snapshot()["assignments"], **load, "replicas": snaps}


def fleet_kill(fleet, coord, expected: dict) -> dict:
    """(c) kill -9 of one replica under the load: no query hangs, the
    tenants drain, the slot respawns warm; the MTTR; the respawned
    replica's ingest and a direct query answered warm with no launch."""
    import threading

    from modin_tpu_torch.observability import meters
    from modin_tpu_torch.testing import ReplicaFaultInjector

    from modin_tpu_torch.fleet.queries import QUERIES

    inj = ReplicaFaultInjector(coord)
    victim = coord.snapshot()["assignments"]["t0"]
    gen0 = coord._replicas[victim].generation
    killed = {}
    started = threading.Event()

    def progress(done: int) -> None:
        if done >= FLEET_QUERIES // 6 and not started.is_set():
            started.set()
            try:  # the victim's launches as late as they can be read
                _replica_snapshot(coord, victim)
            except BaseException as err:  # noqa: BLE001 - raised below, with the kill's outcome
                killed["error"] = f"{type(err).__name__}: {err}"
            killed["t0"] = time.perf_counter()
            killed["pid"] = inj.kill(victim)
            killed["t"] = time.perf_counter()

    recovered = {}

    def watcher() -> None:
        started.wait(FLEET_JOIN_S)
        t_end = time.perf_counter() + FLEET_RESPAWN_S
        while time.perf_counter() < t_end:
            rep = coord._replicas[victim]
            if rep.generation > gen0 and rep.state == "up":
                recovered["t"] = time.perf_counter()
                return
            time.sleep(0.01)

    w = threading.Thread(target=watcher, name="fleet-mttr", daemon=True)
    w.start()
    load = _fleet_load(fleet, expected, FLEET_QUERIES, on_progress=progress)
    w.join(timeout=FLEET_RESPAWN_S + 1)
    if "t" not in killed or "t" not in recovered or "error" in killed:
        raise AssertionError(f"fleet: kill {killed}, recovery {recovered}")
    # Only a query in flight when the SIGKILL landed may go unanswered, and
    # only as ``replica_lost``: the two survivors take everything else, so a
    # ``replica_error`` (a fault inside a survivor), ``no_replicas`` or a
    # deadline fails the leg.
    inflight = sum(1 for start, end in load.pop("spans") if start <= killed["t"] and end >= killed["t0"])
    unanswered = load.pop("unanswered")
    bad = [u for u in unanswered if u["kind"] != "rejected.replica_lost" or u["started"] > killed["t"]]
    if bad or load["completed"] < FLEET_QUERIES - inflight:
        raise AssertionError(f"fleet: {load['completed']} of {FLEET_QUERIES} answered across the kill with "
                             f"{inflight} in flight at it; outcomes {load['typed']}; not excused: {bad}")
    load["inflight_at_kill"] = inflight
    snap = coord.snapshot()
    series = meters.snapshot()["series"]
    counters = {k: series.get(k, {}).get("total", 0) for k in
                ("fleet.replica.lost", "fleet.drain.redistributed", "fleet.replica.respawned",
                 "fleet.query.routed", "fleet.query.redispatch", "fleet.replica.heartbeat_miss")}
    missing = [k for k in ("fleet.replica.lost", "fleet.drain.redistributed", "fleet.replica.respawned")
               if not counters[k]]
    if missing:
        raise AssertionError(f"fleet: {missing} missing from the coordinator's meters: {counters}")
    rep = coord._replicas[victim]
    before = _replica_snapshot(coord, victim)
    _check_replica(before, victim, need_kernels=False)
    if before["view"]["view.ingest"] <= 0:
        raise AssertionError(f"fleet: the respawned replica ingested no view artifacts: {before}")
    direct = coord._call(rep, {"type": "query", "dataset": "ds", "fn": QUERIES["groupby_sum"],
                               "args": (), "kwargs": {}, "tenant": "warm_check", "deadline_ms": None,
                               "label": "warm_check"}, timeout=FLEET_RPC_S)
    if not direct.get("ok"):
        raise AssertionError(f"fleet: the direct query failed: {direct}")
    _fleet_same(direct["result"], expected, "groupby_sum", "(c) respawned")
    after = _replica_snapshot(coord, victim)
    if after["launches"] != before["launches"] or after["view"]["view.hit"] <= before["view"]["view.hit"]:
        raise AssertionError(f"fleet: the respawned replica answered cold: {before} -> {after}")
    return {"victim": victim, "killed_pid": killed["pid"], "mttr_s": recovered["t"] - killed["t"],
            "respawned_hello_s": snap["replicas"][victim]["hello_s"], **load, "counters": counters,
            "respawned": {"view": after["view"], "launches": after["launches"]}}


def fleet_crash_respawn(fleet, coord, expected: dict) -> dict:
    """(d) The next respawn crashes inside its warm request; the attempt
    after succeeds."""
    from modin_tpu_torch.testing import ReplicaFaultInjector

    snap0 = coord.snapshot()
    inj = ReplicaFaultInjector(coord)
    inj.crash_next_respawn()
    victim = next(r["index"] for r in snap0["replicas"] if r["state"] == "up")
    _replica_snapshot(coord, victim)  # its launches up to the kill
    inj.kill(victim)
    t_fail = _fleet_wait(lambda: coord.snapshot()["respawn_failures"] > snap0["respawn_failures"],
                         FLEET_RESPAWN_S, "the crashed respawn")
    t_up = _fleet_wait(lambda: all(r["state"] == "up" for r in coord.snapshot()["replicas"])
                       and coord.snapshot()["respawned"] > snap0["respawned"], FLEET_RESPAWN_S,
                       "the retried respawn")
    _fleet_same(fleet.submit("ds", "sum", tenant="t1", deadline_ms=FLEET_DEADLINE_MS), expected, "sum",
                "(d) after the crashed respawn")
    final = coord.snapshot()
    for i in range(FLEET_REPLICAS):
        _check_replica(_replica_snapshot(coord, i), i, need_kernels=False)
    return {"victim": victim, "failed_attempt_s": t_fail, "recovered_s": t_fail + t_up,
            "respawn_failures": final["respawn_failures"], "respawned": final["respawned"], "lost": final["lost"]}


def fleet_watch(seed: int, workdir: str) -> dict:
    """(e) The watch service in this process: eight serving sessions under a
    25 ms SLO and an injected 80 ms slow deploy; ``/metrics`` scraped
    mid-load through the port's Prometheus parser; ``slo_burn`` trips and
    writes exactly one evidence bundle of four legs; ``/statusz`` and
    ``/debug/queries`` answer; a feed's fold lag trips ``fold_lag``."""
    import glob
    import threading
    import urllib.request

    import pandas

    import modin_tpu_torch.pandas as tpd
    from modin_tpu_torch import config, ingest, serving
    from modin_tpu_torch.observability import flight_recorder, watch
    from modin_tpu_torch.observability.exposition import parse_prometheus
    from modin_tpu_torch.testing import inject_faults

    tracedir = os.path.join(workdir, "watch_traces")
    rng = np.random.default_rng(seed + 231)
    data = {"a": rng.standard_normal(WATCH_ROWS), "b": rng.integers(0, 1000, WATCH_ROWS).astype(np.int64),
            "key": rng.integers(0, 13, WATCH_ROWS).astype(np.int64)}
    pdf = pandas.DataFrame(data)
    df = tpd.DataFrame(data)
    df._query_compiler._modin_frame
    assert_on_cuda(df._query_compiler, "watch frame")
    queries = [("gb_sum", lambda: _host(df.groupby("key").sum()), pdf.groupby("key").sum(),
                pdf.abs().assign(key=pdf["key"]).groupby("key").sum()),
               ("ew_reduce", lambda: float((df["a"] * 2 + df["b"]).sum()), float((pdf["a"] * 2 + pdf["b"]).sum()),
                float((pdf["a"] * 2).abs().sum() + pdf["b"].abs().sum())),
               ("mean", lambda: _host(df.mean()), pdf.mean(), pdf.abs().mean())]
    for _name, q, _want, _scale in queries:
        q()
    knobs = (config.TraceDir, config.TraceEnabled, config.ServingEnabled, config.ServingMaxConcurrent,
             config.ServingQueueDepth, config.WatchSloMs, config.WatchIntervalS, config.WatchPort,
             config.WatchEnabled, config.ResilienceBackoffS, config.IngestEnabled, config.IngestFoldEvery,
             config.IngestFoldLagMs)
    saved = [(k, k.get()) for k in knobs]
    try:
        config.TraceDir.put(tracedir)
        config.TraceEnabled.put(True)
        config.ResilienceBackoffS.put(0.0)
        config.ServingEnabled.put(True)
        config.ServingMaxConcurrent.put(4)
        config.ServingQueueDepth.put(WATCH_SESSIONS * WATCH_QUERIES_PER_SESSION)
        config.WatchSloMs.put(f"default={WATCH_SLO_MS:g}")
        config.WatchIntervalS.put(0.1)
        config.WatchPort.put(0)
        flight_recorder.reset_for_tests()
        config.WatchEnabled.put(True)
        port = watch.httpd_port()
        if not port:
            raise AssertionError("watch: the exporter bound no port")

        def scrape(path: str) -> str:
            return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10).read().decode()

        lock = threading.Lock()
        failures, walls = [], []

        def session(tid: int) -> None:
            for k in range(WATCH_QUERIES_PER_SESSION):
                name, q, want, scale = queries[(tid + k) % len(queries)]
                t0 = time.perf_counter()
                try:
                    got = serving.submit(q, tenant=f"session{tid}", deadline_ms=0, label=name)
                    _serve_same(got, want, scale, f"(e) {name}")
                except BaseException as err:  # noqa: BLE001 - recorded, then raised below
                    with lock:
                        failures.append(f"session {tid} {name}: {type(err).__name__}: {err}")
                    continue
                with lock:
                    walls.append(time.perf_counter() - t0)

        parses = 0
        with inject_faults("slow_kernel", ops=("deploy",), times=None, slow_s=WATCH_SLOW_S):
            threads = [threading.Thread(target=session, args=(tid,), name=f"watch-session-{tid}", daemon=True)
                       for tid in range(WATCH_SESSIONS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            while any(t.is_alive() for t in threads) and time.perf_counter() - t0 < FLEET_JOIN_S:
                if not parse_prometheus(scrape("/metrics")):
                    raise AssertionError("watch: a mid-load /metrics parsed to nothing")
                parses += 1
                time.sleep(0.05)
            for t in threads:
                t.join(timeout=max(FLEET_JOIN_S - (time.perf_counter() - t0), 0.1))
            if any(t.is_alive() for t in threads):
                raise AssertionError("watch: a session thread still runs")
        if failures:
            raise AssertionError("watch: " + "; ".join(failures[:5]))
        if not parses:
            raise AssertionError("watch: the load ended before a mid-load /metrics scrape")
        _fleet_wait(lambda: any(t["rule"] == "slo_burn" for t in watch.recent_trips()), WATCH_WAIT_S,
                    "the slo_burn tripwire")
        snap = serving.serving_snapshot()
        if not any(v["breaching"] for v in snap.get("slo", {}).values()):
            raise AssertionError(f"watch: serving_snapshot shows no breach: {snap.get('slo')}")
        statusz = scrape("/statusz")
        if "BREACHING" not in statusz:
            raise AssertionError("watch: /statusz shows no breach")
        debug = json.loads(scrape("/debug/queries"))
        bundles = glob.glob(os.path.join(tracedir, "watchtrip_*.json"))
        if len(bundles) != 1:
            raise AssertionError(f"watch: {len(bundles)} evidence bundles, not one: {bundles}")
        with open(bundles[0]) as f:
            bundle = json.load(f)
        legs = [leg for leg in ("trace", "metrics", "rings", "slo") if leg in bundle]
        if bundle["rule"] != "slo_burn" or len(legs) != 4 or not bundle["trace"]["traceEvents"]:
            raise AssertionError(f"watch: the bundle is {bundle['rule']} with legs {legs}")
        # the feed: pending batches past a 5 ms fold-lag bound
        config.IngestEnabled.put(True)
        config.IngestFoldEvery.put(1000)
        config.IngestFoldLagMs.put(5.0)
        feed = ingest.create_feed("watch_feed", {"k": "int64", "x": "float64"})
        feed.register_view("total", {"kind": "scalar", "column": "x", "agg": "sum"})
        feed.append(pandas.DataFrame({"k": np.arange(1000, dtype=np.int64), "x": np.ones(1000)}))
        _fleet_wait(lambda: any(t["rule"] == "fold_lag" for t in watch.recent_trips()), WATCH_WAIT_S,
                    "the fold_lag tripwire")
        read = feed.read("total", fresh_within_ms=0.0)
        if float(read.value) != 1000.0:
            raise AssertionError(f"watch: the feed's view read {read.value}")
        wsnap = watch.watch_snapshot()
        if wsnap["sampler"]["died"]:
            raise AssertionError(f"watch: the sampler died: {wsnap}")
        return {"completed": len(walls), "midload_scrapes": parses, "session_p50_ms": _percentile(walls, 50) * 1e3,
                "session_p99_ms": _percentile(walls, 99) * 1e3, "bundle_legs": legs,
                "bundle_trace_events": len(bundle["trace"]["traceEvents"]), "open_scopes": debug["open_scopes"],
                "trips": sorted({t["rule"] for t in watch.recent_trips()}), "sampler_ticks": wsnap["sampler"]["ticks"],
                "statusz_lines": len(statusz.splitlines())}
    finally:
        config.WatchEnabled.put(False)
        ingest.reset()
        for k, v in saved:
            k.put(v)
        watch.reset_for_tests()


def phase_fleet(rows: int, seed: int, workdir: str) -> dict:
    """Phase 23 (``fleet``): (a) ``fleet_off``, then under strict lockdep
    here and in every replica (b) ``fleet_warm``, (c) ``fleet_kill``, (d)
    ``fleet_crash_respawn``, (e) ``fleet_watch``.  Returns the launches,
    the replicas' beside this process's."""
    import modin_tpu_torch.fleet as fleet
    from modin_tpu_torch import config
    from modin_tpu_torch.concurrency import lockdep
    from modin_tpu_torch.core.execution import recovery
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.serving import tenants
    from modin_tpu_torch.serving.gate import gate

    t_phase = time.perf_counter()
    path, pdf = fleet_frame(rows, seed, workdir)
    expected = fleet_expected(pdf)
    del pdf
    k0 = _kernel_marks()
    tqc.DEFAULTS_TO_PANDAS = 0
    knobs = (config.FleetEnabled, config.FleetReplicas, config.FleetHeartbeatS, config.MetersEnabled)
    saved = [(k, k.get()) for k in knobs]
    env_keys = ("MODIN_TPU_TORCH_LOCKDEP", "MODIN_TPU_TORCH_METERS", "MODIN_TPU_TORCH_SERVING_TENANT_WEIGHTS")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    parts, seconds = {}, {}
    replica_launches = {}
    FLEET_GENERATION_LAUNCHES.clear()
    coord = None
    try:
        t0 = time.perf_counter()
        parts["off"] = fleet_off(fleet, path, expected)
        seconds["off"] = time.perf_counter() - t0
        emit({"phase": "fleet", "part": "off", **parts["off"], "seconds": seconds["off"]})
        # the replicas inherit strict lockdep and the launch ledger (meters)
        os.environ["MODIN_TPU_TORCH_LOCKDEP"] = "1"
        os.environ["MODIN_TPU_TORCH_METERS"] = "1"
        os.environ["MODIN_TPU_TORCH_SERVING_TENANT_WEIGHTS"] = FLEET_WEIGHTS
        config.MetersEnabled.put(True)
        config.FleetEnabled.put(True)
        config.FleetReplicas.put(FLEET_REPLICAS)
        config.FleetHeartbeatS.put(FLEET_HEARTBEAT_S)
        lockdep.enable(strict=True)
        t0 = time.perf_counter()
        coord = fleet.start_fleet()
        start_s = time.perf_counter() - t0
        for name, fn, fn_args in (("warm", fleet_warm, (fleet, coord, path, expected)),
                                  ("kill", fleet_kill, (fleet, coord, expected)),
                                  ("crash_respawn", fleet_crash_respawn, (fleet, coord, expected)),
                                  ("watch", fleet_watch, (seed, workdir))):
            t0 = time.perf_counter()
            parts[name] = fn(*fn_args)
            seconds[name] = time.perf_counter() - t0
            if name == "warm":
                parts[name]["start_fleet_s"] = start_s
                replica_launches = {i: s["launches"] for i, s in parts[name].pop("replicas").items()}
                emit({"phase": "fleet", "part": name, **parts[name], "replica_launches": replica_launches,
                      "seconds": seconds[name]})
            else:
                emit({"phase": "fleet", "part": name, **parts[name], "seconds": seconds[name]})
        # every replica process's launches: the living ones' now, a killed
        # one's at its snapshot just before the kill
        for i in range(FLEET_REPLICAS):
            _replica_snapshot(coord, i)
        replica_launches = {f"{i}.{g}": v for (i, g), v in sorted(FLEET_GENERATION_LAUNCHES.items())}
        violations = [v.render() for v in lockdep.violations()]
    finally:
        lockdep.disable()
        fleet.reset_for_tests()
        recovery.reset_for_tests()
        for k, v in saved:
            k.put(v)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        gate.reset_for_tests()
        tenants.registry.reset()
        if coord is not None:
            for rep in coord._replicas:
                if rep.proc is not None and rep.proc.poll() is None:
                    rep.proc.kill()
                    rep.proc.wait(timeout=10)
    if violations:
        raise AssertionError(f"fleet: lockdep in this process: {violations}")
    if tqc.DEFAULTS_TO_PANDAS:
        raise AssertionError(f"fleet: {tqc.DEFAULTS_TO_PANDAS} queries defaulted to pandas in this process")
    if _fleet_threads():
        raise AssertionError(f"fleet: threads left after the fleet stopped: {_fleet_threads()}")
    here = {k: v["launches"] for k, v in _kernel_since(k0).items()}
    replicas_total = {k: sum(v.get(k, 0) for v in replica_launches.values()) for k in ("bincount", "groupagg", "fused")}
    launches = {k: here[k] + replicas_total[k] for k in here}
    emit({"phase": "fleet", "rows": rows, "launches": launches, "launches_here": here,
          "launches_per_replica_generation": replica_launches, "defaults_to_pandas": 0, "lockdep": {"violations": 0},
          "seconds_by_part": seconds, "seconds": time.perf_counter() - t_phase})
    return {**launches, "here": here, "replicas": replicas_total, "per_replica": replica_launches}


def resilience_line(robust: dict, by_path: dict) -> dict:
    """The ``{"resilience": ...}`` line: phase 17's parts in brief and every
    other path's fallbacks and breakers."""
    oom = robust["real_oom"]
    return {
        "real_oom": {k: {f: v[f] for f in ("torch_ooms", "retry_oom", "engine_oom", "spills", "spill_bytes",
                                           "fallbacks", "defaults", "launches", "cap_bytes", "peak_alone_bytes",
                                           "cold_bytes", "alone_ms", "oom_run_ms", "cold_restored_exactly")}
                     for k, v in oom.items()},
        "injected": {k: {f: v[f] for f in v if f != "counts"} for k, v in robust["injected"].items()},
        "cost_ms": {q: {m: v[m] for m in ("Enable", "Disable", "delta_ms", "round_deltas_ms")}
                    for q, v in robust["cost"].items() if q != "per_call_us"},
        "cost_per_call_us": robust["cost"]["per_call_us"],
        "robust_launches": robust["launches"],
        "paths": by_path,
    }


def observability_line(trace: dict) -> dict:
    """The ``{"observability": ...}`` line: phase 18 in brief."""
    prof, cost = trace["profile"], trace["cost"]
    return {
        "rollup": prof["rollup"],
        "peaks": {k: trace["peaks"][k] for k in ("copy_gb_s", "fma_f64_tflop_s", "published")},
        "cost_ms": {q: {m: v[m] for m in ("Enable", "Disable", "delta_ms", "round_deltas_ms", "spread_ms",
                                          "wrapped_calls", "wrappers_off_ms")}
                    for q, v in cost.items() if q in ROBUST_COST_QUERIES},
        "cost_per_call_us": cost["per_call_us"],
        "off_allocations": cost["off_allocations"],
        "explain": {m: trace["explain"][m] for m in ("on", "off")},
        "flight": {k: trace["flight"][k] for k in ("raised", "record_reason", "record_spans", "record_metric_series")},
        "trace_launches": trace["launches"],
    }


def kernels_line(kernel: dict, launches: dict, fused_by_path: dict, groupagg_by_path: dict, rows: int,
                 trace: dict = None) -> dict:
    """``launches`` maps each path (``main``, ``relational``, ``arithmetic``,
    ``io``, ``window``, ``clean``, ``dates``, ``plan``, ``formats``) to its
    kernels' launches; the ``launches`` of a kernel's entry is its own path's:
    bincount's the main path's, scan's the window path's (the clean path's
    ``rank`` runs it too), the fused kernel's the fusion path's
    (``fused_by_path``: its launches on every path, each counted from 0 just
    before that path ran; its masked mode's the plan path's), groupagg's the
    main path's (phase 4's grouped sums and means), and its launches on
    every path beside (``groupagg_by_path``, counted as ``fused_by_path``
    is: each path's eager groupbys, resample included, and the plan path's
    fused groupbys)."""
    by_width = kernel["by_width"]
    main = by_width[100]
    scan = kernel["scan"]["by_case"]
    head = scan["seg_add_f64_nocodes"]
    fused = kernel["fused"]["by_case"]
    fhead = fused["axpb_f64"]
    gahead = kernel["groupagg"]["by_case"]["sum_float64_w100"]
    bincount_paths = {k: v["bincount"] if isinstance(v, dict) else v for k, v in launches.items()
                      if k != "plan"}
    line = {"kernels": [{
        "name": "bincount",
        "route": "cuda",
        "source": "modin_tpu_torch/ops/cuda/csrc/bincount.cu",
        "replaces": "modin_tpu/ops/pallas/groupby_kernels.py:29",
        "launches": launches["main"]["bincount"],
        "launches_by_path": bincount_paths,
        "exact": True,
        "max_abs_err": kernel["max_abs_err"],
        "n": rows,
        "width": 100,
        "ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
        "smem_slots": kernel["cap"],
        "by_width": {
            str(w): {k: by_width[w][k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "mode")}
            for w in (100, 10_000)
        },
    }, {
        "name": "scan",
        "route": "cuda",
        "source": "modin_tpu_torch/ops/cuda/csrc/scan.cu",
        "replaces": "modin_tpu/ops/window.py:209 (_linear_scan) and modin_tpu/ops/groupby.py:1178 "
                    "(_jit_grouped_cum): XLA programs, not Pallas kernels",
        "launches": launches["window"]["scan"],
        "launches_by_path": {"window": launches["window"]["scan"], "clean": launches["clean"]["scan"],
                             "clean_rank": launches["clean"]["rank_scan"],
                             "formats": launches["formats"]["scan"]},
        "max_abs_err": kernel["scan"]["max_abs_err"],
        "n": rows,
        "case": "seg_add_f64_nocodes",
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": head["library_ms"],
        "library": "torch.cumsum, the same function as seg_add without codes (and, over an [n / w, w] "
                   "view, as the forward blocks of w rows); no torch call computes the segmented, "
                   "reverse or linear scans (their cumsum_ms is an unsegmented yardstick)",
        "by_case": {
            k: {f: v[f] for f in ("kernel_ms", "plain_ms", "library_ms", "library", "cumsum_ms", "bound_ms",
                                  "bytes_per_row", "max_abs_err", "tolerance")}
            for k, v in scan.items()
        },
    }, {
        "name": "fused",
        "route": "cuda",
        "source": "modin_tpu_torch/ops/cuda/csrc/fused.cu",
        "replaces": "modin_tpu/ops/lazy.py:288 (run_fused) over modin_tpu/ops/elementwise.py:63 (_build_ops): "
                    "XLA programs, not Pallas kernels",
        "launches": fused_by_path["fusion"],
        "launches_by_path": fused_by_path,
        "max_abs_err": kernel["fused"]["max_abs_err"],
        "grid_cases_bitwise": kernel["fused"]["grid_cases"],
        "n": rows,
        "case": "axpb_f64",
        "ms": fhead["kernel_ms"],
        "plain_ms": fhead["plain_ms"],
        "bound_ms": fhead["bound_ms"],
        "bound_by": fhead["bound_by"],
        "library_ms": fhead["library_ms"],
        "library": "torch.addcmul(c, a, b) for a * b + c; no torch call computes a chain with a tail or "
                   "the 150-node program",
        "by_case": {
            k: {**{f: v[f] for f in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                     "bytes_per_row", "instructions", "registers", "max_abs_err", "threads",
                                     "rows_per_thread")}, "parent_ms": v.get("parent_ms")}
            for k, v in fused.items()
        },
        "masked": {
            "note": "the masked accumulator mode at phase 13's shapes: [b, c] under the deferred mask a > 0 "
                    "(masked_probe: the int64 key's min and max and the kept rows; slot: the fused groupby's "
                    "slot column, no tail); launches on the plan path",
            "launches": fused_by_path.get("plan"),
            **{k: {f: v[f] for f in ("kernel_ms", "plain_ms", "library_ms", "library", "bound_ms",
                                     "bytes_per_row", "max_abs_err")}
               for k, v in fused.items() if k.startswith("masked_") or k == "slot"},
        },
    }, {
        "name": "groupagg",
        "route": "cuda",
        "source": "modin_tpu_torch/ops/cuda/csrc/groupagg.cu",
        "replaces": "modin_tpu/ops/groupby.py:1288 (fused_group_agg, its scatter body :1313-1385): an XLA "
                    "program, not a Pallas kernel; it also carries the eager int-key groupby",
        "launches": launches["main"]["groupagg"],
        "launches_by_path": groupagg_by_path,
        "max_abs_err": kernel["groupagg"]["max_abs_err"],
        "n": rows,
        "case": "sum_float64_w100",
        "ms": gahead["kernel_ms"],
        "plain_ms": gahead["plain_ms"],
        "bound_ms": gahead["bound_ms"],
        "bound_by": "bytes",
        "library_ms": gahead["library_ms"],
        "library": "index_add_ for sum and mean, scatter_reduce_ for min, max and prod (one call a 1-D column), "
                   "torch.bincount for count",
        "staged_sum_ms": kernel["groupagg"]["staged_ms"],
        "groupagg_route_sum_ms": kernel["groupagg"]["groupagg_route_ms"],
        "by_case": {
            k: {f: v[f] for f in ("kernel_ms", "parent_ms", "plain_ms", "library_ms", "library_kept_ms", "bound_ms",
                                  "copies", "ranges", "stage_groups", "blocks")}
            for k, v in kernel["groupagg"]["by_case"].items()
        },
    }]}
    if trace is not None:
        # phase 18's launch ledger: the profiled main path's launches, their
        # event-timed device ms, bytes, achieved bandwidth and roofline
        # fraction against the peaks measured in the same run
        for entry in line["kernels"]:
            entry["ledger"] = {k: v for k, v in trace["profile"]["kernels"][entry["name"]].items()
                               if k != "signatures"}
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=10**8,
                        help="rows of the kernel inputs")
    # Every phase after the kernel check runs at half the rows it had, and
    # phases 8 and 10 at a quarter: the whole run took 1021.1 s of the
    # script's own clock (1037.4 s with the call's set-up) on an H100 host
    # and passed 1200 s on another, most of it pandas' and numpy's
    # references on the host (phase 7 176.4 s, 10 131.7 s, 8 123.2 s, 9
    # 111.3 s); at half the rows it took 860.9 s on a slower host (phase 7
    # 180.9 s, most of it comparing a 1e6-column transpose column by column,
    # now one array; 10 90.5 s, 8 87.5 s); with phases 8 and 10 at a
    # quarter, 714.2 s on a third host.  Earlier cuts: phase 7 from 1e8
    # (595 s of 948), 5e7 (286-321 s) and 2e7 (194.7 s); phase 8 from 2e7
    # (328 s, to_csv 90 s in pandas and as long in the port); phase 9 from
    # 2e7 (503 s, pandas 264 s of it); phase 11 from 1e7 (105.8 s)
    parser.add_argument("--arithmetic-rows", type=int, default=75 * 10**5,
                        help="rows of the arithmetic phase")
    parser.add_argument("--earlier-rows", type=int, default=10**7,
                        help="rows of the main-path and relational phases")
    parser.add_argument("--float-rows", type=int, default=5 * 10**6)
    parser.add_argument("--io-rows", type=int, default=25 * 10**5,
                        help="rows of the io phase's CSV and Parquet files")
    parser.add_argument("--window-rows", type=int, default=25 * 10**5,
                        help="rows of the window phase's asv frame")
    parser.add_argument("--clean-rows", type=int, default=25 * 10**5,
                        help="rows of the clean phase's frames")
    parser.add_argument("--dates-rows", type=int, default=25 * 10**5,
                        help="rows of the dates phase's frames")
    parser.add_argument("--fusion-rows", type=int, default=10**7,
                        help="rows of the fusion phase's frames")
    parser.add_argument("--plan-rows", type=int, default=25 * 10**5,
                        help="rows of the plan phase's CSV file")
    parser.add_argument("--donation-rows", type=int, default=5 * 10**6,
                        help="rows of the memory phase's CSV (donation and optimizer)")
    parser.add_argument("--memory-rows", type=int, default=10**8,
                        help="rows of the memory phase's budgeted frames (10 int64 columns)")
    parser.add_argument("--views-rows", type=int, default=10**6,
                        help="rows of the views phase's correctness frame (tails of a tenth)")
    parser.add_argument("--views-time-rows", type=int, default=5 * 10**7,
                        help="rows of the views phase's timed frame (10 tails of a hundredth)")
    parser.add_argument("--robust-cost-rows", type=int, default=10**7,
                        help="rows of the robust phase's timing of the layer (phase-4 queries)")
    parser.add_argument("--trace-rows", type=int, default=10**7,
                        help="rows of the trace phase's profiled main path and its cost timing")
    parser.add_argument("--stream-rows", type=int, default=5 * 10**6,
                        help="rows of the stream phase's CSV (a); its merge (c) takes half and a tenth")
    parser.add_argument("--stream-sort-rows", type=int, default=5 * 10**6,
                        help="rows of the stream phase's externally sorted frame (b)")
    # phase 20 took 77.9 s at 1e7 rows (pandas' ten-column stable sorts
    # 5.3-6.2 s each, its merges 1.3-6.7 s): past its 40 s share
    parser.add_argument("--mesh-rows", type=int, default=5 * 10**6,
                        help="rows of the mesh phase's sorted frame and merge's left side")
    parser.add_argument("--serve-rows", type=int, default=10**7,
                        help="rows of the serve phase's frame")
    parser.add_argument("--ingest-rows", type=int, default=5 * 10**6,
                        help="rows of the ingest phase's bootstrap (a); its micro-batches are 1e4 rows")
    parser.add_argument("--fleet-rows", type=int, default=2 * 10**6,
                        help="rows of the fleet phase's Parquet dataset, read by every replica")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--time-windows", type=int, default=0, metavar="R",
                        help="only time phase 9's window queries at --window-rows, R calls "
                        "each after a warm-up (no checks, no result lines)")
    parser.add_argument("--parent-checkout", default=None, metavar="DIR",
                        help="a checkout of an earlier commit (git archive) whose fused kernel the "
                        "kernel check times on the same cases, before and after this one's, and "
                        "whose host-bound hot path the serve phase times beside this one's")
    parser.add_argument("--phases", default=",".join(ALL_PHASES),
                        help="comma-separated phases after the kernel check "
                        "(the result lines need all of them)")
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    try:
        import modin_tpu_torch
    except ImportError as err:
        print(f"chip_smoke: modin_tpu_torch is not importable here: {err}", file=sys.stderr)
        return 2
    if not os.path.abspath(modin_tpu_torch.__file__).startswith(os.path.join(HERE, "")):
        print("chip_smoke: modin_tpu_torch must come from this checkout, found "
              f"{modin_tpu_torch.__file__}", file=sys.stderr)
        return 2
    modin_tpu_torch.set_device("cuda")
    try:
        import pandas  # noqa: F401

        have_pandas = True
    except ImportError:
        have_pandas = False

    t_start = time.perf_counter()
    smi = phase_device()
    if args.time_windows:
        phase_window_times(args.window_rows, args.seed, args.time_windows)
        print("chip_smoke: a timing run prints no result", file=sys.stderr)
        return 1
    phase_build()
    rows, earlier_rows = args.arithmetic_rows, args.earlier_rows
    if rows >= 10**8 and mem_available_gib() < 60:
        rows = 5 * 10**7
        emit({"phase": "arithmetic", "note": f"host memory {mem_available_gib():.0f} GiB "
              f"cannot hold the 1e8-row frames: rows cut to {rows}"})
    kernel = phase_kernel(args.rows, args.seed, args.parent_checkout and os.path.abspath(args.parent_checkout))
    from modin_tpu_torch.ops.cuda import fused_kernels as fk
    from modin_tpu_torch.ops.cuda import groupagg_kernels as ga

    from modin_tpu_torch.core.execution import resilience

    launches, fused_by_path, groupagg_by_path, resilience_by_path = {}, {}, {}, {}

    def run(name, fn, *fn_args):
        """One path, its fused and groupagg launches counted from 0 just
        before it; every path but ``robust`` ends with no device-path
        fallback and every breaker closed."""
        fk.LAUNCHES = ga.LAUNCHES = 0
        fallbacks = resilience.fallback_count()
        out = fn(*fn_args)
        fused_by_path[name], groupagg_by_path[name] = fk.LAUNCHES, ga.LAUNCHES
        not_closed = {k: v for k, v in resilience.breaker_snapshot().items() if v != "closed"}
        resilience_by_path[name] = {"fallbacks": resilience.fallback_count() - fallbacks,
                                    "breakers_not_closed": not_closed}
        if name != "robust" and (resilience_by_path[name]["fallbacks"] or not_closed):
            raise AssertionError(f"the {name} path fell back from the device: {resilience_by_path[name]}")
        return out

    if "main" in phases:
        launches["main"] = run("main", phase_main, earlier_rows, args.seed, have_pandas)
    if "float" in phases:
        run("float", phase_float, args.float_rows, args.seed, have_pandas)
    if not have_pandas:
        print("chip_smoke: the relational and arithmetic phases need pandas, their "
              "reference", file=sys.stderr)
        return 1
    if "relational" in phases:
        launches["relational"] = run("relational", phase_relational, earlier_rows, args.seed)
    if "arithmetic" in phases:
        launches["arithmetic"] = run("arithmetic", phase_arithmetic, rows, args.seed)
    if "io" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as workdir:
            launches["io"] = run("io", phase_io, args.io_rows, args.seed, workdir)
    if "window" in phases:
        launches["window"] = run("window", phase_window, args.window_rows, args.float_rows, args.seed)
    if "clean" in phases:
        launches["clean"] = run("clean", phase_clean, args.clean_rows, args.seed)
    if "dates" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dates_") as workdir:
            launches["dates"] = run("dates", phase_dates, args.dates_rows, args.seed, workdir)
    if "fusion" in phases:
        run("fusion", phase_fusion, args.fusion_rows, args.seed)
    if "plan" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_plan_") as workdir:
            launches["plan"] = run("plan", phase_plan, args.plan_rows, args.seed, workdir)
    if "formats" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_formats_") as workdir:
            launches["formats"] = run("formats", phase_formats, args.seed, workdir)
    if "memory" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_memory_") as workdir:
            launches["memory"] = run("memory", phase_memory, args.memory_rows, args.donation_rows, args.seed,
                                     workdir)
    if "views" in phases:
        launches["views"] = run("views", phase_views, args.views_rows, args.views_time_rows, args.seed)
    robust = trace = None
    if "robust" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_robust_") as workdir:
            launches["robust"], robust = run("robust", phase_robust, args.seed, args.robust_cost_rows, workdir)
    if "trace" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as workdir:
            launches["trace"], trace = run("trace", phase_trace, args.trace_rows, args.seed, workdir)
    if "stream" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as workdir:
            launches["stream"] = run("stream", phase_stream, args.stream_rows, args.stream_sort_rows, args.seed,
                                     workdir)
    if "mesh" in phases:
        launches["mesh"] = run("mesh", phase_mesh, args.mesh_rows, args.seed)
    if "serve" in phases:
        launches["serve"] = run("serve", phase_serve, args.serve_rows, args.seed,
                                args.parent_checkout and os.path.abspath(args.parent_checkout))
    if "ingest" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ingest_") as workdir:
            launches["ingest"] = run("ingest", phase_ingest, args.ingest_rows, args.seed, workdir)
    if "fleet" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as workdir:
            launches["fleet"] = run("fleet", phase_fleet, args.fleet_rows, args.seed, workdir)
        # the replicas' launches, counted by their own wrappers (a killed
        # process's up to its snapshot just before the kill)
        fused_by_path["fleet_replicas"] = launches["fleet"]["replicas"]["fused"]
        groupagg_by_path["fleet_replicas"] = launches["fleet"]["replicas"]["groupagg"]
    from modin_tpu_torch.ops import router

    emit({"phase": "done", "seconds": time.perf_counter() - t_start, "fused_launches_by_path": fused_by_path,
          "groupagg_launches_by_path": groupagg_by_path, "router_verdicts": dict(router.COUNTS),
          "router_calibration_error": router.CALIBRATION_ERROR, "resilience_by_path": resilience_by_path})
    for name in ("main", "arithmetic", "clean", "fusion", "plan", "formats"):
        if name in fused_by_path and fused_by_path[name] == 0:
            raise AssertionError(f"the {name} path never launched the fused kernel")
    if "plan" in launches and launches["plan"]["groupagg"] == 0:
        raise AssertionError("the plan path never launched the groupagg kernel")
    if phases != set(ALL_PHASES):
        print("chip_smoke: a partial run prints no result", file=sys.stderr)
        return 1
    emit({"resilience": resilience_line(robust, resilience_by_path)})
    emit({"observability": observability_line(trace)})
    print(smi, flush=True)
    emit(kernels_line(kernel, launches, fused_by_path, groupagg_by_path, args.rows, trace))
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
