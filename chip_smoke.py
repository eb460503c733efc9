#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `predictionio_tpu_torch`'s three paths on the card. It builds the
CUDA kernels from `predictionio_tpu_torch/csrc` with nvcc (one nvcc per
source, all started together) and holds each kernel against its plain
PyTorch version at the shapes its path gives it. Then:

- the recommendation path: rank-200 explicit ALS on synthetic
  MovieLens-20M-shaped ratings (138,493 users x 26,744 items x 20M
  generated ratings, seeded, of which the preparator's dedup keeps 11.3M
  distinct pairs; 2 iterations) through the preparator and
  `ALSAlgorithm.train` (every solve through the CG kernel), served over
  `POST /queries.json`;
- the ALS config fields on that path's prepared data (`als_fields`): the
  reference's ablation rows with solver 'cg_cuda' and sweep_chunk 4 (the
  baseline, bf16 factor tables held to its RMSE, and `fuse_iteration`,
  each iteration replayed from CUDA graphs, its tables bit for bit the
  baseline's, every replayed solve counted as a CG launch), then
  dual_solve='never' against 'auto' on the first 20,000 users;
- the similar-product path: the same 20M (user, item) pairs as view
  events summed into counts, all 26,744 items $set with synthetic
  categories, rank-200 implicit ALS (alpha 1, lam 0.01, 2 iterations)
  through the data source, preparator and `ALSAlgorithm.train` with
  solver 'chol_cuda' (every solve through the Cholesky kernel), served
  over `POST /queries.json` with category, black-list and white-list
  filters; then the same train fused (two graphs an iteration,
  the Grams' eigh eager between them), bit for bit the unfused tables;
- the Schulz path: the recommendation template on the first path's
  prepared data with the reference's full-scale Schulz configuration
  (solver 'schulz_cuda', compute dtype bfloat16, sweep chunk 4; 2
  iterations), every solve through the Newton-Schulz kernel, served over
  `POST /queries.json`;
- the product path (`pio train` -> `pio deploy`): a SQLite event store
  populated through the bulk import with 2M synthetic `rate` events
  (138,493 users x 26,744 items, seed 0) and one `$set` per item
  (categories, creationYear); `create_workflow_main` on an engine.json
  variant trains rank-200 ALS (lam 0.05, 2 iterations, every solve
  through the CG kernel) and persists the engine instance; a fresh
  `EngineServer.load()` restores it onto the card and serves base,
  category and creationYear queries over HTTP, each held against a
  float64 top-k under the reference's mask, built from the items' seeded
  metadata; a retrain through the command line (`cli.main(["train",
  ...])`, what `python -m predictionio_tpu_torch train` runs) then swaps
  in on `POST /reload`; that deploy's AOT warm is read for the
  `memory_allocated` it adds and the capture streams the process has
  used (one: every capture runs on the device's one capture stream);
- the sharded plane on that store, right after its first train
  (`sharded_*`): the same engine with the `als-mesh` algorithm
  (`factor_sharding='model'`, 2 shards on the card, the same seed) through
  the command line, its tables against `store_train`'s and every bucket
  solve a CG launch, as many as `store_train`'s; the shard files of its
  `ShardedALSModelCheckpoint` restored by a deploy bit-equal; the store's
  queries through that deploy (the two-phase top-k of `ops/topk.py`)
  held to float64, one window's device ms beside the replicated
  layout's; one fold tick of each layout, the rows within tolerance;
  then `deploy` as two processes on the card over gloo, each holding one
  shard, 16 answers held to float64 and the collective bytes a query,
  and the worker SIGKILLed: 503 within the 5 s broadcast timeout, and
  `/stats.json` and `/metrics` read poisoned;
- the bulk data plane and the e2 library on that store, right after its
  first train: the same train with `"stream": true` (`stream_train`:
  chunked store cursors, a reader thread and pinned double-buffered
  copies to the card; every solve a CG launch, the factor tables and id
  maps bit-equal to the batch train's, 2,000,000 rows streamed, no kernel
  build mid-stream); `BulkLoadExecutor` on the card over the first
  1,000,000 rate events (`dataplane`: every segment a CUDA tensor on the
  bucket ladder copied from a pinned buffer, the rows copied back
  byte-equal to the host columns, a 64 MB copy still in flight when its
  staging call returns); the Markov chain (26,744 states, 5M seeded
  transition counts, top 20; 16 predictions on the card held to float64
  within 1e-6) and categorical naive Bayes (1,000,000 points, 8
  positions, 64 values, 5 labels; the counts on the card equal to numpy's
  bincount, the model to a float64 reckoning) (`e2`);
- then `pio eval` on the same store (`rec_eval`):
  `create_workflow_main` on this script's `RecEval`/`RecSweep`, a
  FastEvalEngine of the recommendation template (2 folds, one read, one
  lam setting, every solve a CG launch), each PrecisionAtK@10 held to
  the float64 top-10 of the same tables computed on the card;
- the serve plane: the similar-product template trained from the same
  store (`rate` events read as views, rank 200, solver 'chol_cuda', every
  solve through the Cholesky kernel) through the command line; both
  templates deployed as `python -m predictionio_tpu_torch deploy`
  subprocesses at their defaults (micro-batched, two windows in flight,
  f16 packed readback, warmed before the first query); 32 closed-loop
  client threads x 20 queries against each, every answer held against a
  float64 top-k under the seeded mask (ids) and f16 rounding (scores);
  then `undeploy` for each; then the reference REST bench's shape (16
  clients, 320 plain queries, micro_batch 32) against an in-process
  server with two windows in flight and one with one, bursts in ABBA
  order, every answer held the same way;
- the online fold-in: the CG kernel held at the shapes the fold plans (B
  = 16 with inert rows, the primal and duals K = 1-16, a wholly inert
  batch); 256 fresh `rate` events (48 known users, 8 new users, 4 new
  items with a `$set`) folded into the deployed recommendation process by
  `python -m predictionio_tpu_torch update` (the entity-filtered read,
  the quality gates, a published version, `/reload`), every fold solve a
  CG launch, untouched rows bit-equal to the deployed ones, touched rows
  held to a float64 replay of the same two sweeps, 72 queries held to
  the float64 top-k of the published tables; then the similar-product
  instance in an in-process server with `attach_scheduler`: two ticks of
  view events (2 new items), each hot-swapped and held, the second
  against the first's resident tables (its upload under 1% of the
  first's), the carried Gram against a recomputed one;
- event collection and the feedback loop on the same store, after the
  serve plane (`collection_phases`): `python -m predictionio_tpu_torch
  eventserver --port 0 --stats` as a subprocess and an app of its own
  made by `app new`/`accesskey new`; 16 closed-loop clients x 250 single
  `POST /events.json`, 200 `POST /batch/events.json` of 50 and one
  `POST /events/columnar.json` of 100,000 rows, the store's count and
  `/stats.json` exact, 64 ids read back equal, the reference's answers to
  a wrong key, a non-whitelisted event, a reserved name and a batch of
  51, one Segment.io webhook (`eventserver`); a `deploy --feedback` of
  the recommendation instance with an output blocker and a sniffer
  (`PIO_ENGINE_SERVER_PLUGINS`), the fold_update traffic (reseeded, fresh
  ids) posted through `/batch/events.json`, a quarter of it through a
  second event server whose store writes fail at random (`PIO_FAULTS`:
  every event acknowledged, some spilled to its WAL, the WAL drained,
  every id in the store once; `rest_fold_spill`), the fleet registry
  listing both servers and the deploy with their pids and federating
  their metrics (`rest_fold_fleet`), `update` as a subprocess (every
  solve a CG launch, the fold seeing exactly the store's fresh events,
  touched rows held to a float64 replay, the new users answered with the
  float64 top-k of the published tables; `rest_fold`); 64
  queries whose 64 `predict` events must land in the store equal to the
  answers without the blocker's field, with the cache empty, then 16
  clients under feedback (`feedback`). The e-commerce phases append
  `buy` events (read by the recommendation template) dated 2030, which a
  later fold of the recommendation instance would take in too, so these
  phases run before the other templates;
- the other ALS templates on the same store, through `pio train` ->
  `pio deploy` subprocesses: the similar-product template's DIMSUM
  algorithm (the [26,744+, 26,744+] item Gram on the card, 2.9 GB,
  persisted by the model itself; 64 rows held to float64 rows made with
  scipy.sparse from the store's pairs, 64 queries to the float64 top-k);
  the e-commerce template after 288,599 `view`/`buy` events
  (`synthetic_ml20m` asked for 75,000 and 15,000 gives every user at
  least one: 149,988 and 138,611, and 341 views of 64 new users) and two
  `unavailableItems` lists land (rank-200 implicit ALS,
  every solve through the CG kernel, its last half-sweep held to the
  kernel's plain version and read against float64; 240 queries held to
  the float64 top-k under the mask made from the seeds, with zero
  point-read timeouts; the result cache keeping a bought item, as the
  reference's does, and `PIO_SERVE_CACHE=off` dropping it; 32 clients x
  20 queries); the recommended-user template on 172,368 `follow`
  events in an app of their own (every solve through the CG kernel, 64
  queries held);
- the classification template in an app of its own on the same store
  (`cls_*`): 25,000 users $set with a plan of 4 classes and Poisson
  attributes; `python -m predictionio_tpu_torch eval chip_smoke.ClsEval
  chip_smoke.ClsSweep` as a subprocess, each naive Bayes accuracy equal
  to a float64 numpy naive Bayes on the same folds; `train` with naive
  Bayes and the random forest (grown on the card, its arrays equal to
  the plain version's on the CPU given the same draws); a `deploy`
  subprocess, 64 answers each the float64 argmax of the persisted
  model;
- export and import (`import_export`): `export` writes the
  recommended-user template's app (its follow events) as JSON lines and
  `import` loads them into a new app, whose `find_columnar` must equal
  the first's column for column;
- the recommended-user train read from the C++ event log
  (`nativelog_train`): EVENTDATA on a four-partition `nativelog` source
  (`csrc/eventlog.cpp`, built by g++ at first use), the exported follows
  imported into an app there (group commits counted), its columns equal
  to the SQLite app's, and the template trained from it in this process
  (every solve a CG kernel launch), its factor tables bit-equal to
  `recuser_train`'s persisted blob;
- the app moved to a new host (`snapshot_train`): `snapshot create` ships
  that nativelog app's shard files to a `file://` URI; on a fresh store
  (metadata in a `docindex`, events in a new four-partition nativelog,
  models on localfs) `app new`, `snapshot restore` (refused onto the new
  app's empty logs, then `--force`) and `snapshot list`, the restored
  columns equal to the source app's; `build` registers the manifest in
  the docindex, the template trains from the restored app (every solve a
  CG kernel launch, the tables bit-equal to `recuser_train`'s blob), a
  `deploy` subprocess reads the instance from the docindex and answers 64
  queries held to float64; a `run_fake` evaluation on the dashboard
  (index, txt/html/json results, `/telemetry` reading the deploy), the
  admin server's `/cmd/app` through the docindex, `servers` seeing the
  engine, dashboard and admin server UP, and `unregister` (then exit 1);
- many engines on one card (`tenancy`): host A, an in-process
  `ServingHost`, serves the store's recommendation instance and its
  similar-product instance as tenants `rec` and `sp` (answers held to
  float64 through `/engines/<t>/queries.json`; one byte-identical body to
  both tenants never answered from the other's cache); `tenants
  list|status|pin|evict` in process (the operator eviction drops `rec`'s
  CUDA graphs, `torch.cuda.memory_allocated()` falls by its `bytesFreed`,
  and its next answers are the same bytes); one forced fold tick on each
  tenant through the host's `FoldTickGate` (every solve a CG launch, both
  tenants in `pio_fold_tick_wait_seconds`); a `PIO_AUTH=on` host answers
  a real access key and refuses a wrong one with 401. Host B, `python -m
  predictionio_tpu_torch bootstrap ru --snapshot nl_follows --serve
  --port 0`, restores `snapshot_train`'s snapshot into a fresh nativelog
  app, trains the recommended-user template (every solve a CG launch; the
  tables bit-equal to `recuser_train`'s blob) and serves it. With host
  A's budget set so that `ru` cannot join without an eviction, host B is
  SIGKILLed and `placement apply` fails `ru` over onto host A under
  generation 1: a `TenantRouter` client is answered before and after the
  kill with no 5xx, a stale-generation admit is refused, one
  `host_failover` incident is captured, `rec` (unpinned, coldest) is
  evicted for `budget` and `sp` (pinned) is not, and
  `pio_engine_hbm_bytes{tenant}` equals each tenant's live storages, and
  the rise of `memory_allocated` over `rec`'s re-upload equals its gauge
  with no cuBLAS workspace released first;
- the example engines, last (`examples`): the quickstart's
  recommendation family as a subprocess with MODELDATA on a `remotefs`
  `file://` source (4 items answered, the blob under the URL); SimRank
  over the follows among the (at most) 16,384 most-followed accounts (5
  iterations, decay 0.8; the 172,368 follows name 15,594, so S is 0.9 GiB
  in f32) against the float64 fixed point on the card within 1e-6,
  which the same fixed point with TF32 products must miss;
  the keyword engine's scores for 16,384 users x 4,096 items against
  float64; the walk-forward backtest at 500 tickers over 2,520 days
  (retrain every 20), one retrain's batched OLS held to float64 `lstsq`;
- then the static analyzer (`lint`): `python -m predictionio_tpu_torch
  lint --json` as a subprocess, clean against the port's own baseline
  (no new finding, no stale entry, no parse error), and
  `costmon.analyze_jit` on the card over the serve path's batched top-k
  program at the store model's bucket dims (seeded tables), its FLOPs at
  least 2*b*i*r and its gauges carrying them.

Inside `rest_fold`, on its running event server, `eventserver_client`
reads the rec app through the `eventserver` storage type with the app's
key: its `find_columnar` of the first 262,144 rate events equal to the
SQLite read, its chunked read equal to its own, and 64 events written
through it landing in SQLite once each (deleted again after).

The compile and cost plane rides those phases (no deploy of its own):
`serve` first captures the `batch_predict` ladder (b = 1..32) as CUDA
graphs through the executable registry, each replay bit-equal to the
eager program, and prints each bucket's capture seconds; its queries
must all replay. Each deploy's warm-up (`aotWarm`) captured its
template's ladder, or nothing for a template without `aot_warm_specs`.
After `serve_plane`'s bursts each deployed process must show hit rate
1.0, no miss and no failed bucket (and `serve_plane` prints its
`torch.cuda.memory_allocated()` from `/metrics`), the p50 of its sampled CUDA-event
device ms a window within 5x of this script's own readings of the same
program at 1 and 16 queries, an occupancy above 0, and a strictly parsed
`/metrics` carrying every engine family; `fold_update` and `rest_fold` hold that the `/reload`
captured the new version's buckets, that its answers replayed them and
that the update process booked `fold_side` device time; `fold_inprocess`
scrapes the fold's families; `eventserver` holds its `/metrics` window
counts to the events posted, route by route; `import_export` reads
`cache status`, which must list the three kernel libraries (and the
nativelog library `eventlog.so` where a test run or an earlier smoke in
this checkout built it); after `nativelog_train` it must list all four.

The diagnostics plane rides them too: after `serve_plane`'s bursts
(the deploys' slow-query bound at SLOW_QUERY_MS), `diagnostics` reads
each deploy's `/traces.json` (the query and `batch_predict` span trees,
linked both ways; an inbound `X-PIO-Trace-Id` adopted), an exemplar of
`/metrics?exemplars=1` that resolves, the `/slow.json` waterfalls (count
and median ms of each stage), `/health.json`, `/flight.json`
(`model_load`, `aot_warm`), a torch.profiler device trace over
`/profile.json` around a 32-query burst (CUDA kernels and graph launches
in its Chrome trace) and `status --telemetry --slo`; `eventserver`
holds a distinct `traceId` in every single 201 and resolves the columnar
write's; `rest_fold` resolves each batch's events to its ingest trace;
`feedback` holds each `predict` event's ingest trace to the window that
answered its traced query; `fold_inprocess` posts half of tick 2's views
through an in-process event server and half through an event server
subprocess, and holds the `fold_tick` trace's links to their ingest
traces (both ways for the local ones; the remote batch's resolved
through the fleet), the engine server's `/fleet/traces.json` stitching
the remote batch and the fold tick across two pids, and the tick's CG
launches against the CG kernels of its device trace; `canary` reads the rollback's incident
bundle through `incidents list` and `incidents show`.

The phases before the serve plane hold served scores to f32 and run with
`PIO_SERVE_PACK=exact`.

Prints one JSON line per phase, then the kernels line, the card's name
and power limit as nvidia-smi reports them, and as its last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

Exits non-zero, before printing any result, when CUDA is unavailable, when
the port cannot be imported, or when any phase fails; no phase's failure
is caught. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): device memory
# rate, float32 rate outside the tensor cores, bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
RATE_NOTE = ("H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s f32 on CUDA cores "
             "(data sheet, 700 W)")
BF16_RATE_NOTE = ("H100 SXM: 3.35 TB/s HBM, 989 TFLOP/s bf16 on tensor cores "
                  "(data sheet, dense, 700 W)")

DATA = (138_493, 26_744, 20_000_000)   # users, items, generated ratings:
#                                        data/synthetic.py's ML-20M shape
RANK = 200
LAM = 0.01
ALPHA = 1.0
ITERATIONS = 2
WORK_BUDGET = 1 << 20
KERNEL_REL_TOL = 1e-4     # kernel vs plain CG: same algorithm, same
#                           iteration count, f32 sums in another order
ROUNDING_FACTOR = 4       # on real systems: 4x f32 rounding's reading
FAULT_MARGIN = 10         # a planted fault must move x by >= this many
#                           tolerances, or the check could not see it
CHOL_REL_TOL = 1e-2       # trained rows (fixed-iteration CG) vs Cholesky
CHOL_KERNEL_TOL = 1e-4    # Cholesky kernel vs its plain version: the floor
#                           of the tolerance, ROUNDING_FACTOR x the plain
#                           version's f32-vs-f64 reading where larger
SP_QUERIES = 30           # similar-product queries served
TIE_ATOL = 1e-5           # a served swap is allowed only between items
#                           whose float64 cosine sums differ by less
SCHULZ_STEPS = 18         # the primal Schulz solve's own default
SCHULZ_KERNEL_TOL = 1e-4  # Schulz kernel vs its plain version: the floor
#                           of max(., ROUNDING_FACTOR x the plain version's
#                           f32-vs-f64-sum reading), per shape and checkpoint
SCHULZ_DUAL_SHAPES = ((8, 4375), (176, 5957),   # (K, B): the Schulz path's
                      (56, 9053), (120, 6323),  # dual batches at the ML-20M
                      (144, 6778))              # shape: the smallest K, the
#                           two largest-work batches (176 and 144, 49 % of
#                           the path's flops), and K = 56 and 120, padded to
#                           64 and 128 in the bf16 kernel's geometries
#                           (tests/test_torch_compute_dtype.py)
# (R, B, iters) of the CG kernel phase: the primal, the duals K (K + 8
# steps; K = 8 and 24 take the warp geometry, the rest registers), an odd
# B, and R = 256 (the stream kernel reading A from global memory)
CG_KERNEL_SHAPES = ([(RANK, WORK_BUDGET // RANK, 48)]
                    + [(k, WORK_BUDGET // k, k + 8)
                       for k in (8, 24, 56, 144, 192)]
                    + [(RANK, 1001, 48), (256, 129, 48)])
# (R, B) of the Cholesky kernel phase: the primal, the duals (K = 8 and 24
# packed, 8 a block), an odd B, and R % 8 != 0 (packed)
CHOL_KERNEL_SHAPES = ([(RANK, WORK_BUDGET // RANK)]
                      + [(k, WORK_BUDGET // k) for k in (8, 24, 56, 144, 192)]
                      + [(RANK, 1001), (27, 4099)])
PLAN_BATCHES = 98         # solver calls per iteration at the ML-20M shape
#                           (33 user + 65 item batches, 98 distinct shapes,
#                           so sweep chunk 4 merges none)
KAPPA_HARD = 1e3          # the half-steps fault is held where kappa' =
#                           ||A||_inf / lambda_min reaches this
SCHULZ_QUERIES = 8        # Schulz-trained model's queries served
# the product path: events in the store -> `pio train` -> persisted
# instance -> `pio deploy` (bench.py's bench_product_path at full scale)
# users, items, rate events: 2M since the tenancy phase came in (5M, 4M,
# then 3M before): each time a slow host took the smoke past its 1,200 s
# limit (PERF.md §5, §6, PRs 17 and 19)
STORE_DATA = (138_493, 26_744, 2_000_000)
STORE_LAM = 0.05
STORE_SEEDS = (1, 2)      # the first train's, and the retrain's /reload
STORE_APP = "smokeapp"
STORE_CHUNK = 500_000     # rows a bulk import call
STORE_QUERIES = 30        # known-user queries of each kind served
STORE_YEARS = (1950, 2020)   # creationYear range of the items
SERVE_CLIENTS = 32        # serve_plane: closed-loop client threads
SERVE_PER_CLIENT = 20     # queries each client sends
SERVE_NUM = 10            # num of every serve_plane query: top-k bucket 16
SERVE_K_BUCKET = 16
DEPLOY_TIMEOUT_S = 300    # a deploy subprocess answers GET / by then
SHARDS = 2                # sharded: the model axis on the one card (S)
SHARDED_QUERIES = 16      # sharded_mesh: queries the two processes answer
MESH_TIMEOUT_S = 5.0      # sharded_mesh: the broadcast watchdog
SHARDED_FOLD = (32, 16)   # sharded_fold: touched users, touched items
SHARDED_TOL = 4e-4        # of the factor scale: the ALS parity tolerance
#                           at lam 0.01 (ROADMAP); the store's lam is 0.05
WINDOW_REPS = 20          # sharded_serve: windows timed on each layout
F16_REL = 2.0 ** -11      # f16 rounding to nearest, relative
# inflight_bench: the reference's REST bench shape (bench.py
# bench_rest_latency: 16 concurrent clients, 320 unfiltered queries,
# micro_batch 32), timed with 2 windows in flight and with 1, ABBA
BENCH_CLIENTS = 16
BENCH_PER_CLIENT = 20
BENCH_MICRO_BATCH = 32
BENCH_ORDER = (2, 1, 1, 2)
# the fold-in phases (the reference's `pio update` traffic: max_deltas 256)
FOLD_K_DUAL = (1, 2, 4, 8, 16)   # dual K of the fold's kernel holds
FOLD_B = 16                      # the fold's batch floor (_TOUCHED_FLOOR)
FOLD_INERT = 4                   # inert rows in each held fold batch
FOLD_USERS, FOLD_PER_USER = 48, 4        # fold_update: known users' rates
FOLD_NEW_USERS, FOLD_NEW_PER_USER = 8, 6  # ... new users' rates
FOLD_NEW_ITEMS, FOLD_NEW_ITEM_RATES = 4, 16  # ... new items, rates on them
FOLD_UNTOUCHED_QUERIES = 16
FOLD_VIEWS = (64, 32)            # fold_inprocess: views of tick 1, tick 2
FOLD_NEW_SIMILAR = 2             # new items $set in tick 1
FOLD_H2D_SHARE = 0.01            # tick 2 uploads under 1% of tick 1's
# the result cache (the reference's REST bench row with result_cache=True,
# bench.py bench_rest_latency: 200 seeded users, 16 closed-loop clients,
# 320 queries a burst cycling them, an untimed warm burst of the first
# 64, then 3 timed bursts)
CACHE_USERS = 200
CACHE_WARM = 64
CACHE_BURSTS = 3
CACHE_FOLD_OTHERS = 200          # cache_fold: untouched users asked
# the guarded deploy: a quarter of the windows on the candidate, a window
# the 32-client burst fits in, the reference's 20 samples to judge
CANARY_FRACTION = 0.25
CANARY_WINDOW_S = 5.0
CANARY_MIN_REQUESTS = 20
CANARY_PER_CLIENT = 8
# the other ALS templates on the store: DIMSUM,
# e-commerce with its live business rules, recommended-user
DIMSUM_ROWS = 64                 # seeded rows of the [I, I] table held
DIMSUM_QUERIES = 64
DIMSUM_TABLE_ATOL = 1e-6         # float32 counts are exact; the cosine's
#                                  normalization rounds at 2^-24 relative
ECOM_VIEWS = (75_000, 7)         # (events asked, synthetic_ml20m seed;
ECOM_BUYS = (15_000, 8)          # it gives each user one at least)
ECOM_NEW_USERS = 64              # users with 1-10 views and no rating
ECOM_UNAVAILABLE = 500           # items in each unavailableItems $set
ECOM_HELD = (160, 48, 32)        # ecom_deploy: known, new, unknown users
ECOM_PLANE_MIX = (14, 4, 2)      # ecom_plane, per client: the same kinds
ECOM_POOL = 2000                 # known users drawn from: with seeded
#                                  views or buys, and any
RECUSER_FOLLOWS = (125_000, 9)   # asked; every user gets one: 172,368
RECUSER_APP = "recuserapp"       # the follows' own app
RECUSER_QUERIES = 64
FIELDS_CHUNK = 4                 # als_fields: the ablation rows' sweep_chunk
BF16_RMSE_TOL = 0.02             # bf16 tables vs f32 (tests/test_solve.py)
DUAL_USERS = 20_000              # dual_solve='never': the first users only
DUAL_LAM = 0.1
DUAL_TOL = 1e-4                  # of the factor scale at lam 0.1 (ROADMAP)
EVAL_K = 2                       # rec_eval: folds, query num, the sweep
EVAL_QUERY_NUM = 10
EVAL_LAMS = (0.05,)               # one setting: the smoke's time budget
EVAL_CHUNK = 4096                # users a float64 top-k chunk on the card
CLS_APP = "clsapp"
CLS_USERS = 25_000               # cls_*: one $set a user, 4 classes
CLS_MEANS = ((8.0, 2.0, 1.0), (2.0, 8.0, 1.0), (1.0, 2.0, 8.0),
             (4.0, 4.0, 4.0))    # class-dependent Poisson means of attr0-2
CLS_LAMS = (1.0,)                # one setting: the smoke's time budget
CLS_EVAL_K = 3
CLS_KEEP_ENV = "SMOKE_CLS_KEEP_DIR"   # where cls_eval's sweep keeps models
CLS_NB_TOL = 1e-9                # naive Bayes pi/theta vs float64 numpy:
# the card's class counts and feature sums are sums of small integers,
# exact in float32 below 2**24, and pi and theta are the same float64
# formulas, so only the last bits of the logs may differ
CLS_QUERIES = 64
DATAPLANE_ROWS = 1_000_000       # dataplane: the first rate events streamed
ASYNC_PROBE_ROWS = 8 << 20       # int64 rows of the asynchrony probe: 64 MB
ASYNC_PROBE_TRIES = 3           # ... stagings until one is in flight
MARKOV_NNZ = 5_000_000           # e2: seeded transition counts
MARKOV_TOP_N = 20
MARKOV_STATES_HELD = 16          # state vectors predicted and held
MARKOV_REL_TOL = 1e-6            # float32 atomic sums of ~20 terms a bin
NB_POINTS = 1_000_000            # e2 categorical NB: N, P, values, labels
NB_POSITIONS = 8
NB_VALUES = 64
NB_LABELS = 5
CLS_TIE_REL = 1e-12              # a label may differ only where the top
                                 # two float64 scores tie this closely
CAPTURE_LADDER = 32              # serve: batch buckets 1..32 captured
DEVICE_TIME_FACTOR = 5.0         # a deploy's sampled device ms a window
#                                  within this factor of the script's
#                                  own readings (b 1 to b 16)
# the families the port's engine server registers in a deploy process
# (its own registry and the process-wide one through the parent chain);
# `serve_plane` scrapes /metrics and holds each present
ENGINE_FAMILIES = (
    "pio_aot_compile_seconds_total", "pio_aot_dispatch_fallbacks_total",
    "pio_aot_dispatch_hits_total", "pio_aot_dispatch_misses_total",
    "pio_aot_executables_resident", "pio_compile_cache_hits_total",
    "pio_compile_cache_misses_total",
    "pio_compile_executable_seconds_total",
    "pio_compile_pcache_hits_total", "pio_compile_pcache_misses_total",
    "pio_device_occupancy", "pio_device_syncs_total",
    "pio_device_time_seconds_total", "pio_dispatch_seconds_total",
    "pio_engine_avg_inflight_at_dispatch", "pio_engine_batch_exits_total",
    "pio_engine_batch_wait_seconds", "pio_engine_batched_queries_total",
    "pio_engine_batches_total", "pio_engine_fold_in_events_total",
    "pio_engine_fold_ins_total", "pio_engine_immediate_batches_total",
    "pio_engine_max_batch_size", "pio_engine_model_stale",
    "pio_engine_model_staleness_seconds", "pio_engine_model_swaps_total",
    "pio_engine_predict_seconds_total", "pio_engine_publish_failures_total",
    "pio_engine_query_seconds", "pio_engine_queue_wait_bound_seconds",
    "pio_engine_requests_total", "pio_engine_serving_seconds",
    "pio_engine_serving_seconds_total", "pio_engine_shed_total",
    "pio_engine_swap_to_first_query_ms", "pio_guard_canary_requests_total",
    "pio_guard_canary_state", "pio_guard_promotions_total",
    "pio_guard_rollbacks_total", "pio_hbm_table_bytes",
    "pio_jax_compile_seconds_total", "pio_jax_compiles_total",
    "pio_jax_device_memory_bytes", "pio_jax_device_to_host_bytes_total",
    "pio_jax_host_to_device_bytes_total", "pio_serve_cache_bytes",
    "pio_serve_cache_entries", "pio_serve_cache_evictions_total",
    "pio_serve_cache_hits_total", "pio_serve_cache_invalidations_total",
    "pio_serve_cache_misses_total", "pio_serve_d2h_bytes_total",
    "pio_serve_d2h_seconds_total", "pio_serve_inflight_batches",
    "pio_serve_pipeline_stalls_total", "pio_serve_readback_windows_total",
    "pio_serve_stage_seconds", "pio_tenant_occupancy_share",
    "pio_tenant_serve_d2h_bytes_total")
# and, in a process whose scheduler folded (fold_inprocess)
FOLD_FAMILIES = (
    "pio_fold_tick_seconds", "pio_fold_events_total",
    "pio_fold_upload_bytes_total", "pio_fold_tick_failures_total",
    "pio_fold_read_rows_total", "pio_guard_gate_rejects_total",
    "pio_guard_gate_verdicts_total")
# the event server's own (eventserver)
EVENT_FAMILIES = (
    "pio_event_write_seconds", "pio_ingest_admission_group_size",
    "pio_event_window_start_seconds", "pio_event_window_events",
    "pio_event_window_statuses", "pio_jax_host_to_device_bytes_total",
    "pio_ingest_spilled_total", "pio_ingest_spill_pending_bytes",
    "pio_breaker_state")
KERNEL_LIBRARIES = ["cg_solve.so", "chol_solve.so", "schulz_solve.so"]
HOST_LIBRARY = "eventlog.so"     # csrc/eventlog.cpp, built at first use
# the diagnostics plane (obs/): the serve-plane deploys' slow-query bound
# (the reference's default is the serve-p99 SLO's 250 ms; 50 ms makes
# the 32-client bursts yield a sample of waterfalls: at 100 ms the
# similar-product deploy's server side recorded 0 to 7 slow queries a
# burst), the spans of a window's batch_predict trace, the stages a
# waterfall may hold, and the CG kernels' names in a device trace
SLOW_QUERY_MS = 50
WINDOW_SPANS = ["supplement", "predict", "readback", "post_process"]
SLOW_STAGES = ("queue_wait", "batch_formation", "supplement", "dispatch",
               "device_sync", "completion_wait", "d2h_wait", "unpack",
               "post_process", "serialize")
CG_KERNEL_NAME = r"cg_(warp|reg|stream)_kernel"
ENGINE_SLOS = ["serve_p99", "fold_tick_duration", "model_staleness",
               "guarded_deploys"]
HERE = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's line; `t_s`: seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - T_START}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


@contextlib.contextmanager
def exact_pack():
    """`PIO_SERVE_PACK=exact` for the phases whose holds are f32-exact;
    the default f16 readback is held by `serve_plane`."""
    old = os.environ.get("PIO_SERVE_PACK")
    os.environ["PIO_SERVE_PACK"] = "exact"
    try:
        yield
    finally:
        if old is None:
            del os.environ["PIO_SERVE_PACK"]
        else:
            os.environ["PIO_SERVE_PACK"] = old


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    """Wait for the current stream's work. Never a device-wide
    synchronize: a serve graph may be capturing in another thread, and
    a device-wide synchronize would invalidate the capture."""
    torch.cuda.current_stream().synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cg_cost(B: int, R: int, iters: int):
    """(bytes, flops) one batched CG solve must spend: A and b read once,
    x written once; per iteration a 2R^2 matvec plus ~11R vector flops
    (two dot products, three axpys, the preconditioner)."""
    nbytes = 4 * B * (R * R + 2 * R)
    flops = B * (iters * (2 * R * R + 11 * R) + 4 * R)
    return nbytes, flops


def bound(nbytes: int, flops: int, flops_per_s: float = F32_FLOPS_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| / max |ref| over the whole batch."""
    den = ref.abs().max().item()
    return (x - ref).abs().max().item() / max(den, 1e-30)


def hard_systems(B: int, R: int, gen: torch.Generator):
    """SPD systems at the main path's shapes, built so that a wrong kernel
    shows: the Gram of 2R random rows whose columns fall geometrically
    over one decade (a spread-out spectrum), plus a 1e-2 ridge, then
    scaled symmetrically by e^U(-1,1) so the diagonal varies and the
    Jacobi preconditioner changes every iterate. The rhs is random."""
    s = torch.logspace(0, -1, R, device="cuda")
    V = torch.randn(B, 2 * R, R, device="cuda", generator=gen) * s
    A = torch.bmm(V.transpose(1, 2), V).div_(2 * R)
    del V
    A.diagonal(dim1=1, dim2=2).add_(1e-2)
    d = torch.exp(2 * torch.rand(B, R, device="cuda", generator=gen) - 1)
    A.mul_(d[:, :, None]).mul_(d[:, None, :])
    b = torch.randn(B, R, device="cuda", generator=gen)
    return A.contiguous(), b


def cg_unpreconditioned(A: torch.Tensor, b: torch.Tensor,
                        iters: int) -> torch.Tensor:
    """A planted fault: the plain CG without its Jacobi preconditioner."""
    x, r = torch.zeros_like(b), b
    p, rr = r, (r * r).sum(dim=1)
    for _ in range(iters):
        Ap = torch.bmm(A, p.unsqueeze(-1)).squeeze(-1)
        alpha = rr / torch.clamp((p * Ap).sum(dim=1), min=1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rr2 = (r * r).sum(dim=1)
        p = r + (rr2 / torch.clamp(rr, min=1e-30))[:, None] * p
        rr = rr2
    return x


def checkpoints(iters: int):
    """Iteration counts at which the kernel is held against the plain CG:
    the early iterates pin the algorithm (preconditioner, step and
    direction updates), which a converged answer alone would not."""
    return sorted({1, 2, 4, iters // 2, iters})


CG_FAULTS = ("half_iterations", "no_preconditioner")


def hold_kernel(A: torch.Tensor, b: torch.Tensor, iters: int,
                where: str, faults=CG_FAULTS) -> dict:
    """The kernel against the plain CG at every checkpoint k. Its
    tolerance there is KERNEL_REL_TOL, or ROUNDING_FACTOR times what
    float32 rounding itself moves the plain CG (its float32 run against
    its float64 run) where that is larger, as it is on ill-conditioned
    real systems. The same readings of two planted faults, the kernel run
    with half the iterations it was asked for and a CG without the
    preconditioner, must each exceed the tolerance FAULT_MARGIN-fold at
    some checkpoint, or the check could not tell them from the kernel
    (each fault in `faults`; the others are read only: an implicit dual
    system is I + E with a small E, where CG converges in a step or two
    and the diagonal is ~1). Fails the run otherwise; returns the
    readings."""
    from predictionio_tpu_torch.ops.solve import cg_solve, cg_solve_cuda
    A64, b64 = A.double(), b.double()
    per_k = []
    for k in checkpoints(iters):
        xp = cg_solve(A, b, k)
        xk = cg_solve_cuda(A, b, k)
        check(bool(torch.isfinite(xk).all()),
              f"{where}: non-finite x after {k} iterations")
        rounding = rel_err(xp.double(), cg_solve(A64, b64, k))
        per_k.append({
            "k": k, "rel_err": rel_err(xk, xp),
            "abs_err": (xk - xp).abs().max().item(),
            "rounding": rounding,
            "tolerance": max(KERNEL_REL_TOL, ROUNDING_FACTOR * rounding),
            "half_iterations": (rel_err(cg_solve_cuda(A, b, k // 2), xp)
                                if k >= 2 else 0.0),
            "no_preconditioner": rel_err(cg_unpreconditioned(A, b, k),
                                         xp)})
    out = {"max_rel_err": max(c["rel_err"] for c in per_k),
           "max_abs_err": max(c["abs_err"] for c in per_k),
           "max_rounding": max(c["rounding"] for c in per_k),
           "max_tolerance": max(c["tolerance"] for c in per_k)}
    for fault in CG_FAULTS:
        out[f"fault_{fault}_margin"] = max(c[fault] / c["tolerance"]
                                           for c in per_k)
    emit("checkpoints", where=where, per_checkpoint=per_k)
    for c in per_k:
        check(c["rel_err"] <= c["tolerance"],
              f"{where}: kernel vs plain CG rel err {c['rel_err']:.3g} > "
              f"{c['tolerance']:.3g} after {c['k']} iterations")
    for fault in faults:
        margin = out[f"fault_{fault}_margin"]
        check(margin >= FAULT_MARGIN,
              f"{where}: the check cannot see the planted fault {fault} "
              f"(it moves x by only {margin:.3g} tolerances)")
    return out


def ptxas_functions(log: str) -> dict:
    """{kernel function: {"registers", "spill_stores", "spill_loads"}} from
    `nvcc -Xptxas -v` output (its "Function properties for F" line, the
    spill line below it, then F's "Used N registers" line)."""
    import re
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out[fn]["registers"] = int(m.group(1))
    return out


def phase_device() -> dict:
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.device import resolve_device
    resolve_device("cuda")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    per_source = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_functions(_build.build_log(name))
             for name in per_source}
    info = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s,
            "build_s_by_source": per_source, "ptxas": ptxas}
    emit("device", **info)
    return info


def phase_kernel() -> dict:
    """Kernel vs plain vs Cholesky at the main path's shapes, with the
    reading of two planted faults to show that the check can see them, at
    CG_KERNEL_SHAPES."""
    from predictionio_tpu_torch.ops.solve import (cg_device_geometry,
                                                  cg_geometry,
                                                  cg_smem_optin, cg_solve,
                                                  cg_solve_cuda,
                                                  cholesky_solve)
    optin = cg_smem_optin()
    mirror = [R for R in range(1, 2049)
              if cg_geometry(R, optin) != cg_device_geometry(R)]
    check(not mirror, f"ops/solve.py:cg_geometry differs from the kernel's "
          f"own choice at R = {mirror[:8]}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for R, B, iters in CG_KERNEL_SHAPES:
        A, b = hard_systems(B, R, gen)
        row = {"R": R, "B": B, "iters": iters,
               "geometry": cg_device_geometry(R),
               **hold_kernel(A, b, iters, f"kernel phase R={R} B={B}")}
        xk, xc = cg_solve_cuda(A, b, iters), cholesky_solve(A, b)
        row["bitwise_repeat"] = bool(torch.equal(
            xk, cg_solve_cuda(A, b, iters)))
        row["kernel_vs_cholesky_rel"] = rel_err(xk, xc)
        row["plain_vs_cholesky_rel"] = rel_err(cg_solve(A, b, iters), xc)
        row.update(
            kernel_ms=cuda_ms(lambda: cg_solve_cuda(A, b, iters), 5),
            plain_ms=cuda_ms(lambda: cg_solve(A, b, iters), 3),
            library_ms=cuda_ms(
                lambda: torch.linalg.solve(A, b.unsqueeze(-1)), 3))
        nbytes, flops = cg_cost(B, R, iters)
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
        row["bytes"], row["flops"], row["rates"] = nbytes, flops, RATE_NOTE
        row["achieved_tflops"] = flops / row["kernel_ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        emit("kernel", **row)
        check(row["bitwise_repeat"], f"two CG kernel launches differ at "
              f"R={R} B={B}")
        # the issue's bar on these systems: 1e-4 whatever rounding reads
        check(row["max_rel_err"] <= KERNEL_REL_TOL,
              f"kernel vs plain CG rel err {row['max_rel_err']:.3g} > "
              f"{KERNEL_REL_TOL} at R={R} B={B}")
        rows.append(row)
        del A, b, xk, xc
    # plan padding rows: A = reg*I, b = 0 must solve to exactly 0, in
    # every geometry
    for R in (RANK, 8, 27, 56, 232, 256):
        A = (LAM * torch.eye(R, device="cuda")).expand(3, R, R)
        x0 = cg_solve_cuda(A.contiguous(), torch.zeros(3, R, device="cuda"))
        check(bool((x0 == 0).all()), f"padding systems (R={R}, "
              f"{cg_device_geometry(R)}) did not solve to 0")
    emit("kernel_padding", exact_zero=True)
    torch.cuda.empty_cache()
    return {"rows": rows}


def phase_train():
    """The main path's train: data source -> preparator -> ALS train."""
    from predictionio_tpu_torch.data.synthetic import synthetic_ml20m
    from predictionio_tpu_torch.models.common import RatingsData
    from predictionio_tpu_torch.models.recommendation import (
        ALSAlgorithm, ALSAlgorithmParams, DataSourceParams,
        RecommendationDataSource, RecommendationPreparator)
    from predictionio_tpu_torch.ops.solve import COUNTS

    t0 = time.perf_counter()
    u, i, r = synthetic_ml20m(*DATA, seed=0)
    td = RecommendationDataSource(
        DataSourceParams(ratings=RatingsData(u, i, r))).read_training()
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pd = RecommendationPreparator().prepare(td)
    prepare_s = time.perf_counter() - t0
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=RANK,
                                           num_iterations=ITERATIONS,
                                           lam=LAM, seed=0, solver="auto"))
    COUNTS.reset()
    t0 = time.perf_counter()
    model = algo.train(pd)
    sync()
    train_s = time.perf_counter() - t0
    launches, plain = COUNTS.cg_solve, COUNTS.cg_solve_plain
    tel = algo.last_train_telemetry
    U, V = model.als.tables()
    finite = bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all())

    coo = pd.ratings_coo
    sample = np.random.default_rng(1).choice(coo.nnz, min(100_000, coo.nnz),
                                             replace=False)
    from predictionio_tpu_torch.ops.als import predict_ratings
    pred = predict_ratings(model.als, coo.user_idx[sample],
                           coo.item_idx[sample])
    rmse = float(np.sqrt(np.mean((pred - coo.rating[sample]) ** 2)))
    emit("train", users=coo.n_users, items=coo.n_items,
         rank=RANK, iterations=ITERATIONS, lam=LAM, data_s=data_s,
         prepare_s=prepare_s, train_s=train_s,
         **{k: v for k, v in tel.items()},
         cg_kernel_launches=launches, plain_cg_calls=plain,
         factors_finite=finite, train_rmse_100k=rmse)
    check(launches > 0, "the CG kernel was never launched")
    check(launches == tel["solver_calls"],
          f"{launches} kernel launches for {tel['solver_calls']} solver "
          "calls")
    check(plain == 0, f"the plain CG ran {plain} times on the main path")
    check(finite, "trained factors are not finite")
    check(np.isfinite(rmse), "train RMSE is not finite")
    resolve_check(model.als, coo)
    return algo, model, launches, pd, (sample, rmse)


def resolve_check(als, coo) -> None:
    """Re-solve one primal and one dual item-side bucket from the final
    user table: the trained item rows came from the kernel on exactly
    these systems (the item half-sweep ran last). On these real lam=0.01
    systems the kernel is also held against the plain CG at every
    checkpoint, and against Cholesky."""
    from predictionio_tpu_torch.ops.als import normal_equations
    from predictionio_tpu_torch.ops.ratings import plan_for_items
    from predictionio_tpu_torch.ops.solve import (cg_solve_cuda,
                                                  cholesky_solve)
    U, V = als.tables()
    plan = plan_for_items(coo, work_budget=WORK_BUDGET)
    primal = next(b for b in plan.batches if b.shape[1] >= RANK)
    dual = max((b for b in plan.batches if b.shape[1] < RANK),
               key=lambda b: b.shape[0])
    for batch in (primal, dual):
        rows = torch.from_numpy(batch.rows).cuda().long()
        kind, A, rhs, to_rows = normal_equations(
            U, torch.from_numpy(batch.idx).cuda().long(),
            torch.from_numpy(batch.val).cuda(),
            torch.from_numpy(batch.mask).cuda(), LAM, RANK)
        K = batch.shape[1]
        iters = 48 if kind == "primal" else K + 8
        held = hold_kernel(A, rhs, iters, f"real {kind} bucket K={K}")
        xk, xc = cg_solve_cuda(A, rhs, iters), cholesky_solve(A, rhs)
        xk, xc = to_rows(xk), to_rows(xc)
        real = rows >= 0
        trained = V[rows[real]]
        out = {"kind": kind, "K": K, "B": batch.shape[0], **held,
               "trained_vs_resolve_rel": rel_err(trained, xk[real]),
               "kernel_vs_cholesky_rel": rel_err(xk[real], xc[real]),
               "tolerance_cholesky": CHOL_REL_TOL}
        emit("train_resolve", **out)
        check(out["trained_vs_resolve_rel"] <= KERNEL_REL_TOL,
              f"trained {kind} rows differ from a kernel re-solve")
        check(out["kernel_vs_cholesky_rel"] <= CHOL_REL_TOL,
              f"{kind} bucket: CG vs Cholesky rel err "
              f"{out['kernel_vs_cholesky_rel']:.3g} > {CHOL_REL_TOL}")


def post_raw(url: str, body: bytes):
    """(status, the response's bytes, its headers)."""
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def post(url: str, body: bytes):
    status, data, _ = post_raw(url, body)
    return status, json.loads(data)


def capture_ladder(model) -> dict:
    """Capture the `batch_predict` executable of `model` for every batch
    bucket 1..CAPTURE_LADDER through the registry (`compile/aot.py`):
    each must be a CUDA graph whose replay is bit-equal to the eager
    program on the same padded batch. Returns the capture seconds by
    bucket (the first pays the tables' upload at their row buckets), a
    replay's device ms from the graph's own stamps and the eager
    program's (`cuda_ms`)."""
    from predictionio_tpu_torch.compile import buckets as B
    from predictionio_tpu_torch.compile.aot import GraphExecutable, get_aot
    from predictionio_tpu_torch.obs import costmon
    from predictionio_tpu_torch.ops import als as ALS
    from predictionio_tpu_torch.utils.device_cache import cached_put_rows
    ALS.register_aot_specs()
    aot, als = get_aot(), model.als
    rng = np.random.default_rng(14)
    capture_s, replay_ms, eager_ms = {}, {}, {}
    for b in B.batch_ladder(CAPTURE_LADDER):
        dims = ALS.batch_predict_dims(als, b, SERVE_NUM)
        t0 = time.perf_counter()
        exe = aot.ensure(costmon.BATCH_PREDICT, dims, (als,))
        capture_s[b] = time.perf_counter() - t0
        check(isinstance(exe, GraphExecutable),
              f"bucket b{b} was not captured as a CUDA graph: {exe!r}")
        ixs = torch.tensor(rng.integers(0, als.n_users, dims["b"]),
                           device=als.device)
        U = cached_put_rows(als.user_factors, dims["u"], als.device)
        V = cached_put_rows(als.item_factors, dims["i"], als.device)
        eager = ALS._users_topk_b(U, V, ixs, als.n_items, dims["k"],
                                  dims["p"])
        replay = exe(ixs)
        check(torch.equal(replay, eager),
              f"bucket b{b}: the replay differs from the eager dispatch")
        stamps = []
        exe(ixs, sample=stamps.append)
        exe.poll(wait=True)
        replay_ms[b] = stamps[0] * 1e3
        eager_ms[b] = cuda_ms(lambda: ALS._users_topk_b(
            U, V, ixs, als.n_items, dims["k"], dims["p"]), 10)
    return {"capture_s": capture_s, "replay_device_ms": replay_ms,
            "eager_device_ms": eager_ms}


def phase_serve(algo, model, phase: str = "serve",
                n_users: int = 31) -> None:
    """Serve the trained model over HTTP; hold the answers for `n_users`
    known users against a float64 numpy top-k on the served tables. The
    `serve` phase first captures the `batch_predict` ladder (b = 1..32,
    `capture_ladder`) and then holds that every query replayed a graph:
    the registry's hits grow by the queries asked, its misses not."""
    from predictionio_tpu_torch.compile.aot import get_aot
    from predictionio_tpu_torch.core import Engine, EngineParams, \
        TrainResult
    from predictionio_tpu_torch.core.base import FirstServing
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    engine = Engine({}, {}, {"als": type(algo)}, {"": FirstServing})
    server = EngineServer(ServerConfig(ip="127.0.0.1", port=0), engine,
                          EngineParams(serving_params=("", None)),
                          TrainResult(models=[model], algorithms=[algo]))
    server.start(background=True)
    ladder = capture_ladder(model) if phase == "serve" else {}
    aot0 = get_aot().snapshot()
    try:
        url = f"http://127.0.0.1:{server.config.port}/queries.json"
        U64 = model.als.user_factors.astype(np.float64)
        V64 = model.als.item_factors.astype(np.float64)
        users = np.random.default_rng(2).choice(len(model.user_ix), n_users,
                                                replace=False)
        lat, exact, ties = [], 0, 0
        for uix in users:
            user = model.user_ix.id_of(int(uix))
            t0 = time.perf_counter()
            status, body = post(url, json.dumps(
                {"user": user, "num": 10}).encode())
            lat.append(time.perf_counter() - t0)
            check(status == 200, f"query for {user} answered {status}")
            got = [s["item"] for s in body["itemScores"]]
            s64 = V64 @ U64[uix]
            top = np.argsort(-s64, kind="stable")[:10]
            want = model.item_ix.ids_of(top)
            if got == want:
                exact += 1
                continue
            # a swap is allowed only between items whose float64 scores
            # tie within float32 rounding
            got_ix = [model.item_ix[g] for g in got]
            scale = np.abs(s64[top]).max()
            check(len(got) == 10 and np.allclose(
                np.sort(s64[got_ix])[::-1], s64[top], rtol=0,
                atol=1e-6 * scale),
                f"user {user}: served {got} != float64 top-10 {want}")
            ties += 1
        t0 = time.perf_counter()
        status, body = post(url, b'{"user": "no-such-user", "num": 10}')
        lat.append(time.perf_counter() - t0)
        check(status == 200 and body == {"itemScores": []},
              f"unknown user answered {status} {body}")
        status, _ = post(url, b'{"user": ')
        check(status == 400, f"malformed body answered {status}")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.config.port}/", timeout=60) as r:
            check(r.status == 200, "GET / failed")
        ms = np.array(lat) * 1e3
        aot1 = get_aot().snapshot()
        replays = (aot1["dispatchHits"].get("batch_predict", 0)
                   - aot0["dispatchHits"].get("batch_predict", 0))
        misses = (aot1["dispatchMisses"].get("batch_predict", 0)
                  - aot0["dispatchMisses"].get("batch_predict", 0))
        if ladder:
            check(replays == n_users and misses == 0,
                  f"{n_users} queries made {replays} replays and {misses} "
                  "misses of the captured ladder")
        emit(phase, queries=len(lat), ids_equal_f64=exact,
             f32_tie_swaps=ties, unknown_user_empty=True,
             malformed_400=True, p50_ms=float(np.percentile(ms, 50)),
             p99_ms=float(np.percentile(ms, 99)), **ladder,
             executables_resident=aot1["executablesResident"],
             graph_replays=replays, dispatch_misses=misses)
    finally:
        server.stop()


def chol_cost(B: int, R: int):
    """(bytes, flops) one batched Cholesky solve must spend: A's lower
    triangle (all the kernel reads of a symmetric A) and b read once, x
    written once; R^3/3 flops to factor and 2R^2 to substitute, per
    system."""
    return 4 * B * (R * (R + 1) // 2 + 2 * R), B * (R ** 3 // 3 + 2 * R * R)


# Planted faults of the Cholesky check (`chol_faults`). On a system
# I + E with a small coupling E (the implicit path's eig-SMW dual systems)
# a skipped trailing update, A22 -= L21 L21^T with L21 ~ E, moves x only to
# second order in E; the other two move it to first order.
CHOL_FAULTS = ("no_back_substitution", "skipped_forward_update",
               "skipped_trailing_update")
FIRST_ORDER_CHOL_FAULTS = CHOL_FAULTS[:2]


def chol_faults(A: torch.Tensor, b: torch.Tensor, names) -> dict:
    """The planted faults in `names`, built from the plain solve's own
    pieces:
    - no_back_substitution: x = y, the forward substitution's answer;
    - skipped_forward_update: panel p = n_panels // 2's forward update
      b_p -= L[p, :p] y[:p] left out, so y_p solves L_pp y_p = b_p (the
      forward substitution run with L[p, :p] zeroed), then the true back
      substitution;
    - skipped_trailing_update: the middle panel p's trailing update
      A22 -= L21 L21^T left out. That factors A + E exactly, with
      E = L21 L21^T on panel p's trailing block, so it is computed as the
      plain solve of A + E.
    The last two are absent when R is one panel."""
    from predictionio_tpu_torch.ops.solve import (CHOL_PANEL, chol_back,
                                                  chol_factor, chol_forward,
                                                  pad_to_panel)
    R = b.shape[1]
    Ap, bp = pad_to_panel(A, b)
    L = chol_factor(Ap)
    n_panels = Ap.shape[1] // CHOL_PANEL
    faults = {}
    if "no_back_substitution" in names:
        faults["no_back_substitution"] = chol_forward(L, bp)[:, :R]
    if n_panels > 1 and "skipped_forward_update" in names:
        c0 = n_panels // 2 * CHOL_PANEL
        Lf = L.clone()
        Lf[:, c0:c0 + CHOL_PANEL, :c0] = 0.0
        faults["skipped_forward_update"] = chol_back(
            L, chol_forward(Lf, bp))[:, :R]
    if n_panels > 1 and "skipped_trailing_update" in names:
        c0 = (n_panels - 1) // 2 * CHOL_PANEL
        r0 = c0 + CHOL_PANEL
        L21 = L[:, r0:, c0:r0]
        Af = Ap.clone()
        Af[:, r0:, r0:] += torch.bmm(L21, L21.transpose(1, 2))
        Lf = chol_factor(Af)
        faults["skipped_trailing_update"] = chol_back(
            Lf, chol_forward(Lf, bp))[:, :R]
    return faults


def hold_chol(A: torch.Tensor, b: torch.Tensor, where: str, faults):
    """The Cholesky kernel against its plain version, and both against the
    plain version in float64. The tolerance is CHOL_KERNEL_TOL, or
    ROUNDING_FACTOR times what float32 rounding moves the plain version
    (its f32 run against its f64 run) where that is larger. Each planted
    fault named in `faults` (`chol_faults`) must miss the plain version by
    FAULT_MARGIN tolerances. Fails the run otherwise; returns (readings,
    kernel x)."""
    from predictionio_tpu_torch.ops.solve import chol_solve, chol_solve_cuda
    xk = chol_solve_cuda(A, b)
    check(bool(torch.isfinite(xk).all()), f"{where}: non-finite x")
    xp = chol_solve(A, b)
    x64 = chol_solve(A.double(), b.double())
    rounding = rel_err(xp.double(), x64)
    tol = max(CHOL_KERNEL_TOL, ROUNDING_FACTOR * rounding)
    out = {"rel_err": rel_err(xk, xp), "abs_err": (xk - xp).abs().max().item(),
           "kernel_vs_f64": rel_err(xk.double(), x64),
           "plain_vs_f64": rounding, "tolerance": tol}
    del x64
    margins = {name: rel_err(xf, xp) / tol
               for name, xf in chol_faults(A, b, faults).items()}
    out.update({f"fault_{name}_margin": m for name, m in margins.items()})
    check(out["rel_err"] <= tol,
          f"{where}: Cholesky kernel vs plain rel err {out['rel_err']:.3g} "
          f"> {tol:.3g}")
    check(out["kernel_vs_f64"] <= tol,
          f"{where}: Cholesky kernel vs float64 rel err "
          f"{out['kernel_vs_f64']:.3g} > {tol:.3g}")
    for name, m in margins.items():
        check(m >= FAULT_MARGIN,
              f"{where}: the check cannot see the planted fault {name} (it "
              f"moves x by only {m:.3g} tolerances)")
    return out, xk


def phase_chol_kernel() -> dict:
    """The Cholesky kernel at the implicit path's shapes (primal R = rank
    and the eig-SMW dual K < rank, B = work budget / K), an odd B and an R
    that is not a multiple of 8, on systems whose spectrum spreads over
    ~1e3-1e4 (`hard_systems`)."""
    from predictionio_tpu_torch.ops.solve import (chol_device_threads,
                                                  chol_layout,
                                                  chol_max_rank,
                                                  chol_rank_limit,
                                                  chol_solve,
                                                  chol_solve_cuda,
                                                  cg_smem_optin)
    max_rank = chol_max_rank(torch.device("cuda"))
    check(max_rank == chol_rank_limit(cg_smem_optin()),
          f"the Cholesky kernel takes R <= {max_rank}, ops/solve.py:"
          f"chol_rank_limit says {chol_rank_limit(cg_smem_optin())}")
    mirror = [R for R in range(1, max_rank + 1)
              if chol_layout(R)[1] != chol_device_threads(R)]
    check(not mirror, f"ops/solve.py:chol_layout's threads differ from the "
          f"kernel's at R = {mirror[:8]}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = []
    for R, B in CHOL_KERNEL_SHAPES:
        A, b = hard_systems(B, R, gen)
        held, _ = hold_chol(A, b, f"chol phase R={R} B={B}",
                            CHOL_FAULTS)
        cond = torch.linalg.cond(A[:8].double())
        geometry, threads, per_block, smem = chol_layout(R)
        row = {"R": R, "B": B, "geometry": geometry, "threads": threads,
               "systems_per_block": per_block, "smem_bytes": smem, **held,
               "bitwise_repeat": bool(torch.equal(chol_solve_cuda(A, b),
                                                  chol_solve_cuda(A, b))),
               "cond_of_8": [float(cond.min()), float(cond.max())],
               "kernel_ms": cuda_ms(lambda: chol_solve_cuda(A, b), 5),
               "plain_ms": cuda_ms(lambda: chol_solve(A, b), 2),
               "library_ms": cuda_ms(
                   lambda: torch.linalg.solve(A, b.unsqueeze(-1)), 3)}
        nbytes, flops = chol_cost(B, R)
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
        row["bytes"], row["flops"], row["rates"] = nbytes, flops, RATE_NOTE
        row["achieved_tflops"] = flops / row["kernel_ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        emit("chol_kernel", **row)
        check(row["bitwise_repeat"], f"two Cholesky kernel launches differ "
              f"at R={R} B={B}")
        rows.append(row)
        del A, b
    for R in (RANK, 27):        # plan padding rows: A = reg*I, b = 0
        A = (LAM * torch.eye(R, device="cuda")).expand(3, R, R).contiguous()
        x0 = chol_solve_cuda(A, torch.zeros(3, R, device="cuda"))
        check(bool((x0 == 0).all()), f"padding systems (R={R}) did not "
              "solve to exactly 0")
    emit("chol_kernel_padding", exact_zero=True, max_rank=max_rank)
    torch.cuda.empty_cache()
    return {"rows": rows}


def similar_training_data():
    """The implicit path's data: synthetic_ml20m's (user, item) pairs as
    view events of value 1 (string ids), every item $set with 1-3
    synthetic categories."""
    from predictionio_tpu_torch.data.synthetic import (
        synthetic_item_categories, synthetic_ml20m)
    from predictionio_tpu_torch.models.common import RatingsData
    from predictionio_tpu_torch.models.similarproduct import Item
    n_users, n_items, n_ratings = DATA
    u, i, _ = synthetic_ml20m(n_users, n_items, n_ratings, seed=0)
    cats = synthetic_item_categories(n_items, seed=0)
    items = {str(k): Item(cats[k], properties={"categories": list(cats[k])})
             for k in range(n_items)}
    views = RatingsData(u.astype(f"U{len(str(n_users))}"),
                        i.astype(f"U{len(str(n_items))}"),
                        np.ones(len(u), dtype=np.float32))
    return items, views


def phase_implicit_train(explicit_pairs: int):
    """The similar-product path's train: data source -> preparator ->
    implicit ALSAlgorithm.train with solver 'chol_cuda'."""
    from predictionio_tpu_torch.models.similarproduct import (
        ALSAlgorithm, ALSAlgorithmParams, DataSourceParams,
        SimilarProductDataSource, SimilarProductPreparator)
    from predictionio_tpu_torch.ops.solve import COUNTS

    t0 = time.perf_counter()
    items, views = similar_training_data()
    td = SimilarProductDataSource(DataSourceParams(
        items=items, view_events=views)).read_training()
    pd = SimilarProductPreparator().prepare(td)
    data_s = time.perf_counter() - t0
    algo = ALSAlgorithm(ALSAlgorithmParams(
        rank=RANK, num_iterations=ITERATIONS, lam=LAM, alpha=ALPHA, seed=0,
        solver="chol_cuda"))
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    COUNTS.reset()
    t0 = time.perf_counter()
    model = algo.train(pd)
    sync()
    train_s = time.perf_counter() - t0
    counts = dict(vars(COUNTS))
    peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    tel = algo.last_train_telemetry
    finite = all(bool(np.isfinite(t).all()) for t in (
        model.user_factors, model.item_factors_raw,
        model.item_factors_normalized))
    emit("implicit_train", users=len(model.user_ix), items=len(model.item_ix),
         view_events=len(views), distinct_pairs=tel["ratings"], rank=RANK,
         iterations=ITERATIONS, lam=LAM, alpha=ALPHA, solver="chol_cuda",
         data_s=data_s, train_s=train_s, **tel, launch_counts=counts,
         peak_device_gb_over_start=peak_gb, factors_finite=finite)
    check(counts["chol_solve"] > 0, "the Cholesky kernel was never launched")
    check(counts["chol_solve"] == tel["solver_calls"],
          f"{counts['chol_solve']} Cholesky kernel launches for "
          f"{tel['solver_calls']} solver calls")
    for name in ("chol_solve_plain", "cg_solve_plain", "cg_solve"):
        check(counts[name] == 0, f"{name} ran {counts[name]} times on the "
              "implicit path")
    check(finite, "trained factors are not finite")
    check(tel["ratings"] == explicit_pairs,
          f"{tel['ratings']} distinct view pairs, but the explicit path's "
          f"dedup kept {explicit_pairs} of the same pairs")
    implicit_resolve_check(algo, model, td)
    return algo, model, counts["chol_solve"], pd


def implicit_resolve_check(algo, model, td) -> None:
    """Re-solve one primal and one dual item-side bucket of the trained
    model from its final user table (the item half-sweep ran last, on the
    Gram of exactly that table) and hold the kernel on these real systems
    with `hold_chol` (all planted faults on the primal bucket, the
    first-order ones on the dual); the trained item rows must equal the
    re-solve. On the primal bucket also read how far 48 iterations of the CG kernel
    (the card's 'auto' solver) land from the Cholesky answer: a reading,
    not a check."""
    from predictionio_tpu_torch.ops.als import gram_eig, implicit_equations
    from predictionio_tpu_torch.ops.ratings import plan_for_items
    from predictionio_tpu_torch.ops.solve import (CG_PRIMAL_ITERS,
                                                  cg_solve_cuda)
    _, _, coo = algo._build_ratings(td)
    U = torch.tensor(model.user_factors, device="cuda")
    V = torch.tensor(model.item_factors_raw, device="cuda")
    # the fit on 100k observed pairs: predicted preference u.v against 1
    sample = torch.from_numpy(np.random.default_rng(1).choice(
        coo.nnz, min(100_000, coo.nnz), replace=False)).cuda()
    pred = (U[torch.from_numpy(coo.user_idx).cuda()[sample].long()]
            * V[torch.from_numpy(coo.item_idx).cuda()[sample].long()]
            ).sum(dim=1)
    rmse = float(torch.sqrt(((pred - 1.0) ** 2).mean()))
    emit("implicit_fit", preference_rmse_100k=rmse)
    check(np.isfinite(rmse), "implicit preference RMSE is not finite")
    gram = gram_eig(U)
    plan = plan_for_items(coo, work_budget=WORK_BUDGET)
    primal = max((b for b in plan.batches if b.shape[1] >= RANK),
                 key=lambda b: b.shape[0])
    dual = max((b for b in plan.batches if b.shape[1] < RANK),
               key=lambda b: b.shape[0])
    for batch in (primal, dual):
        rows = torch.from_numpy(batch.rows).cuda().long()
        kind, A, rhs, to_rows = implicit_equations(
            U, gram, torch.from_numpy(batch.idx).cuda().long(),
            torch.from_numpy(batch.val).cuda(),
            torch.from_numpy(batch.mask).cuda(), LAM, ALPHA, RANK)
        K = batch.shape[1]
        coupling = (A - torch.diag_embed(A.diagonal(dim1=1, dim2=2))
                    ).abs().max().item() if kind == "dual" else None
        # the dual systems are I + E with a small E: hold the faults that
        # move x to first order in E there (see CHOL_FAULTS)
        held, xk = hold_chol(
            A, rhs, f"real implicit {kind} bucket K={K}",
            CHOL_FAULTS if kind == "primal" else FIRST_ORDER_CHOL_FAULTS)
        real = rows >= 0
        out = {"kind": kind, "K": K, "B": batch.shape[0],
               "max_abs_offdiag": coupling, **held,
               "trained_vs_resolve_rel": rel_err(V[rows[real]],
                                                 to_rows(xk)[real])}
        if kind == "primal":
            xcg = cg_solve_cuda(A, rhs, CG_PRIMAL_ITERS)
            out["cg48_vs_cholesky_rel"] = rel_err(xcg, xk)
            out["cg48_rows_vs_cholesky_rows_rel"] = rel_err(
                to_rows(xcg)[real], to_rows(xk)[real])
        emit("implicit_resolve", **out)
        check(out["trained_vs_resolve_rel"] <= KERNEL_REL_TOL,
              f"trained implicit {kind} rows differ from a kernel re-solve "
              f"by {out['trained_vs_resolve_rel']:.3g}")
        del A, rhs, xk


def f64_cosine_top(T64: np.ndarray, algo, model, query, k: int):
    """Float64 reference of the served answer: summed cosines of the
    re-normalized query rows against the served normalized table, under
    the same candidate mask and the score > 0 rule. Returns (scores with
    -inf where excluded, top ids)."""
    from predictionio_tpu_torch.models.common import resolve_ids
    q_ix = resolve_ids(model.item_ix, query.items)
    Q = T64[q_ix]
    Q = Q / np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-12)
    s = T64 @ Q.sum(axis=0)
    s = np.where(algo._build_mask(model, query, q_ix) & (s > 0), s,
                 -np.inf)
    top = np.argsort(-s, kind="stable")[:k]
    return s, top[np.isfinite(s[top])]


def held_to_f64(got_ids, s64, top, model, what: str,
                atol: float = TIE_ATOL) -> bool:
    """True when the served ids equal the float64 top-k; False for a swap
    between items whose float64 scores tie within `atol`; fails the run
    otherwise."""
    want = model.item_ix.ids_of(top)
    if got_ids == want:
        return True
    got_ix = [model.item_ix[g] for g in got_ids]
    check(len(got_ids) == len(want)
          and bool(np.isfinite(s64[got_ix]).all())
          and np.allclose(np.sort(s64[got_ix])[::-1], s64[top], rtol=0,
                          atol=atol),
          f"{what}: served {got_ids} != float64 top {want}")
    return False


def phase_similar_serve(algo, model) -> None:
    """Serve the implicit model over HTTP; hold every answer against a
    float64 cosine top-k, and batch_predict against the single answers."""
    from predictionio_tpu_torch.core import Engine, EngineParams, \
        TrainResult
    from predictionio_tpu_torch.core.base import FirstServing
    from predictionio_tpu_torch.models.similarproduct import Query
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    engine = Engine({}, {}, {"als": type(algo)}, {"": FirstServing})
    server = EngineServer(ServerConfig(ip="127.0.0.1", port=0), engine,
                          EngineParams(serving_params=("", None)),
                          TrainResult(models=[model], algorithms=[algo]))
    T64 = model.item_factors_normalized.astype(np.float64)
    n_items = len(model.item_ix)
    cats = sorted({c for cs in model.item_categories if cs for c in cs})
    rng = np.random.default_rng(3)
    queries = []
    for n in range(SP_QUERIES):
        q_ix = rng.choice(n_items, 1 + n % 3, replace=False)
        q = {"items": model.item_ix.ids_of(q_ix), "num": 10}
        _, top = f64_cosine_top(T64, algo, model, Query.from_dict(q), 10)
        if n % 3 == 1:
            q["categories"] = [str(c) for c in
                               rng.choice(cats, 1 + n % 2, replace=False)]
        if n % 5 == 2:      # the best five and some others
            q["blackList"] = model.item_ix.ids_of(np.concatenate(
                [top[:5], rng.choice(n_items, 20)]))
        if n % 5 == 4:      # a few of the best among 300 others
            q["whiteList"] = model.item_ix.ids_of(np.concatenate(
                [top[::3], rng.choice(n_items, 300)]))
        queries.append(q)
    server.start(background=True)
    try:
        url = f"http://127.0.0.1:{server.config.port}/queries.json"
        lat, exact, ties, single = [], 0, 0, []
        for q in queries:
            t0 = time.perf_counter()
            status, body = post(url, json.dumps(q).encode())
            lat.append(time.perf_counter() - t0)
            check(status == 200, f"query {q} answered {status}")
            got = [s["item"] for s in body["itemScores"]]
            check(len(got) > 0, f"query {q} answered no items")
            s64, top = f64_cosine_top(T64, algo, model, Query.from_dict(q),
                                      q["num"])
            if held_to_f64(got, s64, top, model, f"query {q}"):
                exact += 1
            else:
                ties += 1
            single.append(body["itemScores"])
        t0 = time.perf_counter()
        status, body = post(url, b'{"items": ["no-such-item"], "num": 10}')
        lat.append(time.perf_counter() - t0)
        check(status == 200 and body == {"itemScores": []},
              f"unknown item answered {status} {body}")
        status, _ = post(url, b'{"items": ')
        check(status == 400, f"malformed body answered {status}")
        status, _ = post(url, b'{"num": 3}')
        check(status == 400, f"body without items answered {status}")
        batched = dict(algo.batch_predict(
            model, [(n, Query.from_dict(q)) for n, q in enumerate(queries)]))
        batch_exact = 0
        for n, q in enumerate(queries):
            got = [s.item for s in batched[n].item_scores]
            want = [s["item"] for s in single[n]]
            if got == want:
                batch_exact += 1
                check(np.allclose([s.score for s in batched[n].item_scores],
                                  [s["score"] for s in single[n]], rtol=0,
                                  atol=TIE_ATOL),
                      f"query {q}: batch_predict scores differ")
                continue
            s64, top = f64_cosine_top(T64, algo, model, Query.from_dict(q),
                                      q["num"])
            held_to_f64(got, s64, top, model, f"batch_predict {q}")
        ms = np.array(lat) * 1e3
        emit("similar_serve", queries=len(lat), ids_equal_f64=exact,
             f32_tie_swaps=ties, batch_equal_single=batch_exact,
             with_categories=sum("categories" in q for q in queries),
             with_black_list=sum("blackList" in q for q in queries),
             with_white_list=sum("whiteList" in q for q in queries),
             unknown_items_empty=True, malformed_400=True,
             p50_ms=float(np.percentile(ms, 50)),
             p99_ms=float(np.percentile(ms, 99)))
    finally:
        server.stop()


def schulz_cost(B: int, R: int, iters: int):
    """(bytes, flops) one batched Schulz solve must spend: A and b read
    once, x written once; two R x R x R products a step (4 iters R^3
    flops), x = X b and two refinements (10 R^2), per system."""
    return 4 * B * (R * R + 2 * R), B * (4 * iters * R ** 3 + 10 * R * R)


def schulz_iterates(A: torch.Tensor, steps: int, cd: str, snap: int):
    """A copy of the plain `schulz_solve`'s loop that runs exactly `steps`
    steps and also returns the iterate after `snap` steps."""
    from predictionio_tpu_torch.ops.solve import round_operand
    R = A.shape[-1]
    alpha = 1.0 / torch.clamp(A.abs().sum(dim=-1).amax(dim=-1), min=1e-30)
    X = alpha[:, None, None] * torch.eye(R, dtype=A.dtype, device=A.device)
    Ac = round_operand(A, cd)
    X_snap = X
    for step in range(steps):
        Xc = round_operand(X, cd)
        X = 2.0 * X - torch.bmm(Xc, round_operand(torch.bmm(Ac, Xc), cd))
        if step + 1 == snap:
            X_snap = X
    return X, X_snap


def schulz_refine(A_res: torch.Tensor, X: torch.Tensor, b: torch.Tensor,
                  n: int) -> torch.Tensor:
    """The plain version's tail: x = X b, then n refinements
    x += X (b - A_res x)."""
    x = torch.bmm(X, b.unsqueeze(-1)).squeeze(-1)
    for _ in range(n):
        r = b - torch.bmm(A_res, x.unsqueeze(-1)).squeeze(-1)
        x = x + torch.bmm(X, r.unsqueeze(-1)).squeeze(-1)
    return x


# Planted faults of the Schulz check (`hold_schulz`), each a copy of the
# plain version with one change: the two refinements left out; the
# refinement residual taken against the bf16-rounded A (bf16 mode only);
# the iteration stopped at half its steps (held where kappa' >= KAPPA_HARD,
# where half the steps cannot have converged).
SCHULZ_FAULTS = ("no_refinement", "rounded_residual", "half_steps")


def kappa_prime(A: torch.Tensor) -> float:
    """max over the first 8 systems of ||A||_inf / lambda_min."""
    A8 = A[:8].double()
    lam = torch.linalg.eigvalsh(A8)[:, 0]
    return float((A8.abs().sum(dim=-1).amax(dim=-1) / lam).max())


def schulz_checkpoints(iters: int):
    return sorted({1, 2, 5, iters})


def hold_schulz(A: torch.Tensor, b: torch.Tensor, iters: int, cd: str,
                where: str, gate_faults: bool = True) -> dict:
    """The Schulz kernel against the plain `schulz_solve` at checkpoints
    1, 2, 5 and `iters` steps. The tolerance there is SCHULZ_KERNEL_TOL,
    or ROUNDING_FACTOR times what the order of the f32 sums moves the
    plain version (its f32-sum run against its f64-sum run with the same
    bf16 rounding points) where that is larger. The planted faults
    (SCHULZ_FAULTS) are read against the kernel at every checkpoint; with
    `gate_faults` each that applies must miss it by FAULT_MARGIN
    tolerances at some checkpoint. Fails the run otherwise; returns the
    readings."""
    from predictionio_tpu_torch.ops.solve import (round_operand,
                                                  schulz_solve,
                                                  schulz_solve_cuda)
    A64, b64 = A.double(), b.double()
    kappa = kappa_prime(A)
    applies = {"no_refinement": True, "rounded_residual": cd == "bfloat16",
               "half_steps": kappa >= KAPPA_HARD}
    per_k = []
    for k in schulz_checkpoints(iters):
        xk = schulz_solve_cuda(A, b, k, cd)
        check(bool(torch.isfinite(xk).all()),
              f"{where}: non-finite x after {k} steps")
        xp = schulz_solve(A, b, k, cd)
        rounding = rel_err(xp.double(), schulz_solve(A64, b64, k, cd))
        tol = max(SCHULZ_KERNEL_TOL, ROUNDING_FACTOR * rounding)
        X, X_half = schulz_iterates(A, k, cd, k // 2)
        faults = {"no_refinement": schulz_refine(A, X, b, 0),
                  "rounded_residual": schulz_refine(round_operand(A, cd), X,
                                                    b, 2),
                  "half_steps": schulz_refine(A, X_half, b, 2)}
        row = {"k": k, "rel_err": rel_err(xk, xp),
               "abs_err": (xk - xp).abs().max().item(),
               "rounding": rounding, "tolerance": tol,
               "copy_equals_plain": bool(torch.equal(
                   schulz_refine(A, X, b, 2), xp))}
        row.update({f: rel_err(x, xk) / tol for f, x in faults.items()})
        per_k.append(row)
        del X, X_half, faults
    out = {"kappa_prime_max_of_8": kappa,
           "max_rel_err": max(c["rel_err"] for c in per_k),
           "max_abs_err": max(c["abs_err"] for c in per_k),
           "max_rounding": max(c["rounding"] for c in per_k),
           "max_tolerance": max(c["tolerance"] for c in per_k)}
    for f in SCHULZ_FAULTS:
        out[f"fault_{f}_margin"] = (max(c[f] for c in per_k) if applies[f]
                                    else None)
    emit("schulz_checkpoints", where=where, compute_dtype=cd,
         per_checkpoint=per_k)
    for c in per_k:
        check(c["copy_equals_plain"], f"{where}: the faults' copy of the "
              f"plain Schulz differs from it after {c['k']} steps")
        check(c["rel_err"] <= c["tolerance"],
              f"{where}: Schulz kernel vs plain rel err {c['rel_err']:.3g} "
              f"> {c['tolerance']:.3g} after {c['k']} steps ({cd})")
    if gate_faults:
        for f in SCHULZ_FAULTS:
            m = out[f"fault_{f}_margin"]
            if m is not None:
                check(m >= FAULT_MARGIN,
                      f"{where}: the check cannot see the planted fault "
                      f"{f} (it moves x by only {m:.3g} tolerances)")
    return out


def sass_tensor_core_check() -> dict:
    """The bf16 Schulz kernel's SASS (`cuobjdump --dump-sass` of the built
    library, the `cuobjdump` beside `nvcc`) must hold tensor-core MMA
    instructions (HMMA or HGMMA) in every bf16 instantiation. Returns the
    count per kernel function; fails the run otherwise."""
    from pathlib import Path
    from predictionio_tpu_torch.ops import _build
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "--dump-sass",
                          str(_build.library_path("schulz_solve"))],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    mma = {f: n for f, n in counts.items() if "schulz_solve_mma" in f}
    fma = {f: n for f, n in counts.items() if "schulz_solve_fma" in f}
    emit("schulz_sass", tensor_core_instructions_bf16=mma,
         tensor_core_instructions_f32=fma)
    check(len(mma) > 0, "no bf16 Schulz kernel in the library's SASS")
    for f, n in mma.items():
        check(n > 0, f"the bf16 Schulz kernel {f} has no HMMA/HGMMA "
              "instruction: it does not run on the tensor cores")
    return mma


def phase_schulz_kernel() -> dict:
    """The Schulz kernel at the Schulz path's shapes: the primal R = rank
    with 18 steps in both compute dtypes, the path's dual extremes
    (K + 8 steps, bf16 as every dual solve), an odd B and an R that is
    not a multiple of 8, on systems whose spectrum spreads over ~1e3-1e4
    (`hard_systems`). Each shape is timed (the kernel, the plain version
    and `torch.linalg.solve`) beside its bound, with the kernel's
    achieved TFLOP/s and its share of the bound. The bf16 kernel's SASS
    must hold tensor-core instructions."""
    from predictionio_tpu_torch.ops.solve import (schulz_max_rank,
                                                  schulz_solve,
                                                  schulz_solve_cuda)
    sass = sass_tensor_core_check()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    B0 = WORK_BUDGET // RANK
    shapes = [(RANK, B0, SCHULZ_STEPS, "bfloat16"),
              (RANK, B0, SCHULZ_STEPS, "float32")]
    shapes += [(K, B, K + 8, "bfloat16") for K, B in SCHULZ_DUAL_SHAPES]
    shapes += [(RANK, 1001, SCHULZ_STEPS, "bfloat16"),
               (27, 4099, SCHULZ_STEPS, "bfloat16")]
    rows = []
    for R, B, iters, cd in shapes:
        t_row = time.perf_counter()
        A, b = hard_systems(B, R, gen)
        row = {"R": R, "B": B, "iters": iters, "compute_dtype": cd,
               **hold_schulz(A, b, iters, cd,
                             f"schulz phase R={R} B={B} {cd}")}
        nbytes, flops = schulz_cost(B, R, iters)
        reps = 1 if flops > 1e13 else 3   # the K = 176 dual: ~24 TFLOP
        row.update(
            kernel_ms=cuda_ms(lambda: schulz_solve_cuda(A, b, iters, cd),
                              reps),
            plain_ms=cuda_ms(lambda: schulz_solve(A, b, iters, cd), reps),
            library_ms=cuda_ms(
                lambda: torch.linalg.solve(A, b.unsqueeze(-1)), 3))
        bf16 = cd == "bfloat16"
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, flops, BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S)
        row["bytes"], row["flops"] = nbytes, flops
        row["achieved_tflops"] = flops / row["kernel_ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        row["rates"] = BF16_RATE_NOTE if bf16 else RATE_NOTE
        row["row_s"] = time.perf_counter() - t_row
        emit("schulz_kernel", **row)
        rows.append(row)
        del A, b
    for R in (RANK, 120, 27, 16):   # plan padding rows: A = reg*I, b = 0
        A = (LAM * torch.eye(R, device="cuda")).expand(3, R, R).contiguous()
        for cd in ("bfloat16", "float32"):
            x0 = schulz_solve_cuda(A, torch.zeros(3, R, device="cuda"),
                                   SCHULZ_STEPS, cd)
            check(bool((x0 == 0).all()), f"padding systems (R={R}, {cd}) "
                  "did not solve to exactly 0")
    x0 = schulz_solve_cuda(torch.zeros(0, 8, 8, device="cuda"),
                           torch.zeros(0, 8, device="cuda"))
    check(x0.shape == (0, 8), "an empty batch did not solve to empty x")
    check(rows[0]["kappa_prime_max_of_8"] >= KAPPA_HARD,
          "the primal systems are too well conditioned to hold the "
          "half-steps fault")
    emit("schulz_kernel_padding", exact_zero=True, empty_batch=True,
         max_rank={cd: schulz_max_rank(torch.device("cuda"), cd)
                   for cd in ("bfloat16", "float32")})
    torch.cuda.empty_cache()
    return {"rows": rows, "sass": sass}


def phase_schulz_train(pd, cg_rmse):
    """The Schulz path's train: the train phase's prepared data through
    `ALSAlgorithm.train` with the reference's full-scale Schulz
    configuration; every solve through the Schulz kernel."""
    from predictionio_tpu_torch.models.recommendation import (
        ALSAlgorithm, ALSAlgorithmParams)
    from predictionio_tpu_torch.ops.als import predict_ratings
    from predictionio_tpu_torch.ops.solve import COUNTS
    algo = ALSAlgorithm(ALSAlgorithmParams(
        rank=RANK, num_iterations=ITERATIONS, lam=LAM, seed=0,
        solver="schulz_cuda", compute_dtype="bfloat16", sweep_chunk=4))
    COUNTS.reset()
    t0 = time.perf_counter()
    model = algo.train(pd)
    sync()
    train_s = time.perf_counter() - t0
    counts = dict(vars(COUNTS))
    tel = algo.last_train_telemetry
    U, V = model.als.tables()
    finite = bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all())
    sample, cg_rmse_100k = cg_rmse
    coo = pd.ratings_coo
    pred = predict_ratings(model.als, coo.user_idx[sample],
                           coo.item_idx[sample])
    rmse = float(np.sqrt(np.mean((pred - coo.rating[sample]) ** 2)))
    emit("schulz_train", rank=RANK, iterations=ITERATIONS, lam=LAM,
         solver="schulz_cuda", compute_dtype="bfloat16", sweep_chunk=4,
         train_s=train_s, **tel, launch_counts=counts, factors_finite=finite,
         train_rmse_100k=rmse, cg_train_rmse_100k=cg_rmse_100k)
    launches = counts["schulz_solve"]
    check(launches > 0, "the Schulz kernel was never launched")
    check(launches == tel["solver_calls"] == ITERATIONS * PLAN_BATCHES,
          f"{launches} Schulz kernel launches for {tel['solver_calls']} "
          f"solver calls (expected {ITERATIONS * PLAN_BATCHES})")
    for name in ("schulz_solve_plain", "cg_solve", "cg_solve_plain",
                 "chol_solve", "chol_solve_plain"):
        check(counts[name] == 0, f"{name} ran {counts[name]} times on the "
              "Schulz path")
    check(finite, "trained factors are not finite")
    check(np.isfinite(rmse), "train RMSE is not finite")
    return algo, model, launches


def phase_schulz_resolve(als, coo) -> None:
    """Re-solve one real primal (K = 208) and one real dual item-side
    bucket from the final user table with the Schulz path's arithmetic
    (bf16 equations, 18 bf16 steps primal, K + 8 dual): the trained item
    rows came from the kernel on exactly these systems, so they must be
    equal. On these real lam = 0.01 systems the kernel is held against
    the plain version at every checkpoint (the planted faults read, not
    gated), and its answer read against a float64 Cholesky solve of the
    same systems: whether 18 bf16 steps converge here."""
    from predictionio_tpu_torch.ops.als import normal_equations
    from predictionio_tpu_torch.ops.ratings import plan_for_items
    from predictionio_tpu_torch.ops.solve import (cholesky_solve,
                                                  schulz_solve_cuda)
    U, V = als.tables()
    plan = plan_for_items(coo, work_budget=WORK_BUDGET)
    primal = next(b for b in plan.batches if b.shape[1] >= RANK)
    dual = max((b for b in plan.batches if b.shape[1] < RANK),
               key=lambda b: b.shape[0])
    for batch in (primal, dual):
        rows = torch.from_numpy(batch.rows).cuda().long()
        kind, A, rhs, to_rows = normal_equations(
            U, torch.from_numpy(batch.idx).cuda().long(),
            torch.from_numpy(batch.val).cuda(),
            torch.from_numpy(batch.mask).cuda(), LAM, RANK,
            compute_dtype="bfloat16")
        K = batch.shape[1]
        iters = SCHULZ_STEPS if kind == "primal" else K + 8
        held = hold_schulz(A, rhs, iters, "bfloat16",
                           f"real Schulz {kind} bucket K={K}",
                           gate_faults=False)
        z = schulz_solve_cuda(A, rhs, iters, "bfloat16")
        z64 = cholesky_solve(A.double(), rhs.double())
        xk = to_rows(z)
        real = rows >= 0
        out = {"kind": kind, "K": K, "B": batch.shape[0], **held,
               "trained_vs_resolve_max_abs": (
                   V[rows[real]] - xk[real]).abs().max().item(),
               "solve_vs_f64_cholesky_rel": rel_err(z[real].double(),
                                                    z64[real])}
        emit("schulz_resolve", **out)
        check(out["trained_vs_resolve_max_abs"] == 0.0,
              f"trained Schulz {kind} rows differ from a kernel re-solve "
              f"by {out['trained_vs_resolve_max_abs']:.3g}")
        del A, rhs, z, z64, xk


def use_store(workdir: str) -> None:
    """Point this process (and the children it starts) at a SQLite event
    store and a localfs model store under `workdir`."""
    for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        del os.environ[k]
    os.environ["PIO_FS_BASEDIR"] = os.path.join(workdir, "pio")


def store_items() -> tuple:
    """The item metadata the store is populated with, by item number k
    (id "i{k}"): 1-3 of 20 categories, and a creationYear."""
    from predictionio_tpu_torch.data.synthetic import \
        synthetic_item_categories
    n_items = STORE_DATA[1]
    return (synthetic_item_categories(n_items, seed=0),
            np.random.default_rng(5).integers(*STORE_YEARS, n_items))


def store_truth(model) -> tuple:
    """`store_items` by the model's dense item index (categories as sets,
    years): what the served filters are held to, made from the seeds and
    not from the port's property fold or its filters."""
    cats, years = store_items()
    ks = [int(i[1:]) for i in model.item_ix.ids]
    return [set(cats[k]) for k in ks], years[ks]


def populate_store(app_id: int) -> int:
    """The product path's events, through the bulk import
    (`insert_columnar`): synthetic_ml20m's 2M ratings as `rate` events
    (one millisecond apart), then one `$set` per item with 1-3 of 20
    categories and a creationYear. The rate events carry ids in
    insertion order, so the primary-key index grows by appends (the
    import's speed only: the training read never sees an id). Returns the
    events written."""
    from predictionio_tpu_torch.data.columnar import ColumnarBatch
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.data.synthetic import synthetic_ml20m
    ev = Storage.get_events()
    n_users, n_items, nnz = STORE_DATA
    ui, ii, vv = synthetic_ml20m(n_users, n_items, nnz, seed=0)

    def time_str(ms: int) -> str:
        sec, ms = divmod(1000 + ms, 1000)
        mi, sec = divmod(sec, 60)
        hh, mi = divmod(mi, 60)
        return "1970-01-01T%02d:%02d:%02d.%03dZ" % (hh, mi, sec, ms)

    for lo in range(0, len(vv), STORE_CHUNK):
        hi = min(lo + STORE_CHUNK, len(vv))
        ev.insert_columnar(ColumnarBatch(
            hi - lo, "rate", "user", [f"u{int(u)}" for u in ui[lo:hi]],
            target_entity_type="item",
            target_entity_id=[f"i{int(i)}" for i in ii[lo:hi]],
            properties=[{"rating": float(v)} for v in vv[lo:hi]],
            event_time=[time_str(j) for j in range(lo, hi)],
            event_id=[f"{j:032x}" for j in range(lo, hi)]), app_id)
    cats, years = store_items()
    ev.insert_columnar(ColumnarBatch(
        n_items, "$set", "item", [f"i{k}" for k in range(n_items)],
        properties=[{"categories": list(cats[k]),
                     "creationYear": int(years[k])}
                    for k in range(n_items)],
        event_time=time_str(len(vv))), app_id)
    return len(vv) + n_items


def store_variant(path: str, seed: int, stream: bool = False) -> None:
    """The engine.json of the product path: the recommendation template
    reading the store with item properties (streamed through the bulk
    data plane with `stream`), rank-200 ALS on the card (solver 'auto'),
    creationYear returned on each item."""
    ds = {"app_name": STORE_APP, "read_items": True}
    if stream:
        ds["stream"] = True
    with open(path, "w") as f:
        json.dump({
            "id": "default", "engineFactory": "recommendation",
            "datasource": {"params": ds},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "num_iterations": ITERATIONS,
                "lam": STORE_LAM, "seed": seed, "solver": "auto",
                "return_properties": ["creationYear"]}}]}, f)


def similar_variant(path: str) -> None:
    """The engine.json of the similar-product template on the same store:
    its `rate` events read as views, rank-200 implicit ALS through the
    Cholesky kernel."""
    with open(path, "w") as f:
        json.dump({
            "id": "default", "engineFactory": "similarproduct",
            "datasource": {"params": {"app_name": STORE_APP,
                                      "rate_as_view": True}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "num_iterations": ITERATIONS, "lam": LAM,
                "alpha": ALPHA, "seed": 0, "solver": "chol_cuda"}}]}, f)


def workflow_train(path: str, phase: str, kernel="cg_solve",
                   tel_out: dict = None) -> tuple:
    """`cli.main(["train", "-v", path])` in this process (what `python -m
    predictionio_tpu_torch train` runs), with every kernel count set to
    0 just before and read just after; every solve must be `kernel` (None:
    a train that solves nothing, whose counts must all stay 0). Returns
    (instance id, the TrainResult it persisted, launches of `kernel`);
    `tel_out` receives the train's telemetry (read_s, train_s, ...)."""
    from predictionio_tpu_torch.core.engine import Engine
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.ops.solve import COUNTS
    from predictionio_tpu_torch.tools import cli
    trained, tels = [], []
    engine_train = Engine.train

    def keep(self, engine_params, sanity_check=True, telemetry=None,
             **kwargs):
        # the trained models, held to what deploy restores, and the
        # train's telemetry, which run_train goes on filling
        tels.append(telemetry)
        trained.append(engine_train(self, engine_params, sanity_check,
                                    telemetry, **kwargs))
        return trained[-1]

    out = io.StringIO()
    Engine.train = keep
    try:
        COUNTS.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["train", "-v", path])
        sync()
        workflow_s = time.perf_counter() - t0
        counts = dict(vars(COUNTS))
    finally:
        Engine.train = engine_train
    said = out.getvalue().strip().splitlines()
    check(rc == 0 and said and said[-1].startswith(
        "Training completed. Engine instance ID: "),
        f"train of {path} exited {rc} saying {said}")
    iid = said[-1].rsplit(" ", 1)[1]
    tel = dict(tels[0])
    if tel_out is not None:
        tel_out.update(tel)
    algo_tels = tel.pop("algorithms")
    algo_tel = algo_tels[0]
    inst = Storage.get_meta_data_engine_instances().get(iid)
    launches = counts.get(kernel, 0)
    emit(phase, template=inst.engine_factory, instance=iid,
         status=inst.status, workflow_s=workflow_s, **tel,
         **(algo_tel if len(algo_tels) == 1 else {"algorithms": algo_tels}),
         launch_counts=counts)
    check(inst.status == "COMPLETED", f"engine instance {iid} is "
          f"{inst.status}")
    if kernel is None:
        check(not any(counts.values()), f"the {phase} train launched "
              f"solves: {counts}")
        return iid, trained[0], 0
    check(launches > 0, f"the {kernel} kernel was never launched")
    check(launches == algo_tel["solver_calls"],
          f"{launches} {kernel} kernel launches for "
          f"{algo_tel['solver_calls']} solver calls")
    for name, n in counts.items():
        check(name == kernel or n == 0, f"{name} ran {n} times in the "
              f"{phase} train: every solve must be the {kernel} kernel")
    return iid, trained[0], launches


#: per template: (the engine factory's module, its name, an expression
#: over the restored model `m` read in a process without a card, its
#: device state and tables, and the model's tables)
BLOB_PROBES = {
    "recommendation": (
        "predictionio_tpu_torch.models.recommendation",
        "RecommendationEngineFactory",
        "m.als.device, m.als._tables, m.als.user_factors.shape, "
        "m.als.item_factors.shape",
        lambda m: (m.als.user_factors, m.als.item_factors)),
    "ecommercerecommendation": (
        "predictionio_tpu_torch.models.ecommerce", "ECommerceEngineFactory",
        "m.device, m._als, m.user_factors.shape, "
        "m.item_factors.shape",
        lambda m: (m.user_factors, m.item_factors,
                   m.item_factors_normalized)),
    "recommendeduser": (
        "predictionio_tpu_torch.models.recommendeduser",
        "RecommendedUserEngineFactory",
        "m.device, m.followed_factors_normalized.shape",
        lambda m: (m.followed_factors_normalized,)),
}


def blob_check(iid: str, trained, template: str = "recommendation"
               ) -> dict:
    """The persisted blob unpickles in a process that sees no card (it
    holds host numpy only, the device state dropped), and its tables are
    the trained ones, bit for bit."""
    import importlib
    from predictionio_tpu_torch.data.storage.registry import Storage
    module, factory, probe, tables = BLOB_PROBES[template]
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {HERE!r})\n"
        "from predictionio_tpu_torch.data.storage.registry import Storage\n"
        f"from {module} import {factory}\n"
        f"blob = Storage.get_model_data_models().get({iid!r}).models\n"
        f"(m,) = {factory}.apply().deserialize_models(blob, {iid!r})\n"
        f"print(torch.cuda.is_available(), {probe})\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"the blob did not unpickle without a card: "
          f"{out.stderr[-2000:]}")
    model = trained.models[0]
    shapes = " ".join(str(t.shape) for t in tables(model)[:2])
    nones = len(probe.split(",")) - min(2, len(tables(model)))
    want = " ".join(["False"] + ["None"] * nones) + " " + shapes
    check(out.stdout.strip() == want,
          f"blob read without a card: {out.stdout.strip()!r} != {want!r}")
    blob = Storage.get_model_data_models().get(iid).models
    (restored,) = getattr(importlib.import_module(module),
                          factory).apply().deserialize_models(blob, iid)
    equal = (all(np.array_equal(a, b) for a, b in
                 zip(tables(restored), tables(model)))
             and getattr(restored, "item_properties", None)
             == getattr(model, "item_properties", None))
    ix = "followed_ix" if template == "recommendeduser" else "item_ix"
    equal &= list(getattr(restored, ix).ids) == list(getattr(model,
                                                             ix).ids)
    check(equal, "the restored model differs from the trained one")
    return {"blob_bytes": len(blob), "unpickles_without_card": True,
            "restored_bit_equal": True}


def phase_store_train(workdir: str) -> tuple:
    """The product path's train: populate the store under `workdir`
    (`populate_store`, set-up), then `create_workflow_main` on an
    engine.json variant."""
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.registry import Storage
    t0 = time.perf_counter()
    app_id = Storage.get_meta_data_apps().insert(App(0, STORE_APP))
    events = populate_store(app_id)
    emit("store_populate", events=events, items=STORE_DATA[1],
         populate_s=time.perf_counter() - t0,
         note="set-up: the bulk import, not a measurement of train")
    path = os.path.join(workdir, "engine.json")
    store_variant(path, STORE_SEEDS[0])
    tel = {}
    iid, trained, launches = workflow_train(path, "store_train",
                                            tel_out=tel)
    emit("store_blob", instance=iid, **blob_check(iid, trained))
    return path, iid, trained, launches, tel["read_s"]


def persisted_model(iid: str):
    """The recommendation model of instance `iid`, as deploy restores it
    (host tables)."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models.recommendation import \
        RecommendationEngineFactory
    blob = Storage.get_model_data_models().get(iid).models
    (model,) = RecommendationEngineFactory.apply().deserialize_models(
        blob, iid)
    return model


def phase_stream_train(workdir: str, batch_iid: str,
                       batch_read_s: float) -> tuple:
    """`store_train` again with `"stream": true` and the same seed: the
    training read streams through the bulk data plane (chunked cursors,
    a reader thread, pinned double-buffered copies to the card), and the
    persisted factor tables and id maps must be bit-equal to the batch
    train's. Returns the CG launches (every solve one) and the stream's
    `BulkLoadStats`."""
    from predictionio_tpu_torch.dataplane import pipeline
    batch = persisted_model(batch_iid)
    path = os.path.join(workdir, "engine_stream.json")
    store_variant(path, STORE_SEEDS[0], stream=True)
    pipeline.last_stats = None
    tel = {}
    iid, _, launches = workflow_train(path, "stream_train", tel_out=tel)
    st = pipeline.last_stats
    check(st is not None, "the stream_train read did not go through the "
          "bulk data plane")
    streamed = persisted_model(iid)
    equal = {
        "user_ids": list(streamed.user_ix.ids) == list(batch.user_ix.ids),
        "item_ids": list(streamed.item_ix.ids) == list(batch.item_ix.ids),
        "user_factors": np.array_equal(streamed.als.user_factors,
                                       batch.als.user_factors),
        "item_factors": np.array_equal(streamed.als.item_factors,
                                       batch.als.item_factors)}
    stage_s = st.decode_s + st.upload_submit_s + st.upload_wait_s
    emit("stream_read", rows=st.rows, chunks=st.chunks, read_s=st.read_s,
         decode_s=st.decode_s, upload_submit_s=st.upload_submit_s,
         upload_wait_s=st.upload_wait_s, h2d_bytes=st.h2d_bytes,
         h2d_overlap_frac=st.h2d_overlap_frac, read_mb_s=st.read_mb_s,
         read_bytes=st.read_bytes, wall_s=st.wall_s,
         unattributed_s=st.wall_s - stage_s,
         steady_compiles=st.steady_compiles,
         steady_compile_s=st.steady_compile_s,
         stream_train_read_s=tel["read_s"],
         batch_train_read_s=batch_read_s, bit_equal=equal,
         note="read_s etc. are the data plane's stages; *_train_read_s "
              "the train's whole read (ratings and item properties); "
              "unattributed_s = wall - (decode + submit + wait): the "
              "interning encode and the queue waits")
    check(st.rows == STORE_DATA[2], f"the stream read {st.rows} rows, not "
          f"{STORE_DATA[2]}")
    check(st.steady_compiles == 0, f"{st.steady_compiles} kernel builds "
          "ran during the stream's steady phase")
    check(all(equal.values()), f"the streamed train differs from the batch "
          f"train: {equal}")
    return launches, st


def async_copy_probe(device: torch.device) -> dict:
    """`ops.staging.device_stage` of one 64 MB column: its copy must still
    be in flight when the call returns (a copy from pageable memory, or
    on the caller's stream behind other work, would have landed or
    blocked), from a pinned buffer, on the copy stream. Times the same
    bytes' host-to-device copy with CUDA events for the card's rate, and
    the host time of enqueueing it (`submit_s` also pads the column into
    the pinned buffer): the enqueue must take under a quarter of the
    copy. The copy takes a few ms, so a host that stalls the caller that
    long lands it before the return; a synchronous copy is never in
    flight at the return, so the column is staged up to
    ASYNC_PROBE_TRIES times until one copy is."""
    from predictionio_tpu_torch.ops import staging
    col = {"t": np.arange(ASYNC_PROBE_ROWS, dtype=np.int64)}
    stream = staging.copy_stream(device)
    staging.device_stage({"t": col["t"][:1024]}, device, stream)
    stream.synchronize()
    for tries in range(1, ASYNC_PROBE_TRIES + 1):
        out, rows, padded, submit_s, event, hosts = staging.device_stage(
            col, device, stream)
        in_flight = not event.query()
        wait_s = staging.wait_ready(event)
        if in_flight:
            break
    landed = bool(torch.equal(out["t"][:rows].cpu(),
                              torch.from_numpy(col["t"])))
    nbytes = int(out["t"].nbytes)
    copy_ms = cuda_ms(lambda: out["t"].copy_(hosts[0], non_blocking=True),
                      5)
    with torch.cuda.stream(stream):
        t0 = time.perf_counter()
        out["t"].copy_(hosts[0], non_blocking=True)
        enqueue_s = time.perf_counter() - t0
    stream.synchronize()
    info = {"bytes": nbytes, "submit_s": submit_s, "wait_s": wait_s,
            "enqueue_s": enqueue_s, "in_flight_at_return": in_flight,
            "stagings": tries,
            "pinned": all(h.is_pinned() for h in hosts),
            "h2d_copy_ms": copy_ms,
            "h2d_gb_s": nbytes / (copy_ms * 1e-3) / 1e9}
    check(info["pinned"], "the probe's staging buffer is not pinned")
    check(in_flight, f"the 64 MB staged copy had landed when device_stage "
          f"returned, {tries} times in a row: the copy did not run "
          "asynchronously")
    check(landed, "the probe's staged column differs from its source")
    check(enqueue_s < copy_ms * 1e-3 / 4, f"enqueueing the 64 MB copy took "
          f"{enqueue_s * 1e3:.3f} ms against its {copy_ms:.3f} ms transfer")
    return info


def phase_dataplane(stream_stats) -> None:
    """`BulkLoadExecutor(device="cuda")` over the first 1,000,000 rate
    events of the store (bounded by `until_time`) with the default encode
    (the `t` and `prop` wire columns): every segment a CUDA tensor padded
    to `bucket_rows`, every copy from a pinned buffer, and the valid rows,
    copied back after `finish()`, byte-equal to the host columns. Beside
    it, `stream_train`'s staged bytes at the probe's host-to-device rate
    against that stream's `upload_submit_s`."""
    from predictionio_tpu_torch.data.event import from_millis
    from predictionio_tpu_torch.dataplane import BulkLoadExecutor
    from predictionio_tpu_torch.ops import staging
    from predictionio_tpu_torch.compile.buckets import bucket_rows
    device = torch.device("cuda")
    t_phase = time.perf_counter()
    probe = async_copy_probe(device)
    staging.COUNTS.reset()
    # the store's rate events are one millisecond apart from 1000 ms
    result = BulkLoadExecutor(device=device).run(
        STORE_APP, property_field="rating", event_names=["rate"],
        entity_type="user", target_entity_type="item",
        until_time=from_millis(1000 + DATAPLANE_ROWS))
    st = result.stats
    copies = dict(vars(staging.COUNTS))
    check(st.rows == DATAPLANE_ROWS, f"the bounded stream read {st.rows} "
          f"rows, not {DATAPLANE_ROWS}")
    for seg in result.segments:
        check(set(seg.arrays) == {"t", "prop"}, f"staged columns "
              f"{sorted(seg.arrays)}")
        check(seg.padded_rows == bucket_rows(seg.rows), f"a segment of "
              f"{seg.rows} rows padded to {seg.padded_rows}")
        for name, t in seg.arrays.items():
            check(t.device.type == "cuda" and t.shape == (seg.padded_rows,),
                  f"staged {name} is {t.device} {tuple(t.shape)}")
    check(copies == {"pinned": 2 * len(result.segments), "plain": 0},
          f"copies by path {copies} for {len(result.segments)} segments")
    byte_equal = {}
    for name in ("t", "prop"):
        host = np.concatenate([c[name] for c in result.decoded])
        dev = np.concatenate([s.arrays[name][:s.rows].cpu().numpy()
                              for s in result.segments])
        byte_equal[name] = host.tobytes() == dev.tobytes()
    emit("dataplane", rows=st.rows, chunks=st.chunks, read_s=st.read_s,
         decode_s=st.decode_s, upload_submit_s=st.upload_submit_s,
         upload_wait_s=st.upload_wait_s, h2d_bytes=st.h2d_bytes,
         h2d_overlap_frac=st.h2d_overlap_frac, read_mb_s=st.read_mb_s,
         wall_s=st.wall_s, steady_compiles=st.steady_compiles,
         buckets=sorted({s.padded_rows for s in result.segments}),
         copies=copies, byte_equal=byte_equal, async_probe=probe,
         stream_h2d_bytes=stream_stats.h2d_bytes,
         stream_upload_submit_s=stream_stats.upload_submit_s,
         stream_transfer_s_at_probe_rate=stream_stats.h2d_bytes
         / (probe["h2d_gb_s"] * 1e9),
         phase_s=time.perf_counter() - t_phase)
    check(all(byte_equal.values()), f"staged rows differ from the host "
          f"columns: {byte_equal}")
    check(st.steady_compiles == 0, "kernel builds ran mid-stream")


def phase_e2() -> None:
    """The e2 library on the card. Markov: a seeded COO of 5M transition
    counts over the store's 26,744 items as states, top-20 pruned on the
    host, `predict` on the card for 16 state distributions held to a
    float64 numpy reckoning of the same tables within 1e-6 of each
    answer's largest entry (float32 atomic sums). Categorical naive
    Bayes: 1,000,000 points, 8 positions, <= 64 values, 5 labels; the
    counts on the card equal numpy's `bincount` exactly, and the priors
    and likelihoods equal a float64 host reckoning from those counts."""
    import math
    from predictionio_tpu_torch.ops.markov import (markov_chain_train,
                                                   mc_predict)
    from predictionio_tpu_torch.ops.naive_bayes import (
        LabeledPoint, categorical_counts, categorical_nb_train)
    device = torch.device("cuda")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(41)
    S = STORE_DATA[1]
    r = rng.integers(0, S, MARKOV_NNZ)
    c = rng.integers(0, S, MARKOV_NNZ)
    v = rng.integers(1, 9, MARKOV_NNZ)
    t0 = time.perf_counter()
    model = markov_chain_train(r, c, v, S, MARKOV_TOP_N, device=device)
    train_s = time.perf_counter() - t0
    flat = np.where(model.indices >= 0, model.indices, S).ravel()
    probs64 = model.probs.astype(np.float64)
    worst, t_pred = 0.0, 0.0
    for _ in range(MARKOV_STATES_HELD):
        cur = rng.random(S)
        cur /= cur.sum()
        t1 = time.perf_counter()
        got = model.predict(cur)
        t_pred += time.perf_counter() - t1
        cur32 = cur.astype(np.float32).astype(np.float64)
        ref = np.bincount(flat, weights=(probs64 * cur32[:, None]).ravel(),
                          minlength=S + 1)[:S]
        worst = max(worst, float(np.abs(got - ref).max() / np.abs(ref).max()))
    idx_t, probs_t = model.tables()
    cur_t = torch.from_numpy(cur.astype(np.float32)).to(device)
    predict_ms = cuda_ms(lambda: mc_predict(idx_t, probs_t, cur_t, S), 20)
    emit("e2_markov", states=S, nnz=MARKOV_NNZ, top_n=MARKOV_TOP_N,
         train_s=train_s, held=MARKOV_STATES_HELD, max_rel_err=worst,
         tol=MARKOV_REL_TOL, predict_call_s=t_pred / MARKOV_STATES_HELD,
         predict_device_ms=predict_ms)
    check(worst <= MARKOV_REL_TOL, f"Markov predict is {worst:.3g} from "
          f"float64, above {MARKOV_REL_TOL}")

    labels = rng.integers(0, NB_LABELS, NB_POINTS)
    vals = (rng.integers(0, 48, (NB_POINTS, NB_POSITIONS))
            + 4 * labels[:, None]) % NB_VALUES
    names = np.array([f"v{k:02d}" for k in range(NB_VALUES)])
    feats = names[vals].tolist()
    t0 = time.perf_counter()
    points = [LabeledPoint(f"l{lab}", tuple(f))
              for lab, f in zip(labels.tolist(), feats)]
    points_s = time.perf_counter() - t0
    del feats
    t0 = time.perf_counter()
    nb = categorical_nb_train(points, device=device)
    nb_train_s = time.perf_counter() - t0
    # the same triples counted on the card directly, and by numpy
    lab_t = torch.from_numpy(labels).to(device)
    feat_t = torch.from_numpy(vals).to(device)
    counts, label_counts = categorical_counts(lab_t, feat_t, NB_LABELS,
                                              NB_VALUES)
    counts_ms = cuda_ms(lambda: categorical_counts(
        lab_t, feat_t, NB_LABELS, NB_VALUES), 10)
    flat = ((labels[:, None] * NB_POSITIONS + np.arange(NB_POSITIONS))
            * NB_VALUES + vals).ravel()
    ref_counts = np.bincount(flat, minlength=NB_LABELS * NB_POSITIONS
                             * NB_VALUES).reshape(NB_LABELS, NB_POSITIONS,
                                                  NB_VALUES)
    ref_labels = np.bincount(labels, minlength=NB_LABELS)
    counts_exact = (np.array_equal(counts.cpu().numpy(), ref_counts)
                    and np.array_equal(label_counts.cpu().numpy(),
                                       ref_labels))
    priors = {f"l{i}": math.log(ref_labels[i] / NB_POINTS)
              for i in range(NB_LABELS)}
    likelihoods = {f"l{i}": [
        {names[k]: math.log(ref_counts[i, p, k] / ref_labels[i])
         for k in range(NB_VALUES) if ref_counts[i, p, k] > 0}
        for p in range(NB_POSITIONS)] for i in range(NB_LABELS)}
    model_equal = (nb.priors == priors and nb.likelihoods == likelihoods)
    emit("e2_categorical_nb", points=NB_POINTS, positions=NB_POSITIONS,
         values=NB_VALUES, labels=NB_LABELS, points_build_s=points_s,
         train_s=nb_train_s, counts_device_ms=counts_ms,
         counts_exact=counts_exact, model_equal_f64=model_equal,
         e2_phase_s=time.perf_counter() - t_phase)
    check(counts_exact, "the categorical counts on the card differ from "
          "numpy's bincount")
    check(model_equal, "the categorical priors/likelihoods differ from the "
          "float64 host reckoning")


def dot_tolerance(u64: np.ndarray, V64: np.ndarray) -> np.ndarray:
    """Per item: the float32 dot product's rounding bound,
    n * 2^-24 * sum_i |u_i v_i| over the rank n."""
    return len(u64) * 2.0 ** -24 * (np.abs(V64) @ np.abs(u64))


def hold_served(body: dict, query: dict, model, U64, V64, truth,
                what: str, f16: bool = False) -> bool:
    """Hold one served answer against the float64 top-k over the
    persisted tables under the reference's mask, built here from the
    items' true metadata (`store_truth`): an item must share one of the
    query's categories, and be of its creationYear or later. Held: the
    ids (a swap only between items whose float64 scores tie within 1e-6
    of the largest, the serve phases' rule), each score within the f32
    dot's rounding bound (plus f16 rounding, 2^-11 |s|, when `f16`), and
    each item's creationYear. Returns whether the ids were exact."""
    cats, years = truth
    uix = model.user_ix[query["user"]]
    s64 = V64 @ U64[uix]
    allowed = np.ones(len(years), dtype=bool)
    if query.get("categories"):
        want = set(query["categories"])
        allowed &= np.array([bool(c & want) for c in cats])
    if query.get("creationYear") is not None:
        allowed &= years >= query["creationYear"]
    s64 = np.where(allowed, s64, -np.inf)
    top = np.argsort(-s64, kind="stable")[:query["num"]]
    top = top[np.isfinite(s64[top])]
    got = [s["item"] for s in body["itemScores"]]
    scale = float(np.abs(s64[top]).max()) if len(top) else 1.0
    exact = held_to_f64(got, s64, top, model, what, atol=1e-6 * scale)
    got_ix = np.array([model.item_ix[g] for g in got], dtype=np.int64)
    served = np.array([s["score"] for s in body["itemScores"]])
    tol = dot_tolerance(U64[uix], V64[got_ix])
    if f16:
        tol = tol + F16_REL * np.abs(s64[got_ix])
    check(bool((np.abs(served - s64[got_ix]) <= tol).all()),
          f"{what}: scores off the float64 scores by more than the "
          f"{'f16' if f16 else 'f32'} rounding bound")
    check([s.get("creationYear") for s in body["itemScores"]]
          == [int(years[i]) for i in got_ix],
          f"{what}: creationYear does not ride on each item")
    return exact


def store_queries(model, truth, rng) -> list:
    """STORE_QUERIES known-user queries of each kind: base, categories,
    creationYear, and both; categories drawn from the items' true ones."""
    n_users = len(model.user_ix)
    cats = sorted(set().union(*truth[0]))
    out = []
    for kind in ("base", "categories", "creationYear", "both"):
        for n in range(STORE_QUERIES):
            q = {"user": model.user_ix.id_of(int(rng.integers(n_users))),
                 "num": 10}
            if kind in ("categories", "both"):
                q["categories"] = [str(c) for c in rng.choice(
                    cats, 1 + n % 2, replace=False)]
            if kind in ("creationYear", "both"):
                q["creationYear"] = int(rng.integers(*STORE_YEARS))
            out.append(q)
    return out


def serve_and_hold(url: str, model, rng, what: str) -> dict:
    """POST `store_queries`, hold each answer (`hold_served`); latencies
    in ms, the first query's apart."""
    truth = store_truth(model)
    queries = store_queries(model, truth, rng)
    U64 = model.als.user_factors.astype(np.float64)
    V64 = model.als.item_factors.astype(np.float64)
    lat, exact = [], 0
    for q in queries:
        t0 = time.perf_counter()
        status, body = post(url + "/queries.json", json.dumps(q).encode())
        lat.append((time.perf_counter() - t0) * 1e3)
        check(status == 200, f"{what}: query {q} answered {status}")
        exact += hold_served(body, q, model, U64, V64, truth,
                             f"{what} query {q}")
    kinds = ["+".join(k for k in ("categories", "creationYear") if k in q)
             or "base" for q in queries]
    ms = np.array(lat[1:])
    return {"queries": len(lat), "ids_equal_f64": exact,
            "f32_tie_swaps": len(lat) - exact, "first_query_ms": lat[0],
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "p50_ms_by_kind": {k: float(np.percentile(
                [t for t, kk in zip(lat[1:], kinds[1:]) if kk == k], 50))
                for k in dict.fromkeys(kinds)}}


def phase_store_deploy(path: str, iid: str, trained) -> tuple:
    """The product path's deploy: a fresh server restores the instance
    from storage (not the trained object), serves base and filtered
    queries over HTTP, then hot-swaps on /reload to a retrain through the
    command line. Returns the retrain's CG kernel launches and the
    reloaded model."""
    from predictionio_tpu_torch.compile.aot import capture_streams
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    # memory_allocated around the deploy's AOT warm (its captures), and
    # the capture streams the process has used: one a device
    warm_allocated = {}
    warm_aot = EngineServer._warm_aot

    def measured_warm(self, *args, **kwargs):
        sync()
        before = torch.cuda.memory_allocated()
        out = warm_aot(self, *args, **kwargs)
        sync()
        warm_allocated.update(before=before,
                              after=torch.cuda.memory_allocated())
        return out

    EngineServer._warm_aot = measured_warm
    t0 = time.perf_counter()
    try:
        server = EngineServer(ServerConfig(ip="127.0.0.1", port=0,
                                           engine_variant=path)).load()
    finally:
        EngineServer._warm_aot = warm_aot
    sync()
    load_s = time.perf_counter() - t0
    warm_allocated.update(rise=warm_allocated["after"]
                          - warm_allocated["before"],
                          capture_streams=capture_streams())
    server.start(background=True)
    url = f"http://127.0.0.1:{server.config.port}"
    try:
        check(server.engine_instance.id == iid,
              f"deployed {server.engine_instance.id}, trained {iid}")
        check(warm_allocated["capture_streams"] == 1,
              f"the process captured on {warm_allocated['capture_streams']} "
              "streams, not one")
        (model,) = server.models
        U, V = model.als.tables()
        U0, V0 = trained.models[0].als.tables()
        check(U.device.type == "cuda" and torch.equal(U, U0)
              and torch.equal(V, V0),
              "the restored tables on the card differ from the trained ones")
        out = serve_and_hold(url, model, np.random.default_rng(4),
                             "store_deploy")
        status, body = post(url + "/queries.json",
                            b'{"user": "no-such-user", "num": 10}')
        check(status == 200 and body == {"itemScores": []},
              f"unknown user answered {status} {body}")
        user = model.user_ix.id_of(0)
        status, body = post(url + "/queries.json", json.dumps(
            {"user": user, "num": 10, "categories": ["no-such"]}).encode())
        check(status == 200 and body == {"itemScores": []},
              f"a category no item has answered {status} {body}")
        for bad in (b'{"user": ', b'{"num": 3}',
                    b'{"user": "u1", "num": 3, "creationYear": "x"}'):
            status, _ = post(url + "/queries.json", bad)
            check(status == 400, f"malformed body {bad} answered {status}")
        emit("store_deploy", instance=iid, load_s=load_s,
             warm=server.last_aot_warm, warm_allocated=warm_allocated,
             tables_bit_equal=True,
             unknown_user_empty=True,
             unknown_category_empty=True, malformed_400=True, **out)

        store_variant(path, STORE_SEEDS[1])
        new_iid, _, launches = workflow_train(path, "cli_train")
        t0 = time.perf_counter()
        status, body = post(url + "/reload", b"")
        reload_s = time.perf_counter() - t0
        check(status == 200, f"/reload answered {status} {body}")
        with urllib.request.urlopen(url + "/", timeout=60) as r:
            named = json.loads(r.read())["engineInstanceId"]
        check(named == new_iid, f"GET / names {named}, not the retrained "
              f"instance {new_iid}")
        (model,) = server.models
        check(server.algorithms[0].params.seed == STORE_SEEDS[1],
              "the reloaded engine params are not the retrain's")
        out = serve_and_hold(url, model, np.random.default_rng(6),
                             "store_reload")
        emit("store_reload", instance=new_iid, reload_s=reload_s,
             warm=server.last_aot_warm, **out)
        return launches, model
    finally:
        server.stop()


def sharded_variant(path: str, seed: int) -> None:
    """`store_variant`'s engine with the `als-mesh` algorithm: the same
    params, the factor tables split over SHARDS shards on the card and
    persisted through `ShardedALSModelCheckpoint`."""
    store_variant(path, seed)
    with open(path) as f:
        variant = json.load(f)
    algo = variant["algorithms"][0]
    algo["name"] = "als-mesh"
    algo["params"].update(factor_sharding="model", model_shards=SHARDS)
    with open(path, "w") as f:
        json.dump(variant, f)


def host_view(model, U: np.ndarray, V: np.ndarray):
    """A recommendation model's id maps with whole host tables: what
    `serve_and_hold` holds a sharded model's answers to."""
    return types.SimpleNamespace(
        als=types.SimpleNamespace(user_factors=U, item_factors=V),
        user_ix=model.user_ix, item_ix=model.item_ix)


def held_close(got: np.ndarray, want: np.ndarray) -> dict:
    """Bit-equality, else the largest difference, of two factor tables
    against SHARDED_TOL of the reference's scale."""
    diff = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 1.0
    return {"bit_equal": bool(np.array_equal(got, want)),
            "max_abs_diff": diff, "within_tol": diff <= SHARDED_TOL * scale}


def dir_bytes(path: str) -> tuple:
    """(files, bytes) under `path`."""
    n = total = 0
    for root, _, files in os.walk(path):
        for name in files:
            n += 1
            total += os.path.getsize(os.path.join(root, name))
    return n, total


def phase_sharded(workdir: str, trained, store_launches: int) -> int:
    """The sharded plane at the store model's widths (rank 200, the
    `store_variant` engine, the loaded store):

    - `sharded_train`: the `als-mesh` engine through `cli.main(["train"])`
      with `factor_sharding='model'`, S = SHARDS on the card and the store
      train's seed: its tables against the replicated `store_train`'s
      (bit-equal, or within SHARDED_TOL), every bucket solve a
      `cg_solve.cu` launch, as many as the replicated train's;
    - `sharded_checkpoint`: the tables went to disk through
      `ShardedALSModelCheckpoint` (one file a shard), and a deploy
      restores them bit-equal (save and restore seconds, bytes);
    - `sharded_serve`: the store's queries through that deploy (the
      plain ones through `_users_topk_serve_sharded_begin`, the filtered
      ones through the sharded masked top-k), held to the float64 top-k;
      one window's device ms beside the replicated layout's;
    - `sharded_fold`: one fold tick of the sharded model against the
      same tick of the replicated one (rows within SHARDED_TOL), every
      solve a `cg_solve.cu` launch;
    - `sharded_mesh`: `deploy` as two processes on the one card over gloo
      (S = 2, P = 2) answering SHARDED_QUERIES queries held to float64,
      the collective bytes a query; then the worker is SIGKILLed: the next
      query answers 503 within MESH_TIMEOUT_S, and `/stats.json` and
      `/metrics` read poisoned.

    Returns the CG launches of the train and the fold."""
    from predictionio_tpu_torch.compile.aot import get_aot
    from predictionio_tpu_torch.models.recommendation import \
        MeshALSAlgorithm
    from predictionio_tpu_torch.obs import costmon
    from predictionio_tpu_torch.online.fold_in import fold_in_coo
    from predictionio_tpu_torch.ops import als as ALS
    from predictionio_tpu_torch.ops.solve import COUNTS
    from predictionio_tpu_torch.parallel.sharded_table import is_sharded
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    from predictionio_tpu_torch.utils.checkpoint import checkpoint_dir
    rep = trained.models[0].als
    path = os.path.join(workdir, "engine_sharded.json")
    sharded_variant(path, STORE_SEEDS[0])
    kept = {}
    mesh_train = MeshALSAlgorithm.train

    def keep(self, pd):
        kept["pd"] = pd
        kept["algo"] = self
        return mesh_train(self, pd)

    MeshALSAlgorithm.train = keep
    tel = {}
    try:
        iid, res, launches = workflow_train(path, "sharded_train",
                                            tel_out=tel)
    finally:
        MeshALSAlgorithm.train = mesh_train
    sh = res.models[0].als
    check(is_sharded(sh.user_factors) and sh.user_factors.n_shards == SHARDS
          and len(sh.item_factors._dev.tensors) == SHARDS
          and all(t.device.type == sh.device.type
                  for t in sh.item_factors._dev.tensors),
          f"the sharded train's tables are {sh.user_factors!r}, "
          f"{sh.item_factors!r}")
    U_sh, V_sh = sh.user_factors.to_numpy(), sh.item_factors.to_numpy()
    held = {"user_factors": held_close(U_sh, rep.user_factors),
            "item_factors": held_close(V_sh, rep.item_factors)}
    emit("sharded_hold", shards=SHARDS, replicated_launches=store_launches,
         sharded_launches=launches, tables=held)
    check(all(h["within_tol"] for h in held.values()),
          f"the sharded train's tables are off the replicated train's: "
          f"{held}")
    check(launches == store_launches, f"the sharded train launched "
          f"cg_solve {launches} times, the replicated {store_launches}")

    # the checkpoint, and a deploy that restores it
    files, nbytes = dir_bytes(checkpoint_dir(iid))
    t0 = time.perf_counter()
    server = EngineServer(ServerConfig(ip="127.0.0.1", port=0,
                                       engine_variant=path)).load()
    sync()
    restore_s = time.perf_counter() - t0
    server.start(background=True)
    url = f"http://127.0.0.1:{server.config.port}"
    cg = launches
    try:
        (model,) = server.models
        back = (model.als.user_factors.to_numpy(),
                model.als.item_factors.to_numpy())
        restored_equal = (np.array_equal(back[0], U_sh)
                          and np.array_equal(back[1], V_sh))
        emit("sharded_checkpoint", instance=iid, files=files, bytes=nbytes,
             save_s=tel.get("serialize_s"), restore_s=restore_s,
             restored_bit_equal=restored_equal,
             note="save_s: the train's serialize stage, which writes the "
                  "shard files; restore_s: the deploy's load()")
        check(restored_equal, "the restored sharded tables differ from the "
              "trained ones")
        check(files == 2 * SHARDS + 3, f"the checkpoint holds {files} "
              "files: one a shard of each table, the manifest, the vocab "
              "and the item properties")

        with exact_pack():
            out = serve_and_hold(url, host_view(model, *back),
                                 np.random.default_rng(8), "sharded_serve")
            users = np.arange(16)
            dims = {}
            for name, m in (("replicated", rep), ("sharded", model.als)):
                dims[name] = ALS.batch_predict_dims(m, len(users), SERVE_NUM)
                get_aot().ensure(costmon.BATCH_PREDICT, dims[name], (m,))
                out[f"{name}_window_ms"] = cuda_ms(
                    lambda m=m: ALS.users_topk_serve_begin(m, users,
                                                           SERVE_NUM),
                    WINDOW_REPS)
        emit("sharded_serve", dims=dims, **out,
             note="*_window_ms: one 16-query window's device time (CUDA "
                  "events around its enqueue, the graph replayed)")

        # one fold tick, each layout
        pd, algo = kept["pd"], kept["algo"]
        rng = np.random.default_rng(12)
        tu = rng.choice(pd.ratings_coo.n_users, SHARDED_FOLD[0],
                        replace=False)
        ti = rng.choice(pd.ratings_coo.n_items, SHARDED_FOLD[1],
                        replace=False)
        ticks = {}
        for name, m in (("replicated", rep), ("sharded", model.als)):
            COUNTS.reset()
            t0 = time.perf_counter()
            folded, st = fold_in_coo(m, pd.ratings_coo, tu, ti,
                                     algo.fold_config(is_sharded(
                                         m.user_factors)))
            sync()
            ticks[name] = (folded, st, dict(vars(COUNTS)),
                           time.perf_counter() - t0)
        (f_r, st_r, c_r, s_r), (f_s, st_s, c_s, s_s) = (
            ticks["replicated"], ticks["sharded"])
        rows = {"user_rows": held_close(f_s.user_factors.rows(tu),
                                        f_r.user_factors[tu]),
                "item_rows": held_close(f_s.item_factors.rows(ti),
                                        f_r.item_factors[ti])}
        emit("sharded_fold", touched=list(SHARDED_FOLD), sharded=st_s.sharded,
             solver_calls=st_s.solver_calls, launch_counts=c_s,
             replicated_launch_counts=c_r, sharded_s=s_s, replicated_s=s_r,
             rows=rows)
        check(st_s.sharded and is_sharded(f_s.user_factors),
              "the sharded fold tick did not run the sharded layout")
        check(all(h["within_tol"] for h in rows.values()),
              f"the sharded tick's rows are off the replicated tick's: "
              f"{rows}")
        check(c_s.get("cg_solve", 0) == st_s.solver_calls > 0
              and all(n == 0 for k, n in c_s.items() if k != "cg_solve"),
              f"the sharded fold's solves: {c_s} for {st_s.solver_calls} "
              "solver calls; every one must be the cg_solve kernel")
        cg += c_s["cg_solve"]
    finally:
        server.stop()
    del server, model, res, sh
    phase_sharded_mesh(path, workdir, (U_sh, V_sh), kept["pd"])
    return cg


def phase_sharded_mesh(path: str, workdir: str, tables, pd) -> None:
    """`deploy` of the sharded instance as two processes of one group on
    the one card (gloo: NCCL takes no two ranks on one device), each
    holding one of the two shards; the queries held to the float64 top-k
    of the whole tables; then the worker's SIGKILL (module docstring of
    `serving/mesh_serving.py`)."""
    import signal
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = sock.getsockname()[1]
    procs, logs = [], []
    t0 = time.perf_counter()
    for pid in range(2):
        env = dict(os.environ, PIO_COORDINATOR=f"127.0.0.1:{coord}",
                   PIO_NUM_PROCESSES="2", PIO_PROCESS_ID=str(pid),
                   PIO_SERVE_PACK="exact")
        logs.append(os.path.join(workdir, f"deploy_mesh{pid}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch", "deploy",
                 "-v", path, "--ip", "127.0.0.1", "--port", "0",
                 "--mesh-broadcast-timeout", str(MESH_TIMEOUT_S)],
                cwd=HERE, env=env, stdout=f, stderr=subprocess.STDOUT))
    live = re.compile(r"Engine API is live at http://127\.0\.0\.1:(\d+)\.")
    url = None
    try:
        while url is None:
            check(all(p.poll() is None for p in procs),
                  "a mesh deploy process exited: "
                  + " | ".join(log_tail(log) for log in logs))
            check(time.perf_counter() - t0 < DEPLOY_TIMEOUT_S,
                  "the mesh deploy is not live: "
                  + " | ".join(log_tail(log) for log in logs))
            with open(logs[0], errors="replace") as f:
                m = live.search(f.read())
            if m:
                url = f"http://127.0.0.1:{m.group(1)}"
            else:
                time.sleep(0.25)
        alive_s = time.perf_counter() - t0
        U, V = tables
        view = host_view(types.SimpleNamespace(
            user_ix=pd.user_ix, item_ix=pd.item_ix), U, V)
        truth = store_truth(view)
        U64, V64 = U.astype(np.float64), V.astype(np.float64)
        rng = np.random.default_rng(9)
        before = get_json(url + "/stats.json")["meshCollectives"]
        exact, lat = 0, []
        for _ in range(SHARDED_QUERIES):
            q = {"user": pd.user_ix.id_of(int(rng.integers(len(pd.user_ix)))),
                 "num": SERVE_NUM}
            t1 = time.perf_counter()
            status, body = post(url + "/queries.json", json.dumps(q).encode())
            lat.append((time.perf_counter() - t1) * 1e3)
            check(status == 200, f"sharded_mesh: {q} answered {status} {body}")
            exact += hold_served(body, q, view, U64, V64, truth,
                                 f"sharded_mesh query {q}")
        stats = get_json(url + "/stats.json")
        after = stats["meshCollectives"]
        per_query = {k: (after[k]["bytes"] - before.get(k, {}).get(
            "bytes", 0)) / SHARDED_QUERIES for k in after if k != "total"}
        check(stats["meshCoordinator"] == {"processes": 2,
                                           "poisoned": False,
                                           "shutdown": False},
              f"the mesh coordinator reads {stats['meshCoordinator']}")
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(timeout=60)
        t1 = time.perf_counter()
        status, body = post(url + "/queries.json", json.dumps(
            {"user": pd.user_ix.id_of(1), "num": SERVE_NUM}).encode())
        first_503_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        status2, _ = post(url + "/queries.json", json.dumps(
            {"user": pd.user_ix.id_of(2), "num": SERVE_NUM}).encode())
        second_503_s = time.perf_counter() - t1
        poisoned = get_json(url + "/stats.json")["meshCoordinator"]
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        emit("sharded_mesh", processes=2, shards=SHARDS, alive_s=alive_s,
             queries=SHARDED_QUERIES, ids_equal_f64=exact,
             p50_ms=float(np.percentile(lat[1:], 50)),
             first_query_ms=lat[0], collective_bytes_per_query=per_query,
             after_kill={"status": status, "s": first_503_s,
                         "next_status": status2, "next_s": second_503_s,
                         "message": body.get("message")},
             coordinator=poisoned)
        check(status == 503 and first_503_s <= MESH_TIMEOUT_S + 1.0,
              f"after the worker's SIGKILL a query answered {status} in "
              f"{first_503_s:.2f} s, not 503 within {MESH_TIMEOUT_S} s")
        check(status2 == 503 and second_503_s < 1.0,
              f"the next query answered {status2} in {second_503_s:.2f} s")
        check(poisoned["poisoned"] is True,
              f"/stats.json meshCoordinator reads {poisoned}")
        check("\npio_engine_mesh_poisoned 1\n" in metrics,
              "/metrics does not read pio_engine_mesh_poisoned 1")
    finally:
        if url is not None:
            try:
                post(url + "/stop", b"")
            except OSError:
                pass
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_metrics(text: str) -> tuple:
    """A Prometheus text exposition parsed strictly: ({family: type},
    {(sample name, ((label, value), ...)): value}). Fails the run on a
    line that is not a HELP, TYPE or sample line, a sample of no declared
    family, or a value that is not a number."""
    families, samples = {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            families[name] = kind
            continue
        m = _SAMPLE.match(line)
        check(m is not None, f"/metrics line does not parse: {line!r}")
        name, labels, value = m.groups()
        base = next((f for f in (name, name.rsplit("_", 1)[0])
                     if f in families), None)
        check(base is not None, f"/metrics sample {name} has no family")
        key = (name, tuple(_LABEL.findall(labels or "")))
        samples[key] = float(value)
    return families, samples


def scrape(url: str) -> tuple:
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        check(r.headers["Content-Type"].startswith("text/plain; "
                                                   "version=0.0.4"),
              f"/metrics content type {r.headers['Content-Type']}")
        return parse_metrics(r.read().decode())


def check_families(families: dict, want, what: str) -> None:
    missing = sorted(set(want) - set(families))
    check(not missing, f"{what} /metrics lacks {missing}")


def log_tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def span_names(node: dict) -> list:
    return [c["name"] for c in node.get("children", ())]


def post_traced(url: str, body, trace_id: str) -> tuple:
    """(status, parsed answer) of a POST of `body` as JSON carrying
    `X-PIO-Trace-Id: trace_id`."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json",
                 "X-PIO-Trace-Id": trace_id})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def device_trace_events(path: str) -> tuple:
    """A Chrome trace's (kernel events, graph launches, CG kernels)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    graphs = [e for e in events
              if str(e.get("name")).startswith("cudaGraphLaunch")]
    cg = [e for e in kernels if re.search(CG_KERNEL_NAME, str(e["name"]))]
    return kernels, graphs, cg


def phase_cli_deploy(variants: dict, workdir: str, deps: dict,
                     first_queries=None, warmed: bool = True,
                     extra_args=(), extra_env=None) -> None:
    """Start `python -m predictionio_tpu_torch deploy --port 0` for each
    template (all at once, `PIO_SERVE_PACK` unset: the default f16
    readback), read the port each bound from the line it prints, wait
    until each answers GET /, then read its warm-up (`aotWarm`: the
    graphs its `aot_warm_specs` captured) from /stats.json and time its
    first query (`first_queries` by name, a non-empty answer expected; by
    default a recommendation or similar-product query). An algorithm
    without `aot_warm_specs` is not warmed (as the reference's):
    `warmed` False expects no capture. `extra_args` and `extra_env` go to every deploy command. The
    deployments go into `deps` by template as they start; the caller
    stops them."""
    env = {k: v for k, v in os.environ.items() if k != "PIO_SERVE_PACK"}
    env.update(extra_env or {})
    for name, path in variants.items():
        log = os.path.join(workdir, f"deploy_{name}.log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch", "deploy",
                 "-v", path, "--ip", "127.0.0.1", "--port", "0",
                 *extra_args],
                cwd=HERE, env=env, stdout=f, stderr=subprocess.STDOUT)
        deps[name] = {"proc": proc, "log": log, "t0": time.perf_counter()}
    live = re.compile(r"Engine API is live at http://127\.0\.0\.1:(\d+)\.")
    for name, dep in deps.items():
        deadline = dep["t0"] + DEPLOY_TIMEOUT_S
        while True:
            check(dep["proc"].poll() is None,
                  f"deploy of {name} exited {dep['proc'].returncode}: "
                  f"{log_tail(dep['log'])}")
            if "port" not in dep:
                with open(dep["log"], errors="replace") as f:
                    m = live.search(f.read())
                if m:
                    dep["port"] = int(m.group(1))
                    dep["url"] = f"http://127.0.0.1:{dep['port']}"
            try:
                if "url" in dep:
                    status = get_json(dep["url"] + "/")
                    break
            except OSError:
                pass
            check(time.perf_counter() < deadline, f"deploy of {name} not "
                  f"alive in {DEPLOY_TIMEOUT_S} s: {log_tail(dep['log'])}")
            time.sleep(0.25)
        alive_s = time.perf_counter() - dep["t0"]
        warm = get_json(dep["url"] + "/stats.json")["aotWarm"]
        check(warm is not None and (warm["compiled"] > 0) == warmed
              and warm["compiled"] == warm["specs"],
              f"deploy of {name}: warm-up {warm}, warmed={warmed} "
              "expected")
        query = (first_queries or {}).get(name) or (
            {"user": "u1", "num": SERVE_NUM} if name == "recommendation"
            else {"items": ["i1"], "num": SERVE_NUM})
        t0 = time.perf_counter()
        code, body = post(dep["url"] + "/queries.json",
                          json.dumps(query).encode())
        first_ms = dep["first_query_ms"] = (time.perf_counter() - t0) * 1e3
        check(code == 200 and next(iter(body.values())),
              f"{name}'s first query answered {code} {body}")
        emit("cli_deploy", template=name, instance=status[
            "engineInstanceId"], pid=dep["proc"].pid, alive_s=alive_s,
             warm=warm, first_query_ms=first_ms)


def closed_loop(url: str, per_client: list) -> tuple:
    """Each client thread POSTs its queries one after another; all start
    together. Returns ([(query, status, body, ms)], wall seconds)."""
    results, wall = closed_loop_raw(url, per_client)
    return [(q, code, json.loads(data), (t1 - t0) * 1e3)
            for q, code, data, _, t0, t1 in results], wall


def closed_loop_raw(url: str, per_client: list,
                    path: str = "/queries.json") -> tuple:
    """`closed_loop` keeping each response's bytes and headers and its
    send and receive times: ([(query, status, bytes, headers, t_sent,
    t_received)], wall seconds). The bodies go to `url` + `path`."""
    results = [None] * len(per_client)
    start = threading.Barrier(len(per_client) + 1)

    def client(c):
        out = []
        start.wait()
        for q in per_client[c]:
            t0 = time.perf_counter()
            code, data, headers = post_raw(url + path,
                                           json.dumps(q).encode())
            out.append((q, code, data, headers, t0, time.perf_counter()))
        results[c] = out

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(per_client))]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client hung")
    return [r for rs in results for r in rs], wall


def rec_plane_queries(model, truth, rng) -> list:
    """Per client: base, categories, creationYear and both in turn, the
    last query an unknown user."""
    cats = sorted(set().union(*truth[0]))
    out = []
    for c in range(SERVE_CLIENTS):
        qs = []
        for n in range(SERVE_PER_CLIENT - 1):
            q = {"user": model.user_ix.id_of(int(rng.integers(len(
                model.user_ix)))), "num": SERVE_NUM}
            if (c + n) % 4 in (1, 3):
                q["categories"] = [str(x) for x in rng.choice(
                    cats, 1 + n % 2, replace=False)]
            if (c + n) % 4 in (2, 3):
                q["creationYear"] = int(rng.integers(*STORE_YEARS))
            qs.append(q)
        qs.append({"user": f"no-such-user-{c}", "num": SERVE_NUM})
        out.append(qs)
    return out


def similar_plane_queries(model, rng) -> list:
    """Per client: 1-3 query items, every other query with 1-2 of the
    items' categories."""
    cats = sorted({c for cs in store_items()[0] for c in cs})
    out = []
    for c in range(SERVE_CLIENTS):
        qs = []
        for n in range(SERVE_PER_CLIENT):
            q = {"items": model.item_ix.ids_of(rng.choice(
                len(model.item_ix), 1 + (c + n) % 3, replace=False)),
                 "num": SERVE_NUM}
            if (c + n) % 2:
                q["categories"] = [str(x) for x in rng.choice(
                    cats, 1 + n % 2, replace=False)]
            qs.append(q)
        out.append(qs)
    return out


def hold_similar(body: dict, query: dict, model, T64, cats,
                 what: str) -> bool:
    """Hold one similar-product answer against the float64 score of the
    served sum over the query items' normalized rows, under the mask
    built from the seeded categories (the query items excluded, score >
    0): ids as `held_to_f64` (TIE_ATOL), scores within f16 rounding
    (2^-11 |s|) plus the f32 dot's bound. Returns whether exact."""
    q_ix = [model.item_ix[i] for i in query["items"]]
    qsum = T64[q_ix].sum(axis=0)
    s64 = T64 @ qsum
    allowed = s64 > 0
    allowed[q_ix] = False
    if query.get("categories"):
        want = set(query["categories"])
        allowed &= np.array([bool(c & want) for c in cats])
    s64 = np.where(allowed, s64, -np.inf)
    top = np.argsort(-s64, kind="stable")[:query["num"]]
    top = top[np.isfinite(s64[top])]
    got = [s["item"] for s in body["itemScores"]]
    exact = held_to_f64(got, s64, top, model, what)
    got_ix = np.array([model.item_ix[g] for g in got], dtype=np.int64)
    served = np.array([s["score"] for s in body["itemScores"]])
    tol = ((RANK + 3) * 2.0 ** -24 * (np.abs(T64[got_ix]) @ np.abs(qsum))
           + F16_REL * np.abs(s64[got_ix]))
    check(bool((np.abs(served - s64[got_ix]) <= tol).all()),
          f"{what}: scores off the float64 scores by more than the f16 "
          "rounding bound")
    return exact


def stats_delta(before: dict, after: dict) -> dict:
    """The serve plane's counters over one load, from two /stats.json."""
    from predictionio_tpu_torch.ops.readback import overlap_frac
    d = {k: after[k] - before[k] for k in (
        "batches", "batchedQueries", "immediateBatches", "exitFullBatch",
        "exitDrainGate", "exitWindow", "exitAdaptive", "shedQueries",
        "pipelineStalls")}
    rb0, rb1 = before["readback"], after["readback"]
    windows = rb1["windows"] - rb0["windows"]
    nbytes = rb1["bytes"] - rb0["bytes"]
    d.update(
        avg_batch=d["batchedQueries"] / max(d["batches"], 1),
        max_batch=after["maxBatchSize"], d2h_windows=windows,
        d2h_bytes=nbytes, d2h_bytes_per_window=nbytes / max(windows, 1),
        d2h_wait_ms_per_window=(rb1["wait_s"] - rb0["wait_s"]) * 1e3
        / max(windows, 1),
        d2h_span_ms_per_window=(rb1["span_s"] - rb0["span_s"]) * 1e3
        / max(windows, 1),
        overlap_frac=overlap_frac(rb1, rb0),
        stage_ms_per_window={
            k: (after["stageSeconds"][k] - before["stageSeconds"][k]) * 1e3
            / max(d["batches"], 1) for k in after["stageSeconds"]})
    return d


def window_breakdown(name: str, algo, model, queries: list) -> dict:
    """Where one full window's time goes, measured in this process at the
    plane's shapes (16 queries, top-k bucket 16): the host's mask
    building, the device's matmul + top-k + pack (CUDA events), and the
    answers' JSON serialization."""
    from predictionio_tpu_torch.ops import als as ALS
    from predictionio_tpu_torch.ops import readback
    from predictionio_tpu_torch.ops.similarity import _masked_topk_impl
    from predictionio_tpu_torch.utils.device_cache import cached_put_rows
    qs = [q for q in queries if "categories" in q][:16]
    t0 = time.perf_counter()
    if name == "recommendation":
        Q = [model.als.user_factors[model.user_ix[q["user"]]] for q in qs]
        masks = [model.allowed_mask(algo.query_class.from_dict(q))
                 for q in qs]
    else:
        Q, masks = [], []
        for q in qs:
            query = algo.query_class.from_dict(q)
            q_ix = model.item_ix.to_indices(list(query.items))
            Q.append(model.item_factors_normalized[q_ix].sum(axis=0))
            masks.append(algo._build_mask(model, query, q_ix))
    mask_ms = (time.perf_counter() - t0) * 1e3
    table = (model.als.tables()[1] if name == "recommendation"
             else model.table())
    qd = torch.tensor(np.stack(Q), device=table.device)
    md = torch.tensor(np.stack(masks), device=table.device)

    def masked():
        s_, i_ = _masked_topk_impl(qd, table, md, SERVE_K_BUCKET,
                                   name != "recommendation")
        return readback.pack_device(s_, i_, readback.PACK_F16)

    out = {"template": name, "queries": len(qs),
           "mask_host_ms": mask_ms,
           "masked_matmul_topk_pack_ms": cuda_ms(masked, 20)}
    if name == "recommendation":
        als = model.als
        dims = ALS.batch_predict_dims(als, 16, SERVE_NUM)
        U = cached_put_rows(als.user_factors, dims["u"], als.device)
        V = cached_put_rows(als.item_factors, dims["i"], als.device)
        ixs = torch.arange(16, device=U.device)
        out["plain_matmul_topk_pack_ms"] = cuda_ms(
            lambda: ALS._users_topk_b(U, V, ixs, als.n_items,
                                      SERVE_K_BUCKET, readback.PACK_F16), 20)
    answers = dict(algo.batch_predict(model, [
        (k, algo.query_class.from_dict(q)) for k, q in enumerate(qs)]))
    t0 = time.perf_counter()
    for r in answers.values():
        json.dumps(r.to_dict())
    out["serialize_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def serve_program_ms(name: str, model, b: int) -> float:
    """This process's CUDA-event time of the program a deployed window of
    `b` queries replays: the plain top-k (recommendation) or the masked
    one (similar-product), on the same tables padded to their buckets,
    with the f16 pack."""
    from predictionio_tpu_torch.ops import als as ALS
    from predictionio_tpu_torch.ops import readback
    from predictionio_tpu_torch.ops import similarity as SIM
    from predictionio_tpu_torch.utils.device_cache import cached_put_rows
    if name == "recommendation":
        als = model.als
        dims = ALS.batch_predict_dims(als, b, SERVE_NUM)
        U = cached_put_rows(als.user_factors, dims["u"], als.device)
        V = cached_put_rows(als.item_factors, dims["i"], als.device)
        ixs = torch.arange(b, device=U.device)
        return cuda_ms(lambda: ALS._users_topk_b(
            U, V, ixs, als.n_items, dims["k"], readback.PACK_F16), 20)
    table = model.table()
    n, r = table.shape
    dims = SIM.masked_topk_dims(n, r, b, SERVE_NUM, True)
    T = cached_put_rows(table, dims["i"])
    q = table[:b].clone()
    allowed = torch.zeros((b, dims["i"]), dtype=torch.bool,
                          device=table.device)
    allowed[:, :n] = True
    return cuda_ms(lambda: SIM._masked_topk_b(
        T, q, allowed, dims["k"], True, readback.PACK_F16), 20)


def compile_plane_check(name: str, dep: dict, stats: dict,
                        model) -> dict:
    """The deployed process's compile plane after its bursts: every
    dispatch replayed a warmed graph (`aot.hitRate` 1.0, no miss, no
    failed bucket); the p50 of its sampled device ms a window (each a
    replay's own CUDA-event stamps) within DEVICE_TIME_FACTOR of the
    range of this process's readings of the same program at the window's
    smallest and largest batch bucket (1 and 16; the eager b 1 reading
    is the larger: a one-row top-k); the occupancy above 0; and its
    /metrics, parsed strictly, carrying every ENGINE_FAMILIES family."""
    aot, dt = stats["aot"], stats["deviceTime"]
    check(aot["hitRate"] == 1.0 and aot["failedBuckets"] == 0
          and not any(aot["dispatchMisses"].values()),
          f"{name}: hit rate {aot['hitRate']}, misses "
          f"{aot['dispatchMisses']}, {aot['failedBuckets']} failed buckets")
    label = ("batch_predict" if name == "recommendation"
             else "batch_predict_masked")
    # the least of three readings: a busy host only adds launch gaps
    own = {b: min(serve_program_ms(name, model, b) for _ in range(3))
           for b in (1, 16)}
    sampled = dt["sampledWallMs"][label]
    check(min(own.values()) / DEVICE_TIME_FACTOR <= sampled["p50_ms"]
          <= max(own.values()) * DEVICE_TIME_FACTOR,
          f"{name}: sampled device p50 {sampled['p50_ms']} ms a window vs "
          f"{own[1]:.4f} (b 1) and {own[16]:.4f} ms (b 16) measured here")
    check(dt["secondsByExecutable"][label] > 0 and dt["occupancy"] > 0,
          f"{name}: device time {dt}")
    t0 = time.perf_counter()
    families, samples = scrape(dep["url"])
    scrape_ms = (time.perf_counter() - t0) * 1e3
    check_families(families, ENGINE_FAMILIES, name)
    hits = samples[("pio_aot_dispatch_hits_total",
                    (("executable", label),))]
    # the deployed process's torch.cuda.memory_allocated()
    in_use = [v for lab, v in labelled(samples, "pio_jax_device_memory_bytes")
              if lab.get("kind") == "bytes_in_use"]
    check(len(in_use) == 1, f"{name}: device memory samples {in_use}")
    check(hits == aot["dispatchHits"][label],
          f"{name}: /metrics counts {hits} hits, /stats.json "
          f"{aot['dispatchHits'][label]}")
    return {"hit_rate": aot["hitRate"], "dispatch_hits": aot["dispatchHits"],
            "own_program_ms": own,
            "executables_resident": aot["executablesResident"],
            "buckets": aot["bucketsCompiled"],
            "compile_s": aot["compileSeconds"],
            "device_s": dt["secondsByExecutable"],
            "dispatch_s": dt["dispatchSecondsByExecutable"],
            "sampled_ms": dt["sampledWallMs"], "occupancy": dt["occupancy"],
            "swap_to_first_query_ms": stats["swapToFirstQueryMs"],
            "aot_warm": stats["aotWarm"], "metrics_families": len(families),
            "metrics_samples": len(samples), "scrape_ms": scrape_ms,
            "memory_allocated": int(in_use[0])}


def diag_queries(name: str, model, rng) -> list:
    """Fresh queries (result-cache misses) for the device-trace burst."""
    if name == "recommendation":
        return [{"user": model.user_ix.id_of(int(k)), "num": SERVE_NUM}
                for k in rng.choice(len(model.user_ix), SERVE_CLIENTS,
                                    replace=False)]
    return [{"items": [model.item_ix.id_of(int(k))], "num": SERVE_NUM}
            for k in rng.choice(len(model.item_ix), SERVE_CLIENTS,
                                replace=False)]


def phase_diagnostics(name: str, dep: dict, model, workdir: str) -> dict:
    """The diagnostics plane of a deployed process after its serve-plane
    bursts: the `query` traces (a `batch_wait` span, one link) and the
    `batch_predict` windows (the reference's four spans, linked both ways
    to their queries); an inbound `X-PIO-Trace-Id` adopted; the newest
    exemplar on `pio_engine_query_seconds` resolving in `/traces.json`; the
    `/slow.json` waterfalls (count and median ms of each stage);
    `/health.json` with the engine SLOs; `/flight.json` holding
    `model_load` and `aot_warm`; a torch.profiler device trace started
    and stopped over `/profile.json` around a 32-query burst of fresh
    queries, whose Chrome trace must hold CUDA kernels and graph
    launches; the sampler's report; `status --telemetry --slo` against
    the deploy."""
    url = dep["url"]
    t0 = time.perf_counter()
    queries = get_json(url + "/traces.json?kind=query&n=128")["traces"]
    windows = get_json(url + "/traces.json?kind=batch_predict&n=128"
                       )["traces"]
    traces_ms = (time.perf_counter() - t0) * 1e3 / 2
    check(queries and windows, f"{name}: no query or window traces")
    for t in queries:
        check(span_names(t["root"]) == ["batch_wait"]
              and len(t["links"]) == 1,
              f"{name}: query trace {span_names(t['root'])} links "
              f"{t['links']}")
    by_id = {t["traceId"]: t for t in queries}
    linked = 0
    for w in windows:
        check(span_names(w["root"]) == WINDOW_SPANS and w["links"]
              and {"formationMs", "completionWaitMs", "batch"}
              <= set(w["root"]["attrs"]),
              f"{name}: window trace {span_names(w['root'])} "
              f"{w['root'].get('attrs')}")
        for tid in w["links"]:
            if tid in by_id:
                check(by_id[tid]["links"] == [w["traceId"]],
                      f"{name}: query {tid} does not link its window")
                linked += 1
    check(linked > 0, f"{name}: no window linked a query in the rings")
    inbound = f"{0x5e0000 + len(name):016x}"
    q = diag_queries(name, model, np.random.default_rng(40))[0]
    code, _ = post_traced(url + "/queries.json", dict(q, num=SERVE_NUM - 1),
                          inbound)
    got = get_json(url + f"/traces.json?trace_id={inbound}")["traces"]
    check(code == 200 and any(t["traceId"] == inbound
                              and t["kind"] == "query" for t in got),
          f"{name}: the inbound trace id was not adopted: {got}")
    t0 = time.perf_counter()
    with urllib.request.urlopen(url + "/metrics?exemplars=1",
                                timeout=60) as r:
        text = r.read().decode()
    scrape_ms = (time.perf_counter() - t0) * 1e3
    # each bucket keeps its latest query; the newest of them is in the
    # trace ring (a bucket last reached by an earlier burst may name a
    # trace the ring has since dropped)
    ex = re.findall(r'^pio_engine_query_seconds_bucket\{[^}]*\} \S+ '
                    r'# \{trace_id="([0-9a-f]+)"\} \S+ (\S+)$', text, re.M)
    check(ex, f"{name}: no exemplar on pio_engine_query_seconds")
    newest = max(ex, key=lambda e: float(e[1]))[0]
    got = get_json(url + f"/traces.json?trace_id={newest}")["traces"]
    check(any(t["traceId"] == newest for t in got),
          f"{name}: exemplar {newest} does not resolve")
    slow = get_json(url + "/slow.json?n=64")
    stages = {}
    for row in slow["slow"]:
        for st in row["stages"]:
            stages.setdefault(st["stage"], []).append(st["ms"])
    check(slow["recorded"] > 0 and set(stages) <= set(SLOW_STAGES)
          and {"queue_wait", "dispatch", "d2h_wait"} <= set(stages),
          f"{name}: /slow.json recorded {slow['recorded']}, stages "
          f"{sorted(stages)}")
    waterfall = {st: {"n": len(stages[st]),
                      "median_ms": float(np.median(stages[st]))}
                 for st in SLOW_STAGES if st in stages}
    health = get_json(url + "/health.json")
    check(health["status"] in ("ok", "burning", "breached")
          and [s["name"] for s in health["slo"]] == ENGINE_SLOS,
          f"{name}: /health.json {health}")
    kinds = {r["kind"] for r in get_json(url + "/flight.json?n=2048"
                                         )["records"]}
    check({"model_load", "aot_warm"} <= kinds,
          f"{name}: /flight.json kinds {sorted(kinds)}")
    trace_dir = os.path.join(workdir, f"trace_{name}")
    t0 = time.perf_counter()
    code, started = post_json(url + "/profile.json",
                              {"action": "start", "dir": trace_dir})
    start_s = time.perf_counter() - t0
    check(code == 200 and started["tracing"]
          and started["activities"] == ["CPU", "CUDA"],
          f"{name}: profile start answered {code} {started}")
    burst = diag_queries(name, model, np.random.default_rng(41))
    results, wall = closed_loop(url, [[q] for q in burst])
    check(all(r[1] == 200 for r in results), f"{name}: a traced query "
          "failed")
    t0 = time.perf_counter()
    code, stopped = post_json(url + "/profile.json", {"action": "stop"})
    stop_s = time.perf_counter() - t0
    check(code == 200 and not stopped["tracing"]
          and os.path.isfile(stopped.get("traceFile", "")),
          f"{name}: profile stop answered {code} {stopped}")
    kernels, graphs, _ = device_trace_events(stopped["traceFile"])
    check(kernels and graphs, f"{name}: the device trace holds "
          f"{len(kernels)} kernels and {len(graphs)} graph launches")
    report = get_json(url + "/profile.json?action=report&top=5")
    check(report["running"] and report["samples"] > 0
          and report["topStacks"], f"{name}: profiler report {report}")
    rc, said = cli_out("status", "--telemetry", "--slo", "--url", url)
    check(rc == 0 and "overall:" in said and "serve_p99" in said
          and "Slowest recent traces" in said,
          f"{name}: status --telemetry --slo exited {rc}: {said}")
    out = {"query_traces": len(queries), "window_traces": len(windows),
           "windows_linked": linked, "traces_json_ms": traces_ms,
           "exemplars": len(ex), "metrics_exemplar_scrape_ms": scrape_ms,
           "slow_recorded": slow["recorded"],
           "slow_threshold_ms": slow["thresholdMs"],
           "waterfall": waterfall, "health": health["status"],
           "flight_kinds": sorted(kinds), "profile_start_s": start_s,
           "profile_stop_s": stop_s, "traced_burst_qps":
           len(results) / wall, "trace_kernels": len(kernels),
           "trace_graph_launches": len(graphs),
           "profiler_samples": report["samples"]}
    emit("diagnostics", template=name, **out)
    return out


def phase_serve_plane(name: str, dep: dict, algo, model, per_client,
                      hold) -> dict:
    """32 closed-loop clients x 20 queries against a deployed process;
    every answer held after the load (`hold`), the serve plane's counters
    read from /stats.json around it."""
    t_phase = time.perf_counter()
    before = get_json(dep["url"] + "/stats.json")
    results, wall = closed_loop(dep["url"], per_client)
    after = get_json(dep["url"] + "/stats.json")
    exact = empty = 0
    for q, code, body, _ in results:
        check(code == 200, f"{name} serve_plane query {q} answered {code}")
        if str(q.get("user", "")).startswith("no-such-user"):
            check(body == {"itemScores": []},
                  f"unknown user answered {body}")
            empty += 1
            continue
        exact += hold(body, q, f"{name} serve_plane query {q}")
    ms = np.array([r[3] for r in results])
    d = stats_delta(before, after)
    # the default deploy's result cache answers a repeated query
    # before the micro-batcher
    hits = after["resultCache"]["hits"] - before["resultCache"]["hits"]
    window = window_breakdown(name, algo, model,
                              [q for qs in per_client for q in qs])
    plane = compile_plane_check(name, dep, after, model)
    emit("serve_plane", template=name, clients=SERVE_CLIENTS,
         queries=len(results), cache_hits=hits, ids_equal_f64=exact,
         f32_tie_swaps=len(results) - empty - exact, unknown_empty=empty,
         wall_s=wall, qps=len(results) / wall,
         p50_ms=float(np.percentile(ms, 50)),
         p99_ms=float(np.percentile(ms, 99)), max_ms=float(ms.max()),
         **d, window=window, compile_plane=plane,
         memory_allocated=plane["memory_allocated"],
         phase_s=time.perf_counter() - t_phase)
    check(d["batchedQueries"] + hits == len(results),
          f"{d['batchedQueries']} queries went through the micro-batcher "
          f"and {hits} were cache hits, of {len(results)}")
    check(d["avg_batch"] > 1, f"{name}: realized batch {d['avg_batch']:.3f}"
          " under 32 clients")
    slot = 6 * SERVE_K_BUCKET
    check(d["d2h_windows"] > 0 and d["d2h_bytes"] % slot == 0
          and d["d2h_windows"] * slot <= d["d2h_bytes"]
          <= d["d2h_windows"] * slot * 16,
          f"{name}: {d['d2h_bytes']} d2h bytes over {d['d2h_windows']} "
          f"windows is not 6 bytes x 16 slots x a pow2 batch <= 16 each")
    return d


def phase_undeploy(deps: dict) -> None:
    """`undeploy` for each deployment, through the CLI's `cli.main` in
    this process (`cli_out`: no interpreter and torch import a call);
    each deploy process must then exit 0."""
    for name, dep in deps.items():
        rc, said = cli_out("undeploy", "--ip", "127.0.0.1", "--port",
                           str(dep["port"]))
        check(rc == 0, f"undeploy of {name} exited {rc}: {said}")
        try:
            rc = dep["proc"].wait(timeout=60)
        except subprocess.TimeoutExpired:
            rc = None
        check(rc == 0, f"the {name} deploy process exited {rc} after "
              f"undeploy: {log_tail(dep['log'])}")
        emit("undeploy", template=name, said=said.strip(), deploy_exit=rc)


def phase_inflight_bench(path: str, iid: str, model, truth) -> dict:
    """The reference's REST bench shape against the deployed
    recommendation instance `iid` (named: the fold has published a newer
    version by then): an in-process server (`load()` from the store,
    micro_batch 32, the default f16 readback) with
    `serve_inflight` 2 (the pipelined executor) and one with 1 (the
    synchronous loop), 16 closed-loop clients x 20 plain queries a
    burst, after an untimed warm burst on each; bursts in `BENCH_ORDER`.
    Every answer is held as serve_plane's are. Reads each burst's qps,
    p50/p99, realized batch, stalls and readback wait. The result cache
    is off, as in the reference's batcher sweeps: the bursts repeat their
    queries, and hits would bypass the executor it measures."""
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    U64 = model.als.user_factors.astype(np.float64)
    V64 = model.als.item_factors.astype(np.float64)
    rng = np.random.default_rng(10)
    per_client = [[{"user": model.user_ix.id_of(int(rng.integers(len(
        model.user_ix)))), "num": SERVE_NUM}
        for _ in range(BENCH_PER_CLIENT)] for _ in range(BENCH_CLIENTS)]
    servers, runs = {}, []
    try:
        for n in sorted(set(BENCH_ORDER)):
            servers[n] = EngineServer(ServerConfig(
                ip="127.0.0.1", port=0, engine_variant=path,
                engine_instance_id=iid, micro_batch=BENCH_MICRO_BATCH,
                serve_inflight=n, result_cache=False)).load().start()
            check(servers[n].batcher.pipelined == (n > 1),
                  f"serve_inflight={n} did not pick its executor")
            closed_loop(f"http://127.0.0.1:{servers[n].config.port}",
                        [qs[:4] for qs in per_client])
        for n in BENCH_ORDER:
            srv = servers[n]
            before = srv.stats()
            results, wall = closed_loop(
                f"http://127.0.0.1:{srv.config.port}", per_client)
            after = srv.stats()
            for q, code, body, _ in results:
                check(code == 200, f"inflight_bench query {q} answered "
                      f"{code}")
                hold_served(body, q, model, U64, V64, truth,
                            f"inflight_bench ({n} in flight) query {q}",
                            f16=True)
            ms = np.array([r[3] for r in results])
            d = stats_delta(before, after)
            runs.append({
                "inflight": n, "qps": len(results) / wall,
                "p50_ms": float(np.percentile(ms, 50)),
                "p99_ms": float(np.percentile(ms, 99)),
                "avg_batch": d["avg_batch"],
                "pipeline_stalls": d["pipelineStalls"],
                "d2h_wait_ms_per_window": d["d2h_wait_ms_per_window"],
                "overlap_frac": d["overlap_frac"]})
    finally:
        for srv in servers.values():
            srv.stop()
    median = {n: {k: float(np.median([r[k] for r in runs
                                      if r["inflight"] == n]))
                  for k in ("qps", "p50_ms", "p99_ms", "avg_batch")}
              for n in servers}
    emit("inflight_bench", clients=BENCH_CLIENTS,
         queries=BENCH_CLIENTS * BENCH_PER_CLIENT,
         micro_batch=BENCH_MICRO_BATCH, runs=runs, median=median)
    return median


def stop_all(deps: dict) -> None:
    for dep in deps.values():
        if dep["proc"].poll() is None:
            dep["proc"].kill()
            dep["proc"].wait(timeout=60)


def serve_plane_phases(rec_path: str, rec_model, workdir: str) -> tuple:
    """The serve plane: the similar-product template trained from the
    store through the command line (`cli_train`), both templates
    deployed as subprocesses (`cli_deploy`), held under 32 concurrent
    clients (`serve_plane`); `pio update` against the deployed
    recommendation process (`fold_update`) and `pio rollback` of it
    (`rollback_cli`); both undeployed (`undeploy`); then the
    recommendation instance at the reference bench's shape with 2
    windows in flight and with 1 (`inflight_bench`), with the result
    cache (`cache_bench`), under a fold (`cache_fold`) and as a guarded
    deploy (`canary`), and the similar-product instance folded in
    process (`fold_inprocess`). Returns the similar-product train's
    Cholesky kernel launches, the folds' CG kernel launches and (the
    served recommendation instance, the similar-product variant and its
    instance), which `tenancy` serves again."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models import recommendation as TR
    from predictionio_tpu_torch.models import similarproduct as TS
    sim_path = os.path.join(workdir, "similar.json")
    similar_variant(sim_path)
    sim_iid, sim_trained, launches = workflow_train(sim_path, "cli_train",
                                                    kernel="chol_solve")
    m = sim_trained.models[0]
    check(all(bool(np.isfinite(t).all()) for t in (
        m.user_factors, m.item_factors_raw, m.item_factors_normalized)),
        "the similar-product factors are not finite")
    del sim_trained, m
    sim_algo = TS.ALSAlgorithm(TS.ALSAlgorithmParams(rank=RANK))
    (sim_model,) = TS.SimilarProductEngineFactory.apply().deserialize_models(
        Storage.get_model_data_models().get(sim_iid).models, sim_iid)
    sim_algo.place_model(sim_model)
    rec_algo = TR.ALSAlgorithm(TR.ALSAlgorithmParams(
        rank=RANK, return_properties=("creationYear",)))
    deps = {}
    try:
        # a sampled device time every 4th window (the default is 16):
        # enough samples in one burst for `compile_plane_check`'s p50
        phase_cli_deploy({"recommendation": rec_path,
                          "similarproduct": sim_path}, workdir, deps,
                         extra_env={"PIO_DEVICE_SYNC_EVERY": "4",
                                    "PIO_SLOW_QUERY_MS": str(SLOW_QUERY_MS)})
        truth = store_truth(rec_model)
        U64 = rec_model.als.user_factors.astype(np.float64)
        V64 = rec_model.als.item_factors.astype(np.float64)
        phase_serve_plane(
            "recommendation", deps["recommendation"], rec_algo, rec_model,
            rec_plane_queries(rec_model, truth, np.random.default_rng(8)),
            lambda body, q, what: hold_served(body, q, rec_model, U64, V64,
                                              truth, what, f16=True))
        del U64, V64
        T64 = sim_model.item_factors_normalized.astype(np.float64)
        cats = store_truth(sim_model)[0]
        phase_serve_plane(
            "similarproduct", deps["similarproduct"], sim_algo, sim_model,
            similar_plane_queries(sim_model, np.random.default_rng(9)),
            lambda body, q, what: hold_similar(body, q, sim_model, T64,
                                               cats, what))
        del T64
        phase_diagnostics("recommendation", deps["recommendation"],
                          rec_model, workdir)
        phase_diagnostics("similarproduct", deps["similarproduct"],
                          sim_model, workdir)
        rec_iid = get_json(deps["recommendation"]["url"] + "/")[
            "engineInstanceId"]
        fold_launches, version, queries = phase_fold_update(
            rec_path, deps["recommendation"], rec_model)
        phase_rollback_cli(rec_path, deps["recommendation"], rec_model,
                           rec_iid, version, queries)
        phase_undeploy(deps)
        phase_inflight_bench(rec_path, rec_iid, rec_model, truth)
    finally:
        stop_all(deps)
    phase_cache_bench(rec_path, rec_iid, rec_model, truth)
    fold_launches += phase_cache_fold(rec_path, rec_iid, rec_model)
    fold_launches += phase_canary(rec_path, rec_iid, rec_model)
    fold_launches += phase_fold_inprocess(sim_path, workdir)
    return launches, fold_launches, (rec_iid, sim_path, sim_iid)


def fold_systems(B: int, K: int, n_inert: int, gen: torch.Generator):
    """A fold batch of B systems at dimension K: `hard_systems` with its
    last `n_inert` rows inert (a padding row of the fold's plan: mask 0,
    so A = lam I and b = 0, which must solve to exactly 0)."""
    A, b = hard_systems(B, K, gen)
    A[B - n_inert:] = LAM * torch.eye(K, device="cuda")
    b[B - n_inert:] = 0
    return A.contiguous(), b.contiguous()


def phase_fold_kernel() -> list:
    """The CG kernel at the shapes the fold plans (B = 16, the fold's
    batch floor): the primal R = 200 and duals K in FOLD_K_DUAL, each with
    inert rows, and a wholly inert batch. Each is held against the plain
    CG at every checkpoint, max(1e-4, 4x its f32-vs-f64 reading); the
    primal also with `hold_kernel`'s planted faults (a dual CG converges
    within K of its K+8 steps, which hides them). Two launches must be
    bit-equal, inert rows exactly 0."""
    from predictionio_tpu_torch.ops.solve import cg_solve, cg_solve_cuda
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rows = []
    shapes = ([(RANK, 48, FOLD_INERT)]
              + [(K, K + 8, FOLD_INERT) for K in FOLD_K_DUAL]
              + [(8, 16, FOLD_B)])                 # a wholly inert batch
    for R, iters, n_inert in shapes:
        A, b = fold_systems(FOLD_B, R, n_inert, gen)
        where = f"fold shape R={R} B={FOLD_B} inert={n_inert}"
        row = {"R": R, "B": FOLD_B, "iters": iters, "inert_rows": n_inert}
        if R == RANK:
            row.update(hold_kernel(A, b, iters, where))
        else:
            per_k = []
            for k in checkpoints(iters):
                xp, xk = cg_solve(A, b, k), cg_solve_cuda(A, b, k)
                rounding = rel_err(xp.double(), cg_solve(
                    A.double(), b.double(), k)) if n_inert < FOLD_B else 0.0
                per_k.append({"k": k, "rel_err": rel_err(xk, xp),
                              "abs_err": (xk - xp).abs().max().item(),
                              "tolerance": max(KERNEL_REL_TOL,
                                               ROUNDING_FACTOR * rounding)})
            emit("checkpoints", where=where, per_checkpoint=per_k)
            for c in per_k:
                check(c["rel_err"] <= c["tolerance"]
                      or (n_inert == FOLD_B and c["abs_err"] == 0),
                      f"{where}: kernel vs plain CG rel err "
                      f"{c['rel_err']:.3g} > {c['tolerance']:.3g} after "
                      f"{c['k']} iterations")
            row.update(max_rel_err=max(c["rel_err"] for c in per_k),
                       max_abs_err=max(c["abs_err"] for c in per_k),
                       max_tolerance=max(c["tolerance"] for c in per_k))
        xk = cg_solve_cuda(A, b, iters)
        row["bitwise_repeat"] = bool(torch.equal(xk, cg_solve_cuda(A, b,
                                                                   iters)))
        row["inert_exact_zero"] = bool((xk[FOLD_B - n_inert:] == 0).all())
        row["kernel_ms"] = cuda_ms(lambda: cg_solve_cuda(A, b, iters), 20)
        row["plain_ms"] = cuda_ms(lambda: cg_solve(A, b, iters), 5)
        row["library_ms"] = cuda_ms(
            lambda: torch.linalg.solve(A, b.unsqueeze(-1)), 5)
        row["bound_ms"], row["bound_by"] = bound(*cg_cost(FOLD_B, R, iters))
        emit("fold_kernel", **row)
        check(row["bitwise_repeat"], f"{where}: two launches differ")
        check(row["inert_exact_zero"], f"{where}: inert rows are not 0")
        rows.append(row)
    return rows


def fold_truth(model, new_meta: dict) -> tuple:
    """`store_truth` for a folded model whose vocabulary grew: the seeded
    metadata of the store's items, and `new_meta` ({id: (categories,
    year)}) for the items the fold appended."""
    cats, years = store_items()
    out_c, out_y = [], []
    for i in model.item_ix.ids:
        c, y = (new_meta[i] if i in new_meta
                else (cats[int(i[1:])], years[int(i[1:])]))
        out_c.append(set(c))
        out_y.append(y)
    return out_c, np.array(out_y)


def replay_rows(algo, touched, template_model, td, U0, V0, cfg):
    """The fold of `td` from the deployed tables (U0, V0) replayed on the
    host by the plain versions (`solver='cg_cuda'` on CPU tensors runs the
    plain CG, the card's kernel's algorithm): in float64 and in float32.
    `template_model` carries the published (grown) maps, so the replay's
    rows line up with the published tables. Returns (f64 tables, f32
    tables, touched user indices, touched item indices)."""
    from predictionio_tpu_torch.online.fold_in import fold_in_coo
    from predictionio_tpu_torch.ops.als import ALSModel
    _, _, coo, tu, ti = algo.fold_data(template_model, td, *touched)
    out = []
    for dt in (np.float64, np.float32):
        m, _ = fold_in_coo(ALSModel(U0.astype(dt), V0.astype(dt), RANK,
                                    None), coo, tu, ti, cfg, device="cpu")
        out.append((m.user_factors, m.item_factors))
    return out[0], out[1], np.unique(tu), np.unique(ti)


def hold_replay(got: tuple, f64: tuple, f32: tuple, tu, ti,
                what: str) -> dict:
    """Touched rows of the card's fold within max(1e-4, 4x the plain
    replay's f32-vs-f64 reading) of the float64 replay, per table."""
    out = {}
    for name, idx, g, r64, r32 in (("user", tu, got[0], f64[0], f32[0]),
                                    ("item", ti, got[1], f64[1], f32[1])):
        ref = torch.from_numpy(r64[idx])
        reading = rel_err(torch.from_numpy(r32[idx]).double(), ref)
        err = rel_err(torch.from_numpy(g[idx]).double(), ref)
        tol = max(KERNEL_REL_TOL, ROUNDING_FACTOR * reading)
        out[name] = {"rows": int(idx.size), "rel_err": err,
                     "f32_reading": reading, "tolerance": tol}
        check(err <= tol, f"{what}: touched {name} rows off the float64 "
              f"replay by {err:.3g} > {tol:.3g}")
    return out


def fold_device_time(report: dict, what: str) -> dict:
    """The update process's device time (the fold report's `deviceTime`):
    the fold's sides booked from CUDA events, above 0, sampled."""
    seconds = report["deviceTime"]["seconds"].get("fold_side", 0.0)
    samples = report["deviceTime"]["samples"].get("fold_side", 0)
    check(seconds > 0 and samples >= 1,
          f"{what}: fold_side device time {seconds} s over {samples} "
          "samples")
    return {"fold_side_s": seconds, "fold_side_samples": samples}


def swapped_graphs(dep: dict, version: str, what: str) -> dict:
    """After a `/reload` onto `version`: the deployed process captured
    the new version's serve ladder (`aot.versions`), nothing failed."""
    aot = get_json(dep["url"] + "/stats.json")["aot"]
    buckets = aot["versions"].get(version, {})
    check(buckets.get("batch_predict") and aot["failedBuckets"] == 0,
          f"{what}: no graphs captured for {version}: {aot['versions']}, "
          f"{aot['failedBuckets']} failed")
    return aot


def replays_since(dep: dict, aot0: dict, what: str) -> dict:
    """The deployed process's replays and misses since `aot0`: the
    queries asked since came through graphs (hits grew), none missed."""
    aot = get_json(dep["url"] + "/stats.json")["aot"]
    grew = {k: v - aot0["dispatchHits"].get(k, 0)
            for k, v in aot["dispatchHits"].items()}
    missed = {k: v - aot0["dispatchMisses"].get(k, 0)
              for k, v in aot["dispatchMisses"].items()}
    check(grew.get("batch_predict", 0) > 0 and not any(missed.values()),
          f"{what}: replays {grew}, misses {missed} after the swap")
    return {"graph_replays": grew, "dispatch_misses": missed}


def phase_fold_update(rec_path: str, dep: dict, rec_model) -> tuple:
    """`pio update` against the deployed recommendation process: fresh
    events after its instance's start (FOLD_USERS known users x
    FOLD_PER_USER rates, FOLD_NEW_USERS new users x FOLD_NEW_PER_USER, and
    FOLD_NEW_ITEMS new items, each a `$set` of 1-3 of the 20 categories
    and a creationYear, with FOLD_NEW_ITEM_RATES rates on them: 256 rates,
    the reference's max_deltas), then `python -m predictionio_tpu_torch
    update --engine-port P` (one forced tick, publish, `/reload`). Holds:
    the entity-filtered read, a passed gate report, every solve a CG
    launch; untouched rows of the published tables bit-equal to the
    deployed ones, touched rows within tolerance of a float64 replay;
    72 queries (the 56 touched users and 16 others, base and categories),
    asked before the update too (so the default deploy's result cache
    holds them: the known users' answers held to the deployed tables,
    the new users' empty), against the float64 top-k of the published
    tables after it, which the `/reload` must have cleared the cache for.
    Returns (the CG launches, the published version, the queries)."""
    from predictionio_tpu_torch.data.columnar import ColumnarBatch
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models import recommendation as TR
    from predictionio_tpu_torch.online.fold_in import FoldInConfig
    app = Storage.get_meta_data_apps().get_by_name(STORE_APP)
    ev = Storage.get_events()
    rng = np.random.default_rng(11)
    n_u, n_i = len(rec_model.user_ix), len(rec_model.item_ix)
    users = rec_model.user_ix.ids_of(rng.choice(n_u, FOLD_USERS,
                                                replace=False))
    new_users = [f"fu{k}" for k in range(FOLD_NEW_USERS)]
    new_items = [f"fi{k}" for k in range(FOLD_NEW_ITEMS)]
    cat_names = sorted({c for cs in store_items()[0] for c in cs})
    new_meta = {i: (tuple(rng.choice(cat_names, int(rng.integers(1, 4)),
                                     replace=False)),
                    int(rng.integers(*STORE_YEARS))) for i in new_items}
    subj = (np.repeat(users, FOLD_PER_USER).tolist()
            + np.repeat(new_users, FOLD_NEW_PER_USER).tolist()
            + [users[k % FOLD_USERS] for k in range(FOLD_NEW_ITEM_RATES)])
    n_known = FOLD_USERS * FOLD_PER_USER + FOLD_NEW_USERS * FOLD_NEW_PER_USER
    tgt = (rec_model.item_ix.ids_of(rng.integers(0, n_i, n_known))
           + [new_items[k % FOLD_NEW_ITEMS]
              for k in range(FOLD_NEW_ITEM_RATES)])
    touched = (sorted(set(subj)), sorted(set(tgt)))
    others = [u for u in rec_model.user_ix.ids_of(rng.choice(
        n_u, 4 * FOLD_UNTOUCHED_QUERIES, replace=False))
        if u not in set(subj)][:FOLD_UNTOUCHED_QUERIES]
    queries = []
    for k, u in enumerate(touched[0] + others):
        q = {"user": u, "num": SERVE_NUM}
        if k % 2:
            q["categories"] = ([new_meta[new_items[k % 4]][0][0]] if k % 4
                               == 1 else [str(rng.choice(cat_names))])
        queries.append(q)
    # before the update: the deployed tables' answers, now cached
    truth0 = store_truth(rec_model)
    U64 = rec_model.als.user_factors.astype(np.float64)
    V64 = rec_model.als.item_factors.astype(np.float64)
    for q in queries:
        code, body = post(dep["url"] + "/queries.json",
                          json.dumps(q).encode())
        check(code == 200, f"fold_update query {q} answered {code} before "
              "the update")
        if q["user"] in new_users:
            check(body == {"itemScores": []},
                  f"unknown user {q['user']} answered {body}")
        else:
            hold_served(body, q, rec_model, U64, V64, truth0,
                        f"fold_update query {q} before the update",
                        f16=True)
    cache0 = get_json(dep["url"] + "/stats.json")["resultCache"]
    check(cache0["entries"] >= len(queries),
          f"{cache0['entries']} cache entries after {len(queries)} queries")
    ev.insert_columnar(ColumnarBatch(
        FOLD_NEW_ITEMS, "$set", "item", new_items,
        properties=[{"categories": list(new_meta[i][0]),
                     "creationYear": new_meta[i][1]} for i in new_items]),
        app.id)
    ev.insert_columnar(ColumnarBatch(
        len(subj), "rate", "user", subj, "item", tgt,
        [{"rating": float(r)} for r in rng.integers(1, 6, len(subj))]),
        app.id)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch", "update", "-v",
         rec_path, "--engine-port", str(dep["port"])], cwd=HERE,
        capture_output=True, text=True, timeout=900)
    update_s = time.perf_counter() - t0
    check(out.returncode == 0, f"update exited {out.returncode}: "
          f"{out.stderr[-3000:]}")
    report = json.loads(out.stdout.strip().splitlines()[-1])
    (algo_rep,) = report["algorithms"]
    emit("fold_update_report", update_s=update_s, **report)
    check(report["readPath"] == "entity_filtered",
          f"the fold read {report['readPath']}")
    check(report.get("reloaded") is True and report.get("publishedVersion"),
          "the fold was not published and reloaded")
    check(report["gateReport"]["passed"], "the fold failed its gates")
    check(report["events"] == len(subj) + FOLD_NEW_ITEMS,
          f"{report['events']} fresh events, wrote "
          f"{len(subj) + FOLD_NEW_ITEMS}")
    launches = algo_rep["launches"]
    check(launches == {"cg_solve": algo_rep["solverCalls"]}
          and algo_rep["solverCalls"] > 0,
          f"fold solves {algo_rep['solverCalls']} vs launches {launches}: "
          "every fold solve must be the CG kernel")
    version = report["publishedVersion"]
    status = get_json(dep["url"] + "/")
    check(status["engineInstanceId"] == version,
          f"the deployed process serves {status['engineInstanceId']}, not "
          f"the published {version}")
    fold_dt = fold_device_time(report, "fold_update")
    aot0 = swapped_graphs(dep, version, "fold_update")
    cache1 = get_json(dep["url"] + "/stats.json")["resultCache"]
    cleared = (cache1["invalidations"].get("reload", 0)
               - cache0["invalidations"].get("reload", 0))
    check(cache1["entries"] == 0 and cleared == cache0["entries"],
          f"the /reload left {cache1['entries']} cache entries, cleared "
          f"{cleared} of {cache0['entries']}")
    (pub,) = TR.RecommendationEngineFactory.apply().deserialize_models(
        Storage.get_model_data_models().get(version).models, version)
    check(list(pub.user_ix.ids[:n_u]) == list(rec_model.user_ix.ids)
          and list(pub.item_ix.ids[:n_i]) == list(rec_model.item_ix.ids)
          and sorted(pub.user_ix.ids[n_u:]) == new_users
          and sorted(pub.item_ix.ids[n_i:]) == new_items,
          "the grown vocabularies moved a deployed index")
    U0, V0 = rec_model.als.user_factors, rec_model.als.item_factors
    tu_all = pub.user_ix.to_indices(touched[0])
    ti_all = pub.item_ix.to_indices(touched[1])
    keep_u = np.setdiff1d(np.arange(n_u), tu_all)
    keep_i = np.setdiff1d(np.arange(n_i), ti_all)
    check(np.array_equal(pub.als.user_factors[keep_u], U0[keep_u])
          and np.array_equal(pub.als.item_factors[keep_i], V0[keep_i]),
          "untouched rows of the published tables differ from the deployed")
    algo = TR.ALSAlgorithm(TR.ALSAlgorithmParams(rank=RANK, lam=STORE_LAM,
                                                 device="cpu"))
    td = TR.RecommendationDataSource(TR.DataSourceParams(
        app_name=STORE_APP, read_items=True)).read_training_touched(
            *touched)
    t0 = time.perf_counter()
    f64, f32, tu, ti = replay_rows(
        algo, touched, pub, td, U0, V0,
        FoldInConfig(lam=STORE_LAM, sweeps=2, solver="cg_cuda"))
    replay_s = time.perf_counter() - t0
    held = hold_replay((pub.als.user_factors, pub.als.item_factors), f64,
                       f32, tu, ti, "fold_update")
    # the deployed process, after the swap: touched and untouched users
    truth = fold_truth(pub, new_meta)
    U64 = pub.als.user_factors.astype(np.float64)
    V64 = pub.als.item_factors.astype(np.float64)
    lat, exact, new_answered = [], 0, 0
    for q in queries:
        t0 = time.perf_counter()
        code, body = post(dep["url"] + "/queries.json",
                          json.dumps(q).encode())
        lat.append((time.perf_counter() - t0) * 1e3)
        check(code == 200, f"fold_update query {q} answered {code}")
        exact += hold_served(body, q, pub, U64, V64, truth,
                             f"fold_update query {q}", f16=True)
        if q["user"] in new_users:
            check(len(body["itemScores"]) > 0,
                  f"new user {q['user']} got no answer")
            new_answered += 1
    cache2 = get_json(dep["url"] + "/stats.json")["resultCache"]
    check(cache2["hits"] == cache1["hits"],
          f"{cache2['hits'] - cache1['hits']} answers after the /reload came "
          "from the cache")
    graphs = replays_since(dep, aot0, "fold_update")
    emit("fold_update", tick_s=report["tickS"], read_s=report["readS"],
         read_rows=report["readRows"], wall_s=algo_rep["wallS"],
         user_rows=algo_rep["userRows"], item_rows=algo_rep["itemRows"],
         new_users=algo_rep["newUsers"], new_items=algo_rep["newItems"],
         h2d_bytes=report["h2dBytes"], publish_s=report["publishS"],
         reload_s=report["reloadS"], update_s=update_s,
         cg_launches=launches.get("cg_solve", 0), replay_s=replay_s,
         replay=held, queries=len(queries), ids_equal_f64=exact,
         new_users_answered=new_answered,
         first_query_after_swap_ms=lat[0],
         p50_ms=float(np.percentile(lat, 50)),
         model_swaps=get_json(dep["url"] + "/stats.json")["modelSwaps"],
         cache_entries_cleared=cleared, buckets_of_version=aot0[
             "versions"][version],
         swap_to_first_query_ms=get_json(dep["url"] + "/stats.json")[
             "swapToFirstQueryMs"], **graphs, **fold_dt)
    check(algo_rep["newUsers"] == FOLD_NEW_USERS
          and algo_rep["newItems"] == FOLD_NEW_ITEMS,
          f"grew {algo_rep['newUsers']} users, {algo_rep['newItems']} items")
    check(new_answered == FOLD_NEW_USERS, "a new user went unanswered")
    return launches.get("cg_solve", 0), version, queries


def phase_fold_inprocess(sim_path: str, workdir: str) -> int:
    """The similar-product instance in an in-process `EngineServer` at its
    defaults with `attach_scheduler`: tick 1 folds FOLD_VIEWS[0] view
    events (FOLD_NEW_SIMILAR new items with a `$set`), hot-swaps and is
    held (the `/stats.json` counters; a new item's query against a
    float64 cosine top-k; touched rows against a float64 replay; the
    carried Gram against a recomputed one); tick 2 folds FOLD_VIEWS[1]
    more against the resident tables and must upload under
    FOLD_H2D_SHARE of tick 1's bytes. Half of tick 2's views go in
    through an in-process event server (one `POST /events.json` each, so
    this process's tracer holds their ingest traces), the other half as
    one `/batch/events.json` through an event server subprocess, a fleet
    member of its own: the `fold_tick` trace must link every local ingest
    trace and the remote batch's (resolved through the fleet), each local
    one must link the tick back, and the engine server's
    `/fleet/traces.json` of the remote batch's trace must stitch traces of
    two pids, the remote `event_batch` and this process's `fold_tick`;
    the tick runs under a torch.profiler device trace whose CG kernel
    events must be the tick's CG launches, one for one. The scheduler's cursor
    is this phase's start, so the ticks fold this phase's events. Returns
    the CG launches."""
    from predictionio_tpu_torch.data.api.event_server import (
        EventServer, EventServerConfig)
    from predictionio_tpu_torch.data.columnar import ColumnarBatch
    from predictionio_tpu_torch.data.event import utcnow
    from predictionio_tpu_torch.data.storage.base import AccessKey
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.obs import TRACER, profiler
    from predictionio_tpu_torch.online import (SchedulerConfig,
                                               attach_scheduler)
    from predictionio_tpu_torch.online.fold_in import FoldInConfig
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    from predictionio_tpu_torch.utils import device_cache
    app = Storage.get_meta_data_apps().get_by_name(STORE_APP)
    ev = Storage.get_events()
    key = "smoke-fold-inprocess"
    Storage.get_meta_data_access_keys().insert(AccessKey(key, app.id, ()))
    rng = np.random.default_rng(12)
    server = EngineServer(ServerConfig(ip="127.0.0.1", port=0,
                                       engine_variant=sim_path)).load()
    server.start()
    es = EventServer(EventServerConfig(ip="127.0.0.1", port=0,
                                       stats=True)).start()
    url = f"http://127.0.0.1:{server.config.port}"
    es_url = f"http://127.0.0.1:{es.config.port}"
    launches = 0
    remote = None
    try:
        # tick 2's remote event server, started now and awaited at tick 2
        remote = start_eventserver(workdir, "eventserver_fold", wait=False)
        (algo,) = server.algorithms
        cursor = utcnow()
        sched = attach_scheduler(server, SchedulerConfig(app_name=STORE_APP),
                                 cursor=cursor)
        captured = {}
        read = sched._read_training

        def keep_read(tu, ti):
            td, info = read(tu, ti)
            captured.update(td=td, touched=(list(tu), list(ti)))
            return td, info
        sched._read_training = keep_read
        cat_names = sorted({c for cs in store_items()[0] for c in cs})
        new_items = [f"si{k}" for k in range(FOLD_NEW_SIMILAR)]
        new_meta = {i: (tuple(rng.choice(cat_names, 2, replace=False)),
                        None) for i in new_items}
        ticks = []
        for t, n_views in enumerate(FOLD_VIEWS):
            before = server.models[0]
            n_u, n_i = len(before.user_ix), len(before.item_ix)
            users = before.user_ix.ids_of(rng.integers(0, n_u, n_views))
            items = before.item_ix.ids_of(rng.integers(0, n_i, n_views))
            if t == 0:
                ev.insert_columnar(ColumnarBatch(
                    len(new_items), "$set", "item", new_items,
                    properties=[{"categories": list(new_meta[i][0])}
                                for i in new_items]), app.id)
                items[-16:] = [new_items[k % 2] for k in range(16)]
                ev.insert_columnar(ColumnarBatch(n_views, "view", "user",
                                                 users, "item", items),
                                   app.id)
                report, n = cg_tick(sched, f"fold_inprocess tick {t + 1}")
            else:
                ingest = []
                half = n_views // 2
                t_post = time.perf_counter()
                for u, i in zip(users[:half], items[:half]):
                    code, body = post_json(
                        f"{es_url}/events.json?accessKey={key}",
                        {"event": "view", "entityType": "user",
                         "entityId": u, "targetEntityType": "item",
                         "targetEntityId": i})
                    check(code == 201 and body.get("traceId"),
                          f"tick 2's view answered {code} {body}")
                    ingest.append(body["traceId"])
                post_s = time.perf_counter() - t_post
                await_eventserver(remote)
                remote_ids, _ = post_batches(remote, key, [
                    {"event": "view", "entityType": "user", "entityId": u,
                     "targetEntityType": "item", "targetEntityId": i}
                    for u, i in zip(users[half:], items[half:])])
                (remote_trace,) = batch_traces(remote, remote_ids)
                trace_dir = os.path.join(os.environ["PIO_FS_BASEDIR"],
                                         "trace_fold")
                code, started = profiler.profile_response(
                    "start", {"dir": trace_dir})
                check(code == 200 and started["activities"]
                      == ["CPU", "CUDA"], f"device trace: {started}")
                report, n = cg_tick(sched, f"fold_inprocess tick {t + 1}")
                code, stopped = profiler.profile_response("stop")
                check(code == 200, f"device trace stop: {stopped}")
                _, _, cg = device_trace_events(stopped["traceFile"])
                check(len(cg) == n, f"the device trace of tick 2 holds "
                      f"{len(cg)} CG kernels, the tick launched {n}")
                tick = next(
                    (tr for tr in TRACER.snapshot(limit=8, kind="fold_tick")
                     if set(ingest) <= set(tr["links"])), None)
                check(tick is not None, "no fold_tick trace links tick 2's "
                      "ingest traces")
                check(remote_trace in tick["links"], "the fold tick does "
                      "not link the remote event server's batch trace")
                back = [tid for tid in ingest
                        if tick["traceId"] in (TRACER.get(tid).links
                                               if TRACER.get(tid) else ())]
                check(len(back) == len(ingest), f"{len(back)} of "
                      f"{len(ingest)} ingest traces link the fold tick")
                got = get_json(f"{es_url}/traces.json?trace_id={ingest[0]}"
                               )["traces"]
                check(any(tr["traceId"] == tick["traceId"] for tr in got),
                      "the event server's /traces.json does not walk from "
                      "an ingest trace to the fold tick")
                stitched = get_json(f"{url}/fleet/traces.json?trace_id="
                                    f"{remote_trace}")
                kinds = {(tr["pid"], tr["kind"])
                         for tr in stitched["traces"]}
                check(len(stitched["pids"]) >= 2
                      and (remote["proc"].pid, "event_batch") in kinds
                      and (os.getpid(), "fold_tick") in kinds,
                      f"/fleet/traces.json of {remote_trace}: pids "
                      f"{stitched['pids']}, traces {sorted(kinds)}")
                emit("fold_inprocess_trace", events_posted=len(ingest),
                     remote_events=len(remote_ids[0]),
                     post_s=post_s, tick_links=len(tick["links"]),
                     back_links=len(back),
                     stitched_pids=stitched["pids"],
                     stitched_kinds=sorted({k for _, k in kinds}),
                     tick_spans=span_names(tick["root"]),
                     trace_cg_kernels=len(cg), tick_cg_launches=n,
                     profile_start_s=profiler.TORCH_TRACE.last_start_s,
                     profile_stop_s=profiler.TORCH_TRACE.last_stop_s)
            (rep,) = report["algorithms"]
            launches += n
            after = server.models[0]
            check(after is not before, f"tick {t + 1} did not swap")
            stats = server.stats()
            check(stats["modelSwaps"] == t + 1 and stats["foldIns"] == t + 1,
                  f"/stats.json after tick {t + 1}: modelSwaps "
                  f"{stats['modelSwaps']}, foldIns {stats['foldIns']}")
            q = {"items": [new_items[t % 2]] if t == 0 else [items[0]],
                 "num": SERVE_NUM}
            t0 = time.perf_counter()
            code, body = post(url + "/queries.json", json.dumps(q).encode())
            first_ms = (time.perf_counter() - t0) * 1e3
            check(code == 200 and body["itemScores"],
                  f"tick {t + 1}: query {q} answered {code} {body}")
            T64 = after.item_factors_normalized.astype(np.float64)
            exact = hold_similar(body, q, after, T64,
                                 fold_truth(after, new_meta)[0],
                                 f"fold_inprocess tick {t + 1} query {q}")
            row = {"tick": t + 1, "events": report["events"],
                   "tick_s": report["tickS"], "read_s": report["readS"],
                   "read_path": report["readPath"],
                   "read_rows": report["readRows"], "wall_s": rep["wallS"],
                   "user_rows": rep["userRows"], "item_rows": rep["itemRows"],
                   "new_users": rep["newUsers"], "new_items": rep["newItems"],
                   "h2d_bytes": report["h2dBytes"],
                   "resident_hit": rep["residentHit"],
                   "cg_launches": n,
                   "first_query_after_swap_ms": first_ms,
                   "ids_equal_f64": exact, "model_swaps": stats["modelSwaps"],
                   "fold_ins": stats["foldIns"]}
            slot = device_cache.get_resident(
                f"fold:{type(algo).__name__}:{id(algo)}",
                (after.user_factors, after.item_factors_raw),
                sharding="replicated")
            check(slot is not None, f"tick {t + 1} left no resident tables")
            gram = {}
            for name, G, tab in (("user", slot["GU"], slot["U"]),
                                 ("item", slot["GV"], slot["V"])):
                ref = tab.double().T @ tab.double()
                reading = rel_err((tab.T @ tab).double(), ref)
                err = rel_err(G.double(), ref)
                gram[name] = {"rel_err": err, "f32_reading": reading}
                check(err <= max(KERNEL_REL_TOL, ROUNDING_FACTOR * reading),
                      f"tick {t + 1}: the carried {name} Gram is off a "
                      f"recomputed one by {err:.3g}")
            row["gram"] = gram
            if t == 0:
                check(rep["newItems"] == FOLD_NEW_SIMILAR
                      and report["readPath"] == "entity_filtered",
                      f"tick 1 grew {rep['newItems']} items through "
                      f"{report['readPath']}")
                f64, f32, tu, ti = replay_rows(
                    algo, captured["touched"], after, captured["td"],
                    before.user_factors, before.item_factors_raw,
                    FoldInConfig(lam=LAM, alpha=ALPHA, implicit_prefs=True,
                                 sweeps=2, solver="cg_cuda"))
                row["replay"] = hold_replay(
                    (after.user_factors, after.item_factors_raw), f64, f32,
                    tu, ti, "fold_inprocess tick 1")
            ticks.append(row)
            emit("fold_inprocess", **row)
        check(ticks[1]["resident_hit"] and not ticks[0]["resident_hit"],
              "tick 2 did not reuse tick 1's device tables")
        check(ticks[1]["h2d_bytes"]
              < FOLD_H2D_SHARE * ticks[0]["h2d_bytes"],
              f"tick 2 uploaded {ticks[1]['h2d_bytes']} bytes, tick 1 "
              f"{ticks[0]['h2d_bytes']}")
        # this process folded: its /metrics carries the fold's families
        families, samples = scrape(url)
        check_families(families, ENGINE_FAMILIES + FOLD_FAMILIES,
                       "fold_inprocess")
        folded = samples[("pio_fold_events_total", (("tenant", ""),))]
        check(folded >= sum(t["events"] for t in ticks),
              f"pio_fold_events_total {folded} after "
              f"{sum(t['events'] for t in ticks)} folded events")
        emit("fold_inprocess_metrics", families=len(families),
             fold_events_total=folded,
             fold_side_device_s=samples.get(
                 ("pio_device_time_seconds_total",
                  (("executable", "fold_side"), ("tenant", "")))))
    finally:
        es.stop()
        server.stop()
        if remote is not None and remote["proc"].poll() is None:
            remote["proc"].terminate()
        rc = remote["proc"].wait(timeout=60) if remote else None
    check(rc == 0, f"tick 2's remote event server exited {rc} on SIGTERM: "
          f"{log_tail(remote['log'])}")
    return launches


def phase_rollback_cli(rec_path: str, dep: dict, rec_model, pre_iid: str,
                       version: str, queries: list) -> None:
    """`python -m predictionio_tpu_torch rollback --engine-port P` against
    the deployed recommendation process after `fold_update`: no pin, so
    it demotes the fold's published `version` (the newest COMPLETED) back
    to `pre_iid` and `/reload`s. Its lines must be the reference's; the
    process must serve `pre_iid` again, with the cache cleared, and
    answer `fold_update`'s queries with the float64 top-k of the
    pre-update tables (its new users unknown again)."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.online import ROLLEDBACK_STATUS
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch", "rollback", "-v",
         rec_path, "--engine-port", str(dep["port"])], cwd=HERE,
        capture_output=True, text=True, timeout=300)
    rollback_s = time.perf_counter() - t0
    said = out.stdout.strip().splitlines()
    want = [f"Rolled back to instance {pre_iid}.",
            f"  demoted {version} -> ROLLEDBACK",
            f"Reloaded engine server at http://127.0.0.1:{dep['port']}"
            "/reload."]
    check(out.returncode == 0 and said == want,
          f"rollback exited {out.returncode} saying {said}, not {want}: "
          f"{out.stderr[-2000:]}")
    check(get_json(dep["url"] + "/")["engineInstanceId"] == pre_iid,
          "the deployed process does not serve the rolled-back-to version")
    instances = Storage.get_meta_data_engine_instances()
    check(instances.get(version).status == ROLLEDBACK_STATUS,
          f"{version} is {instances.get(version).status}")
    cache0 = get_json(dep["url"] + "/stats.json")["resultCache"]
    check(cache0["entries"] == 0, "the rollback's /reload left "
          f"{cache0['entries']} cache entries")
    truth = store_truth(rec_model)
    U64 = rec_model.als.user_factors.astype(np.float64)
    V64 = rec_model.als.item_factors.astype(np.float64)
    exact = unknown = 0
    for q in queries:
        code, body = post(dep["url"] + "/queries.json",
                          json.dumps(q).encode())
        check(code == 200, f"rollback_cli query {q} answered {code}")
        if rec_model.user_ix.get(q["user"], -1) < 0:
            check(body == {"itemScores": []}, f"user {q['user']}, unknown "
                  f"before the update, answered {body}")
            unknown += 1
            continue
        exact += hold_served(body, q, rec_model, U64, V64, truth,
                             f"rollback_cli query {q}", f16=True)
    cache1 = get_json(dep["url"] + "/stats.json")["resultCache"]
    check(cache1["hits"] == cache0["hits"],
          "an answer after the rollback came from the cache")
    emit("rollback_cli", said=said, rollback_s=rollback_s, target=pre_iid,
         demoted=[version], queries=len(queries), ids_equal_f64=exact,
         unknown_empty=unknown)


def answers_by(results) -> tuple:
    """Per request of `closed_loop_raw`'s results: 'first' when no request
    of its user was sent before it (it found no entry, so a miss unless
    another overtook it), 'repeat' when one of its user's answers had
    arrived before it was sent (its entry was stored, so a hit), else
    'overlap'. Returns the kinds in the results' order."""
    by_user = {}
    for k, (q, _, _, _, t0, t1) in enumerate(results):
        by_user.setdefault(q["user"], []).append((t0, t1, k))
    kinds = [None] * len(results)
    for reqs in by_user.values():
        reqs.sort()
        first_done = float("inf")
        for n, (t0, t1, k) in enumerate(reqs):
            kinds[k] = ("first" if n == 0 else "repeat" if first_done < t0
                        else "overlap")
            first_done = min(first_done, t1)
    return kinds


def phase_cache_bench(path: str, iid: str, model, truth) -> None:
    """The reference REST bench's row with the result cache on (the
    default deploy): an in-process server `load()`ed from the store at
    micro_batch 32, CACHE_USERS seeded plain users, 16 closed-loop
    clients, 320 queries a burst cycling the users, an untimed warm burst
    of the first CACHE_WARM, then CACHE_BURSTS timed bursts. Per burst:
    hits and misses (the cache's counters), qps, p50/p99, and the p50 of
    first asks (misses) and repeat asks (hits) apart (`answers_by`).
    Every answer is held as inflight_bench's; every answer of a user is
    the same bytes, which are the bytes of its cache entry."""
    from predictionio_tpu_torch.serving.result_cache import query_key
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    U64 = model.als.user_factors.astype(np.float64)
    V64 = model.als.item_factors.astype(np.float64)
    rng = np.random.default_rng(13)
    users = model.user_ix.ids_of(rng.choice(len(model.user_ix), CACHE_USERS,
                                            replace=False))
    jobs = [{"user": users[i % CACHE_USERS], "num": SERVE_NUM}
            for i in range(BENCH_CLIENTS * BENCH_PER_CLIENT)]

    def split(js):
        return [js[c::BENCH_CLIENTS] for c in range(BENCH_CLIENTS)]

    srv = EngineServer(ServerConfig(
        ip="127.0.0.1", port=0, engine_variant=path, engine_instance_id=iid,
        micro_batch=BENCH_MICRO_BATCH)).load().start()
    cache = srv.result_cache
    check(cache is not None, "a default deploy has no result cache")
    url = f"http://127.0.0.1:{srv.config.port}"
    everything, bursts = [], []
    try:
        for b in range(1 + CACHE_BURSTS):
            before = cache.stats()
            batched0 = srv.batcher.stats()["batchedQueries"]
            results, wall = closed_loop_raw(
                url, split(jobs[:CACHE_WARM] if b == 0 else jobs))
            after = cache.stats()
            everything += results
            kinds = answers_by(everything)[-len(results):]
            ms = np.array([(t1 - t0) * 1e3 for *_, t0, t1 in results])

            def p50(kind):
                sel = [m for m, k in zip(ms, kinds) if k == kind]
                return float(np.percentile(sel, 50)) if sel else None
            row = {"burst": "warm" if b == 0 else b,
                   "hits": after["hits"] - before["hits"],
                   "misses": after["misses"] - before["misses"],
                   "batched": srv.batcher.stats()["batchedQueries"]
                   - batched0,
                   "first_asks": kinds.count("first"),
                   "repeat_asks": kinds.count("repeat"),
                   "overlapping_asks": kinds.count("overlap"),
                   "qps": len(results) / wall,
                   "p50_ms": float(np.percentile(ms, 50)),
                   "p99_ms": float(np.percentile(ms, 99)),
                   "hit_p50_ms": p50("repeat"), "miss_p50_ms": p50("first")}
            check(row["hits"] + row["misses"] == len(results)
                  and row["batched"] == row["misses"]
                  and row["hits"] >= row["repeat_asks"]
                  and row["misses"] <= row["first_asks"]
                  + row["overlapping_asks"],
                  f"cache_bench burst {row['burst']}: {row}")
            if b:
                bursts.append(row)
        stats = cache.stats()
        bodies = {}
        for q, code, data, _, _, _ in everything:
            check(code == 200, f"cache_bench query {q} answered {code}")
            bodies.setdefault(q["user"], set()).add(data)
        for u, seen in bodies.items():
            check(len(seen) == 1, f"user {u} got {len(seen)} different "
                  "answers: a hit's bytes differ from its miss's")
            key = query_key({"user": u, "num": SERVE_NUM})
            check(cache._entries[key].body in seen,
                  f"user {u}: the cache entry is not the bytes sent")
            q = {"user": u, "num": SERVE_NUM}
            hold_served(json.loads(next(iter(seen))), q, model, U64, V64,
                        truth, f"cache_bench query {q}", f16=True)
    finally:
        srv.stop()
    timed = sum(r["hits"] + r["misses"] for r in bursts)
    hit_share = sum(r["hits"] for r in bursts) / timed
    emit("cache_bench", clients=BENCH_CLIENTS, users=CACHE_USERS,
         queries_per_burst=len(jobs), warm_queries=CACHE_WARM,
         micro_batch=BENCH_MICRO_BATCH, bursts=bursts,
         timed_hit_share=hit_share,
         median_qps=float(np.median([r["qps"] for r in bursts])),
         cache=stats, answers_held=len(everything))
    check(hit_share >= 0.6, f"timed hit share {hit_share:.3f} < 0.6")


def fold_rates(users: list, rng, model) -> int:
    """FOLD_PER_USER fresh `rate` events for each of `users` on seeded
    items of `model` (fold_update's kind of event, no new item); returns
    the count."""
    from predictionio_tpu_torch.data.columnar import ColumnarBatch
    from predictionio_tpu_torch.data.storage.registry import Storage
    app = Storage.get_meta_data_apps().get_by_name(STORE_APP)
    subj = np.repeat(users, FOLD_PER_USER).tolist()
    Storage.get_events().insert_columnar(ColumnarBatch(
        len(subj), "rate", "user", subj, "item",
        model.item_ix.ids_of(rng.integers(0, len(model.item_ix), len(subj))),
        [{"rating": float(r)} for r in rng.integers(1, 6, len(subj))]),
        app.id)
    return len(subj)


def cg_tick(sched, what: str) -> tuple:
    """One forced tick, every kernel count set to 0 just before and read
    just after: every fold solve must be a CG launch. Returns (report,
    CG launches)."""
    from predictionio_tpu_torch.ops.solve import COUNTS
    COUNTS.reset()
    report = sched.tick(force=True)
    counts = dict(vars(COUNTS))
    check(report is not None and report["gateReport"]["passed"],
          f"{what}: the tick did not fold and pass its gates: {report}")
    (rep,) = report["algorithms"]
    check(counts["cg_solve"] == rep["solverCalls"] > 0
          and sum(counts.values()) == counts["cg_solve"],
          f"{what}: launches {counts} for {rep['solverCalls']} fold solves")
    return report, counts["cg_solve"]


def ask_all(url: str, users: list) -> dict:
    """One plain query a user, in turn: {user: response bytes}."""
    out = {}
    for u in users:
        code, data, _ = post_raw(url + "/queries.json", json.dumps(
            {"user": u, "num": SERVE_NUM}).encode())
        check(code == 200, f"query of {u} answered {code}")
        out[u] = data
    return out


def stale_entries(bodies: dict, model) -> int:
    """Answers whose ids differ from the float64 top-k of `model`'s
    tables beyond a tie (what a recompute would answer)."""
    U64 = model.als.user_factors.astype(np.float64)
    V64 = model.als.item_factors.astype(np.float64)
    n = 0
    for u, data in bodies.items():
        s64 = V64 @ U64[model.user_ix[u]]
        top = np.argsort(-s64, kind="stable")[:SERVE_NUM]
        got = [x["item"] for x in json.loads(data)["itemScores"]]
        if got != model.item_ix.ids_of(top):
            got_s = np.sort(s64[[model.item_ix[g] for g in got]])[::-1]
            n += not np.allclose(got_s, s64[top], rtol=0,
                                 atol=1e-6 * np.abs(s64[top]).max())
    return n


def phase_cache_fold(path: str, iid: str, model) -> int:
    """The default deploy's cache under a fold: an in-process server on
    instance `iid` at its defaults (cache on, canary off) with
    `attach_scheduler`. FOLD_USERS seeded known users and
    CACHE_FOLD_OTHERS others are asked (cached), the first get
    FOLD_PER_USER fresh rates each, one tick folds them (every solve a CG
    launch) and hot-swaps with the touched ids: the invalidations must be
    exactly the entries registered under the touched users, every
    untouched user must hit with its pre-swap bytes, every touched user
    must miss and get the float64 top-k of the swapped-in tables. The
    surviving entries that a recompute would answer otherwise are
    counted, not failed (the documented staleness trade). Then again with
    PIO_SERVE_CACHE_STRICT=1, whose broader drop is reported. Returns the
    CG launches."""
    from predictionio_tpu_torch.data.event import utcnow
    from predictionio_tpu_torch.online import (SchedulerConfig,
                                               attach_scheduler)
    from predictionio_tpu_torch.serving.result_cache import query_key
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    rng = np.random.default_rng(14)
    picks = model.user_ix.ids_of(rng.choice(
        len(model.user_ix), FOLD_USERS + CACHE_FOLD_OTHERS, replace=False))
    touched, others = picks[:FOLD_USERS], picks[FOLD_USERS:]
    srv = EngineServer(ServerConfig(ip="127.0.0.1", port=0,
                                    engine_variant=path,
                                    engine_instance_id=iid)).load().start()
    cache = srv.result_cache
    url = f"http://127.0.0.1:{srv.config.port}"
    launches, rows = 0, []
    try:
        sched = attach_scheduler(srv, SchedulerConfig(app_name=STORE_APP),
                                 cursor=utcnow())
        bodies = ask_all(url, touched + others)
        for strict in (False, True):
            if strict:
                os.environ["PIO_SERVE_CACHE_STRICT"] = "1"
            check(cache.stats()["entries"] == len(picks),
                  f"{cache.stats()['entries']} entries for {len(picks)} "
                  "users asked")
            registered = {k for u in touched
                          for k in cache._by_entity.get(f"user:{u}", ())}
            events = fold_rates(touched, rng, model)
            dropped0 = cache.invalidations.get("fold_swap", 0)
            report, n = cg_tick(sched, f"cache_fold (strict {strict})")
            launches += n
            dropped = cache.invalidations.get("fold_swap", 0) - dropped0
            new = srv.models[0]
            check(new is not model, "the fold did not swap")
            surviving = [u for u in others if query_key(
                {"user": u, "num": SERVE_NUM}) in cache._entries]
            hits0, misses0 = cache.hits, cache.misses
            after = ask_all(url, others)
            check(all(after[u] == bodies[u] for u in surviving),
                  "a surviving entry changed bytes across the swap")
            check(cache.hits - hits0 == len(surviving)
                  and cache.misses - misses0 == len(others) - len(surviving),
                  f"untouched users: {cache.hits - hits0} hits, "
                  f"{cache.misses - misses0} misses, {len(surviving)} "
                  "entries survived")
            if not strict:
                check(dropped == len(registered) == FOLD_USERS
                      and len(surviving) == len(others),
                      f"the swap dropped {dropped} entries; "
                      f"{len(registered)} were registered under the "
                      f"touched users, {len(surviving)} of {len(others)} "
                      "untouched survived")
            else:
                check(dropped >= len(registered),
                      f"strict mode dropped {dropped} < {len(registered)}")
            stale = stale_entries({u: after[u] for u in surviving}, new)
            misses0 = cache.misses
            fresh = ask_all(url, touched)
            check(cache.misses - misses0 == len(touched),
                  "a touched user's query hit the cache")
            truth = store_truth(new)
            U64 = new.als.user_factors.astype(np.float64)
            V64 = new.als.item_factors.astype(np.float64)
            exact = sum(hold_served(
                json.loads(fresh[u]), {"user": u, "num": SERVE_NUM}, new,
                U64, V64, truth, f"cache_fold touched user {u}", f16=True)
                for u in touched)
            bodies = dict(after, **fresh)
            model = new
            rows.append({
                "strict": strict, "events": events,
                "tick_s": report["tickS"], "cg_launches": n,
                "touched_users": report["touchedUsers"],
                "touched_items": report["touchedItems"],
                "entries_under_touched_users": len(registered),
                "invalidated": dropped,
                "untouched_hits": len(surviving),
                "untouched_recomputed": len(others) - len(surviving),
                "stale_surviving_entries": stale,
                "touched_misses": len(touched),
                "touched_ids_equal_f64": exact})
            emit("cache_fold", **rows[-1])
    finally:
        os.environ.pop("PIO_SERVE_CACHE_STRICT", None)
        srv.stop()
    return launches


def canary_incident(version: str) -> dict:
    """The planted candidate's rollback captured an incident bundle:
    `incidents list` and `incidents show` (through `cli.main`) read it,
    and it holds the canary's flight records and the server's state."""
    from predictionio_tpu_torch.obs import get_incidents
    check(get_incidents().drain(30.0), "the incident capture did not end")
    rc, listed = cli_out("incidents", "list")
    ids = [line.split()[0] for line in listed.splitlines()
           if " canary_rollback " in line and version in line]
    check(rc == 0 and len(ids) == 1,
          f"incidents list exited {rc}: {listed}")
    rc, shown = cli_out("incidents", "show", ids[0])
    check(rc == 0 and f"canary rollback of {version}" in shown
          and "canary_rollback" in shown.split("flight records", 1)[1]
          and "canary_promote" in shown and "[engine_server]" in shown,
          f"incidents show {ids[0]} exited {rc}: {shown[-3000:]}")
    kinds = re.findall(r"#\s*\d+ (\S+)", shown)
    return {"id": ids[0], "flight_records": len(kinds),
            "canary_records": sorted({k for k in kinds
                                      if k.startswith("canary_")})}


def phase_canary(path: str, iid: str, model) -> int:
    """A guarded deploy in process: a server on instance `iid` with
    canary_fraction CANARY_FRACTION, a CANARY_WINDOW_S window and
    CANARY_MIN_REQUESTS, `attach_scheduler` with a registry. A fold tick
    (every solve a CG launch) stages its version; the cache must be
    bypassed; under 32 clients the `X-PIO-Canary` answers must number
    the candidate arm's requests, each answer held to the float64 top-k
    of its arm's tables. After the window the candidate is promoted: the
    last-good pin names it and the cache is cleared. Then a planted
    candidate (non-finite creationYear on every item, published past the
    gates) must roll back on `nan_scores`; the incumbent's answers stay
    equal to their float64 top-k, the version is ROLLEDBACK, the latest
    COMPLETED version is not it, the scheduler asks for a retrain and the
    rollback left an incident bundle (`canary_incident`). Returns the CG
    launches."""
    from predictionio_tpu_torch.data.event import utcnow
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.online import (ROLLEDBACK_STATUS,
                                               ModelVersionRegistry,
                                               SchedulerConfig,
                                               attach_scheduler)
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    rng = np.random.default_rng(15)
    n_u = len(model.user_ix)
    reg = ModelVersionRegistry()
    srv = EngineServer(ServerConfig(
        ip="127.0.0.1", port=0, engine_variant=path, engine_instance_id=iid,
        canary_fraction=CANARY_FRACTION, canary_window_s=CANARY_WINDOW_S,
        canary_min_requests=CANARY_MIN_REQUESTS)).load().start()
    cache = srv.result_cache
    url = f"http://127.0.0.1:{srv.config.port}"
    inst = srv.engine_instance
    truth = store_truth(model)    # the folds grow no item
    per_client = [[{"user": model.user_ix.id_of(int(rng.integers(n_u))),
                    "num": SERVE_NUM} for _ in range(CANARY_PER_CLIENT)]
                  for _ in range(SERVE_CLIENTS)]

    def held(results, models: dict, what: str) -> dict:
        """Each answer held to its arm's tables: `models` by tag."""
        out = {}
        for q, code, data, headers, _, _ in results:
            check(code == 200, f"{what} query {q} answered {code}")
            tag = headers.get("X-PIO-Canary")
            m = models[tag]
            hold_served(json.loads(data), q, m, *tables64[id(m)], truth,
                        f"{what} ({tag or 'incumbent'}) query {q}",
                        f16=True)
            out[tag] = out.get(tag, 0) + 1
        return out

    try:
        sched = attach_scheduler(srv, SchedulerConfig(app_name=STORE_APP),
                                 registry=reg, cursor=utcnow())
        cached = ask_all(url, [qs[0]["user"] for qs in per_client])
        incumbent = srv.models[0]
        fold_rates(model.user_ix.ids_of(rng.choice(n_u, 16, replace=False)),
                   rng, model)
        report, launches = cg_tick(sched, "canary")
        version = report["publishedVersion"]
        t_stage = time.perf_counter()
        check(srv.canary.active and srv.model_version == iid
              and srv.models[0] is incumbent,
              "the fold's version was not staged as a canary")
        candidate = srv.canary._candidate_models[0]
        tables64 = {id(m): (m.als.user_factors.astype(np.float64),
                            m.als.item_factors.astype(np.float64))
                    for m in (incumbent, candidate)}
        c0 = cache.stats()
        again, _ = closed_loop_raw(url, [[{"user": u, "num": SERVE_NUM}
                                          for u in cached]])
        c1 = cache.stats()
        check((c1["hits"], c1["misses"], c1["entries"])
              == (c0["hits"], c0["misses"], c0["entries"]),
              f"the cache answered during the canary: {c0} -> {c1}")
        results, wall = closed_loop_raw(url, per_client)
        stats = get_json(url + "/stats.json")
        check(time.perf_counter() - t_stage < CANARY_WINDOW_S
              and stats["canary"]["active"],
              "the canary's window closed before its burst was counted")
        by_arm = held(again + results, {None: incumbent, version: candidate},
                      "canary")
        arms = stats["canary"]["arms"]
        check(by_arm.get(version, 0) == arms["candidate"]["requests"] > 0,
              f"{by_arm.get(version, 0)} X-PIO-Canary answers, candidate "
              f"arm {arms['candidate']['requests']} requests")
        staged = {"tagged": by_arm.get(version, 0),
                  "untagged": by_arm.get(None, 0), "arms": arms,
                  "burst_qps": len(results) / wall,
                  "bypassed_queries": len(again)}
        time.sleep(max(0.0, t_stage + CANARY_WINDOW_S
                       - time.perf_counter()) + 0.2)
        stats = get_json(url + "/stats.json")   # the poll decides
        last = stats["canary"]["lastDecision"]
        check(last is not None and last["decision"] == "promote"
              and srv.model_version == version
              and srv.models[0] is candidate,
              f"the clean candidate was not promoted: {last}")
        pin = reg.last_good(inst.engine_id, inst.engine_version,
                            inst.engine_variant)
        check(pin == version and stats["lastGoodVersion"] == version,
              f"last-good pin {pin}, server {stats['lastGoodVersion']}, "
              f"promoted {version}")
        check(stats["resultCache"]["entries"] == 0
              and stats["resultCache"]["invalidations"].get(
                  "canary_promote") == c1["entries"],
              f"the promote left the cache {stats['resultCache']}")
        promoted = dict(last, pin=pin)
        bad = dataclasses.replace(candidate, item_properties=[
            dict(p or {}, creationYear=float("nan"))
            for p in candidate.item_properties])
        bad_version = ModelVersionRegistry().publish(
            srv.engine, srv.engine_params, inst, [bad])
        srv.swap_models([bad], version=bad_version)
        check(srv.canary.active, "the planted candidate was not staged")
        results, _ = closed_loop_raw(url, [qs[:4] for qs in per_client])
        last = srv.canary.stats()["lastDecision"]
        check(not srv.canary.active and last["decision"] == "rollback"
              and last["reason"] == "nan_scores"
              and srv.models[0] is candidate,
              f"the planted candidate was not rolled back: {last}")
        tagged = 0
        for q, code, data, headers, _, _ in results:
            check(code == 200, f"canary rollback query {q} answered {code}")
            if headers.get("X-PIO-Canary"):
                tagged += 1
                check(all(x["creationYear"] != x["creationYear"]
                          for x in json.loads(data)["itemScores"]),
                      "a candidate answer without its planted NaN")
        check(tagged > 0, "no window ran on the planted candidate")
        instances = Storage.get_meta_data_engine_instances()
        latest = instances.get_latest_completed(
            inst.engine_id, inst.engine_version, inst.engine_variant)
        check(instances.get(bad_version).status == ROLLEDBACK_STATUS
              and latest.id != bad_version
              and sched.stats()["retrainRequested"]
              and sched.models[0] is candidate,
              f"after the rollback: {bad_version} is "
              f"{instances.get(bad_version).status}, latest {latest.id}, "
              f"scheduler {sched.stats()}")
        tables64 = {id(candidate): tables64[id(candidate)]}
        after, _ = closed_loop_raw(url, [qs[4:] for qs in per_client])
        held(after, {None: candidate}, "canary after the rollback")
        incident = canary_incident(bad_version)
        emit("canary", fraction=CANARY_FRACTION, window_s=CANARY_WINDOW_S,
             version=version, tick_s=report["tickS"], cg_launches=launches,
             staged=staged, promoted=promoted,
             rollback={"version": bad_version, "decision": last,
                       "tagged_answers": tagged,
                       "status": instances.get(bad_version).status,
                       "latest_completed": latest.id,
                       "retrain_requested": True, "incident": incident},
             incumbent_answers_held=len(after))
    finally:
        srv.stop()
    return launches


# ---------------------------------------------------------------------------
# The other ALS templates on the same store: DIMSUM, e-commerce (with its
# live business-rule reads) and recommended-user
# ---------------------------------------------------------------------------

def store_sql(sql: str, params=()) -> list:
    """Rows of `sql` ({t} = the events table) over the event store's
    SQLite file, read with the standard library's sqlite3 and not through
    the port: what the holds below take as the store's own content."""
    import sqlite3
    from predictionio_tpu_torch.data.storage.registry import Storage
    ev = Storage.get_events()
    con = sqlite3.connect(ev.c.config.get("URL"), timeout=60)
    try:
        return con.execute(sql.format(t=ev.t), params).fetchall()
    finally:
        con.close()


def appended_events(app_id: int) -> list:
    """The events earlier phases appended after the seeded import (the
    fold, cache and canary phases: all made by this script from seeds),
    by event time: (event, entity type, entity id, target type, target
    id, properties JSON). `channelid=0` (every event here is on the
    default channel) lets SQLite range-scan the (appid, channelid,
    eventtime) index instead of visiting every row of the app."""
    return store_sql(
        "SELECT event, entitytype, entityid, targetentitytype, "
        "targetentityid, properties FROM {t} WHERE appid=? AND "
        "channelid=0 AND eventtime>? ORDER BY eventtime, rowid",
        (app_id, 1000 + STORE_DATA[2]))


def item_meta(appended: list) -> dict:
    """{item id: (category set or None, creationYear or None)}: the
    seeded catalog, then the earlier phases' item `$set`s in time order
    (property by property, as a `$set` merges)."""
    cats, years = store_items()
    props = {f"i{k}": {"categories": list(cats[k]),
                       "creationYear": int(years[k])}
             for k in range(STORE_DATA[1])}
    for ev, etype, eid, _, _, p in appended:
        if ev == "$set" and etype == "item":
            props.setdefault(eid, {}).update(json.loads(p or "{}"))
    return {i: (set(p["categories"]) if p.get("categories") else None,
                p.get("creationYear")) for i, p in props.items()}


def category_mask(ids, meta: dict, categories) -> np.ndarray:
    """Items (by the given id order) sharing one of `categories`."""
    want = set(categories)
    return np.array([bool(meta.get(i, (None,))[0]
                          and meta[i][0] & want) for i in ids])


def event_time(ms: int) -> str:
    """The new phases' explicit event times: after every earlier event."""
    import datetime as _dt
    t = (_dt.datetime(2030, 1, 1, tzinfo=_dt.timezone.utc)
         + _dt.timedelta(milliseconds=int(ms)))
    return t.isoformat(timespec="milliseconds").replace("+00:00", "Z")


def insert_events(app_id: int, name: str, etype: str, eids, ttype, tids,
                  t0: int, props=None) -> int:
    """Bulk-import one event per row at times t0, t0 + 1 ms, ... (ids in
    insertion order, after the seeded ones). Returns the next time."""
    from predictionio_tpu_torch.data.columnar import ColumnarBatch
    from predictionio_tpu_torch.data.storage.registry import Storage
    ev = Storage.get_events()
    for lo in range(0, len(eids), STORE_CHUNK):
        hi = min(lo + STORE_CHUNK, len(eids))
        ev.insert_columnar(ColumnarBatch(
            hi - lo, name, etype, list(eids[lo:hi]), ttype,
            None if tids is None else list(tids[lo:hi]),
            None if props is None else props[lo:hi],
            [event_time(t0 + j) for j in range(lo, hi)],
            [f"f{t0 + j:031x}" for j in range(lo, hi)]), app_id)
    return t0 + len(eids)


def held_ranked(got_ids, served, s64, allowed, num, ix, tol, what: str,
                atol: float) -> bool:
    """Hold one ranked answer (ids `got_ids`, scores `served`) against the
    float64 scores `s64` under `allowed` (score > 0 kept): the ids as
    `held_to_f64` (a swap only between scores tied within `atol`), each
    score within `tol(got index)`. `ix` maps ids both ways. Returns
    whether the ids were exact."""
    s = np.where(allowed & (s64 > 0), s64, -np.inf)
    top = np.argsort(-s, kind="stable")[:num]
    top = top[np.isfinite(s[top])]
    exact = held_to_f64(got_ids, s, top, ix, what, atol=atol)
    got_ix = np.array([ix.item_ix[g] for g in got_ids], dtype=np.int64)
    check(bool((np.abs(np.asarray(served) - s64[got_ix])
                <= tol(got_ix)).all()),
          f"{what}: scores off the float64 scores by more than their "
          "rounding bound")
    return exact


def latencies(lat: list, kinds: list) -> dict:
    """p50/p99 of all but the first query, and p50 by kind."""
    ms = np.array(lat[1:])
    return {"queries": len(lat), "first_query_ms": lat[0],
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "p50_ms_by_kind": {k: float(np.percentile(
                [t for t, kk in zip(lat[1:], kinds[1:]) if kk == k], 50))
                for k in dict.fromkeys(kinds[1:])}}


def dimsum_variant(path: str) -> None:
    """The similar-product template's dimsum algorithm on the store: its
    `rate` events read as views, creationYear returned on each item."""
    with open(path, "w") as f:
        json.dump({
            "id": "default", "engineFactory": "similarproduct",
            "datasource": {"params": {"app_name": STORE_APP,
                                      "rate_as_view": True}},
            "algorithms": [{"name": "dimsum", "params": {
                "threshold": 0.0,
                "return_properties": ["creationYear"]}}]}, f)


def phase_dimsum(workdir: str, appended: list) -> None:
    """DIMSUM from the store: `pio train` (the [I, I] Gram on the card,
    the table saved under `<PIO_FS_BASEDIR>/dimsum/<id>`, the engine
    instance a manifest), the table's seeded rows against float64 rows
    made with scipy.sparse from the pairs the store holds (the seeded
    rates and the views and rates earlier phases appended), its diagonal
    0; `DIMSUMModel.load` timed and bit-equal; then a `deploy` subprocess
    and DIMSUM_QUERIES queries held to the float64 top-k of the summed
    rows under the mask from the items' metadata."""
    import scipy.sparse as sp
    from predictionio_tpu_torch.core.persistence import \
        PersistentModelManifest
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.data.synthetic import synthetic_ml20m
    from predictionio_tpu_torch.models import similarproduct as TS
    path = os.path.join(workdir, "dimsum.json")
    dimsum_variant(path)
    iid, trained, _ = workflow_train(path, "dimsum_train", kernel=None)
    model = trained.models[0]
    del trained
    (manifest,) = TS.SimilarProductEngineFactory.apply().deserialize_models(
        Storage.get_model_data_models().get(iid).models, iid)
    check(manifest == PersistentModelManifest(TS.DIMSUMModel.loader_name()),
          f"the dimsum instance stored {manifest!r}, not its manifest")
    t0 = time.perf_counter()
    loaded = TS.DIMSUMModel.load(iid, None)
    load_s = time.perf_counter() - t0
    check(np.array_equal(loaded.similarities, model.similarities)
          and list(loaded.item_ix.ids) == list(model.item_ix.ids),
          "the loaded dimsum table differs from the trained one")
    del loaded
    # the float64 truth from the pairs the store holds: the seeded rates
    # by their numbers, the appended views and rates by their ids
    n_users, n_seeded, _ = STORE_DATA
    ui, ii, _ = synthetic_ml20m(*STORE_DATA, seed=0)
    seeded = model.item_ix.to_indices([f"i{k}" for k in range(n_seeded)])
    extra_u, extra_i = [], []
    for ev, etype, eid, ttype, tid, _ in appended:
        if ev in ("view", "rate") and etype == "user" and ttype == "item":
            extra_u.append(eid)
            extra_i.append(tid)
    meta = item_meta(appended)
    check(set(model.item_ix.ids) == set(meta) | set(extra_i),
          "the dimsum vocabulary is not the store's $set and viewed items")
    user_no = {f"u{k}": k for k in range(n_users)}
    for u in extra_u:
        user_no.setdefault(u, len(user_no))
    u_ix = np.concatenate([ui, [user_no[u] for u in extra_u]])
    i_ix = np.concatenate([seeded[ii], model.item_ix.to_indices(extra_i)])
    M = sp.csr_matrix((np.ones(len(u_ix)), (u_ix, i_ix)),
                      shape=(len(user_no), len(model.item_ix)))
    M.data[:] = 1.0                       # binary: a repeated pair once
    del ui, ii, u_ix, i_ix, user_no
    d = np.sqrt(np.maximum(np.asarray(M.sum(axis=0)).ravel(), 1e-12))
    Mc = M.tocsc()

    def rows64(q):
        S = (Mc[:, q].T @ M).toarray() / (d[q, None] * d[None, :])
        S[np.arange(len(q)), q] = 0.0
        return S
    rng = np.random.default_rng(21)
    held = model.item_ix.to_indices(
        [f"i{k}" for k in rng.choice(n_seeded, DIMSUM_ROWS, replace=False)])
    row_err = float(np.abs(model.similarities[held] - rows64(held)).max())
    diag_zero = bool((np.diagonal(model.similarities) == 0).all())
    emit("dimsum_table", items=len(model.item_ix), pairs=int(M.nnz),
         rows_held=DIMSUM_ROWS, max_abs_err_vs_f64=row_err,
         tolerance=DIMSUM_TABLE_ATOL, diagonal_zero=diag_zero,
         table_gb=model.similarities.nbytes / 1e9, load_s=load_s)
    check(row_err <= DIMSUM_TABLE_ATOL, f"dimsum rows {row_err:.3g} off "
          "the float64 rows")
    check(diag_zero, "the dimsum table's diagonal is not 0")
    cat_names = sorted({c for cs in store_items()[0] for c in cs})
    queries = []
    for n in range(DIMSUM_QUERIES):
        q = {"items": [f"i{k}" for k in rng.choice(
            n_seeded, 1 + n % 3, replace=False)], "num": SERVE_NUM}
        if n % 2:
            q["categories"] = [str(c) for c in rng.choice(
                cat_names, 1 + n % 4 // 2, replace=False)]
        queries.append(q)
    ids = list(model.item_ix.ids)
    years = [meta.get(i, (None, None))[1] for i in ids]
    deps = {}
    try:
        phase_cli_deploy({"dimsum": path}, workdir, deps,
                         first_queries={"dimsum": queries[0]}, warmed=False)
        url = deps["dimsum"]["url"]
        lat, exact = [], 0
        for q in queries:
            t0 = time.perf_counter()
            code, body = post(url + "/queries.json", json.dumps(q).encode())
            lat.append((time.perf_counter() - t0) * 1e3)
            what = f"dimsum_deploy query {q}"
            check(code == 200, f"{what} answered {code}")
            q_ix = model.item_ix.to_indices(q["items"])
            s64 = rows64(q_ix).sum(axis=0)
            allowed = np.ones(len(ids), dtype=bool)
            allowed[q_ix] = False
            if "categories" in q:
                allowed &= category_mask(ids, meta, q["categories"])
            got = [s["item"] for s in body["itemScores"]]
            exact += held_ranked(
                got, [s["score"] for s in body["itemScores"]], s64, allowed,
                q["num"], model, lambda g: 4 * len(q_ix) * DIMSUM_TABLE_ATOL,
                what, TIE_ATOL)
            check([s["creationYear"] for s in body["itemScores"]]
                  == [years[model.item_ix[g]] for g in got],
                  f"{what}: creationYear does not ride on each item")
        emit("dimsum_deploy", instance=iid, ids_equal_f64=exact,
             tie_swaps=len(queries) - exact,
             **latencies(lat, ["categories" if "categories" in q else "base"
                               for q in queries]))
        phase_undeploy(deps)
    finally:
        stop_all(deps)


def ecom_populate(app_id: int) -> dict:
    """The e-commerce traffic, appended to the store (set-up): ECOM_VIEWS
    `view` and ECOM_BUYS `buy` events (synthetic_ml20m pairs of known
    users and items), ECOM_NEW_USERS new users with 1-10 views each, and
    two `constraint/unavailableItems` `$set`s of ECOM_UNAVAILABLE items
    (the later one wins). Returns what the holds need, from the seeds."""
    from predictionio_tpu_torch.data.synthetic import synthetic_ml20m
    n_users, n_items, _ = STORE_DATA
    t0 = time.perf_counter()
    seeds = {}
    t = 0
    for name, (n, seed) in (("view", ECOM_VIEWS), ("buy", ECOM_BUYS)):
        u, i, _ = synthetic_ml20m(n_users, n_items, n, seed=seed)
        seeds[name] = (np.array([f"u{x}" for x in u]),
                       np.array([f"i{x}" for x in i]))
        t = insert_events(app_id, name, "user", seeds[name][0], "item",
                          seeds[name][1], t)
    rng = np.random.default_rng(14)
    new_users, new_views = [], []
    for k in range(ECOM_NEW_USERS):
        for x in rng.integers(0, n_items, int(rng.integers(1, 11))):
            new_users.append(f"eu{k}")
            new_views.append(f"i{x}")
    t = insert_events(app_id, "view", "user", new_users, "item", new_views,
                      t)
    lists = [[f"i{x}" for x in np.random.default_rng(s).choice(
        n_items, ECOM_UNAVAILABLE, replace=False)] for s in (15, 16)]
    for lst in lists:
        t = insert_events(app_id, "$set", "constraint", ["unavailableItems"],
                          None, None, t, [{"items": lst}])
    seeds.update(new=(np.array(new_users), np.array(new_views)),
                 unavailable=set(lists[1]))
    emit("ecom_populate", views=ECOM_VIEWS[0] + len(new_views),
         buys=ECOM_BUYS[0], new_users=ECOM_NEW_USERS,
         unavailable_sets=len(lists), populate_s=time.perf_counter() - t0,
         note="set-up: the bulk import, not a measurement of train")
    return seeds


def ecom_variant(path: str) -> None:
    """The e-commerce template's engine.json on the store: rank-200
    implicit ALS, the solver left at 'auto' (the CG kernel), the live
    rules on (unseen_only, seen_events buy and view)."""
    with open(path, "w") as f:
        json.dump({
            "id": "default", "engineFactory": "ecommercerecommendation",
            "datasource": {"params": {"app_name": STORE_APP}},
            "algorithms": [{"name": "ecomm", "params": {
                "app_name": STORE_APP, "unseen_only": True,
                "seen_events": ["buy", "view"], "rank": RANK,
                "num_iterations": ITERATIONS, "lam": LAM, "alpha": ALPHA,
                "seed": 0}}]}, f)


def ecom_resolve_check(model, coo) -> dict:
    """Re-solve the largest primal and dual item-side buckets of the
    e-commerce train from its final user table (the item half-sweep ran
    last, on the Gram of that table) through the CG kernel: the trained
    rows must equal the re-solve; the kernel is held against the plain CG
    at every checkpoint (`hold_kernel`, its planted faults on the primal);
    and how far the kernel's answer and the trained rows land from a
    float64 solve of the same systems is read. The kernel, the plain CG
    and `torch.linalg.solve` are timed at these shapes."""
    from predictionio_tpu_torch.ops.als import gram_eig, implicit_equations
    from predictionio_tpu_torch.ops.ratings import plan_for_items
    from predictionio_tpu_torch.ops.solve import (CG_PRIMAL_ITERS, cg_solve,
                                                  cg_solve_cuda)
    U = torch.tensor(model.user_factors, device="cuda")
    V = torch.tensor(model.item_factors, device="cuda")
    gram = gram_eig(U)
    plan = plan_for_items(coo, work_budget=WORK_BUDGET)
    primal = max((b for b in plan.batches if b.shape[1] >= RANK),
                 key=lambda b: b.shape[0])
    dual = max((b for b in plan.batches if b.shape[1] < RANK),
               key=lambda b: b.shape[0])
    out = {}
    for batch in (primal, dual):
        rows = torch.from_numpy(batch.rows).cuda().long()
        kind, A, rhs, to_rows = implicit_equations(
            U, gram, torch.from_numpy(batch.idx).cuda().long(),
            torch.from_numpy(batch.val).cuda(),
            torch.from_numpy(batch.mask).cuda(), LAM, ALPHA, RANK)
        K, B = A.shape[1], A.shape[0]
        iters = CG_PRIMAL_ITERS if kind == "primal" else K + 8
        held = hold_kernel(A, rhs, iters, f"e-commerce implicit {kind} "
                           f"bucket K={K}",
                           CG_FAULTS if kind == "primal" else ())
        xk = cg_solve_cuda(A, rhs, iters)
        x64 = torch.linalg.solve(A.double(), rhs.double().unsqueeze(-1)
                                 ).squeeze(-1)
        real = rows >= 0
        trained = V[rows[real]]
        row = {"kind": kind, "K": K, "B": B, "iters": iters, **held,
               "trained_vs_resolve_rel": rel_err(trained,
                                                 to_rows(xk)[real]),
               "solve_vs_f64_rel": rel_err(xk.double(), x64),
               "trained_vs_f64_rows_rel": rel_err(
                   trained.double(), to_rows(x64.float())[real].double()),
               "kernel_ms": cuda_ms(lambda: cg_solve_cuda(A, rhs, iters),
                                    5),
               "plain_ms": cuda_ms(lambda: cg_solve(A, rhs, iters), 3),
               "library_ms": cuda_ms(lambda: torch.linalg.solve(
                   A, rhs.unsqueeze(-1)), 3)}
        row["bound_ms"], row["bound_by"] = bound(*cg_cost(B, K, iters))
        emit("ecom_resolve", **row)
        check(row["trained_vs_resolve_rel"] <= KERNEL_REL_TOL,
              f"trained e-commerce {kind} rows differ from a kernel "
              f"re-solve by {row['trained_vs_resolve_rel']:.3g}")
        out[kind] = row
        del A, rhs, xk, x64
    torch.cuda.empty_cache()
    return out


def phase_ecom_train(workdir: str) -> tuple:
    """The e-commerce template from the store through `pio train`: every
    solve a CG kernel launch; the last half-sweep against the kernel and
    float64 (`ecom_resolve_check`); the blob host-only and bit-equal.
    Returns (engine.json path, instance id, the trained model, launches)."""
    from predictionio_tpu_torch.models import ecommerce as TE
    path = os.path.join(workdir, "ecommerce.json")
    ecom_variant(path)
    tds = []
    read = TE.ECommerceDataSource.read_training

    def keep(self):
        tds.append(read(self))
        return tds[-1]
    TE.ECommerceDataSource.read_training = keep
    try:
        iid, trained, launches = workflow_train(path, "ecom_train")
    finally:
        TE.ECommerceDataSource.read_training = read
    model = trained.models[0]
    user_ix, item_ix, coo = TE.ECommAlgorithm._build_ratings(tds[0])
    del tds
    check(list(user_ix.ids) == list(model.user_ix.ids)
          and list(item_ix.ids) == list(model.item_ix.ids),
          "the e-commerce vocabularies differ from the data's")
    ecom_resolve_check(model, coo)
    emit("ecom_blob", instance=iid,
         **blob_check(iid, trained, "ecommercerecommendation"))
    return path, iid, model, launches


def by_user(users: np.ndarray, items: np.ndarray) -> dict:
    """{user: its items in event order}."""
    order = np.argsort(users, kind="stable")
    keys, starts = np.unique(users[order], return_index=True)
    ends = np.append(starts[1:], len(order))
    return {str(k): items[order[a:b]] for k, a, b in zip(keys, starts, ends)}


class EcomTruth:
    """What an e-commerce answer is held to, from the seeds and the
    persisted tables: each user's seen items (the seeded buys and views),
    the second unavailableItems list, the new users' 10 latest views, the
    items' categories."""

    def __init__(self, model, seeds: dict, meta: dict):
        self.model = model
        self.U64 = model.user_factors.astype(np.float64)
        self.V64 = model.item_factors.astype(np.float64)
        self.T64 = model.item_factors_normalized.astype(np.float64)
        self.ids = list(model.item_ix.ids)
        self.meta = meta
        self.seeds = seeds
        self.seen_by = [by_user(*seeds[n]) for n in ("view", "buy", "new")]
        self.views_by = self.seen_by[2]
        self.unavailable = model.item_ix.to_indices(
            sorted(seeds["unavailable"]))

    def seen(self, user: str) -> np.ndarray:
        out = []
        for group in self.seen_by:
            out.extend(group.get(user, ()))
        return self.model.item_ix.to_indices(out)

    def recent(self, user: str) -> np.ndarray:
        return self.model.item_ix.to_indices(
            sorted(set(self.views_by.get(user, ())[-10:])))

    def allowed(self, q: dict, seen: bool = True) -> np.ndarray:
        """The candidates of `q`; `seen` False keeps the user's seen
        items (what the template serves when that read times out)."""
        if q.get("whiteList") is not None:
            mask = np.zeros(len(self.ids), dtype=bool)
            mask[self.model.item_ix.to_indices(q["whiteList"])] = True
        else:
            mask = np.ones(len(self.ids), dtype=bool)
        if seen:
            mask[self.seen(q["user"])] = False
        mask[self.unavailable] = False
        mask[self.model.item_ix.to_indices(q.get("blackList") or [])] = False
        if q.get("categories"):
            mask &= category_mask(self.ids, self.meta, q["categories"])
        return mask

    def hold(self, body: dict, q: dict, what: str,
             seen: bool = True) -> bool:
        """Known user: the raw dot top-k; new user: the summed cosines of
        the 10 latest views; unknown user: an empty answer. Scores within
        f16 rounding plus the f32 products' bound. `seen` as `allowed`."""
        got = [s["item"] for s in body["itemScores"]]
        served = [s["score"] for s in body["itemScores"]]
        uix = self.model.user_ix.get(q["user"], -1)
        if uix >= 0:
            u64 = self.U64[uix]
            s64 = self.V64 @ u64
            scale = float(np.abs(s64).max())
            return held_ranked(
                got, served, s64, self.allowed(q, seen), q["num"], self.model,
                lambda g: dot_tolerance(u64, self.V64[g])
                + F16_REL * np.abs(s64[g]), what, 1e-6 * scale)
        r = self.recent(q["user"])
        if len(r) == 0:
            check(body == {"itemScores": []}, f"{what}: {body}")
            return True
        qsum = self.T64[r].sum(axis=0)
        s64 = self.T64 @ qsum
        return held_ranked(
            got, served, s64, self.allowed(q, seen), q["num"], self.model,
            lambda g: (RANK + 3) * 2.0 ** -24 * (np.abs(self.T64[g])
                                                  @ np.abs(qsum))
            + F16_REL * np.abs(s64[g]), what, TIE_ATOL)


def ecom_queries(truth: EcomTruth, rng, n_known: int, n_new: int,
                 n_unknown: int, pool: np.ndarray) -> list:
    """Known users from `pool` (base, categories, whiteList, blackList in
    turn; the lists draw on the user's seen items, unavailable ones and
    others), new users, unknown users, shuffled."""
    cats = sorted({c for cs in store_items()[0] for c in cs})
    n_items = STORE_DATA[1]
    out = []
    for n in range(n_known):
        user = str(pool[rng.integers(len(pool))])
        q = {"user": user, "num": SERVE_NUM}
        kind = n % 4
        if kind == 1:
            q["categories"] = [str(c) for c in rng.choice(cats, 1 + n % 2,
                                                           replace=False)]
        elif kind in (2, 3):
            some = [f"i{k}" for k in rng.integers(0, n_items, 40)]
            some += truth.model.item_ix.ids_of(truth.seen(user)[:3])
            some += sorted(truth.seeds["unavailable"])[:2]
            q["whiteList" if kind == 2 else "blackList"] = some
        out.append(q)
    for n in range(n_new):
        q = {"user": f"eu{n % ECOM_NEW_USERS}", "num": SERVE_NUM}
        if n % 2:
            q["categories"] = [str(c) for c in rng.choice(cats, 2,
                                                           replace=False)]
        out.append(q)
    out += [{"user": f"nouser{n}", "num": SERVE_NUM}
            for n in range(n_unknown)]
    rng.shuffle(out)
    return out


def ecom_kind(q: dict) -> str:
    if q["user"].startswith("eu"):
        return "new"
    if q["user"].startswith("nouser"):
        return "unknown"
    return next((k for k in ("categories", "whiteList", "blackList")
                 if k in q), "base")


def phase_ecom_deploy(path: str, iid: str, truth: EcomTruth, pool,
                      app_id: int, workdir: str, deps: dict) -> tuple:
    """The e-commerce instance as a `deploy` subprocess at its defaults:
    ECOM_HELD queries one at a time, each held (`EcomTruth.hold`), zero
    point-read timeouts; then the result cache over the live reads (a
    fault shared with the reference): a known user's cached answer, a
    `buy` of its top item, the same bytes again; an in-process server
    with `PIO_SERVE_CACHE=off` excludes the item. Returns the deployed
    URL and the user who bought."""
    from predictionio_tpu_torch.data.columnar import ColumnarBatch
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    rng = np.random.default_rng(22)
    queries = ecom_queries(truth, rng, *ECOM_HELD, pool)
    first = next(q for q in queries if ecom_kind(q) == "base")
    phase_cli_deploy({"ecommercerecommendation": path}, workdir, deps,
                     first_queries={"ecommercerecommendation": first},
                     warmed=False)
    url = deps["ecommercerecommendation"]["url"]
    lat, exact = [], 0
    for q in queries:
        t0 = time.perf_counter()
        code, body = post(url + "/queries.json", json.dumps(q).encode())
        lat.append((time.perf_counter() - t0) * 1e3)
        check(code == 200, f"ecom_deploy query {q} answered {code}")
        exact += truth.hold(body, q, f"ecom_deploy query {q}")
    stats = get_json(url + "/stats.json")
    timeouts = stats["pio_event_point_read_timeout_total"]
    emit("ecom_deploy", instance=iid, ids_equal_f64=exact,
         tie_swaps=len(queries) - exact, point_read_timeouts=timeouts,
         by_kind={k: sum(ecom_kind(q) == k for q in queries)
                  for k in ("base", "categories", "whiteList", "blackList",
                            "new", "unknown")},
         **latencies(lat, [ecom_kind(q) for q in queries]))
    check(timeouts == 0, f"{timeouts} point reads timed out while held")
    # the cache over live reads
    user = str(pool[rng.integers(len(pool))])
    q = {"user": user, "num": SERVE_NUM}
    raw = json.dumps(q).encode()
    code, before, _ = post_raw(url + "/queries.json", raw)
    check(code == 200, f"ecom cache query answered {code}")
    bought = json.loads(before)["itemScores"][0]["item"]
    Storage.get_events().insert_columnar(ColumnarBatch(
        1, "buy", "user", [user], "item", [bought]), app_id)
    code, after, _ = post_raw(url + "/queries.json", raw)
    stale = code == 200 and after == before
    check(stale, "the cached e-commerce answer changed after a buy: the "
          "reference's cache answers the stored bytes")
    old = os.environ.get("PIO_SERVE_CACHE")
    os.environ["PIO_SERVE_CACHE"] = "off"
    try:
        srv = EngineServer(ServerConfig(ip="127.0.0.1", port=0,
                                        engine_variant=path,
                                        engine_instance_id=iid)).load()
    finally:
        if old is None:
            del os.environ["PIO_SERVE_CACHE"]
        else:
            os.environ["PIO_SERVE_CACHE"] = old
    try:
        check(srv.result_cache is None, "PIO_SERVE_CACHE=off left the "
              "cache on")
        body = json.loads(srv.queries(raw)[0])
    finally:
        srv.batcher.stop()
    excluded = bought not in [s["item"] for s in body["itemScores"]]
    emit("ecom_cache", user=user, bought=bought, cache_on_stale=stale,
         cache_off_excludes=excluded)
    check(excluded, f"with the cache off {bought} is still served to "
          f"{user} after its buy")
    return url, user


def phase_ecom_plane(url: str, truth: EcomTruth, pool) -> None:
    """SERVE_CLIENTS closed-loop clients x SERVE_PER_CLIENT queries
    against the deployed e-commerce process (70 % known users, half of
    them with categories; 20 % new users; 10 % unknown), every answer
    held; qps, p50/p99, the realized batch and the point-read timeouts.
    A known or new user's seen-items read may miss its 200 ms deadline
    under this load on some runs (`scripts/ecom_plane_ab.py` counts the
    misses of two checkouts in turns); the template then serves without the
    seen filter, as the reference does. Such an answer is held exactly
    to the top-k without that filter, and the distinct queries answered
    so may be no more than the timeouts the deploy counted (a cache hit
    repeats its query's answer)."""
    rng = np.random.default_rng(23)
    cats = sorted({c for cs in store_items()[0] for c in cs})
    known, new, unknown = ECOM_PLANE_MIX
    per_client = []
    for c in range(SERVE_CLIENTS):
        qs = []
        for n in range(known):
            q = {"user": str(pool[rng.integers(len(pool))]),
                 "num": SERVE_NUM}
            if n % 2:
                q["categories"] = [str(x) for x in rng.choice(
                    cats, 1 + n % 4 // 2, replace=False)]
            qs.append(q)
        qs += [{"user": f"eu{rng.integers(ECOM_NEW_USERS)}",
                "num": SERVE_NUM} for _ in range(new)]
        qs += [{"user": f"nouser{c}-{n}", "num": SERVE_NUM}
               for n in range(unknown)]
        rng.shuffle(qs)
        per_client.append(qs)
    before = get_json(url + "/stats.json")
    results, wall = closed_loop(url, per_client)
    after = get_json(url + "/stats.json")
    # the load's own numbers first, so that a failed hold below still
    # says how many of the deploy's live reads missed their deadline
    timeouts = after["pio_event_point_read_timeout_total"] \
        - before["pio_event_point_read_timeout_total"]
    emit("ecom_plane_load", queries=len(results),
         point_read_timeouts=timeouts)
    exact, unfiltered = 0, set()
    for q, code, body, _ in results:
        check(code == 200, f"ecom_plane query {q} answered {code}")
        try:
            exact += truth.hold(body, q, f"ecom_plane query {q}")
        except SmokeFailure as e:
            # a seen-items read past its 200 ms deadline leaves the seen
            # items in (ALSAlgorithm.scala:161-215, as the reference):
            # the answer must then be exactly the one without that filter
            try:
                exact += truth.hold(body, q, "", seen=False)
            except SmokeFailure as e2:
                raise SmokeFailure(f"{e}; nor is it the answer without "
                                   f"the seen filter: {e2}") from None
            unfiltered.add(json.dumps(q, sort_keys=True))
    ms = np.array([r[3] for r in results])
    d = stats_delta(before, after)
    hits = after["resultCache"]["hits"] - before["resultCache"]["hits"]
    emit("ecom_plane", clients=SERVE_CLIENTS, queries=len(results),
         ids_equal_f64=exact, tie_swaps=len(results) - exact,
         unfiltered_queries=len(unfiltered),
         cache_hits=hits, wall_s=wall, qps=len(results) / wall,
         p50_ms=float(np.percentile(ms, 50)),
         p99_ms=float(np.percentile(ms, 99)), max_ms=float(ms.max()),
         point_read_timeouts=timeouts, **d)
    check(len(unfiltered) <= timeouts, f"{len(unfiltered)} queries were "
          f"answered with their seen items, and only {timeouts} point "
          "reads timed out")
    check(d["batchedQueries"] + hits == len(results),
          f"{d['batchedQueries']} batched and {hits} cache hits of "
          f"{len(results)} queries")


def recuser_variant(path: str, app_name: str = RECUSER_APP) -> None:
    with open(path, "w") as f:
        json.dump({
            "id": "default", "engineFactory": "recommendeduser",
            "datasource": {"params": {"app_name": app_name}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "num_iterations": ITERATIONS, "lam": LAM,
                "seed": 0}}]}, f)


def recuser_queries(model) -> list:
    """RECUSER_QUERIES seeded queries of 1-3 followed users, every fourth
    with a white list of 60 and every fourth with a black list of 20."""
    rng = np.random.default_rng(24)
    F = len(model.followed_ix)
    queries = []
    for n in range(RECUSER_QUERIES):
        q = {"users": model.followed_ix.ids_of(rng.choice(
            F, 1 + n % 3, replace=False)), "num": SERVE_NUM}
        if n % 4 == 1:
            q["whiteList"] = model.followed_ix.ids_of(rng.integers(0, F, 60))
        elif n % 4 == 3:
            q["blackList"] = model.followed_ix.ids_of(rng.integers(0, 200,
                                                                   20))
        queries.append(q)
    return queries


def hold_recuser(url: str, model, queries: list, phase: str) -> tuple:
    """POST each query to the deployed recommended-user engine at `url`
    and hold its answer to the float64 cosine-sum top-k with the query
    users excluded (ids, within f16 packing and f32 rounding of the
    scores; a swap only between near-tied users). Returns (answers whose
    ids equal the float64 top-k, per-query ms)."""
    T64 = model.followed_factors_normalized.astype(np.float64)
    ix = types.SimpleNamespace(item_ix=model.followed_ix)
    F = len(model.followed_ix)
    lat, exact = [], 0
    for q in queries:
        t1 = time.perf_counter()
        code, body = post(url + "/queries.json", json.dumps(q).encode())
        lat.append((time.perf_counter() - t1) * 1e3)
        what = f"{phase} query {q}"
        check(code == 200, f"{what} answered {code}")
        q_ix = model.followed_ix.to_indices(q["users"])
        qsum = T64[q_ix].sum(axis=0)
        s64 = T64 @ qsum
        if "whiteList" in q:
            allowed = np.zeros(F, dtype=bool)
            allowed[model.followed_ix.to_indices(q["whiteList"])] = True
        else:
            allowed = np.ones(F, dtype=bool)
        allowed[q_ix] = False
        allowed[model.followed_ix.to_indices(q.get("blackList", []))] = False
        scores = body["similarUserScores"]
        exact += held_ranked(
            [s["user"] for s in scores], [s["score"] for s in scores],
            s64, allowed, q["num"], ix,
            lambda g: (RANK + 3) * 2.0 ** -24 * (np.abs(T64[g])
                                                  @ np.abs(qsum))
            + F16_REL * np.abs(s64[g]), what, TIE_ATOL)
    return exact, lat


def phase_recuser(workdir: str) -> int:
    """The recommended-user template: RECUSER_FOLLOWS `follow` events in
    an app of their own (follower u{a} -> followed u{k}, synthetic_ml20m
    pairs: the 26,744 most-followed accounts), `pio train` (every solve a
    CG kernel launch, the blob host-only and bit-equal), a `deploy`
    subprocess and
    RECUSER_QUERIES queries held to the float64 cosine-sum top-k with the
    query users excluded. Returns the CG launches."""
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.data.synthetic import synthetic_ml20m
    n_users, n_items, _ = STORE_DATA
    t0 = time.perf_counter()
    app_id = Storage.get_meta_data_apps().insert(App(0, RECUSER_APP))
    a, k, _ = synthetic_ml20m(n_users, n_items, RECUSER_FOLLOWS[0],
                              seed=RECUSER_FOLLOWS[1])
    insert_events(app_id, "follow", "user", [f"u{x}" for x in a], "user",
                  [f"u{x}" for x in k], 10 ** 9)
    emit("recuser_populate", follows=len(a),
         populate_s=time.perf_counter() - t0,
         note="set-up: the bulk import, not a measurement of train")
    del a, k
    path = os.path.join(workdir, "recuser.json")
    recuser_variant(path)
    tel = {}
    iid, trained, launches = workflow_train(path, "recuser_train",
                                            tel_out=tel)
    emit("recuser_blob", instance=iid,
         **blob_check(iid, trained, "recommendeduser"))
    model = trained.models[0]
    del trained
    queries = recuser_queries(model)
    deps = {}
    try:
        phase_cli_deploy({"recommendeduser": path}, workdir, deps,
                         first_queries={"recommendeduser": queries[0]},
                         warmed=False)
        url = deps["recommendeduser"]["url"]
        exact, lat = hold_recuser(url, model, queries, "recuser_deploy")
        code, body = post(url + "/queries.json",
                          b'{"users": ["nobody"], "num": 10}')
        check(code == 200 and body == {"similarUserScores": []},
              f"an unknown user answered {code} {body}")
        emit("recuser_deploy", instance=iid,
             followed=len(model.followed_ix),
             ids_equal_f64=exact, tie_swaps=len(queries) - exact,
             **latencies(lat, ["whiteList" if "whiteList" in q else
                               "blackList" if "blackList" in q else "base"
                               for q in queries]))
        phase_undeploy(deps)
    finally:
        stop_all(deps)
    return launches, {"instance": iid, "read_s": tel["read_s"],
                      "train_s": tel.get("train_s")}


# ---------------------------------------------------------------------------
# The ALS config fields (als_fields)
# ---------------------------------------------------------------------------

def fields_train(coo, what: str, kernel: str = "cg_solve", **cfg_kw):
    """`als_train` on the card with every count set to 0 just before and
    read just after: every solve, the fused warm-up's and every replay's
    included, must be a `kernel` launch. Returns (model, telemetry,
    launches, wall seconds)."""
    from predictionio_tpu_torch.ops.als import ALSConfig, als_train
    from predictionio_tpu_torch.ops.solve import COUNTS
    tel = {}
    COUNTS.reset()
    t0 = time.perf_counter()
    model = als_train(coo, ALSConfig(**cfg_kw), telemetry=tel)
    sync()
    wall_s = time.perf_counter() - t0
    counts = dict(vars(COUNTS))
    launches = counts[kernel]
    calls = tel["solver_calls"] + tel.get("warmup_calls", 0)
    check(launches == calls, f"{what}: {launches} {kernel} launches for "
          f"{calls} solver calls")
    for name, n in counts.items():
        check(name == kernel or n == 0, f"{what}: {name} ran {n} times")
    return model, tel, launches, wall_s


def fields_row(tel: dict, launches: int, wall_s: float) -> dict:
    keep = ("plan_s", "upload_s", "iters_s", "s_per_iter", "iter_s",
            "solver_calls", "warmup_calls", "capture_s", "replays",
            "captured_launches")
    return {"train_s": wall_s, "kernel_launches": launches,
            **{k: tel[k] for k in keep if k in tel}}


def sample_rmse(als, coo, sample) -> float:
    from predictionio_tpu_torch.ops.als import predict_ratings
    pred = predict_ratings(als, coo.user_idx[sample], coo.item_idx[sample])
    return float(np.sqrt(np.mean((pred - coo.rating[sample]) ** 2)))


def phase_als_fields(pd, cg_rmse) -> int:
    """The reference's ablation rows (bench.py:2497-2503) on the train
    phase's prepared data, rank 200, lam 0.01, 2 iterations, solver
    'cg_cuda', sweep_chunk 4: the baseline, bf16 factor tables (RMSE on
    the train phase's 100k sample within BF16_RMSE_TOL of the baseline's,
    host tables float32) and the fused iteration (CUDA graphs; tables bit
    for bit the baseline's: the same kernels in the same order). Then
    dual_solve='never' against 'auto' on the first DUAL_USERS users at
    lam 0.1, held to DUAL_TOL of the factor scale. Returns the CG
    launches."""
    from predictionio_tpu_torch.ops.ratings import RatingsCOO
    coo = pd.ratings_coo
    sample = cg_rmse[0]
    kw = dict(rank=RANK, iterations=ITERATIONS, lam=LAM, seed=0,
              solver="cg_cuda", sweep_chunk=FIELDS_CHUNK)
    rows, launches = {}, 0
    base, tel, n, wall = fields_train(coo, "als_fields baseline", **kw)
    rows["baseline"] = fields_row(tel, n, wall)
    rows["baseline"]["rmse_100k"] = sample_rmse(base, coo, sample)
    launches += n
    bf16, tel, n, wall = fields_train(coo, "als_fields bf16",
                                      factor_dtype="bfloat16", **kw)
    launches += n
    rows["bfloat16"] = fields_row(tel, n, wall)
    rows["bfloat16"]["rmse_100k"] = sample_rmse(bf16, coo, sample)
    check(bf16.user_factors.dtype == np.float32
          and bf16.item_factors.dtype == np.float32,
          "the bf16 train's host tables are not float32")
    d_rmse = abs(rows["bfloat16"]["rmse_100k"] - rows["baseline"]["rmse_100k"])
    check(d_rmse < BF16_RMSE_TOL, f"bf16 tables moved the RMSE by {d_rmse}")
    del bf16
    fused, tel, n, wall = fields_train(coo, "als_fields fused",
                                       fuse_iteration=True, **kw)
    launches += n
    rows["fused"] = fields_row(tel, n, wall)
    check(tel["replays"] == ITERATIONS, f"{tel['replays']} graph replays "
          f"for {ITERATIONS} iterations")
    equal = (np.array_equal(fused.user_factors, base.user_factors)
             and np.array_equal(fused.item_factors, base.item_factors))
    rows["fused"]["tables_bit_equal_baseline"] = equal
    check(equal, "the fused train's tables differ from the baseline's")
    del fused, base
    emit("als_fields", rank=RANK, iterations=ITERATIONS, lam=LAM,
         solver="cg_cuda", sweep_chunk=FIELDS_CHUNK, rows=rows,
         bf16_rmse_delta=d_rmse, bf16_rmse_tol=BF16_RMSE_TOL)

    sel = coo.user_idx < DUAL_USERS
    sub = RatingsCOO(coo.user_idx[sel], coo.item_idx[sel], coo.rating[sel],
                     DUAL_USERS, coo.n_items)
    kw = dict(rank=RANK, iterations=ITERATIONS, lam=DUAL_LAM, seed=0,
              solver="cg_cuda")
    auto, tel_a, n_a, wall_a = fields_train(sub, "dual_solve auto", **kw)
    never, tel_n, n_n, wall_n = fields_train(sub, "dual_solve never",
                                             dual_solve="never", **kw)
    launches += n_a + n_n
    errs = {}
    for name in ("user_factors", "item_factors"):
        a, b = getattr(auto, name), getattr(never, name)
        errs[name] = float(np.abs(a - b).max() / np.abs(a).max())
    emit("als_fields_dual", users=DUAL_USERS, items=coo.n_items,
         ratings=sub.nnz, rank=RANK, lam=DUAL_LAM, iterations=ITERATIONS,
         auto=fields_row(tel_a, n_a, wall_a),
         never=fields_row(tel_n, n_n, wall_n), rel_diff=errs,
         tolerance=DUAL_TOL)
    check(max(errs.values()) <= DUAL_TOL, f"dual_solve='never' is "
          f"{errs} of the factor scale from 'auto'")
    return launches


def phase_fused_implicit(algo, model, pd) -> int:
    """The similar-product train's ALS again with fuse_iteration (solver
    'chol_cuda': the user and item sides each a CUDA graph, their Grams'
    eigh eager between them), every solve a Cholesky launch, its tables
    bit for bit the unfused train's (`implicit_train`). Returns the
    Cholesky launches."""
    _, _, coo = algo._build_ratings(pd.td)
    p = algo.params
    got, tel, n, wall = fields_train(
        coo, "fused implicit", kernel="chol_solve", rank=p.rank,
        iterations=p.num_iterations, lam=p.lam, implicit_prefs=True,
        alpha=p.alpha, seed=p.seed, solver=p.solver, fuse_iteration=True)
    check(tel["replays"] == ITERATIONS, "the fused implicit train replayed "
          f"{tel['replays']} times")
    rel = {}
    for name, ref in (("user_factors", model.user_factors),
                      ("item_factors", model.item_factors_raw)):
        rel[name] = float(np.abs(getattr(got, name) - ref).max()
                          / np.abs(ref).max())
    equal = max(rel.values()) == 0.0
    emit("als_fields_implicit", solver=p.solver, **fields_row(tel, n, wall),
         rel_diff_unfused=rel, tables_bit_equal_unfused=equal)
    check(equal, f"the fused implicit tables are {rel} of the scale from "
          "the unfused ones")
    return n


# ---------------------------------------------------------------------------
# pio eval on the card (rec_eval, cls_*)
# ---------------------------------------------------------------------------

class RecEval:
    """`rec_eval`'s Evaluation: a FastEvalEngine of the recommendation
    template whose data source, algorithm and metric keep what the phase
    holds (the folds, each trained model with the answers it gave, the
    stage seconds) on the class, which `create_workflow_main` resolves by
    dotted path."""
    folds: list = []
    trained: list = []     # (lam, model, [(user, served ids)], seconds)
    seconds = {"read_s": 0.0, "train_s": 0.0, "predict_s": 0.0,
               "metric_s": 0.0}

    def __init__(self):
        from predictionio_tpu_torch.core import FastEvalEngine
        from predictionio_tpu_torch.models import recommendation as R
        cls = type(self)

        class KeptDataSource(R.RecommendationDataSource):
            def read_eval(self):
                t0 = time.perf_counter()
                cls.folds = super().read_eval()
                cls.seconds["read_s"] += time.perf_counter() - t0
                return cls.folds

        class KeptALS(R.ALSAlgorithm):
            def train(self, pd):
                t0 = time.perf_counter()
                model = super().train(pd)
                sync()
                cls.seconds["train_s"] += time.perf_counter() - t0
                cls.trained.append([self.params.lam, model, None,
                                    dict(self.last_train_telemetry)])
                return model

            def batch_predict(self, model, queries):
                t0 = time.perf_counter()
                out = super().batch_predict(model, queries)
                cls.seconds["predict_s"] += time.perf_counter() - t0
                answers = dict(out)
                (entry,) = [e for e in cls.trained if e[1] is model]
                entry[2] = [(q.user, [s.item for s in
                                      answers[ix].item_scores])
                            for ix, q in queries]
                return out

        class TimedPrecision(R.PrecisionAtK):
            def calculate(self, eval_data):
                t0 = time.perf_counter()
                out = super().calculate(eval_data)
                cls.seconds["metric_s"] += time.perf_counter() - t0
                return out

        self.engine = FastEvalEngine(
            {"": KeptDataSource}, {"": R.RecommendationPreparator},
            {"als": KeptALS}, {"": R.FirstServing})
        self.metric = TimedPrecision(k=EVAL_QUERY_NUM, rating_threshold=2.0)
        self.metrics = ()


class RecSweep:
    """`rec_eval`'s params generator: the store's recommendation
    template, k-fold, rank 200, 2 iterations, seed 1, at EVAL_LAMS."""

    def __init__(self):
        from predictionio_tpu_torch.core import EngineParams
        from predictionio_tpu_torch.models import recommendation as R
        self.engine_params_list = [EngineParams(
            data_source_params=("", R.DataSourceParams(
                app_name=STORE_APP, eval_k=EVAL_K,
                eval_query_num=EVAL_QUERY_NUM)),
            preparator_params=("", R.PreparatorParams()),
            algorithm_params_list=[("als", R.ALSAlgorithmParams(
                rank=RANK, num_iterations=ITERATIONS, lam=lam, seed=1))],
            serving_params=("", None)) for lam in EVAL_LAMS]


def f64_top(model, user_ix: np.ndarray, k: int) -> tuple:
    """Float64 top-k of the model's tables for the users at `user_ix`, on
    the card in chunks of EVAL_CHUNK users: (ids [n, k], scores [n, k])."""
    U = torch.as_tensor(model.als.user_factors, device="cuda",
                        dtype=torch.float64)
    V = torch.as_tensor(model.als.item_factors, device="cuda",
                        dtype=torch.float64)
    ix = torch.as_tensor(user_ix, device="cuda")
    ids, scores = [], []
    for lo in range(0, len(user_ix), EVAL_CHUNK):
        s, i = torch.topk(U[ix[lo:lo + EVAL_CHUNK]] @ V.T, k, dim=1)
        ids.append(i.cpu().numpy())
        scores.append(s.cpu().numpy())
    return np.concatenate(ids), np.concatenate(scores)


def precision_at_k(tops, qa, k: int) -> tuple:
    """PrecisionAtK's rule over (served or float64) top ids: (the mean,
    the queries counted)."""
    vals = []
    for top, (_, actual) in zip(tops, qa):
        positives = {r.item for r in actual.ratings if r.rating >= 2.0}
        if not positives:
            continue
        top = top[:k]
        vals.append(sum(i in positives for i in top) / min(k, len(top))
                    if top else 0.0)
    return (float(np.mean(vals)) if vals else float("nan")), len(vals)


def phase_rec_eval(workdir: str) -> int:
    """`pio eval` on the 2M-event store: `create_workflow_main` on
    `chip_smoke.RecEval` / `chip_smoke.RecSweep` (one read, EVAL_K folds,
    two lam settings, every solve a CG launch). Each setting's score is
    held to the PrecisionAtK of a float64 top-10 of the same tables,
    computed on the card: a served list may differ from the float64 one
    only by a swap of near-tied items (`held_to_f64`'s rule), and the
    score by at most the swapped queries' share. Returns the CG
    launches."""
    import chip_smoke as mod
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.ops.solve import COUNTS
    from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                                 create_workflow_main)
    best_dir = os.path.join(workdir, "rec_eval")
    COUNTS.reset()
    t0 = time.perf_counter()
    with exact_pack():
        iid = create_workflow_main(WorkflowConfig(
            evaluation_class="chip_smoke.RecEval",
            engine_params_generator_class="chip_smoke.RecSweep",
            output_path=best_dir))
    sync()
    eval_s = time.perf_counter() - t0
    counts = dict(vars(COUNTS))
    inst = Storage.get_meta_data_evaluation_instances().get(iid)
    check(inst.status == "EVALCOMPLETED", f"evaluation {iid} is "
          f"{inst.status}")
    result = json.loads(inst.evaluator_results_json)
    scores = [s["score"] for s in result["scores"]]
    check(len(scores) == len(EVAL_LAMS), f"{len(scores)} scores recorded")
    with open(os.path.join(best_dir, "best.json")) as f:
        best = json.load(f)
    check(best["algorithms"][0]["params"]["lam"]
          == EVAL_LAMS[result["bestIndex"]], f"best.json {best} is not "
          f"setting {result['bestIndex']}")
    trained = mod.RecEval.trained
    calls = sum(e[3]["solver_calls"] for e in trained)
    check(len(trained) == EVAL_K * len(EVAL_LAMS),
          f"{len(trained)} trains for {EVAL_K} folds x {len(EVAL_LAMS)}")
    check(counts["cg_solve"] == calls > 0, f"{counts['cg_solve']} CG "
          f"launches for {calls} solver calls")
    for name, n in counts.items():
        check(name == "cg_solve" or n == 0, f"rec_eval: {name} ran {n} "
              "times")
    folds = mod.RecEval.folds
    held = []
    for s_ix, lam in enumerate(EVAL_LAMS):
        entries = [e for e in trained if e[0] == lam]
        served_all, f64_all, qa_all, swaps, unknown = [], [], [], 0, 0
        for (lam_, model, answers, _), (_, _, qa) in zip(entries, folds):
            users = [u for u, _ in answers]
            check(users == [q.user for q, _ in qa], "the served queries are "
                  "not the fold's")
            uix = np.array([model.user_ix.get(u, -1) for u in users])
            known = uix >= 0
            unknown += int((~known).sum())
            ids, s64 = f64_top(model, uix[known], EVAL_QUERY_NUM)
            # a user the fold's train never saw is answered nothing
            check(all(not got for (_, got), k in zip(answers, known)
                      if not k), "an unknown user was answered")
            tops = iter(zip(ids, s64))
            f64_lists = []
            for (user, got), k in zip(answers, known):
                if not k:
                    f64_lists.append([])
                    continue
                top, srow = next(tops)
                want = model.item_ix.ids_of(top)
                f64_lists.append(want)
                if got == want:
                    continue
                swaps += 1
                scale = float(np.abs(srow).max())
                got_ix = model.item_ix.to_indices(got)
                g64 = (model.als.item_factors[got_ix].astype(np.float64)
                       @ model.als.user_factors[model.user_ix[user]].astype(
                           np.float64))
                check(len(got) == len(want) and np.allclose(
                    np.sort(g64)[::-1], srow, rtol=0, atol=1e-6 * scale),
                    f"rec_eval lam {lam}: served {got} != float64 {want}")
            served_all += [got for _, got in answers]
            f64_all += f64_lists
            qa_all += qa
        p64, counted = precision_at_k(f64_all, qa_all, EVAL_QUERY_NUM)
        p_served, _ = precision_at_k(served_all, qa_all, EVAL_QUERY_NUM)
        check(p_served == scores[s_ix], f"the evaluator's score "
              f"{scores[s_ix]} is not the metric of the served answers "
              f"{p_served}")
        check(abs(scores[s_ix] - p64) <= swaps / max(counted, 1),
              f"lam {lam}: PrecisionAtK {scores[s_ix]} vs float64 {p64} "
              f"with {swaps} tie swaps in {counted} queries")
        held.append({"lam": lam, "precision_at_10": scores[s_ix],
                     "precision_at_10_f64": p64, "queries_counted": counted,
                     "tie_swaps": swaps, "unknown_users": unknown})
    emit("rec_eval", instance=iid, status=inst.status, eval_s=eval_s,
         **mod.RecEval.seconds, folds=len(folds),
         queries_per_fold=[len(qa) for _, _, qa in folds],
         ratings=sum(len(td.ratings) for td, _, _ in folds) // (EVAL_K - 1),
         held=held, best_index=result["bestIndex"],
         cg_kernel_launches=counts["cg_solve"], solver_calls=calls,
         one_liner=inst.evaluator_results)
    mod.RecEval.folds, mod.RecEval.trained = [], []
    return counts["cg_solve"]


class ClsEval:
    """`cls_eval`'s Evaluation: the classification template's
    FastEvalEngine (one read of the points) and its Accuracy. Its naive
    Bayes writes each model it trains, in the order trained, to the
    directory CLS_KEEP_ENV names, so the phase holds every setting's
    model, not only its score."""

    def __init__(self):
        from predictionio_tpu_torch.core import FastEvalEngine
        from predictionio_tpu_torch.models import classification as C

        class KeptNB(C.NaiveBayesAlgorithm):
            def train(self, td):
                model = super().train(td)
                keep = os.environ[CLS_KEEP_ENV]
                np.savez(os.path.join(keep, f"nb{len(os.listdir(keep)):03d}"
                                      ".npz"),
                         lam=self.params.lam, points=len(td.labeled_points),
                         pi=model.pi, theta=model.theta, labels=model.labels)
                return model

        self.engine = FastEvalEngine(
            {"": C.ClassificationDataSource},
            {"": C.ClassificationPreparator},
            {"naive": KeptNB}, {"": C.FirstServing})
        self.metric = C.Accuracy()
        self.metrics = ()


class ClsSweep:
    """`cls_eval`'s params generator: naive Bayes at CLS_LAMS,
    CLS_EVAL_K folds."""

    def __init__(self):
        from predictionio_tpu_torch.core import EngineParams
        from predictionio_tpu_torch.models import classification as C
        self.engine_params_list = [EngineParams(
            data_source_params=("", C.DataSourceParams(
                app_name=CLS_APP, eval_k=CLS_EVAL_K)),
            preparator_params=("", None),
            algorithm_params_list=[("naive", C.NaiveBayesAlgorithmParams(
                lam=lam))],
            serving_params=("", None)) for lam in CLS_LAMS]


def nb64(X: np.ndarray, y: np.ndarray, lam: float) -> tuple:
    """Float64 numpy multinomial naive Bayes (MLlib's formulas): (pi,
    theta, labels)."""
    labels = np.unique(y)
    onehot = (y[:, None] == labels[None, :]).astype(np.float64)
    counts, sums = onehot.sum(axis=0), onehot.T @ X.astype(np.float64)
    pi = np.log(counts + lam) - np.log(counts.sum() + len(labels) * lam)
    theta = np.log(sums + lam) - np.log(
        sums.sum(axis=1, keepdims=True) + X.shape[1] * lam)
    return pi, theta, labels


def hold_nb(model, X: np.ndarray, y: np.ndarray, lam: float) -> float:
    """The largest difference of a naive Bayes model's pi, theta and
    labels from `nb64` on the same points; fails past CLS_NB_TOL."""
    pi, theta, labels = nb64(X, y, lam)
    check(np.array_equal(np.asarray(model.labels), labels),
          f"naive Bayes labels {model.labels} vs {labels}")
    err = float(max(np.abs(np.asarray(model.pi) - pi).max(),
                    np.abs(np.asarray(model.theta) - theta).max()))
    check(err <= CLS_NB_TOL, f"naive Bayes at lam {lam}: pi/theta differ "
          f"from float64 numpy by {err} (> {CLS_NB_TOL})")
    return err


def nb64_scores(model: tuple, X: np.ndarray) -> np.ndarray:
    pi, theta, _ = model
    return pi[None, :] + X.astype(np.float64) @ theta.T


def near_tie(scores: np.ndarray) -> np.ndarray:
    top2 = np.sort(scores, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0] <= CLS_TIE_REL * np.abs(top2[:, 1])


def cls_variant(path: str) -> None:
    """The classification engine.json: naive Bayes and the add-algorithm
    variant's forest (10 trees, depth 5, 32 bins, 4 classes) on the card;
    naive Bayes serves (FirstServing)."""
    with open(path, "w") as f:
        json.dump({
            "id": "default", "engineFactory": "classification",
            "datasource": {"params": {"app_name": CLS_APP}},
            "algorithms": [
                {"name": "naive", "params": {"lam": 1.0}},
                {"name": "randomforest", "params": {
                    "num_classes": 4, "num_trees": 10, "max_depth": 5,
                    "max_bins": 32}}]}, f)


def phase_classification(workdir: str) -> None:
    """The classification template from the same SQLite store, in an app
    of its own: CLS_USERS users $set with a plan of 4 classes and
    attr0-2 drawn from the class's Poisson means (`cls_populate`); `python
    -m predictionio_tpu_torch eval chip_smoke.ClsEval chip_smoke.ClsSweep`
    as a subprocess, each score the accuracy of a float64 numpy naive
    Bayes on the same folds (`cls_eval`); `train` with naive Bayes and the
    forest, the forest grown on the card equal to the plain version's on
    the CPU given the same draws (`cls_train`, `cls_forest`); a `deploy`
    subprocess answering CLS_QUERIES queries, each label the float64
    naive Bayes argmax of the persisted model (`cls_deploy`)."""
    from predictionio_tpu_torch.data.columnar import ColumnarBatch
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models import classification as C
    from predictionio_tpu_torch.ops.forest import forest_train
    t0 = time.perf_counter()
    app_id = Storage.get_meta_data_apps().insert(App(0, CLS_APP))
    rng = np.random.default_rng(31)
    labels = rng.integers(0, len(CLS_MEANS), CLS_USERS)
    attrs = rng.poisson(np.array(CLS_MEANS)[labels]).astype(np.float64)
    Storage.get_events().insert_columnar(ColumnarBatch(
        CLS_USERS, "$set", "user", [f"c{j}" for j in range(CLS_USERS)],
        properties=[{"plan": float(lab), "attr0": float(a[0]),
                     "attr1": float(a[1]), "attr2": float(a[2])}
                    for lab, a in zip(labels, attrs)],
        event_time=[event_time(2 * 10 ** 9 + j) for j in range(CLS_USERS)]),
        app_id)
    emit("cls_populate", users=CLS_USERS, classes=len(CLS_MEANS),
         populate_s=time.perf_counter() - t0,
         note="set-up: the bulk import, not a measurement of eval")

    out_dir = os.path.join(workdir, "cls_eval")
    keep_dir = os.path.join(workdir, "cls_eval_models")
    os.makedirs(keep_dir)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch", "eval",
         "chip_smoke.ClsEval", "chip_smoke.ClsSweep", "--output-path",
         out_dir], cwd=HERE, capture_output=True, text=True, timeout=600,
        env={**os.environ, CLS_KEEP_ENV: keep_dir})
    eval_s = time.perf_counter() - t0
    said = out.stdout.strip().splitlines()
    check(out.returncode == 0 and said and said[-1].startswith(
        "Evaluation completed. Evaluation instance ID: "),
        f"eval exited {out.returncode}: {out.stdout[-2000:]}"
        f"{out.stderr[-3000:]}")
    iid = said[-1].rsplit(" ", 1)[1]
    inst = Storage.get_meta_data_evaluation_instances().get(iid)
    check(inst.status == "EVALCOMPLETED", f"evaluation {iid} is "
          f"{inst.status}")
    result = json.loads(inst.evaluator_results_json)
    t0 = time.perf_counter()
    folds = C.ClassificationDataSource(C.DataSourceParams(
        app_name=CLS_APP, eval_k=CLS_EVAL_K)).read_eval()
    read_s = time.perf_counter() - t0
    # FastEvalEngine trains each setting on each fold in turn: one kept
    # model for each, every one held to float64 numpy on its own fold
    kept = [np.load(os.path.join(keep_dir, name))
            for name in sorted(os.listdir(keep_dir))]
    check(len(kept) == len(CLS_LAMS) * len(folds),
          f"the sweep trained {len(kept)} naive Bayes models, not "
          f"{len(CLS_LAMS)} settings x {len(folds)} folds")
    held, ties, nb_err = [], 0, 0.0
    for i, (lam, got) in enumerate(zip(CLS_LAMS, result["scores"])):
        hits, n, lam_ties = 0, 0, 0
        for j, (td, _, qa) in enumerate(folds):
            X, y = C._points_xy(td)
            k = kept[i * len(folds) + j]
            check(float(k["lam"]) == lam and int(k["points"]) == len(y),
                  f"kept model {i * len(folds) + j} has lam {k['lam']} and "
                  f"{k['points']} points, not lam {lam} and {len(y)}")
            nb_err = max(nb_err, hold_nb(types.SimpleNamespace(
                pi=k["pi"], theta=k["theta"], labels=k["labels"]), X, y,
                lam))
            model = nb64(X, y, lam)
            Xq = np.stack([q.features for q, _ in qa])
            sc = nb64_scores(model, Xq)
            pred = model[2][np.argmax(sc, axis=1)]
            actual = np.array([a.label for _, a in qa])
            hits += int((pred == actual).sum())
            n += len(qa)
            lam_ties += int(near_tie(sc).sum())
        acc64 = hits / n
        ties += lam_ties
        check(abs(got["score"] - acc64) <= lam_ties / n,
              f"lam {lam}: accuracy {got['score']} vs float64 {acc64} with "
              f"{lam_ties} near-ties in {n}")
        held.append({"lam": lam, "accuracy": got["score"],
                     "accuracy_f64": acc64, "near_ties": lam_ties})
    with open(os.path.join(out_dir, "best.json")) as f:
        best = json.load(f)
    check(best["algorithms"][0]["params"]["lam"]
          == CLS_LAMS[result["bestIndex"]], f"best.json {best}")
    emit("cls_eval", instance=iid, status=inst.status, eval_s=eval_s,
         read_s=read_s, points=sum(len(qa) for _, _, qa in folds),
         folds=CLS_EVAL_K, held=held, best_index=result["bestIndex"],
         models_held=len(kept), nb_max_abs_err=nb_err,
         nb_tol=CLS_NB_TOL, one_liner=inst.evaluator_results)

    path = os.path.join(workdir, "classification.json")
    cls_variant(path)
    iid, trained, _ = workflow_train(path, "cls_train", kernel=None)
    nb_model, forest = trained.models
    X, y = C._points_xy(C.ClassificationDataSource(
        C.DataSourceParams(app_name=CLS_APP)).read_training())
    nb_train_err = hold_nb(nb_model, X, y, trained.algorithms[0].params.lam)
    p = trained.algorithms[1].params
    t0 = time.perf_counter()
    plain = forest_train(X, y, num_classes=p.num_classes,
                         num_trees=p.num_trees, max_depth=p.max_depth,
                         max_bins=p.max_bins, seed=p.seed, device="cpu")
    plain_s = time.perf_counter() - t0
    equal = {a: bool(np.array_equal(getattr(forest, a), getattr(plain, a)))
             for a in ("feature", "threshold", "is_leaf", "leaf_class")}
    acc = float((forest.predict_batch(X) == y).mean())
    emit("cls_forest", trees=p.num_trees, depth=p.max_depth,
         bins=p.max_bins, points=len(y),
         card_train_s=trained.algorithms[1].last_train_telemetry["train_s"],
         nb_train_s=trained.algorithms[0].last_train_telemetry["train_s"],
         cpu_plain_train_s=plain_s, arrays_equal=equal,
         nb_max_abs_err=nb_train_err, nb_tol=CLS_NB_TOL,
         train_accuracy=acc)
    check(all(equal.values()), f"the forest grown on the card differs from "
          f"the plain version's: {equal}")

    blob = Storage.get_model_data_models().get(iid).models
    nb_model, _ = C.ClassificationEngineFactory.apply().deserialize_models(
        blob, iid)
    rng = np.random.default_rng(32)
    queries = [{"attr0": int(a[0]), "attr1": int(a[1]), "attr2": int(a[2])}
               for a in rng.poisson(np.array(CLS_MEANS)[rng.integers(
                   0, len(CLS_MEANS), CLS_QUERIES)])]

    def want(q):
        x = np.array([q["attr0"], q["attr1"], q["attr2"]], dtype=np.float64)
        s = nb_model.pi + nb_model.theta @ x
        return float(nb_model.labels[int(np.argmax(s))]), s

    first = next(q for q in queries if want(q)[0] != 0.0)
    deps = {}
    try:
        phase_cli_deploy({"classification": path}, workdir, deps,
                         first_queries={"classification": first},
                         warmed=False)
        url = deps["classification"]["url"]
        lat, exact, tied = [], 0, 0
        for q in queries:
            t0 = time.perf_counter()
            code, body = post(url + "/queries.json", json.dumps(q).encode())
            lat.append((time.perf_counter() - t0) * 1e3)
            check(code == 200, f"cls_deploy query {q} answered {code}")
            label, s = want(q)
            if body == {"label": label}:
                exact += 1
                continue
            tied += 1
            check(bool(near_tie(s[None, :])[0]),
                  f"cls_deploy query {q}: {body}, float64 argmax {label}")
        code, _ = post(url + "/queries.json", b'{"attr0": 1}')
        check(code == 400, f"a query without attr1/attr2 answered {code}")
        emit("cls_deploy", instance=iid, queries=len(queries),
             labels_equal_f64=exact, near_tie_differences=tied,
             p50_ms=float(np.percentile(lat, 50)),
             p99_ms=float(np.percentile(lat, 99)))
        phase_undeploy(deps)
    finally:
        stop_all(deps)


def template_phases(workdir: str) -> int:
    """The other ALS templates on the store, after every earlier phase:
    DIMSUM (`dimsum_train`, `dimsum_table`, `dimsum_deploy`) before the
    e-commerce events land; the e-commerce template (`ecom_populate`,
    `ecom_train`, `ecom_resolve`, `ecom_blob`, `ecom_deploy`,
    `ecom_cache`, `ecom_plane`); the recommended-user template
    (`recuser_*`). Held queries name only users no earlier phase
    appended events for. Returns (the CG kernel launches of the trains,
    the recommended-user train's instance id and read seconds)."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    app_id = Storage.get_meta_data_apps().get_by_name(STORE_APP).id
    appended = appended_events(app_id)
    phase_dimsum(workdir, appended)
    touched = {eid for _, etype, eid, _, _, _ in appended
               if etype == "user"}
    seeds = ecom_populate(app_id)
    path, iid, model, launches = phase_ecom_train(workdir)
    truth = EcomTruth(model, seeds, item_meta(appended))
    buyers = np.unique(np.concatenate([seeds["view"][0], seeds["buy"][0]]))
    rng = np.random.default_rng(25)
    pool = np.array([u for u in np.concatenate([
        buyers[rng.choice(len(buyers), min(ECOM_POOL, len(buyers)),
                          replace=False)],
        [f"u{x}" for x in rng.choice(STORE_DATA[0], ECOM_POOL,
                                     replace=False)]])
        if u not in touched])
    deps = {}
    try:
        url, cache_user = phase_ecom_deploy(path, iid, truth, pool, app_id,
                                            workdir, deps)
        phase_ecom_plane(url, truth, pool[pool != cache_user])
        phase_undeploy(deps)
    finally:
        stop_all(deps)
    del truth, model
    recuser_launches, recuser = phase_recuser(workdir)
    return launches + recuser_launches, recuser


# ---------------------------------------------------------------------------
# Event collection and the feedback loop (eventserver, rest_fold, feedback,
# import_export)
# ---------------------------------------------------------------------------

INGEST_APP = "pio_ingest"
INGEST_SINGLE = (16, 250)        # eventserver: clients x single POSTs
INGEST_BATCH = (8, 25, 50)       # ... clients x batches x events a batch
INGEST_COLUMNAR = 100_000        # ... rows of the one columnar POST
INGEST_SAMPLED = 64              # ids read back by GET /events/<id>.json
REST_FOLD_SEED = 13              # rest_fold: the fold_update shape, reseeded
SPILL_SEED = 14                  # rest_fold: which events go through the
SPILL_SHARE = 0.25               # ... faulted event server, and its faults
SPILL_FAULTS = "storage.write:error=0.3,seed=14"
SPILL_DRAIN_TIMEOUT_S = 120.0    # ... its WAL is replayed by then
FEEDBACK_OTHERS = 8              # feedback: untouched users asked too
FEEDBACK_WAIT_S = 10.0           # ... every predict event lands by then
FEEDBACK_BENCH = (16, 20)        # ... clients x queries with feedback on
FOLLOWS_COPY = "pio_follows_copy"  # import_export: the import's app
NL_APP = "pio_follows_nl"         # nativelog_train: the import's app over
NL_PARTITIONS = 4                  # ... a nativelog EVENTDATA source
SNAPSHOT = "nl_follows"            # snapshot_train: NL_APP's snapshot,
SNAPSHOT_HOST = "host2"            # ... restored into a fresh store here
ADMIN_APP = "pio_admin_probe"      # ... and the app the admin server makes
ESC_WINDOW_ROWS = 262_144          # eventserver_client: the first rate
ESC_CHUNK_ROWS = 65_536            # ... events, read over REST, chunked
ESC_WRITES = 64                    # ... and events written through it
QUICKSTART_FAMILY = "recommendation"   # examples: the quickstart's family
SIMRANK_NODES = 16_384             # ... SimRank on the most-followed
SIMRANK_ITERS, SIMRANK_DECAY = 5, 0.8  # ... accounts' follows
# ... held to float64 within 1e-6: 22 x PR 17's f32 reading of 4.5e-8,
# below what 10-bit (TF32) products give
SIMRANK_TOL = 1e-6
KEYWORD_USERS, KEYWORD_ITEMS = 16_384, 4_096   # ... keyword tables
KEYWORD_VOCAB = 50_000             # ... keyword ids hashed into 4,096
STOCK_TICKERS, STOCK_DAYS = 500, 2_520   # ... backtest: ten years of days
STOCK_START, STOCK_RETRAIN = 250, 20     # ... walk forward, retrain every 20
STOCK_HELD_T = 1_000               # ... the retrain held to float64 lstsq
PLUGINS_MODULE = "smoke_plugins"
PLUGINS_SOURCE = '''"""The feedback phase's engine-server plugins."""
import json
import os
import threading

from predictionio_tpu_torch.serving.plugins import (
    OUTPUT_BLOCKER, OUTPUT_SNIFFER, EngineServerPlugin)


class SmokeTag(EngineServerPlugin):
    plugin_name = "smoke_tag"
    plugin_description = "adds smokeTag (the instance id) to each answer"
    output_type = OUTPUT_BLOCKER

    def process(self, engine_instance, query, prediction, context):
        return dict(prediction, smokeTag=engine_instance.id)


class SmokeCount(EngineServerPlugin):
    plugin_name = "smoke_count"
    plugin_description = "appends each query to $SMOKE_SNIFF_LOG"
    output_type = OUTPUT_SNIFFER
    _lock = threading.Lock()

    def process(self, engine_instance, query, prediction, context):
        with self._lock, open(os.environ["SMOKE_SNIFF_LOG"], "a") as f:
            f.write(json.dumps(query) + "\\n")
'''


def cli_out(*args) -> tuple:
    """`python -m predictionio_tpu_torch *args`, run in this process
    through its `cli.main`: (exit code, what it printed)."""
    from predictionio_tpu_torch.tools import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(args))
    return rc, buf.getvalue()


def cli_value(pattern: str, *args) -> str:
    """Run `cli_out(*args)`, which must exit 0, and return the first group
    of `pattern` in what it printed."""
    rc, out = cli_out(*args)
    m = re.search(pattern, out)
    check(rc == 0 and m is not None, f"{' '.join(args)} exited {rc}: {out}")
    return m.group(1)


def post_json(url: str, body) -> tuple:
    """(status, parsed answer) of a POST of `body` as JSON."""
    return post(url, json.dumps(body).encode())


def fan_out(url: str, path: str, per_client: list) -> tuple:
    """`closed_loop_raw` of JSON answers: ([(body, status, answer, ms)],
    wall seconds)."""
    results, wall = closed_loop_raw(url, per_client, path)
    return [(b, code, json.loads(data), (t1 - t0) * 1e3)
            for b, code, data, _, t0, t1 in results], wall


def route_row(n_events: int, wall: float, ms: list) -> dict:
    return {"events": n_events, "requests": len(ms), "wall_s": wall,
            "events_per_s": n_events / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def start_eventserver(workdir: str, name: str = "eventserver",
                      extra_env=None, wait: bool = True) -> dict:
    """`python -m predictionio_tpu_torch eventserver --port 0 --stats` over
    the smoke's store (`extra_env` added to its environment); the port it
    printed; alive on GET /. `wait` False returns once it is started:
    `await_eventserver` then waits for it."""
    log = os.path.join(workdir, f"{name}.log")
    env = dict(os.environ, **(extra_env or {}))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch", "eventserver",
             "--ip", "127.0.0.1", "--port", "0", "--stats"], cwd=HERE,
            env=env, stdout=f, stderr=subprocess.STDOUT)
    es = {"proc": proc, "log": log, "t0": time.perf_counter()}
    return await_eventserver(es) if wait else es


def await_eventserver(es: dict) -> dict:
    """Wait until the event server `es` started has printed its port and
    answers GET / alive."""
    proc, log = es["proc"], es["log"]
    live = re.compile(r"Event Server is listening on "
                      r"http://127\.0\.0\.1:(\d+)")
    while "alive_s" not in es:
        check(proc.poll() is None, f"the event server exited "
              f"{proc.returncode}: {log_tail(log)}")
        with open(log, errors="replace") as f:
            m = live.search(f.read())
        if m:
            es["port"] = int(m.group(1))
            es["url"] = f"http://127.0.0.1:{es['port']}"
            try:
                if get_json(es["url"] + "/") == {"status": "alive"}:
                    es["alive_s"] = time.perf_counter() - es["t0"]
                    break
            except OSError:
                pass
        check(time.perf_counter() - es["t0"] < DEPLOY_TIMEOUT_S,
              f"the event server is not alive: {log_tail(log)}")
        time.sleep(0.1)
    return es


def ingest_event(k: int) -> dict:
    """The k-th ingest event: a rate at 2030-01-01 + k ms."""
    return {"event": "rate", "entityType": "user", "entityId": f"iu{k % 5003}",
            "targetEntityType": "item", "targetEntityId": f"ii{k % 977}",
            "properties": {"rating": float(1 + k % 5)},
            "eventTime": event_time(k)}


WIRE_FIELDS = ("event", "entityType", "entityId", "targetEntityType",
               "targetEntityId", "properties", "eventTime")


def ingest_metrics(es: dict, n_events: int, n_writes: int) -> dict:
    """The event server's /metrics after a route's posts: the window
    counts exactly the `n_events` rate events accepted so far (each a 201)
    and the write histogram `n_writes` writes (an event each on the
    single and batch routes, one a columnar request); the families all
    there."""
    families, samples = scrape(es["url"])
    check_families(families, EVENT_FAMILIES, "the event server")
    got = (samples.get(("pio_event_window_events", (("event", "rate"),))),
           samples.get(("pio_event_window_statuses", (("status", "201"),))),
           samples.get(("pio_event_write_seconds_count", ())))
    check(got == (n_events, n_events, n_writes),
          f"/metrics counts (events, 201s, writes) {got}, posted "
          f"{(n_events, n_events, n_writes)}")
    return {"events": got[0], "writes": got[2]}


def phase_eventserver(es: dict) -> None:
    """The REST ingest into an app of its own (`app new`, `accesskey new`
    through the command line): INGEST_SINGLE closed-loop clients of single
    `POST /events.json`, INGEST_BATCH `POST /batch/events.json`, one
    `POST /events/columnar.json` of INGEST_COLUMNAR rows. Holds: every
    event acknowledged, the store's count exact, `/stats.json`'s counts
    equal to what was posted, INGEST_SAMPLED ids read back equal to what
    was posted; a wrong key, a non-whitelisted event, a reserved-prefix
    event and a batch of 51 answer the reference's codes and bodies; one
    Segment.io webhook lands."""
    app_id = int(cli_value(r"App ID: (\d+)", "app", "new", INGEST_APP))
    key = cli_value(r"Access Key: (\S+) \|", "app", "show", INGEST_APP)
    rate_key = cli_value(r"Created new access key: (\S+)", "accesskey",
                         "new", INGEST_APP, "--event", "rate")
    url = f"{es['url']}/%s?accessKey={key}"
    posted, rows = {}, {}
    n_c, n_each = INGEST_SINGLE
    res, wall = fan_out(es["url"], f"/events.json?accessKey={key}", [
        [ingest_event(c * n_each + j) for j in range(n_each)]
        for c in range(n_c)])
    single_traces = set()
    for body, code, got, _ in res:
        check(code == 201 and re.fullmatch(r"[0-9a-f]{16}",
                                           got.get("traceId", "")),
              f"POST /events.json answered {code} {got}")
        posted[got["eventId"]] = body
        single_traces.add(got["traceId"])
    check(len(single_traces) == len(res),
          f"{len(single_traces)} trace ids for {len(res)} single posts")
    rows["single"] = route_row(len(res), wall, [r[3] for r in res])
    rows["single"]["metrics"] = ingest_metrics(es, len(posted), len(posted))
    k0 = n_c * n_each
    n_c, n_batches, n_per = INGEST_BATCH
    res, wall = fan_out(es["url"], f"/batch/events.json?accessKey={key}", [
        [[ingest_event(k0 + (c * n_batches + b) * n_per + j)
          for j in range(n_per)] for b in range(n_batches)]
        for c in range(n_c)])
    for body, code, got, _ in res:
        check(code == 200 and [g["status"] for g in got] == [201] * n_per,
              f"POST /batch/events.json answered {code} {got}")
        posted.update((g["eventId"], b) for g, b in zip(got, body))
    rows["batch"] = route_row(n_c * n_batches * n_per, wall,
                              [r[3] for r in res])
    rows["batch"]["metrics"] = ingest_metrics(es, len(posted), len(posted))
    k0 += n_c * n_batches * n_per
    cols = [ingest_event(k0 + j) for j in range(INGEST_COLUMNAR)]
    body = {"event": "rate", "entityType": "user",
            "entityId": [e["entityId"] for e in cols],
            "targetEntityType": "item",
            "targetEntityId": [e["targetEntityId"] for e in cols],
            "properties": [e["properties"] for e in cols],
            "eventTime": [e["eventTime"] for e in cols], "returnIds": True}
    t0 = time.perf_counter()
    code, got = post_json(url % "events/columnar.json", body)
    wall = time.perf_counter() - t0
    check(code == 201 and got["eventsCreated"] == INGEST_COLUMNAR,
          f"POST /events/columnar.json answered {code} "
          f"{ {k: v for k, v in got.items() if k != 'eventIds'} }")
    posted.update(zip(got["eventIds"], cols))
    traced = get_json(f"{es['url']}/traces.json?trace_id={got['traceId']}"
                      )["traces"]
    check([t["kind"] for t in traced if t["traceId"] == got["traceId"]]
          == ["event_ingest_columnar"]
          and span_names(traced[0]["root"]) == ["storage_write"],
          f"the columnar write's trace {got['traceId']}: {traced}")
    rows["columnar"] = route_row(INGEST_COLUMNAR, wall, [wall * 1e3])
    rows["columnar"]["metrics"] = ingest_metrics(es, len(posted),
                                                 len(posted) - INGEST_COLUMNAR
                                                 + 1)
    n_posted = len(posted)
    check(n_posted == k0 + INGEST_COLUMNAR, f"{n_posted} distinct ids for "
          f"{k0 + INGEST_COLUMNAR} events")
    counts = dict(store_sql("SELECT event, COUNT(*) FROM {t} WHERE appid=? "
                            "GROUP BY event", (app_id,)))
    check(counts == {"rate": n_posted}, f"the store holds {counts}, "
          f"{n_posted} rate events were posted")
    stats = get_json(url % "stats.json")
    window = stats["currentWindow"]
    check(window == {
        "count": n_posted, "byEvent": {"rate": n_posted},
        "byEntityType": {"user": n_posted},
        "byStatus": {"201": n_posted}}, f"/stats.json: {stats}")
    rng = np.random.default_rng(32)
    ids = list(posted)
    for k in rng.choice(len(ids), INGEST_SAMPLED, replace=False):
        got = get_json(url % f"events/{ids[k]}.json")
        want = posted[ids[k]]
        check({f: got.get(f) for f in WIRE_FIELDS}
              == {f: want[f] for f in WIRE_FIELDS},
              f"event {ids[k]} read back {got}, posted {want}")
    bad = ingest_event(0)
    for what, (path, body), want in (
            ("a wrong key", (f"{es['url']}/events.json?accessKey=nope", bad),
             (401, {"message": "Invalid accessKey."})),
            ("a non-whitelisted event",
             (f"{es['url']}/events.json?accessKey={rate_key}",
              dict(bad, event="buy")),
             (403, {"message": "buy events are not allowed"})),
            ("a reserved-prefix event",
             (url % "events.json", dict(bad, event="$bad")),
             (400, {"message": "$bad is not a supported reserved event "
                               "name."})),
            ("a batch of 51", (url % "batch/events.json", [bad] * 51),
             (413, {"message": "Batch request must have less than or "
                               "equal to 50 events", "maxBatch": 50,
                    "received": 51,
                    "hint": "POST /events/columnar.json accepts 1000000 "
                            "rows per request as parallel arrays"}))):
        got = post_json(path, body)
        check(got == want, f"{what} answered {got}, the reference {want}")
    hook = {"type": "track", "userId": "seg1", "event": "Signed Up",
            "properties": {"plan": "Pro"},
            "timestamp": "2030-02-01T00:00:00.000Z"}
    code, got = post_json(url % "webhooks/segmentio.json", hook)
    check(code == 201, f"the Segment.io webhook answered {code} {got}")
    got = get_json(url % f"events/{got['eventId']}.json")
    check({f: got.get(f) for f in WIRE_FIELDS} == {
        "event": "track", "entityType": "user", "entityId": "seg1",
        "targetEntityType": None, "targetEntityId": None,
        "properties": {"properties": {"plan": "Pro"}, "event": "Signed Up"},
        "eventTime": "2030-02-01T00:00:00.000Z"},
        f"the webhook's event read back {got}")
    counts = dict(store_sql("SELECT event, COUNT(*) FROM {t} WHERE appid=? "
                            "GROUP BY event", (app_id,)))
    check(counts == {"rate": n_posted, "track": 1},
          f"after the webhook the store holds {counts}")
    emit("eventserver", alive_s=es["alive_s"], events=n_posted,
         sampled=INGEST_SAMPLED, routes=rows)


def truth_of(model, new_meta: dict, app_id: int) -> tuple:
    """`store_truth` for a folded model's items: the seeded catalog, the
    fold's `new_meta`, and any other item's `$set`s read by its id (an
    index seek; `item_meta`'s time-ordered scan reads the whole app)."""
    cats, years = store_items()
    out_c, out_y = [], []
    for i in model.item_ix.ids:
        if i in new_meta:
            c, y = new_meta[i]
        elif re.fullmatch(r"i\d+", i):
            c, y = cats[int(i[1:])], years[int(i[1:])]
        else:
            p = {}
            for (props,) in store_sql(
                    "SELECT properties FROM {t} WHERE appid=? AND "
                    "channelid=0 AND entityid=? AND entitytype='item' AND "
                    "event='$set' ORDER BY eventtime, rowid", (app_id, i)):
                p.update(json.loads(props or "{}"))
            c, y = p.get("categories") or (), p.get("creationYear")
        out_c.append(set(c))
        out_y.append(y)
    return out_c, np.array(out_y)


def instance_cursor(iid: str):
    """Where a fold of engine instance `iid` resumes, read straight from
    the engine-instances table with sqlite3 and not through the port: the
    `cursor` an online version's batch tag (`online-fold-in:<json>`)
    records, else the instance's start time."""
    import datetime as _dt
    import sqlite3
    from predictionio_tpu_torch.data.storage.registry import Storage
    dao = Storage.get_meta_data_engine_instances()
    con = sqlite3.connect(dao.c.config.get("URL"), timeout=60)
    try:
        batch, start_ms = con.execute(
            f"SELECT batch, starttime FROM {dao.t} WHERE id=?",
            (iid,)).fetchone()
    finally:
        con.close()
    tag = "online-fold-in:"
    if (batch or "").startswith(tag):
        cursor = json.loads(batch[len(tag):]).get("cursor")
        if cursor:
            return _dt.datetime.fromisoformat(cursor)
    return (_dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
            + _dt.timedelta(milliseconds=start_ms))


def fresh_touched(app_id: int, iid: str, model) -> dict:
    """What `update` folds into instance `iid` (serving `model`): the
    store's rate, buy and $set events after its cursor (`instance_cursor`;
    the scheduler's own cursor is held against it), read with sqlite3,
    sided as the scheduler sides them, and the users and items that are
    new to `model` and rated (only those grow)."""
    import datetime as _dt
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.online import DeltaTrainingScheduler
    cursor = instance_cursor(iid)
    theirs = DeltaTrainingScheduler._instance_cursor(
        Storage.get_meta_data_engine_instances().get(iid))
    check(theirs == cursor, f"the scheduler resumes instance {iid} at "
          f"{theirs}; its engine-instances row says {cursor}")
    epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
    rows = store_sql(
        "SELECT event, entitytype, entityid, targetentitytype, "
        "targetentityid FROM {t} WHERE appid=? AND channelid=0 AND "
        "eventtime>? AND event IN ('rate', 'buy', '$set')",
        (app_id, (cursor - epoch) // _dt.timedelta(milliseconds=1)))
    users, items, new_users, new_items = set(), set(), set(), set()
    for ev, etype, eid, ttype, tid in rows:
        if eid:
            (items if etype == "item" else users).add(eid)
        if tid and ttype != "user":
            items.add(tid)
        if ev != "$set" and eid not in model.user_ix:
            new_users.add(eid)
        if ev != "$set" and tid not in model.item_ix:
            new_items.add(tid)
    return {"events": len(rows), "users": sorted(users),
            "items": sorted(items), "new_users": len(new_users),
            "new_items": len(new_items)}


def feedback_deploy(es: dict, key: str, workdir: str) -> tuple:
    """(extra args, extra environment) of the feedback deploy: feedback
    to the event server under `key`, and the output plugins of
    PLUGINS_SOURCE, written into the workdir and put on PYTHONPATH."""
    with open(os.path.join(workdir, PLUGINS_MODULE + ".py"), "w") as f:
        f.write(PLUGINS_SOURCE)
    path = os.pathsep.join(p for p in (workdir, os.environ.get(
        "PYTHONPATH")) if p)
    return (("--feedback", "--accesskey", key, "--event-server-ip",
             "127.0.0.1", "--event-server-port", str(es["port"])),
            {"PIO_ENGINE_SERVER_PLUGINS":
             f"{PLUGINS_MODULE}.SmokeTag,{PLUGINS_MODULE}.SmokeCount",
             "PYTHONPATH": path,
             "SMOKE_SNIFF_LOG": os.path.join(workdir, "sniffed.jsonl")})


def post_batches(es: dict, key: str, events: list) -> tuple:
    """`events` through `es`'s `/batch/events.json`, 50 a request, each
    answered 201: ([the ids of each batch], [every event's answer])."""
    url = f"{es['url']}/batch/events.json?accessKey={key}"
    batch_ids, answers = [], []
    for lo in range(0, len(events), 50):
        code, got = post_json(url, events[lo:lo + 50])
        check(code == 200 and {g["status"] for g in got} == {201},
              f"a batch through {es['url']} answered {code} {got}")
        batch_ids.append([g["eventId"] for g in got])
        answers += got
    return batch_ids, answers


def batch_traces(es: dict, batch_ids: list) -> set:
    """Each batch's events resolve, in `es`'s event map, to the batch's
    one `event_batch` trace, which `/traces.json` returns: those trace
    ids."""
    out = set()
    for ids in batch_ids:
        m = get_json(f"{es['url']}/traces.json?event_ids="
                     + ",".join(ids))["eventTraces"]
        check(set(m) == set(ids) and len(set(m.values())) == 1,
              f"the batch's {len(ids)} events map to traces {m}")
        (tid,) = set(m.values())
        got = get_json(f"{es['url']}/traces.json?trace_id={tid}")["traces"]
        check(any(t["traceId"] == tid and t["kind"] == "event_batch"
                  for t in got), f"the batch trace {tid} does not resolve")
        out.add(tid)
    return out


def phase_spill(es: dict, key: str, events: list, app_id: int) -> tuple:
    """The faulted part of rest_fold's ingest: `events` through `es`, an
    event server whose store writes fail at random (SPILL_FAULTS in its
    environment, its spill WAL under the workdir's store). Holds: every
    event acknowledged 201 and at least one `"spilled": true`;
    `pio_ingest_spill_pending_bytes` back to 0 (the WAL replayed) within
    SPILL_DRAIN_TIMEOUT_S and `pio_ingest_spilled_total` equal to the
    spilled acknowledgements; every acknowledged id in the store exactly
    once (the store's key is (app, channel, id)). Returns (the ids of
    each batch, the numbers)."""
    t0 = time.perf_counter()
    batch_ids, answers = post_batches(es, key, events)
    post_s = time.perf_counter() - t0
    spilled = sum(1 for g in answers if g.get("spilled"))
    check(spilled > 0, f"none of {len(answers)} events through the faulted "
          "event server spilled")
    t_last = time.perf_counter()
    while True:
        families, samples = scrape(es["url"])
        if samples.get(("pio_ingest_spill_pending_bytes", ())) == 0:
            break
        check(time.perf_counter() - t_last < SPILL_DRAIN_TIMEOUT_S,
              f"the spill WAL still holds "
              f"{samples.get(('pio_ingest_spill_pending_bytes', ()))} bytes "
              f"after {SPILL_DRAIN_TIMEOUT_S} s: {log_tail(es['log'])}")
        time.sleep(0.2)
    drain_s = time.perf_counter() - t_last
    check_families(families, EVENT_FAMILIES, "the faulted event server")
    spilled_total = samples.get(("pio_ingest_spilled_total", ()))
    check(spilled_total == spilled, f"pio_ingest_spilled_total "
          f"{spilled_total}, {spilled} acknowledgements said spilled")
    injected = {dict(labels)["kind"]: v for (name, labels), v
                in samples.items() if name == "pio_faults_injected_total"}
    check(injected.get("error", 0) > 0, f"faults injected: {injected}")
    ids = [i for b in batch_ids for i in b]
    check(len(set(ids)) == len(ids) == len(events),
          f"{len(set(ids))} distinct ids for {len(events)} events")
    found = 0
    for lo in range(0, len(ids), 500):
        chunk = ids[lo:lo + 500]
        ((n,),) = store_sql(
            "SELECT COUNT(*) FROM {t} WHERE appid=? AND channelid=0 AND "
            f"id IN ({','.join('?' * len(chunk))})", (app_id, *chunk))
        found += n
    check(found == len(ids), f"{found} of the {len(ids)} acknowledged ids "
          "are in the store")
    return batch_ids, {"events": len(events), "spilled": spilled,
                       "post_s": post_s, "spill_drain_s": drain_s,
                       "faults_injected": injected,
                       "read_back": found,
                       "breaker": get_json(es["url"] + "/health.json")[
                           "breaker"]}


def fleet_pids(text: str) -> set:
    """The `pid` labels of a federated scrape's samples (the synthesized
    `pio_fleet_member_up` apart)."""
    out = set()
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if m is None or line.startswith("#") \
                or m.group(1) == "pio_fleet_member_up":
            continue
        labels = dict(_LABEL.findall(m.group(2) or ""))
        if "pid" in labels:
            out.add(int(labels["pid"]))
    return out


def phase_fleet(es: dict, dep: dict) -> dict:
    """The fleet over rest_fold's processes: `/fleet/status.json` lists
    the event server and the deploy as live members with their pids, and
    `/fleet/metrics` of either carries samples of both pids. (The
    cross-process trace stitch is `fold_inprocess`'s: a one-shot
    `update` is no fleet member.)"""
    status = get_json(es["url"] + "/fleet/status.json")
    live = {m["memberId"]: m for m in status["members"] if m["alive"]}
    pids = {}
    for role, who in (("event_server", es), ("engine_server", dep)):
        mid = f"{role}-{who['proc'].pid}"
        check(mid in live and live[mid]["pid"] == who["proc"].pid
              and live[mid]["port"] == who["port"],
              f"/fleet/status.json lists no live {mid}: {sorted(live)}")
        pids[role] = who["proc"].pid
    for who in (es, dep):
        with urllib.request.urlopen(who["url"] + "/fleet/metrics",
                                    timeout=60) as r:
            seen = fleet_pids(r.read().decode())
        check(set(pids.values()) <= seen, f"{who['url']}/fleet/metrics "
              f"carries samples of pids {sorted(seen)}, not of both "
              f"{sorted(pids.values())}")
    return {"members_live": len(live), "member_pids": pids}


def phase_rest_fold(es: dict, key: str, rec_path: str, workdir: str,
                    deps: dict) -> tuple:
    """The fold over REST: a `deploy --feedback` of the recommendation
    instance (`feedback_deploy`), the fold_update traffic (seed
    REST_FOLD_SEED, fresh ids `ru*`/`ri*`) posted through
    `/batch/events.json` with the rec app's `key`: a seeded SPILL_SHARE
    of it first through a second event server with SPILL_FAULTS on its
    store (`phase_spill`), then the rest, the clean burst, through `es`;
    then `update --engine-port` as a subprocess (one tick, publish,
    `/reload`). Holds: the fleet checks of `phase_fleet` while both event
    servers run, the fold saw exactly the store's fresh events (so no
    spilled event was lost or doubled), every solve a CG launch, touched
    rows within tolerance of a float64 replay, the new users answered
    with the float64 top-k of the published tables. Event-to-answer runs
    from the clean burst's last 201. Returns (the CG launches, the published model, its version, the
    fold's users)."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models import recommendation as TR
    from predictionio_tpu_torch.online.fold_in import FoldInConfig
    app = Storage.get_meta_data_apps().get_by_name(STORE_APP)
    args, env = feedback_deploy(es, key, workdir)
    phase_cli_deploy({"recommendation": rec_path}, workdir, deps,
                     extra_args=args, extra_env=env)
    dep = deps["recommendation"]
    iid = get_json(dep["url"] + "/")["engineInstanceId"]
    factory = TR.RecommendationEngineFactory.apply()
    (model,) = factory.deserialize_models(
        Storage.get_model_data_models().get(iid).models, iid)
    rng = np.random.default_rng(REST_FOLD_SEED)
    n_u, n_i = len(model.user_ix), len(model.item_ix)
    users = model.user_ix.ids_of(rng.choice(n_u, FOLD_USERS, replace=False))
    new_users = [f"ru{k}" for k in range(FOLD_NEW_USERS)]
    new_items = [f"ri{k}" for k in range(FOLD_NEW_ITEMS)]
    cat_names = sorted({c for cs in store_items()[0] for c in cs})
    new_meta = {i: (tuple(rng.choice(cat_names, int(rng.integers(1, 4)),
                                     replace=False)),
                    int(rng.integers(*STORE_YEARS))) for i in new_items}
    subj = (np.repeat(users, FOLD_PER_USER).tolist()
            + np.repeat(new_users, FOLD_NEW_PER_USER).tolist()
            + [users[k % FOLD_USERS] for k in range(FOLD_NEW_ITEM_RATES)])
    n_known = FOLD_USERS * FOLD_PER_USER + FOLD_NEW_USERS * FOLD_NEW_PER_USER
    tgt = (model.item_ix.ids_of(rng.integers(0, n_i, n_known))
           + [new_items[k % FOLD_NEW_ITEMS]
              for k in range(FOLD_NEW_ITEM_RATES)])
    events = [{"event": "$set", "entityType": "item", "entityId": i,
               "properties": {"categories": list(new_meta[i][0]),
                              "creationYear": new_meta[i][1]}}
              for i in new_items]
    events += [{"event": "rate", "entityType": "user", "entityId": u,
                "targetEntityType": "item", "targetEntityId": t,
                "properties": {"rating": float(r)}}
               for u, t, r in zip(subj, tgt, rng.integers(1, 6, len(subj)))]
    # a seeded part of the traffic first, through a second event server
    # whose store writes fail at random: it spills, acknowledges, replays
    faulted = np.random.default_rng(SPILL_SEED).random(len(events)) \
        < SPILL_SHARE
    es2 = start_eventserver(workdir, "eventserver_faults",
                            {"PIO_FAULTS": SPILL_FAULTS})
    try:
        spill_ids, spill = phase_spill(
            es2, key, [e for e, f in zip(events, faulted) if f], app.id)
        # the clean burst: event-to-answer starts at its last 201
        t0 = time.perf_counter()
        clean_ids, _ = post_batches(
            es, key, [e for e, f in zip(events, faulted) if not f])
        t_event = time.perf_counter()
        post_s = t_event - t0
        # each batch's events resolve to the batch's one ingest trace
        ingest_traces = batch_traces(es, clean_ids) \
            | batch_traces(es2, spill_ids)
        fleet_view = phase_fleet(es, dep)
    finally:
        if es2["proc"].poll() is None:
            es2["proc"].terminate()
        rc = es2["proc"].wait(timeout=60)
    check(rc == 0, f"the faulted event server exited {rc} on SIGTERM: "
          f"{log_tail(es2['log'])}")
    emit("rest_fold_spill", **spill)
    emit("rest_fold_fleet", **fleet_view)
    fresh = fresh_touched(app.id, iid, model)
    tu_ids, ti_ids = fresh["users"], fresh["items"]
    check(set(subj) <= set(tu_ids) and set(tgt) <= set(ti_ids),
          "the posted events are not all fresh for the deployed instance")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch", "update", "-v",
         rec_path, "--engine-port", str(dep["port"])], cwd=HERE,
        capture_output=True, text=True, timeout=900)
    update_s = time.perf_counter() - t0
    check(out.returncode == 0, f"update exited {out.returncode}: "
          f"{out.stderr[-3000:]}")
    report = json.loads(out.stdout.strip().splitlines()[-1])
    (algo_rep,) = report["algorithms"]
    emit("rest_fold_report", update_s=update_s, **report)
    check(report["readPath"] == "entity_filtered"
          and report.get("reloaded") is True
          and report.get("publishedVersion")
          and report["gateReport"]["passed"],
          "the fold was not read by entity, gated, published and reloaded")
    check((report["events"], report["touchedUsers"],
           report["touchedItems"], algo_rep["newUsers"],
           algo_rep["newItems"]) == (
               fresh["events"], len(tu_ids), len(ti_ids),
               fresh["new_users"], fresh["new_items"]),
          f"the fold saw {report['events']} events, {report['touchedUsers']}"
          f" users, {report['touchedItems']} items and grew "
          f"{algo_rep['newUsers']} users, {algo_rep['newItems']} items; the "
          f"store's fresh events: "
          f"{dict(fresh, users=len(tu_ids), items=len(ti_ids))}")
    launches = algo_rep["launches"]
    check(launches == {"cg_solve": algo_rep["solverCalls"]}
          and algo_rep["solverCalls"] > 0,
          f"fold solves {algo_rep['solverCalls']} vs launches {launches}: "
          "every fold solve must be the CG kernel")
    version = report["publishedVersion"]
    # the new users' answers first: the event-to-answer time ends at the
    # first of them
    t_swap = time.perf_counter()
    aot0 = swapped_graphs(dep, version, "rest_fold")
    t_event += time.perf_counter() - t_swap   # not the event's time
    lat, answers, event_to_answer_s = [], [], None
    for u in new_users:
        q = {"user": u, "num": SERVE_NUM}
        t0 = time.perf_counter()
        code, body = post_json(dep["url"] + "/queries.json", q)
        lat.append((time.perf_counter() - t0) * 1e3)
        if event_to_answer_s is None:
            event_to_answer_s = time.perf_counter() - t_event
        check(code == 200 and body["itemScores"]
              and body["smokeTag"] == version,
              f"new user {u} answered {code} {body}")
        answers.append((q, body))
    graphs = replays_since(dep, aot0, "rest_fold")
    fold_dt = fold_device_time(report, "rest_fold")
    t_hold = time.perf_counter()
    (pub,) = factory.deserialize_models(
        Storage.get_model_data_models().get(version).models, version)
    algo = TR.ALSAlgorithm(TR.ALSAlgorithmParams(rank=RANK, lam=STORE_LAM,
                                                 device="cpu"))
    touched = (tu_ids, ti_ids)
    td = TR.RecommendationDataSource(TR.DataSourceParams(
        app_name=STORE_APP, read_items=True)).read_training_touched(
            *touched)
    f64, f32, tu, ti = replay_rows(
        algo, touched, pub, td, model.als.user_factors,
        model.als.item_factors,
        FoldInConfig(lam=STORE_LAM, sweeps=2, solver="cg_cuda"))
    held = hold_replay((pub.als.user_factors, pub.als.item_factors), f64,
                       f32, tu, ti, "rest_fold")
    replay_s = time.perf_counter() - t_hold
    truth = truth_of(pub, new_meta, app.id)
    U64 = pub.als.user_factors.astype(np.float64)
    V64 = pub.als.item_factors.astype(np.float64)
    exact = sum(hold_served(body, q, pub, U64, V64, truth,
                            f"rest_fold query {q}", f16=True)
                for q, body in answers)
    emit("rest_fold", events_posted=len(events), post_s=post_s,
         ingest_batch_traces=len(ingest_traces),
         replay_s=replay_s, hold_s=time.perf_counter() - t_hold - replay_s,
         fresh_events=fresh["events"], grew=(algo_rep["newUsers"],
                                             algo_rep["newItems"]),
         update_s=update_s, tick_s=report["tickS"],
         read_s=report["readS"], publish_s=report["publishS"],
         reload_s=report["reloadS"], cg_launches=launches.get("cg_solve", 0),
         replay=held, new_users_answered=len(lat), ids_equal_f64=exact,
         event_to_answer_s=event_to_answer_s,
         first_answer_ms=lat[0], p50_ms=float(np.percentile(lat, 50)),
         swap_to_first_query_ms=get_json(dep["url"] + "/stats.json")[
             "swapToFirstQueryMs"], **graphs, **fold_dt)
    phase_eventserver_client(es, key, app.id)
    return launches.get("cg_solve", 0), pub, version, sorted(set(subj))


def phase_feedback(dep: dict, pub, version: str, fold_users: list,
                   workdir: str) -> None:
    """The feedback loop on the rest_fold deploy (PIO_ENGINE_SERVER_PLUGINS:
    an output blocker adding `smokeTag`, a sniffer logging each query):
    the fold's users and FEEDBACK_OTHERS others asked once each, half with
    a `prId`. Holds: every answer lands as one `predict` event in the rec
    app within FEEDBACK_WAIT_S, its query the query sent and its
    prediction the answer without the blocker's field, its entity id the
    prId (the query's, else the published version); the sniffer saw every
    query; the result cache holds nothing and hit nothing;
    `/plugins.json` names both plugins; each query carries an
    `X-PIO-Trace-Id`, and its `predict` event's ingest trace (the event
    server's `/traces.json?event_ids=`, at `dep["es_url"]`) is the window
    the query's trace links. The lag from an answer to its event being
    readable in the store is measured; then FEEDBACK_BENCH closed-loop
    clients with feedback on, and how many of their events land."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    app_id = Storage.get_meta_data_apps().get_by_name(STORE_APP).id
    rng = np.random.default_rng(33)
    others = [u for u in pub.user_ix.ids_of(rng.choice(
        len(pub.user_ix), 4 * FEEDBACK_OTHERS, replace=False))
        if u not in set(fold_users)][:FEEDBACK_OTHERS]
    queries = []
    for k, u in enumerate(fold_users + others):
        q = {"user": u, "num": SERVE_NUM}
        if k % 2:
            q["prId"] = f"fb{k}"
        queries.append(q)
    sniff = os.path.join(workdir, "sniffed.jsonl")
    sniffed0 = sum(1 for _ in open(sniff))
    (row0,) = store_sql("SELECT COALESCE(MAX(rowid), 0) FROM {t}")
    seen, answered, stop = {}, {}, threading.Event()

    def predict_rows(after: int) -> list:
        # `+appid`: seek by rowid, not by an (appid, ...) index
        return store_sql("SELECT rowid, entitytype, entityid, properties "
                         "FROM {t} WHERE rowid>? AND +appid=? AND "
                         "event='predict' ORDER BY rowid", (after, app_id))

    def poll():
        last = row0[0]
        while not stop.is_set():
            for rowid, _, _, props in predict_rows(last):
                seen.setdefault(json.loads(props)["query"]["user"],
                                time.perf_counter())
                last = rowid
            time.sleep(0.005)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    bodies, qtrace = {}, {}
    try:
        for k, q in enumerate(queries):
            qtrace[q["user"]] = f"{0xfeed0000 + k:016x}"
            code, body = post_traced(dep["url"] + "/queries.json", q,
                                     qtrace[q["user"]])
            answered[q["user"]] = time.perf_counter()
            check(code == 200 and body["smokeTag"] == version,
                  f"feedback query {q} answered {code} {body}")
            bodies[q["user"]] = body
        deadline = time.perf_counter() + FEEDBACK_WAIT_S
        while len(seen) < len(queries) and time.perf_counter() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        poller.join(timeout=10)
    rows = predict_rows(row0[0])
    check(len(rows) == len(queries) and len(seen) == len(queries),
          f"{len(rows)} predict events landed for {len(queries)} answers")
    # each predict event landed under the trace that answered its query:
    # the query's window (the feedback POST sends the context it runs
    # in, as the reference's does), which the query's trace links
    ev_ids = {json.loads(props)["query"]["user"]: eid for eid, props in
              store_sql("SELECT id, properties FROM {t} WHERE rowid>? AND "
                        "+appid=? AND event='predict'", (row0[0], app_id))}
    ingest = get_json(f"{dep['es_url']}/traces.json?event_ids="
                      + ",".join(ev_ids.values()))["eventTraces"]
    for user, eid in ev_ids.items():
        got = get_json(dep["url"] + "/traces.json?trace_id="
                       + qtrace[user])["traces"]
        (qt,) = [t for t in got if t["traceId"] == qtrace[user]
                 and t["kind"] == "query"]
        check(ingest.get(eid) in qt["links"],
              f"the predict event of {user} landed under "
              f"{ingest.get(eid)}; its query {qt['traceId']} links "
              f"{qt['links']}")
    by_user = {q["user"]: q for q in queries}
    for _, etype, eid, props in rows:
        p = json.loads(props)
        q = by_user[p["query"]["user"]]
        want = {k: v for k, v in bodies[q["user"]].items()
                if k != "smokeTag"}
        check(etype == "pio_pr" and p["query"] == q
              and p["prediction"] == want
              and eid == want["prId"] == q.get("prId", version),
              f"the predict event of {q}: {etype} {eid} {p}; answered "
              f"{bodies[q['user']]}")
    sniffed = sum(1 for _ in open(sniff)) - sniffed0
    check(sniffed == len(queries), f"the sniffer saw {sniffed} answers")
    cache = get_json(dep["url"] + "/stats.json")["resultCache"]
    check(cache["entries"] == 0 and cache["hits"] == 0,
          f"the result cache under feedback: {cache}")
    plugins = get_json(dep["url"] + "/plugins.json")["plugins"]
    check(list(plugins["outputblocker"]) == ["smoke_tag"]
          and list(plugins["outputsniffer"]) == ["smoke_count"],
          f"/plugins.json: {plugins}")
    lag = [(seen[u] - answered[u]) * 1e3 for u in answered]
    n_c, n_q = FEEDBACK_BENCH
    pool = fold_users + others
    per_client = [[{"user": pool[(c * n_q + j) % len(pool)],
                    "num": SERVE_NUM} for j in range(n_q)]
                  for c in range(n_c)]
    (row1,) = store_sql("SELECT COALESCE(MAX(rowid), 0) FROM {t}")
    results, wall = closed_loop(dep["url"], per_client)
    check(all(code == 200 for _, code, _, _ in results),
          "a query under feedback failed")
    ms = [r[3] for r in results]
    deadline = time.perf_counter() + FEEDBACK_WAIT_S
    while (len(predict_rows(row1[0])) < len(results)
           and time.perf_counter() < deadline):
        time.sleep(0.1)
    emit("feedback", queries=len(queries), events_landed=len(rows),
         traced_events=len(ev_ids),
         sniffed=sniffed, cache=cache, plugins=sorted(
             list(plugins["outputblocker"]) + list(plugins["outputsniffer"])),
         lag_p50_ms=float(np.percentile(lag, 50)),
         lag_p99_ms=float(np.percentile(lag, 99)), lag_max_ms=max(lag),
         bench_clients=n_c, bench_queries=len(results),
         bench_qps=len(results) / wall,
         bench_p50_ms=float(np.percentile(ms, 50)),
         bench_p99_ms=float(np.percentile(ms, 99)),
         bench_events_landed=len(predict_rows(row1[0])))


def collection_phases(rec_path: str, workdir: str) -> int:
    """Event collection and the feedback loop, after the serve plane and
    before the other templates: the event server (`eventserver`), the
    fold over REST into a feedback deploy (`rest_fold`), the feedback
    loop (`feedback`); then the deploy is undeployed and the event server
    stopped (SIGTERM), each process exiting 0. The deploy posts with a key
    of the rec app that `accesskey new` makes. Returns the fold's CG
    launches."""
    es, deps = None, {}
    try:
        es = start_eventserver(workdir)
        phase_eventserver(es)
        key = cli_value(r"Created new access key: (\S+)", "accesskey",
                        "new", STORE_APP)
        launches, pub, version, fold_users = phase_rest_fold(
            es, key, rec_path, workdir, deps)
        deps["recommendation"]["es_url"] = es["url"]
        phase_feedback(deps["recommendation"], pub, version, fold_users,
                       workdir)
        phase_undeploy(deps)
        es["proc"].terminate()
        rc = es["proc"].wait(timeout=60)
        check(rc == 0, f"the event server exited {rc} on SIGTERM: "
              f"{log_tail(es['log'])}")
    finally:
        stop_all(deps)
        if es is not None:
            stop_all({"eventserver": es})
    return launches


def phase_import_export(workdir: str) -> tuple:
    """Export and import, last: `export` writes the recommended-user
    template's app (its follow events, dated 2030, clear of the epoch
    rounding of ROADMAP §C) as JSON lines and `import` loads them into a
    new app; both apps' `find_columnar` must be equal, column for
    column. Without pyarrow, `export --format parquet` must raise an
    ImportError naming it. Returns (the exported file, its events)."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    src = Storage.get_meta_data_apps().get_by_name(RECUSER_APP).id
    dst = int(cli_value(r"App ID: (\d+)", "app", "new", FOLLOWS_COPY))
    ((n,),) = store_sql("SELECT COUNT(*) FROM {t} WHERE appid=?", (src,))
    path = os.path.join(workdir, "follows.json")
    timed = {}
    for name, args, said in (
            ("export", ("export", "--appid", str(src), "--output", path),
             f"Exported {n} events to {path}."),
            ("import", ("import", "--appid", str(dst), "--input", path),
             f"Imported {n} events.")):
        t0 = time.perf_counter()
        rc, out = cli_out(*args)
        s = time.perf_counter() - t0
        check(rc == 0 and out.strip() == said, f"{name} exited {rc}: {out}")
        timed[name] = {"s": s, "events_per_s": n / s}
    ev = Storage.get_events()
    a, b = ev.find_columnar(src), ev.find_columnar(dst)
    check(len(a["event"]) == n and cols_equal(a, b),
          "the imported app's columns differ from the exported app's")
    try:
        import pyarrow  # noqa: F401
        parquet = "pyarrow installed: not tried"
    except ImportError:
        try:
            cli_out("export", "--appid", str(src), "--output",
                    path + ".parquet", "--format", "parquet")
            check(False, "export --format parquet ran without pyarrow")
        except ImportError as e:
            check("pyarrow" in str(e), f"the ImportError names no pyarrow: "
                  f"{e}")
            parquet = str(e)
    rc, out = cli_out("cache", "status")
    status = json.loads(out)
    check(rc == 0 and status["libraries"] in (
        KERNEL_LIBRARIES, sorted(KERNEL_LIBRARIES + [HOST_LIBRARY]))
          and status["dir"].endswith(status["salt"]),
          f"cache status exited {rc}: {out}")
    emit("import_export", events=n, bytes=os.path.getsize(path),
         columns=sorted(a), parquet=parquet, build_cache=status, **timed)
    return path, n


def cols_equal(a: dict, b: dict) -> bool:
    """Two `find_columnar` dicts equal column for column (NaN equal)."""
    return sorted(a) == sorted(b) and all(
        a[k].dtype.kind == b[k].dtype.kind and (
            np.array_equal(a[k], b[k], equal_nan=True)
            if a[k].dtype.kind == "f" else np.array_equal(a[k], b[k]))
        for k in a)


def phase_eventserver_client(es: dict, key: str, app_id: int) -> None:
    """The `eventserver` storage type on `rest_fold`'s running event
    server, with the rec app's `key` (`eventserver_client`): its
    `find_columnar` of the store's first ESC_WINDOW_ROWS rate events (a
    time window, with the rating column) equal to this process's SQLite
    read of the same window, column for column; its `find_columnar_chunked`
    (ESC_CHUNK_ROWS a chunk) equal to its own `find_columnar`; an
    `insert_batch` of ESC_WRITES events landing in the SQLite store once
    each (read with sqlite3), then deleted through it again, so the later
    phases read the store as before."""
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event, from_millis
    from predictionio_tpu_torch.data.storage import eventserver_client
    from predictionio_tpu_torch.data.storage.registry import (
        Storage, StorageClientConfig)
    client = eventserver_client.StorageClient(StorageClientConfig(
        "REMOTE", "eventserver", {"URL": es["url"], "ACCESS_KEY": key}))
    try:
        remote = client.get_data_object("events", "pio_event")
        window = dict(property_field="rating", event_names=["rate"],
                      start_time=from_millis(1000),
                      until_time=from_millis(1000 + ESC_WINDOW_ROWS))
        t0 = time.perf_counter()
        local = Storage.get_events().find_columnar(app_id, **window)
        local_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = remote.find_columnar(app_id, **window)
        read_s = time.perf_counter() - t0
        n = len(got["t"])
        check(n == ESC_WINDOW_ROWS and cols_equal(got, local),
              f"the eventserver read ({n} rows) differs from the SQLite "
              f"read ({len(local['t'])} rows) of the same window")
        t0 = time.perf_counter()
        chunks = list(remote.find_columnar_chunked(
            app_id, chunk_rows=ESC_CHUNK_ROWS, **window))
        chunked_s = time.perf_counter() - t0
        cat = {k: np.concatenate([c[k] for c in chunks]) for k in got}
        check(cols_equal(cat, got), "the eventserver's chunked read differs "
              "from its find_columnar")
        events = [Event(event="esc_probe", entity_type="user",
                        entity_id=f"escp{k}",
                        properties=DataMap({"k": k}))
                  for k in range(ESC_WRITES)]
        t0 = time.perf_counter()
        ids = remote.insert_batch(events, app_id)
        write_s = time.perf_counter() - t0
        rows = store_sql(
            "SELECT id, COUNT(*) FROM {t} WHERE appid=? AND channelid=0 "
            "AND event='esc_probe' GROUP BY id", (app_id,))
        check(len(ids) == ESC_WRITES and sorted(ids) == sorted(
            i for i, _ in rows) and all(c == 1 for _, c in rows),
            f"{len(rows)} of {ESC_WRITES} events written through the "
            "eventserver type landed once in SQLite")
        check(all(remote.delete(i, app_id) for i in ids) and not store_sql(
            "SELECT id FROM {t} WHERE appid=? AND channelid=0 AND "
            "event='esc_probe'", (app_id,)),
            "the probe events were not all deleted again")
    finally:
        client.close()
    emit("eventserver_client", rows=n, read_s=read_s, rows_per_s=n / read_s,
         sqlite_read_s=local_s, chunks=len(chunks), chunked_s=chunked_s,
         writes=ESC_WRITES, write_s=write_s,
         note="the window lies at 1-263 s after the epoch (section C of "
              "ROADMAP.md); the chunk cursors this store takes are not "
              "among the affected milliseconds")


def nativelog_env(workdir: str) -> dict:
    """`nativelog_train`'s EVENTDATA: NL_PARTITIONS partitions under
    `workdir`/eventlog (metadata stays on SQLite, models on localfs)."""
    return {"PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NATIVELOG",
            "PIO_STORAGE_SOURCES_NATIVELOG_TYPE": "nativelog",
            "PIO_STORAGE_SOURCES_NATIVELOG_PATH": os.path.join(workdir,
                                                               "eventlog"),
            "PIO_STORAGE_SOURCES_NATIVELOG_PARTITIONS": str(NL_PARTITIONS)}


def phase_nativelog_train(workdir: str, follows_path: str, n: int,
                          recuser: dict) -> int:
    """The recommended-user train read from the C++ event log
    (`nativelog_train`): EVENTDATA moves to a nativelog source
    (NL_PARTITIONS partitions; metadata stays on SQLite, models on
    localfs), `import` loads `import_export`'s follows into a new app
    there (group commits counted from `pio_ingest_group_size`; the build
    directory then lists HOST_LIBRARY beside the kernels), its
    `find_columnar` must equal the SQLite source app's column for
    column, and `train` of the recommended-user template from that app
    in this process (every solve a CG kernel launch) must give factor
    tables bit-equal to `recuser_train`'s persisted blob. The registry
    is pointed back at SQLite after. Returns the CG launches."""
    from predictionio_tpu_torch.compile.cache import cache_status
    from predictionio_tpu_torch.data.storage import registry
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models.recommendeduser import \
        RecommendedUserEngineFactory
    from predictionio_tpu_torch.obs.metrics import get_registry
    src = Storage.get_meta_data_apps().get_by_name(RECUSER_APP).id
    t0 = time.perf_counter()
    ref_cols = Storage.get_events().find_columnar(src)
    sqlite_read_s = time.perf_counter() - t0
    env = nativelog_env(workdir)

    def group_commits() -> int:
        h = get_registry().get("pio_ingest_group_size")
        return h.count if h is not None else 0

    os.environ.update(env)
    registry.clear_cache()
    try:
        check(Storage.config_summary()["EVENTDATA"] == "nativelog",
              f"EVENTDATA is {Storage.config_summary()}")
        dst = int(cli_value(r"App ID: (\d+)", "app", "new", NL_APP))
        commits0 = group_commits()
        t0 = time.perf_counter()
        rc, out = cli_out("import", "--appid", str(dst), "--input",
                          follows_path)
        import_s = time.perf_counter() - t0
        check(rc == 0 and out.strip() == f"Imported {n} events.",
              f"import into nativelog exited {rc}: {out}")
        commits = group_commits() - commits0
        libs = cache_status()["libraries"]
        check(libs == sorted(KERNEL_LIBRARIES + [HOST_LIBRARY]),
              f"the build directory after the nativelog import: {libs}")
        ev = Storage.get_events()
        t0 = time.perf_counter()
        nl_cols = ev.find_columnar(dst)
        read_s = time.perf_counter() - t0
        check(len(nl_cols["t"]) == n and cols_equal(nl_cols, ref_cols),
              "the nativelog app's columns differ from the SQLite app's")
        logs = sorted(f for f in os.listdir(os.path.join(
            env["PIO_STORAGE_SOURCES_NATIVELOG_PATH"], "pio_event"))
            if f.startswith(f"events_{dst}_"))
        path = os.path.join(workdir, "recuser_nl.json")
        recuser_variant(path, NL_APP)
        tel = {}
        iid, trained, launches = workflow_train(
            path, "nativelog_train_workflow", tel_out=tel)
    finally:
        for k in env:
            os.environ.pop(k, None)
        registry.clear_cache()
    model = trained.models[0]
    ref_iid = recuser["instance"]
    (ref,) = RecommendedUserEngineFactory.apply().deserialize_models(
        Storage.get_model_data_models().get(ref_iid).models, ref_iid)
    check(list(model.followed_ix.ids) == list(ref.followed_ix.ids)
          and np.array_equal(model.followed_factors_normalized,
                             ref.followed_factors_normalized),
          f"the tables trained from nativelog differ from {ref_iid}'s")
    emit("nativelog_train", app=NL_APP, events=n,
         partitions=NL_PARTITIONS, shard_files=logs, import_s=import_s,
         import_events_per_s=n / import_s, group_commits=commits,
         events_per_commit=n / max(commits, 1), read_s=tel["read_s"],
         columnar_read_s=read_s,
         sqlite_read_s=recuser["read_s"], sqlite_columnar_read_s=sqlite_read_s,
         train_s=tel.get("train_s"), cg_launches=launches,
         bit_equal_to=ref_iid, instance=iid)
    return launches


def get_page(url: str) -> tuple:
    """GET `url`: (status, body text)."""
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def closed_port() -> int:
    """A port nothing listens on (bound and released here)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_snapshot_train(workdir: str, recuser: dict) -> int:
    """An app moved to a new host and retrained there (`snapshot_train`),
    after `nativelog_train`, on its four-partition app NL_APP: `snapshot
    create` ships the app's shard files to a `file://` URI; the registry
    then points at a fresh host under `workdir`/SNAPSHOT_HOST (METADATA
    on a `docindex` source, EVENTDATA on a new nativelog with
    NL_PARTITIONS, MODELDATA on localfs), where `app new` makes the app
    again and `snapshot restore` (refused onto the new app's empty logs,
    then `--force`) and `snapshot list` run; the restored app's columns
    must equal the source app's. `build` registers the recommended-user
    variant's manifest in the docindex, `train` runs in this process
    (every solve a CG kernel launch; the tables bit-equal to
    `recuser_train`'s persisted blob), and a `deploy` subprocess reads the
    instance from the docindex and answers RECUSER_QUERIES queries held to
    the float64 top-k. One `run_fake` evaluation is recorded; the
    dashboard (its index, the result in txt, html and json, `/telemetry`
    reading the deploy's /stats.json) and the admin server (`POST` and
    `GET /cmd/app` through the docindex, read back from its log) run in
    this process on port 0; `servers` must see the engine, dashboard and
    admin server UP; `unregister` removes the manifest and a second one
    exits 1. Then `undeploy`, and the registry points back at SQLite.
    Returns the CG launches."""
    from predictionio_tpu_torch.data.storage import registry
    from predictionio_tpu_torch.data.storage.docindex import DocIndex
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models.recommendeduser import \
        RecommendedUserEngineFactory
    from predictionio_tpu_torch.tools.admin import (AdminServer,
                                                    AdminServerConfig)
    from predictionio_tpu_torch.tools.dashboard import (Dashboard,
                                                        DashboardConfig)
    from predictionio_tpu_torch.workflow.fake_workflow import run_fake
    ref_iid = recuser["instance"]
    (ref,) = RecommendedUserEngineFactory.apply().deserialize_models(
        Storage.get_model_data_models().get(ref_iid).models, ref_iid)
    uri = "file://" + os.path.join(workdir, "snapshots")
    nl_env = nativelog_env(workdir)
    os.environ.update(nl_env)
    registry.clear_cache()
    try:
        src = Storage.get_meta_data_apps().get_by_name(NL_APP).id
        src_cols = Storage.get_events().find_columnar(src)
        t0 = time.perf_counter()
        rc, out = cli_out("snapshot", "create", "--appid", str(src), "--uri",
                          uri, "--name", SNAPSHOT)
        snapshot_s = time.perf_counter() - t0
    finally:
        for k in nl_env:
            os.environ.pop(k, None)
        registry.clear_cache()
    m = re.fullmatch(rf"Snapshot {SNAPSHOT} created: (\d+) file\(s\), "
                     rf"(\d+) bytes at {re.escape(uri)}\.\n", out)
    check(rc == 0 and m is not None, f"snapshot create exited {rc}: {out}")
    files, nbytes = int(m.group(1)), int(m.group(2))
    check(files == NL_PARTITIONS, f"{files} shard files in the snapshot")
    host = os.path.join(workdir, SNAPSHOT_HOST)
    env = {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DOCINDEX",
           "PIO_STORAGE_SOURCES_DOCINDEX_TYPE": "docindex",
           "PIO_STORAGE_SOURCES_DOCINDEX_PATH": os.path.join(host,
                                                             "docindex"),
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NATIVELOG",
           "PIO_STORAGE_SOURCES_NATIVELOG_TYPE": "nativelog",
           "PIO_STORAGE_SOURCES_NATIVELOG_PATH": os.path.join(host,
                                                              "eventlog"),
           "PIO_STORAGE_SOURCES_NATIVELOG_PARTITIONS": str(NL_PARTITIONS),
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOCALFS",
           "PIO_STORAGE_SOURCES_LOCALFS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_LOCALFS_PATH": os.path.join(host, "models")}
    os.environ.update(env)
    registry.clear_cache()
    deps, dash, admin = {}, None, None
    try:
        check(Storage.config_summary() == {
            "METADATA": "docindex", "EVENTDATA": "nativelog",
            "MODELDATA": "localfs"}, f"the new host's store is "
              f"{Storage.config_summary()}")
        dst = int(cli_value(r"App ID: (\d+)", "app", "new", NL_APP))
        restore = ("snapshot", "restore", "--uri", uri, "--name", SNAPSHOT,
                   "--appid", str(dst))
        rc, out = cli_out(*restore)
        check(rc == 1 and "pass --force" in out, f"a restore onto the new "
              f"app's logs was not refused: {rc} {out}")
        t0 = time.perf_counter()
        rc, out = cli_out(*restore, "--force")
        restore_s = time.perf_counter() - t0
        check(rc == 0 and out.strip() == f"Snapshot {SNAPSHOT} restored "
              f"({files} file(s)).", f"snapshot restore exited {rc}: {out}")
        rc, listed = cli_out("snapshot", "list", "--uri", uri)
        check(rc == 0 and listed.startswith(
            f"  {SNAPSHOT}  app={src} partitions={NL_PARTITIONS} "
            f"files={files} bytes={nbytes} created="),
            f"snapshot list exited {rc}: {listed}")
        t0 = time.perf_counter()
        cols = Storage.get_events().find_columnar(dst)
        columnar_read_s = time.perf_counter() - t0
        check(len(cols["t"]) == len(src_cols["t"]) and cols_equal(
            cols, src_cols), "the restored app's columns differ from the "
              "source app's")
        path = os.path.join(workdir, "recuser_restored.json")
        recuser_variant(path, NL_APP)
        rc, out = cli_out("build", "-v", path)
        check(rc == 0 and out.strip() == "Engine recommendeduser is valid. "
              "Registered manifest default 0. Build finished successfully.",
              f"build exited {rc}: {out}")
        manifest = Storage.get_meta_data_engine_manifests().get("default",
                                                                 "0")
        check(manifest is not None and manifest.files == (path,)
              and manifest.engine_factory == "recommendeduser"
              and os.path.exists(os.path.join(
                  host, "docindex", "pio_meta", "engine_manifests.log")),
              f"the manifest in the docindex: {manifest}")
        tel = {}
        iid, trained, launches = workflow_train(
            path, "snapshot_train_workflow", tel_out=tel)
        model = trained.models[0]
        del trained
        check(list(model.followed_ix.ids) == list(ref.followed_ix.ids)
              and np.array_equal(model.followed_factors_normalized,
                                 ref.followed_factors_normalized),
              f"the tables trained from the restored app differ from "
              f"{ref_iid}'s")
        queries = recuser_queries(model)
        phase_cli_deploy({"recuser_restored": path}, workdir, deps,
                         first_queries={"recuser_restored": queries[0]},
                         warmed=False)
        dep = deps["recuser_restored"]
        served = get_json(dep["url"] + "/")["engineInstanceId"]
        check(served == iid, f"the deploy serves {served}, not {iid}")
        exact, lat = hold_recuser(dep["url"], model, queries,
                                  "snapshot_train")
        ms = np.array(lat[1:])     # the first repeats the deploy's first
        eval_iid = run_fake(lambda device: None)
        dash = Dashboard(DashboardConfig(
            ip="127.0.0.1", port=0, engine_url=dep["url"],
            event_server_url=f"http://127.0.0.1:{closed_port()}")).start()
        admin = AdminServer(AdminServerConfig(ip="127.0.0.1",
                                              port=0)).start()
        dash_url = f"http://127.0.0.1:{dash.config.port}"
        admin_url = f"http://127.0.0.1:{admin.config.port}"
        code, index = get_page(dash_url + "/")
        check(code == 200 and eval_iid in index, f"the dashboard's index "
              f"({code}) does not list {eval_iid}")
        inst = Storage.get_meta_data_evaluation_instances().get(eval_iid)
        for fmt, want in (("txt", inst.evaluator_results),
                          ("html", inst.evaluator_results_html),
                          ("json", inst.evaluator_results_json)):
            code, page = get_page(f"{dash_url}/engine_instances/{eval_iid}/"
                                  f"evaluator_results.{fmt}")
            check(code == 200 and page == want, f"the dashboard's {fmt} "
                  f"result answered {code}: {page[:200]}")
        code, page = get_page(dash_url + "/telemetry")
        engine_rows = page.split("<h2>Event server")[0]
        check(code == 200 and f"<td>modelVersion</td><td>{iid}</td>"
              in engine_rows and "<td>queryLatency</td>" in engine_rows
              and "<td>error</td>" not in engine_rows,
              f"/telemetry did not read the deploy's /stats.json: "
              f"{engine_rows[:600]}")
        code, made = post(admin_url + "/cmd/app",
                          json.dumps({"name": ADMIN_APP}).encode())
        check(code == 200 and made["name"] == ADMIN_APP,
              f"POST /cmd/app answered {code} {made}")
        names = [a["name"] for a in get_json(admin_url + "/cmd/app")["apps"]]
        log = DocIndex(os.path.join(host, "docindex", "pio_meta",
                                    "apps.log"), fsync=False)
        try:
            logged = [d["id"] for d in log.search(eq={"name": ADMIN_APP})]
        finally:
            log.close()
        check(sorted(names) == sorted([NL_APP, ADMIN_APP])
              and logged == [made["id"]],
              f"GET /cmd/app lists {names}; the docindex log holds "
              f"{logged} for {ADMIN_APP}")
        free = closed_port()
        rc, out = cli_out("servers", "--event-server-port", str(free),
                          "--engine-port", str(dep["port"]),
                          "--dashboard-port", str(dash.config.port),
                          "--admin-port", str(admin.config.port))
        states = dict(re.findall(r"^  (\w+)\s+:\d+\s+(UP|down)", out,
                                 re.M))
        check(rc == 0 and states == {"eventserver": "down", "engine": "UP",
                                     "dashboard": "UP",
                                     "adminserver": "UP"},
              f"servers exited {rc}: {out}")
        unregistered = [cli_out("unregister", "-v", path) for _ in range(2)]
        check(unregistered == [(0, "Unregistered engine default 0.\n"),
                               (1, "Engine default 0 is not registered.\n")]
              and Storage.get_meta_data_engine_manifests().get(
                  "default", "0") is None,
              f"unregister answered {unregistered}")
        phase_undeploy(deps)
    finally:
        for server in (dash, admin):
            if server is not None:
                server.stop()
        stop_all(deps)
        for k in env:
            os.environ.pop(k, None)
        registry.clear_cache()
    emit("snapshot_train", app=NL_APP, source_app=src, restored_app=dst,
         snapshot=SNAPSHOT, snapshot_s=snapshot_s, snapshot_bytes=nbytes,
         snapshot_files=files, restore_s=restore_s, events=len(cols["t"]),
         columnar_read_s=columnar_read_s, read_s=tel["read_s"],
         train_s=tel.get("train_s"), cg_launches=launches,
         bit_equal_to=ref_iid, instance=iid, manifest="registered, removed",
         metadata="docindex", first_query_ms=dep["first_query_ms"],
         queries=len(lat), p50_ms=float(np.percentile(ms, 50)),
         p99_ms=float(np.percentile(ms, 99)), ids_equal_f64=exact,
         tie_swaps=len(queries) - exact, evaluation=eval_iid,
         admin_app=made["id"], servers=states)
    return launches


TENANCY_APP = "pio_follows_boot"   # tenancy: host B's fresh nativelog app
TENANCY_FOLD_RATES = 64            # ... rates appended for the gated ticks
TENANCY_QUERIES = 16               # ... held answers a tenant and a check
TENANCY_SLACK = 8 << 20            # ... bytes an eviction's fall in
#                                    memory_allocated may miss bytesFreed
#                                    by, and a re-upload's rise may miss
#                                    the tenant's gauge by (the static
#                                    inputs of the captures it schedules,
#                                    allocations of other threads: none
#                                    are expected)
TENANCY_ROUTER_AFTER = 8           # ... router answers after the failover
TENANCY_KEY = "smoke-tenancy-key"  # ... the PIO_AUTH host's access key


def labelled(samples: dict, name: str) -> list:
    """[(labels, value)] of the samples of `name` in a `scrape`."""
    return [(dict(labels), v) for (n, labels), v in samples.items()
            if n == name]


def allocated() -> int:
    """`torch.cuda.memory_allocated()` once this stream's work is done:
    the bytes of the tensors alive on the card (not the caching
    allocator's reserve)."""
    sync()
    return torch.cuda.memory_allocated()


def settled_allocated() -> int:
    """`allocated()` once it holds still: the same over three readings
    0.2 s apart (a background capture's warm-up runs may be in flight),
    at most 10 s."""
    last, same = allocated(), 0
    deadline = time.perf_counter() + 10
    while same < 2 and time.perf_counter() < deadline:
        time.sleep(0.2)
        now = allocated()
        same = same + 1 if now == last else 0
        last = now
    return last


def hbm_gauge(url: str) -> dict:
    """tenant -> `pio_engine_hbm_bytes{tenant}` on the host at `url`."""
    return {lab["tenant"]: v for lab, v in labelled(
        scrape(url)[1], "pio_engine_hbm_bytes")}


def owned_graphs(owner) -> int:
    """Executables of the registry keyed on `owner`."""
    from predictionio_tpu_torch.compile.aot import get_aot
    aot = get_aot()
    return sum(1 for k, refs in list(aot._refs.items())
               if k in aot._compiled and any(r() is owner for r in refs))


def ask_fresh(url: str, slot, queries: list) -> list:
    """Each query's answer bytes, computed: the tenant's cache namespace
    is cleared first, so none is a stored answer."""
    slot.server.result_cache.invalidate_all("smoke")
    out = []
    for q in queries:
        code, data, _ = post_raw(url + "/queries.json",
                                 json.dumps(q).encode())
        check(code == 200, f"{url} answered {code} to {q}: {data[:200]}")
        out.append(data)
    return out


def start_host_b(workdir: str, uri: str, path: str) -> dict:
    """`python -m predictionio_tpu_torch bootstrap ru --snapshot SNAPSHOT
    --serve --port 0` on `nativelog_env` (metadata on the same SQLite
    file, models on the same localfs, so host A can load what it
    trains), started now and awaited by `await_host_b`."""
    env = dict(os.environ, **nativelog_env(workdir))
    env.pop("PIO_SERVE_PACK", None)
    log = os.path.join(workdir, "host_b.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch", "bootstrap",
             "ru", "--snapshot", SNAPSHOT, "--uri", uri, "-v", path,
             "--force", "--serve", "--ip", "127.0.0.1", "--port", "0"],
            cwd=HERE, env=env, stdout=f, stderr=subprocess.STDOUT)
    return {"proc": proc, "log": log, "t0": time.perf_counter()}


def await_host_b(b: dict) -> dict:
    """Wait for host B's "serving host live" line: its report (the line
    before), url and seconds to it."""
    live = re.compile(r"Tenant 'ru' admitted; serving host live at "
                      r"(http://127\.0\.0\.1:\d+)\.")
    while True:
        check(b["proc"].poll() is None, f"host B exited "
              f"{b['proc'].returncode}: {log_tail(b['log'])}")
        with open(b["log"], errors="replace") as f:
            lines = f.read().splitlines()
        for k, line in enumerate(lines):
            m = live.fullmatch(line)
            if m:
                b.update(url=m.group(1), report=json.loads(lines[k - 1]),
                         live_s=time.perf_counter() - b["t0"])
                return b
        check(time.perf_counter() - b["t0"] < DEPLOY_TIMEOUT_S,
              f"host B not live in {DEPLOY_TIMEOUT_S} s: "
              f"{log_tail(b['log'])}")
        time.sleep(0.25)


def phase_tenancy(workdir: str, recuser: dict, rec_path: str, rec_iid: str,
                  sim_path: str, sim_iid: str) -> int:
    """Many engines under one HBM budget on the card (`tenancy`), after
    `snapshot_train`, on what the smoke persisted: see the module's
    docstring. The budget is set on host A once its two tenants are
    resident and folded, halfway between the sum of the two largest
    `estimate_padded_bytes` and the sum of all three: the planner then
    places `ru` by pre-empting the cold `rec` (`ru`'s durable priority
    is 1), the first query of `ru` makes the budget evict `rec`, and
    `rec`'s next query evicts `ru`; the resident bytes stay within the
    budget after each. Returns the CG launches (the gated ticks' and host
    B's train, which its report counts)."""
    from predictionio_tpu_torch.compile.aot import capture_quiesced
    from predictionio_tpu_torch.data.columnar import ColumnarBatch
    from predictionio_tpu_torch.data.event import (format_event_time,
                                                   parse_event_time, utcnow)
    from predictionio_tpu_torch.data.storage import registry
    from predictionio_tpu_torch.data.storage.base import AccessKey
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models.recommendeduser import \
        RecommendedUserEngineFactory
    from predictionio_tpu_torch.obs import get_incidents
    from predictionio_tpu_torch.online import SchedulerConfig
    from predictionio_tpu_torch.ops.solve import COUNTS
    from predictionio_tpu_torch.resilience import RetryPolicy
    from predictionio_tpu_torch.tenancy import (HostConfig,
                                                PlacementController,
                                                ServingHost, TenantRouter,
                                                TenantSpec,
                                                estimate_padded_bytes)
    from predictionio_tpu_torch.tenancy import props as tenant_props
    t_phase = time.perf_counter()
    uri = "file://" + os.path.join(workdir, "snapshots")
    nl_env = nativelog_env(workdir)
    os.environ.update(nl_env)
    registry.clear_cache()
    try:
        boot_app = int(cli_value(r"App ID: (\d+)", "app", "new",
                                 TENANCY_APP))
    finally:
        for k in nl_env:
            os.environ.pop(k, None)
        registry.clear_cache()
    boot_path = os.path.join(workdir, "recuser_boot.json")
    recuser_variant(boot_path, TENANCY_APP)
    # `ru` outranks host A's tenants: the planner may pre-empt for it
    tenant_props.save_props("ru", priority=1)
    b = start_host_b(workdir, uri, boot_path)
    host = ServingHost(HostConfig(ip="127.0.0.1", port=0))
    host_c = client = None
    stop_client = threading.Event()
    try:
        # PIO_AUTH=on: a host armed at construction. Stopped before host
        # A starts: two hosts of one process share one fleet record
        app = Storage.get_meta_data_apps().get_by_name(STORE_APP)
        Storage.get_meta_data_access_keys().insert(AccessKey(
            TENANCY_KEY, app.id, ()))
        os.environ["PIO_AUTH"] = "on"
        try:
            host_c = ServingHost(HostConfig(ip="127.0.0.1", port=0))
        finally:
            del os.environ["PIO_AUTH"]
        host_c.add_tenant(TenantSpec(key="sp-auth",
                                     engine_instance_id=sim_iid,
                                     engine_variant=sim_path))
        host_c.start()
        url_c = f"http://127.0.0.1:{host_c.config.port}/engines/sp-auth"
        sp_auth = host_c.slots["sp-auth"].server.models[0]
        body = json.dumps({"items": [sp_auth.item_ix.id_of(3)],
                           "num": SERVE_NUM}).encode()
        auth = {name: post_raw(url_c + f"/queries.json{suffix}", body)[0]
                for name, suffix in (("none", ""),
                                     ("wrong", "?accessKey=nope"),
                                     ("real", f"?accessKey={TENANCY_KEY}"))}
        check(auth == {"none": 401, "wrong": 401, "real": 200},
              f"the PIO_AUTH host answered {auth}")
        host_c.stop()
        host_c = None
        t0 = time.perf_counter()
        host.add_tenant(TenantSpec(key="rec", engine_instance_id=rec_iid,
                                   engine_variant=rec_path))
        host.add_tenant(TenantSpec(key="sp", engine_instance_id=sim_iid,
                                   engine_variant=sim_path))
        host.start()
        admit_s = time.perf_counter() - t0
        url_a = f"http://127.0.0.1:{host.config.port}"
        rec_url, sp_url = url_a + "/engines/rec", url_a + "/engines/sp"

        # each hold computes: the tenant's cache namespace is cleared
        # first (a fold leaves untouched entries, stale by design)
        def hold_rec(what: str) -> int:
            host.slots["rec"].server.result_cache.invalidate_all("smoke")
            model = host.slots["rec"].server.models[0]
            truth = store_truth(model)
            qs = store_queries(model, truth, np.random.default_rng(31))
            U64 = model.als.user_factors.astype(np.float64)
            V64 = model.als.item_factors.astype(np.float64)
            exact = 0
            for q in qs[::len(qs) // TENANCY_QUERIES][:TENANCY_QUERIES]:
                code, body = post(rec_url + "/queries.json",
                                  json.dumps(q).encode())
                check(code == 200, f"{what}: {q} answered {code}")
                exact += hold_served(body, q, model, U64, V64, truth,
                                     f"{what} query {q}", f16=True)
            return exact

        def hold_sp(what: str) -> int:
            host.slots["sp"].server.result_cache.invalidate_all("smoke")
            model = host.slots["sp"].server.models[0]
            T64 = model.item_factors_normalized.astype(np.float64)
            cats = store_truth(model)[0]
            exact = 0
            for q in similar_plane_queries(model, np.random.default_rng(
                    32))[0][:TENANCY_QUERIES]:
                code, body = post(sp_url + "/queries.json",
                                  json.dumps(q).encode())
                check(code == 200, f"{what}: {q} answered {code}")
                exact += hold_similar(body, q, model, T64, cats,
                                      f"{what} query {q}")
            return exact

        held = {"rec": hold_rec("tenancy rec"), "sp": hold_sp("tenancy sp")}
        # one body both tenants read (the user for rec, the items for
        # sp): each answers from its own namespace, never the other's
        rec_model = host.slots["rec"].server.models[0]
        sp_model = host.slots["sp"].server.models[0]
        shared = json.dumps({"user": rec_model.user_ix.id_of(7),
                             "items": [sp_model.item_ix.id_of(7)],
                             "num": SERVE_NUM}).encode()
        hits0 = host.result_cache.stats()["hits"]
        first = {k: post_raw(u + "/queries.json", shared)[1]
                 for k, u in (("rec", rec_url), ("sp", sp_url))}
        again = {k: post_raw(u + "/queries.json", shared)[1]
                 for k, u in (("rec", rec_url), ("sp", sp_url))}
        check(first == again and first["rec"] != first["sp"]
              and b"itemScores" in first["sp"]
              and host.result_cache.stats()["hits"] == hits0 + 2,
              "a byte-identical body crossed tenants in the result cache")

        # the CLI in process, and the operator eviction of rec
        rc, out = cli_out("tenants", "list", "--url", url_a)
        check(rc == 0 and "2 tenant(s)" in out and re.search(
            r"^  rec\s+v=", out, re.M), f"tenants list: {rc} {out}")
        rc, out = cli_out("tenants", "status", "rec", "--url", url_a)
        check(rc == 0 and json.loads(out)["modelVersion"] == rec_iid,
              f"tenants status rec: {rc} {out}")
        rc, out = cli_out("tenants", "pin", "sp", "--url", url_a)
        check(rc == 0 and json.loads(out)["persisted"], f"tenants pin: "
              f"{rc} {out}")
        evictions = []
        budget_evict = host.budget.evict

        def timed_evict(tenant, reason="operator"):
            # memory_allocated around one eviction (no other traffic)
            before = allocated()
            out = budget_evict(tenant, reason=reason)
            evictions.append(dict(out, allocatedFall=before - allocated()))
            return out
        host.budget.evict = timed_evict
        rec_q = store_queries(rec_model, store_truth(rec_model),
                              np.random.default_rng(33))[:TENANCY_QUERIES]
        rec_slot = host.slots["rec"]
        before = ask_fresh(rec_url, rec_slot, rec_q)
        graphs = owned_graphs(rec_model.als)
        rc, out = cli_out("tenants", "evict", "rec", "--url", url_a)
        check(rc == 0 and json.loads(out)["bytesFreed"] > 0,
              f"tenants evict rec: {rc} {out}")
        operator = evictions[-1]
        check(owned_graphs(rec_model.als) == 0 < graphs
              and host.budget.sizes()["rec"] == 0,
              f"the eviction left {owned_graphs(rec_model.als)} of rec's "
              f"{graphs} graphs and {host.budget.sizes().get('rec')} "
              f"bytes")
        check(operator["allocatedFall"] >= operator["bytesFreed"]
              - TENANCY_SLACK, f"memory_allocated fell by "
              f"{operator['allocatedFall']} on an eviction that reported "
              f"{operator['bytesFreed']} bytes freed")
        # the gauge against the card: what rec's re-upload adds to
        # memory_allocated, its captures held off (their graphs' pools
        # are not tables), is what pio_engine_hbm_bytes{rec} then reads.
        # Every capture and its warm-up run on the process's one capture
        # stream, whose cuBLAS workspace exists by now: none is allocated
        # inside the reading
        with capture_quiesced():
            a0 = allocated()
            again = ask_fresh(rec_url, rec_slot, rec_q)
            settled_allocated()
            reupload = {"allocatedRise": allocated() - a0,
                        "gauge": hbm_gauge(url_a)["rec"]}
        check(again == before,
              "rec's answers after the operator eviction differ")
        check(abs(reupload["allocatedRise"] - reupload["gauge"])
              <= TENANCY_SLACK, f"rec's re-upload raised memory_allocated "
              f"by {reupload['allocatedRise']}, its pio_engine_hbm_bytes "
              f"reads {reupload['gauge']}")

        # one fold tick a tenant, each scheduler's own loop through the
        # host's gate (the ticks fold at TENANCY_FOLD_RATES deltas). The
        # fold swaps new models in: nothing here may keep the old ones
        # (their graphs would keep what a later eviction reports freed)
        users, items = rec_model.user_ix, rec_model.item_ix
        del rec_model, sp_model
        cursor = utcnow()
        rng = np.random.default_rng(34)
        users = users.ids_of(rng.integers(0, len(users),
                                          TENANCY_FOLD_RATES))
        items = items.ids_of(rng.integers(0, len(items),
                                          TENANCY_FOLD_RATES))
        t_rates = cursor + datetime.timedelta(seconds=1)
        Storage.get_events().insert_columnar(ColumnarBatch(
            TENANCY_FOLD_RATES, "rate", "user", list(users), "item",
            list(items), [{"rating": float(r)} for r in rng.integers(
                1, 6, TENANCY_FOLD_RATES)],
            [format_event_time(t_rates + datetime.timedelta(milliseconds=j))
             for j in range(TENANCY_FOLD_RATES)]), app.id)
        scheds = {k: host.attach_scheduler(k, SchedulerConfig(
            app_name=STORE_APP, event_names=("rate",),
            max_deltas=TENANCY_FOLD_RATES, poll_interval_s=0.2),
            cursor=cursor) for k in ("rec", "sp")}
        COUNTS.reset()
        t0 = time.perf_counter()
        for sched in scheds.values():
            sched.start()
        try:
            deadline = time.perf_counter() + DEPLOY_TIMEOUT_S
            while not all(sc.last_report is not None or sc.last_error
                          for sc in scheds.values()):
                check(time.perf_counter() < deadline, "the schedulers' "
                      "loops folded nothing")
                time.sleep(0.05)
        finally:
            for sched in scheds.values():
                sched.stop()
        sync()
        ticks_s = time.perf_counter() - t0
        counts = dict(vars(COUNTS))
        reports = {k: sc.last_report for k, sc in scheds.items()}
        check(not any(sc.last_error for sc in scheds.values()),
              f"a scheduler's tick failed: "
              f"{[sc.last_error for sc in scheds.values()]}")
        solves = 0
        for k, rep in reports.items():
            check(rep is not None and rep["gateReport"]["passed"]
                  and rep["events"] == TENANCY_FOLD_RATES,
                  f"{k}'s gated tick: {rep}")
            solves += sum(a["solverCalls"] for a in rep["algorithms"])
        fold_launches = counts["cg_solve"]
        check(fold_launches == solves > 0
              and sum(counts.values()) == fold_launches,
              f"the gated ticks launched {counts} for {solves} solves")
        waited = {lab.get("tenant") for lab, _ in labelled(
            scrape(url_a)[1], "pio_fold_tick_wait_seconds_count")}
        check({"rec", "sp"} <= waited, f"pio_fold_tick_wait_seconds "
              f"has tenants {waited}")
        held_after_fold = {"rec": hold_rec("tenancy rec after fold"),
                           "sp": hold_sp("tenancy sp after fold")}

        # host B: the bootstrap's train, its catch-up and its answers.
        # The catch-up tails every restored event dated at or after the
        # snapshot's creation: the follows are dated 2030, so all of
        # them. The recommended-user template has no fold, so the
        # scheduler counts them and drops them (the reference's does
        # too) and the tables stay the train's.
        await_host_b(b)
        rep_b = b["report"]
        launches_b = rep_b["kernel_launches"]
        os.environ.update(nl_env)
        registry.clear_cache()
        try:
            t_boot = Storage.get_events().find_columnar(boot_app)["t"]
        finally:
            for k in nl_env:
                os.environ.pop(k, None)
            registry.clear_cache()
        tail = int((np.asarray(t_boot) >= int(parse_event_time(
            rep_b["cutover"]).timestamp() * 1000)).sum())
        check(rep_b["admitted"] and rep_b["catchup_events"] == tail
              and rep_b["restored_files"] == NL_PARTITIONS
              and set(launches_b) == {"cg_solve"}
              and launches_b["cg_solve"] > 0,
              f"host B's bootstrap report: {rep_b}")
        iid_b = rep_b["engine_instance_id"]
        (model_b,) = RecommendedUserEngineFactory.apply().deserialize_models(
            Storage.get_model_data_models().get(iid_b).models, iid_b)
        (ref,) = RecommendedUserEngineFactory.apply().deserialize_models(
            Storage.get_model_data_models().get(recuser["instance"]).models,
            recuser["instance"])
        check(list(model_b.followed_ix.ids) == list(ref.followed_ix.ids)
              and np.array_equal(model_b.followed_factors_normalized,
                                 ref.followed_factors_normalized),
              f"host B's tables differ from {recuser['instance']}'s")
        ru_q = recuser_queries(model_b)[:TENANCY_QUERIES]
        exact_b, _ = hold_recuser(b["url"] + "/engines/ru", model_b, ru_q,
                                  "tenancy host B")
        rc, status_out = cli_out("placement", "status")
        check(rc == 0 and len(re.findall(r"^serving_host-\d+\s+UP",
                                         status_out, re.M)) == 2,
              f"placement status: {rc} {status_out}")
        rc, plan_out = cli_out("placement", "plan")
        check(rc == 0, f"placement plan: {rc} {plan_out}")

        # the budget: any two tenants fit, all three do not, so ru
        # cannot join host A without an eviction
        est = {"rec": estimate_padded_bytes(host.slots["rec"].server.models),
               "sp": estimate_padded_bytes(host.slots["sp"].server.models),
               "ru": estimate_padded_bytes([model_b])}
        two_largest = sum(sorted(est.values())[1:])
        budget = (two_largest + sum(est.values())) // 2
        sizes = host.budget.sizes()
        check(sum(sizes.values()) <= budget, f"rec and sp hold {sizes}, "
              f"over the budget {budget} (padded {est})")
        host.budget.budget_bytes = budget

        def within_budget(what: str) -> int:
            n = host.budget.resident_bytes()
            check(n <= budget, f"{what}: the tenants hold {n} bytes "
                  f"({host.budget.sizes()}), over the budget {budget}")
            return n
        rec_q2 = rec_q[::-1]
        rec_before = ask_fresh(rec_url, rec_slot, rec_q2)
        sp_before = host.budget.sizes()["sp"]

        # a router client through the kill
        ctl = PlacementController()
        ctl.refresh_routes()
        check(ctl.route_for("ru") is not None and ctl.route_for("ru")[0]
              == b["url"], f"the route of ru: {ctl.route_for('ru')}")
        router = TenantRouter(ctl, policy=RetryPolicy(
            max_attempts=200, base_delay_s=0.05, max_delay_s=0.5,
            deadline_s=float(DEPLOY_TIMEOUT_S)))
        answers, failures = [], []

        def ride():
            k = 0
            while not stop_client.is_set():
                try:
                    out = router.query("ru", ru_q[k % len(ru_q)])
                    answers.append((time.perf_counter(), out))
                except Exception as e:
                    failures.append(repr(e))
                k += 1
        client = threading.Thread(target=ride, daemon=True)
        client.start()
        deadline = time.perf_counter() + 60
        while len(answers) < 4 and not failures:
            check(time.perf_counter() < deadline, "the router client got "
                  "no answers from host B")
            time.sleep(0.05)
        n_before = len(answers)
        pid_b = b["proc"].pid
        b["proc"].kill()
        b["proc"].wait()
        t_kill = time.perf_counter()
        rc, apply_out = cli_out("placement", "apply")
        apply_s = time.perf_counter() - t_kill
        check(rc == 0 and f"failover executed for serving_host-{pid_b}"
              in apply_out, f"placement apply: {rc} {apply_out}")
        deadline = time.perf_counter() + DEPLOY_TIMEOUT_S
        while sum(1 for t, _ in answers if t > t_kill) \
                < TENANCY_ROUTER_AFTER and not failures:
            check(time.perf_counter() < deadline, "the router client got "
                  "no answers after the failover")
            time.sleep(0.05)
        stop_client.set()
        client.join(timeout=120)
        check(not failures, f"the router client failed: {failures[:3]}")
        after = [t for t, _ in answers if t > t_kill]
        first_after_s = min(after) - t_kill
        plc = get_json(url_a + "/placement.json")
        check(plc["tenants"]["ru"]["generation"] == 1
              and plc["tenants"]["ru"]["priority"] == 1,
              f"ru on host A: {plc['tenants'].get('ru')}")
        code, body = post(url_a + "/tenants/ru/admit",
                          json.dumps({"generation": 0}).encode())
        check(code == 409 and body["message"] == "stale placement "
              "generation", f"a stale admit answered {code} {body}")
        incidents = [r for r in get_incidents().list_incidents()
                     if r.get("kind") == "host_failover"]
        check(len(incidents) == 1
              and f"serving_host-{pid_b}" in incidents[0]["reason"],
              f"host_failover incidents: {incidents}")
        budget_ev = [e for e in evictions if e["reason"] == "budget"]
        check(budget_ev and budget_ev[0]["tenant"] == "rec"
              and all(e["tenant"] != "sp" for e in evictions)
              and host.budget.sizes()["sp"] == sp_before,
              f"the evictions: {evictions}")
        ev = budget_ev[0]
        check(ev["bytesFreed"] > 0 and ev["allocatedFall"]
              >= ev["bytesFreed"] - TENANCY_SLACK,
              f"memory_allocated fell by {ev['allocatedFall']} on the "
              f"budget eviction of {ev['bytesFreed']} bytes")
        exact_a, _ = hold_recuser(url_a + "/engines/ru", model_b, ru_q,
                                  "tenancy after failover")
        resident_after = {
            "ru_uploaded": within_budget("ru's upload on host A")}
        # rec's re-upload makes room by evicting ru (sp is pinned)
        check(ask_fresh(rec_url, rec_slot, rec_q2) == rec_before,
              "rec's answers after the budget eviction differ")
        resident_after["rec_reuploaded"] = within_budget("rec's re-upload")
        check([e["tenant"] for e in evictions if e["reason"] == "budget"]
              == ["rec", "ru"], f"the budget evictions: {evictions}")
        samples = scrape(url_a)[1]
        gauge = {lab["tenant"]: v for lab, v in labelled(
            samples, "pio_engine_hbm_bytes")}
        evicted = {f"{lab['tenant']}/{lab['reason']}": v
                   for lab, v in labelled(samples,
                                          "pio_tenant_evictions_total")}
        evictions = list(evictions)    # the removals at teardown apart
    finally:
        stop_client.set()
        if client is not None:
            client.join(timeout=120)
        if b["proc"].poll() is None:
            b["proc"].kill()
            b["proc"].wait()
        for h in (host_c, host):
            if h is not None:
                h.stop()
    launches = fold_launches + launches_b["cg_solve"]
    emit("tenancy", tenants=sorted(gauge), admit_s=admit_s,
         held_ids_equal_f64=held, held_after_fold=held_after_fold,
         host_b_live_s=b["live_s"], host_b_restore_s=rep_b["restore_s"],
         host_b_train_s=rep_b["train_s"],
         host_b_catchup_s=rep_b["bootstrap_catchup_s"],
         host_b_catchup_events=rep_b["catchup_events"],
         host_b_catchup_folds=rep_b["catchup_folds"],
         host_b_streamed=rep_b["load"] is not None,
         host_b_cg_launches=launches_b["cg_solve"],
         bit_equal_to=recuser["instance"], host_b_ids_equal_f64=exact_b,
         fold_ticks_s=ticks_s, fold_cg_launches=fold_launches,
         auth=auth, padded=est, resident_before_failover=sizes,
         budget_bytes=budget, two_largest_padded=two_largest,
         all_padded=sum(est.values()), resident_after=resident_after,
         reupload=reupload,
         evictions=evictions, evictions_total=evicted,
         graphs_dropped=graphs, router_answers_before=n_before,
         router_answers_after=len(after), placement_apply_s=apply_s,
         first_answer_after_failover_s=first_after_s,
         ru_ids_equal_f64_on_a=exact_a, hbm_bytes=gauge,
         incident=incidents[0]["id"], phase_s=time.perf_counter() - t_phase)
    return launches


def simrank_graph() -> tuple:
    """The recommended-user follows among their SIMRANK_NODES most-followed
    accounts (ties by id): (edges [E, 3] as (follower, followed, 1),
    node count, the largest in-degree)."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    app = Storage.get_meta_data_apps().get_by_name(RECUSER_APP).id
    c = Storage.get_events().find_columnar(app, event_names=["follow"])
    accounts, counts = np.unique(c["target_entity_id"], return_counts=True)
    top = accounts[np.argsort(-counts, kind="stable")[:SIMRANK_NODES]]
    ix = {a: k for k, a in enumerate(sorted(top))}
    src = np.array([ix.get(u, -1) for u in c["entity_id"]])
    dst = np.array([ix.get(u, -1) for u in c["target_entity_id"]])
    keep = (src >= 0) & (dst >= 0)
    edges = np.stack([src[keep], dst[keep], np.ones(keep.sum())],
                     axis=1).astype(np.float32)
    in_deg = np.bincount(dst[keep], minlength=len(ix))
    return edges, len(ix), int(in_deg.max())


def timed_ms(fn) -> tuple:
    """(fn(), its device ms from CUDA events around the one call)."""
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_examples(workdir: str) -> None:
    """The example engines on the card (`examples`):
    - the quickstart's QUICKSTART_FAMILY family as a subprocess (`python
      -m predictionio_tpu_torch.examples.quickstart`), its MODELDATA on
      a `remotefs` `file://` source: exit 0, an answer of 4 items, the
      model blob under that URL (its train's solves are the
      subprocess's, not counted in the kernels line);
    - SimRank on the recommended-user follows among their SIMRANK_NODES
      most-followed accounts, SIMRANK_ITERS iterations at decay
      SIMRANK_DECAY, against the same fixed point in float64 on the card
      within SIMRANK_TOL, unit diagonal; the same fixed point with TF32
      products (10-bit mantissas) must miss SIMRANK_TOL, so the hold
      shows that the port's products are true f32;
    - the keyword engine's scores (`_user_items`, the product behind
      `score_all_items`) for KEYWORD_USERS users against KEYWORD_ITEMS
      items, exact against float64 (sums of small integer weights), and
      `score_all_items` of one user equal to its row;
    - the walk-forward backtest at STOCK_TICKERS tickers over STOCK_DAYS
      days (retrain every STOCK_RETRAIN days); the retrain at
      STOCK_HELD_T held to numpy's float64 `lstsq` of the same ridged
      least squares per ticker, within the componentwise first-order
      bound of f32 rounding in the Gram, the right-hand side and the
      solve (the indicator features are nearly collinear: cond(G) reads
      ~1e6, so a normwise bound would hold nothing)."""
    from predictionio_tpu_torch.examples import friend_recommendation as TF
    from predictionio_tpu_torch.examples import stock_backtesting as TS
    dev = torch.device("cuda")
    # -- the quickstart, MODELDATA on remotefs ------------------------------
    root = os.path.join(workdir, "remote_models")
    env = dict(os.environ, TMPDIR=workdir,
               PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE="RFS",
               PIO_STORAGE_SOURCES_RFS_TYPE="remotefs",
               PIO_STORAGE_SOURCES_RFS_URL=f"file://{root}")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.examples.quickstart",
         QUICKSTART_FAMILY], cwd=HERE, env=env, capture_output=True,
        text=True, timeout=600)
    quickstart_s = time.perf_counter() - t0
    check(out.returncode == 0, f"the quickstart exited {out.returncode}: "
          f"{out.stderr[-3000:]}")
    iid = re.search(r"Trained engine instance (\S+)", out.stdout).group(1)
    answer = json.loads(re.search(r"^Result (.*)$", out.stdout,
                                  re.M).group(1))
    blob = os.path.join(root, "pio_model", iid)
    check(len(answer.get("itemScores", [])) == 4
          and os.path.getsize(blob) > 0,
          f"the quickstart answered {answer}; blob {blob}")
    emit("examples_quickstart", family=QUICKSTART_FAMILY, instance=iid,
         wall_s=quickstart_s, answer=answer,
         blob=os.path.relpath(blob, workdir),
         blob_bytes=os.path.getsize(blob))
    # -- SimRank -------------------------------------------------------------
    edges, n, d_max = simrank_graph()
    W = TF.adjacency(edges, n, dev)
    W64 = TF.adjacency(edges, n, dev, torch.float64)
    S, ms = timed_ms(lambda: TF._simrank(W, SIMRANK_ITERS, SIMRANK_DECAY))
    S64, ms64 = timed_ms(lambda: TF._simrank(W64, SIMRANK_ITERS,
                                             SIMRANK_DECAY))
    err = (S.double() - S64).abs().max().item()
    tol = SIMRANK_TOL
    diag = bool(torch.equal(torch.diagonal(S), torch.ones(n, device=dev)))
    check(torch.isfinite(S).all().item() and err <= tol and diag,
          f"SimRank f32 vs float64: {err} (tolerance {tol}), unit diagonal "
          f"{diag}")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        S_tf32 = TF._simrank(W, SIMRANK_ITERS, SIMRANK_DECAY)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_err = (S_tf32.double() - S64).abs().max().item()
    check(tf32_err > tol, f"SimRank with TF32 products passes the f32 hold "
          f"({tf32_err} <= {tol}): the hold cannot tell them apart")
    del S_tf32
    flops = SIMRANK_ITERS * 2 * 2 * n ** 3
    emit("examples_simrank", nodes=n, edges=len(edges), max_in_degree=d_max,
         iterations=SIMRANK_ITERS, decay=SIMRANK_DECAY, max_abs_err=err,
         tolerance=tol, tf32_max_abs_err=tf32_err, device_ms=ms, f64_device_ms=ms64,
         tflops=flops / ms / 1e9, unit_diagonal=diag)
    del W, W64, S, S64
    # -- the keyword engine ----------------------------------------------------
    rng = np.random.default_rng(31)
    U = np.zeros((KEYWORD_USERS, TF.HASH_DIM), np.float32)
    np.add.at(U, (np.repeat(np.arange(KEYWORD_USERS), 5),
                  rng.integers(0, KEYWORD_VOCAB, 5 * KEYWORD_USERS)
                  % TF.HASH_DIM),
              rng.integers(1, 4, 5 * KEYWORD_USERS).astype(np.float32))
    I = np.zeros((KEYWORD_ITEMS, TF.HASH_DIM), np.float32)
    np.add.at(I, (np.repeat(np.arange(KEYWORD_ITEMS), 4),
                  rng.integers(0, KEYWORD_VOCAB, 4 * KEYWORD_ITEMS)
                  % TF.HASH_DIM), 1.0)
    users = [f"u{k}" for k in range(KEYWORD_USERS)]
    model = TF.KeywordSimModel({u: k for k, u in enumerate(users)},
                               {f"i{k}": k for k in range(KEYWORD_ITEMS)},
                               U, I, 1.0, 1.0)
    algo = TF.KeywordSimilarityAlgorithm(TF.KeywordSimParams())
    Ud, Id = algo._tables(model)
    idx = torch.arange(KEYWORD_USERS, device=dev)
    scores = TF._user_items(Ud, Id, idx)
    ref = Ud.double() @ Id.double().T
    kw_err = (scores.double() - ref).abs().max().item()
    row = algo.score_all_items(model, users[7])
    pair = algo.predict(model, TF.FriendQuery(users[7], "i9"))
    check(kw_err == 0 and np.array_equal(row, scores[7].cpu().numpy())
          and pair.confidence == float(ref[7, 9]),
          f"keyword scores vs float64: {kw_err}")
    kw_ms = cuda_ms(lambda: TF._user_items(Ud, Id, idx), 5)
    emit("examples_keyword", users=KEYWORD_USERS, items=KEYWORD_ITEMS,
         hash_dim=TF.HASH_DIM, max_abs_err=kw_err, device_ms=kw_ms,
         nonzero_scores=int((scores > 0).sum().item()))
    del scores, ref, Ud, Id, U, I, model
    # -- the stock engine --------------------------------------------------------
    frame = TS.synthetic_prices(STOCK_DAYS, STOCK_TICKERS, seed=17)
    strat = TS.RegressionStrategy(TS.RegressionStrategyParams())
    t0 = time.perf_counter()
    result = TS.backtest(frame, strat, TS.BacktestingParams(), STOCK_START,
                         STOCK_DAYS, retrain_every=STOCK_RETRAIN)
    backtest_s = time.perf_counter() - t0
    navs = np.array([d.nav for d in result.daily])
    check(result.days == STOCK_DAYS - STOCK_START
          and np.isfinite(navs).all() and (navs > 0).all(),
          f"the backtest's NAV: {result.to_dict()}")
    p = strat.params
    lo = max(strat._warmup(), STOCK_HELD_T - p.training_window)
    feats = strat._features(frame)
    lp = frame.log_prices
    r_fwd = np.zeros_like(lp)
    r_fwd[:-1] = lp[1:] - lp[:-1]
    X = feats[lo:STOCK_HELD_T - 1].transpose(1, 0, 2)
    y = r_fwd[lo:STOCK_HELD_T - 1].transpose(1, 0)
    coefs = strat.train(frame, STOCK_HELD_T).coefs
    N, Wn, F = X.shape
    u = 2.0 ** -24
    worst = 0.0
    max_err = 0.0
    for k in range(N):
        X64, y64 = X[k].astype(np.float64), y[k].astype(np.float64)
        aug = np.vstack([X64, np.sqrt(1e-6) * np.eye(F)])
        c64, *_ = np.linalg.lstsq(aug, np.concatenate([y64, np.zeros(F)]),
                                  rcond=None)
        # the componentwise first-order bound: f32 sums of Wn products in
        # the Gram and the right-hand side (gamma_Wn |X|^T|X|, |X|^T|y|)
        # and a backward-stable F x F solve (4 F u |G|), through |G^-1|
        G = X64.T @ X64 + 1e-6 * np.eye(F)
        gam = Wn * u / (1 - Wn * u)
        AX = np.abs(X64)
        bound = np.abs(np.linalg.inv(G)) @ (
            gam * (AX.T @ AX @ np.abs(c64) + AX.T @ np.abs(y64))
            + 4 * F * u * np.abs(G) @ np.abs(c64))
        e = np.abs(coefs[k] - c64)
        max_err = max(max_err, float(e.max()))
        worst = max(worst, float((e / bound).max()))
    check(worst <= 1.0, f"batched OLS vs float64 lstsq: error {max_err}, "
          f"{worst} of its bound")
    Xd = torch.as_tensor(X, device=dev)
    yd = torch.as_tensor(y, device=dev)
    ols_ms = cuda_ms(lambda: TS.ols_solve(Xd, yd), 20)
    Gd = torch.einsum("nwf,nwg->nfg", Xd, Xd) + 1e-6 * torch.eye(F,
                                                                 device=dev)
    bd = torch.einsum("nwf,nw->nf", Xd, yd)
    solve_ms = cuda_ms(lambda: torch.linalg.solve(Gd, bd[..., None]), 20)
    emit("examples_backtest", tickers=STOCK_TICKERS, frame_days=STOCK_DAYS,
         start=STOCK_START, retrain_every=STOCK_RETRAIN,
         retrains=-(-(STOCK_DAYS - STOCK_START) // STOCK_RETRAIN),
         wall_s=backtest_s, **result.to_dict(), final_nav=float(navs[-1]),
         held_t=STOCK_HELD_T, window=[N, Wn, F], max_abs_err=max_err,
         err_of_bound=worst, ols_device_ms=ols_ms,
         solve_device_ms=solve_ms)


def phase_lint() -> None:
    """The port's static analyzer and its cost analysis. `python -m
    predictionio_tpu_torch lint --json` runs as a subprocess on the card's
    host and must report the port clean against its own baseline (`ok`,
    no new finding, no stale baseline entry, no parse error); meanwhile
    `costmon.analyze_jit` runs the serve path's batched top-k program
    (`ops/als._users_topk_b`) once on the card at the store model's
    bucket dims (seeded tables of its padded shapes), and must count at
    least the product's 2*b*i*r FLOPs and the item table's bytes, and
    its gauges must carry both."""
    from predictionio_tpu_torch.obs import costmon
    from predictionio_tpu_torch.obs import get_registry
    from predictionio_tpu_torch.ops import als as TA
    t_phase = time.perf_counter()
    # the analyzer runs on the host while the cost analysis runs on the
    # card
    lint = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch", "lint", "--json"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cost, dims, analyze_s = lint_cost_analysis(costmon, TA)
        stdout, stderr = lint.communicate(timeout=300)
    finally:
        if lint.poll() is None:
            lint.kill()
            lint.wait()
    check(lint.returncode == 0, f"lint exited {lint.returncode}: "
          f"{stdout[-2000:]} {stderr[-2000:]}")
    rep = json.loads(stdout)
    check(rep["ok"] is True and rep["findings"] == []
          and rep["staleBaselineEntries"] == [] and rep["parseErrors"] == [],
          f"lint is not clean: {json.dumps(rep)[:2000]}")
    b, i, r = dims["b"], dims["i"], dims["r"]
    flops_floor = 2 * b * i * r
    check(cost is not None and cost["flops"] >= flops_floor
          and cost["bytes_accessed"] >= 4 * i * r,
          f"analyze_jit counted {cost} on the card, against at least "
          f"{flops_floor} FLOPs and {4 * i * r} bytes")
    gauges = {name: {lab["executable"]: v for lab, v in
                     get_registry().get(name).samples() if lab}
              for name in ("pio_executable_flops",
                           "pio_executable_bytes_accessed")}
    check(gauges["pio_executable_flops"][costmon.BATCH_PREDICT]
          == cost["flops"]
          and gauges["pio_executable_bytes_accessed"][costmon.BATCH_PREDICT]
          == cost["bytes_accessed"], f"the cost gauges read {gauges}")
    emit("lint", files=rep["files"], analyzer_s=rep["elapsedS"], suppressed=rep["suppressed"],
         analyze_jit={"label": costmon.BATCH_PREDICT, "dims": dims,
                      "flops": cost["flops"],
                      "bytes_accessed": cost["bytes_accessed"],
                      "flops_floor": flops_floor, "wall_s": analyze_s},
         phase_s=time.perf_counter() - t_phase)


def lint_cost_analysis(costmon, TA) -> tuple:
    """`analyze_jit` of the batched top-k program on the card at the
    store model's bucket dims: (its cost, the dims, its wall seconds)."""
    n_u, n_i, _ = STORE_DATA
    dims = TA.batch_predict_dims(
        types.SimpleNamespace(n_users=n_u, n_items=n_i, rank=RANK,
                              item_factors=None),
        SERVE_CLIENTS // 2, SERVE_NUM)
    i, r = dims["i"], dims["r"]
    gen = torch.Generator(device="cuda").manual_seed(20)
    U = torch.randn(dims["u"], r, device="cuda", generator=gen)
    V = torch.randn(i, r, device="cuda", generator=gen)
    ixs = torch.randint(0, n_u, (dims["b"],), device="cuda", generator=gen)
    fn = functools.partial(TA._users_topk_b, U, V, n_items=n_i,
                           k=dims["k"], p=dims["p"])
    t0 = time.perf_counter()
    cost = costmon.analyze_jit(costmon.BATCH_PREDICT, fn, ixs)
    sync()
    return cost, dims, time.perf_counter() - t0


def kernel_entry(name: str, source: str, replaces: str, launches: int,
                 max_abs_err: float, max_rel_err: float, timed: dict,
                 timed_shape: dict) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"predictionio_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "max_rel_err": max_rel_err,
            "ms": timed["kernel_ms"], "kernel_ms": timed["kernel_ms"],
            "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "library_call": "torch.linalg.solve",
            "timed_shape": timed_shape}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pio_smoke_store_") as workdir:
        use_store(workdir)
        try:
            info = phase_device()
            kern = phase_kernel()
            phase_fold_kernel()
            chol = phase_chol_kernel()
            schulz = phase_schulz_kernel()
            algo, model, cg_launches, pd, cg_rmse = phase_train()
            with exact_pack():
                phase_serve(algo, model)
            del algo, model
            cg_launches += phase_als_fields(pd, cg_rmse)
            sp_algo, sp_model, chol_launches, sp_pd = phase_implicit_train(
                pd.ratings_coo.nnz)
            with exact_pack():
                phase_similar_serve(sp_algo, sp_model)
            chol_launches += phase_fused_implicit(sp_algo, sp_model, sp_pd)
            del sp_algo, sp_model, sp_pd
            s_algo, s_model, schulz_launches = phase_schulz_train(pd,
                                                                  cg_rmse)
            phase_schulz_resolve(s_model.als, pd.ratings_coo)
            with exact_pack():
                phase_serve(s_algo, s_model, "schulz_serve",
                            SCHULZ_QUERIES)
            del s_algo, s_model, pd
            path, iid, trained, store_launches, batch_read_s = \
                phase_store_train(workdir)
            cg_launches += store_launches
            cg_launches += phase_sharded(workdir, trained, store_launches)
            stream_launches, stream_stats = phase_stream_train(
                workdir, iid, batch_read_s)
            cg_launches += stream_launches
            phase_dataplane(stream_stats)
            phase_e2()
            with exact_pack():
                retrain_launches, rec_model = phase_store_deploy(
                    path, iid, trained)
            cg_launches += retrain_launches
            del trained
            cg_launches += phase_rec_eval(workdir)
            sim_launches, fold_launches, tenants = serve_plane_phases(
                path, rec_model, workdir)
            chol_launches += sim_launches
            cg_launches += fold_launches
            del rec_model
            cg_launches += collection_phases(path, workdir)
            template_launches, recuser = template_phases(workdir)
            cg_launches += template_launches
            phase_classification(workdir)
            follows_path, n_follows = phase_import_export(workdir)
            cg_launches += phase_nativelog_train(workdir, follows_path,
                                                 n_follows, recuser)
            cg_launches += phase_snapshot_train(workdir, recuser)
            cg_launches += phase_tenancy(workdir, recuser, path, *tenants)
            phase_examples(workdir)
            phase_lint()
        finally:
            from predictionio_tpu_torch.data.storage import registry
            registry.clear_cache()
    emit("done", wall_s=time.perf_counter() - t_start)
    cg_primal, chol_primal = kern["rows"][0], chol["rows"][0]
    schulz_primal = schulz["rows"][0]
    line = {"kernels": [
        kernel_entry("cg_solve", "cg_solve.cu",
                     "predictionio_tpu/ops/solve.py:208 (_cg_kernel)",
                     cg_launches,
                     max(r["max_abs_err"] for r in kern["rows"]),
                     max(r["max_rel_err"] for r in kern["rows"]), cg_primal,
                     {"B": cg_primal["B"], "R": cg_primal["R"],
                      "iters": cg_primal["iters"]}),
        kernel_entry("chol_solve", "chol_solve.cu",
                     "predictionio_tpu/ops/solve.py:406 (_chol_kernel -> "
                     "_blocked_cholesky_solve :285)",
                     chol_launches,
                     max(r["abs_err"] for r in chol["rows"]),
                     max(r["rel_err"] for r in chol["rows"]), chol_primal,
                     {"B": chol_primal["B"], "R": chol_primal["R"]}),
        kernel_entry("schulz_solve", "schulz_solve.cu",
                     "predictionio_tpu/ops/solve.py:91 (_schulz_kernel, "
                     "pallas_call :146)",
                     schulz_launches,
                     max(r["max_abs_err"] for r in schulz["rows"]),
                     max(r["max_rel_err"] for r in schulz["rows"]),
                     schulz_primal,
                     {"B": schulz_primal["B"], "R": schulz_primal["R"],
                      "iters": schulz_primal["iters"],
                      "compute_dtype": schulz_primal["compute_dtype"]})]}
    print(json.dumps(line), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
