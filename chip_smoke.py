#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gubernator_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--windows 30] [--out results.json]

Run from the root of the repository. Phases, each fatal on failure:

1. print the card (nvidia-smi name and power limit) and build every native
   source, all compilers started together: the CUDA kernels from csrc/
   with nvcc and the key directory native/keydir.cpp with g++; each
   source's build time is printed;
2. hold the decide kernels to their plain PyTorch version on the card, on
   a 10,000,001-row table populated from --seed: the one-window kernel in
   the wide, compact, lean and interned formats at W in {64, 1024, 8192},
   the scan kernel at K in {2, 32}, W = 64, and on a herd group (32
   windows, one live lane each, one row). Responses and whole tables must
   be bit-equal (an interned case also to the compact kernel on the same
   window); each shape is timed against its plain version and its bound.
   Then the sweep, run once over the engine's three formats: the
   one-window kernel in blocks of 64 and 128 at each W, and the scan spread
   over 1, 2, 4 and 8 blocks at K = 32 (each variant held bit-equal first;
   the library keeps the winners as constants); then the edge lanes,
   bit-equal: clamped, wrapping and overflowing lanes, the lean sign bit,
   the interned config id 255, lanes past the table beside the lane that
   writes row C-1 (one window of 8192 lanes and scan groups, every format),
   herds on rows with a negative duration, and scans run in chunks or
   window by window;
3. the main path: Engine(device="cuda", capacity=10_000_001) on the native
   directory after warmup() takes --windows client batches of 8192
   requests over 1,000,000 Zipf(1.1) keys through the one-pass fast
   window; after each window the 16 hottest keys go through seed_mirror
   (the gather kernel in its pinned form) and three decide_native_single
   calls each (a miss becomes a one-request window), so the next window's
   lookups inject the dirty mirrors (the inject kernel, in its pinned form:
   the key directory writes the rows into the engine's page-locked
   staging). Engine(device="cpu") takes the same sequence; responses, lone
   responses, tables and EngineStats counters must be equal, every inject
   and gather launch must have gone through the pinned entry point, and
   every engine dispatch must have made exactly one decide launch.
   Prints decisions/s, the stage split, seed_mirror's time per call and
   the host time per Engine._apply_inject_rows that had rows; the host-stage
   split of seed_mirror over 10,000 calls; and the decide launches by
   format, form, width and K, with the live lanes per window and the
   longest per-row chain of each scan group. The first 16 scan groups of
   each format are captured (staging and the rows they touch) and replayed
   on a fresh table, kernel against plain version, bit-equal, then timed;
3b. the same engines on the python directory (GUBER_NO_NATIVE=1), 10
   windows, no lone requests;
4. the GLOBAL sync: the ring kernel against its plain version at
   L in {G, 4G}, timed; the raw stream handle of the shared launch path
   held equal to torch.cuda.current_stream's, on the default stream and a
   side stream; the host-stage split of the ring wrapper over 10,000
   calls; then sync steps over S = 8 shards of 1,250,000 rows with
   G = 1024 global keys, collectives="ring" on the card against "psum" on
   the CPU (each step's owner apply one sharded decide launch); mirrors
   and shard tables must be equal;
5. the row kernels against their plain versions on the card: inject at
   m in {1, 16, 64, 4096}, from rows on the card and from page-locked host
   rows (the engine's form, timed as a host round trip beside
   torch.from_numpy(a).to(dev) + index_copy_), and gather at m in {1, 64,
   8192} on a populated 10,000,001-row table (dropped, clamped and
   int32-overflowing lanes); the pinned inject in its three forms, by value
   (rows in the launch's parameters, m <= 448), mapped, and copied up into
   the staging's device scratch (m >= the library's copy_min), at m in {1,
   16, 64, 448, 449, 1024, 2048, 3072, 4096, 8192} and copy_min - 1 and
   copy_min, with the slots -1, C - 1 and C, in the form m picks and in
   every other form the library takes at that m; the reuse check: 64
   pinned injects of each form from one reused InjectStaging, the host
   rewriting it between launches with no wait but the staging's own (a
   mapped inject's or a copy's), and rewriting it whole right after each
   by-value launch, behind a busy stream, must leave the table equal to the
   plain version's of the rows as launched; the gather's pinned forms, by value
   (m <= 64) and mapped, at m in {1, 16, 64, 65, 4096} with the slots -1,
   C - 1, C and C + 8, through the public wrapper and the engine's entry;
   row_bump into a caller's out on an
   int32[10,000,000, 128] table (5.12 GB) against the plain version on a
   clone; then the probe's own loop (gubernator_tpu_torch.bench_rows);
6. the serving pipeline: Engine(device="cuda", capacity=10_000_001,
   widths 64-8192) after warmup() and warmup_pipeline(max_group=8), the
   combiner's depth probe over (1, 3, 6) printed; phase 3's first 24
   windows (196,608 requests) cut into client submissions of 1-512 requests
   (log-uniform, from --seed) and one of 10,000 (the combiner's serial
   path), now_ms + 1 every 64 submissions, from one async submitter through
   BackendCombiner at depth 3 and scan 8, the first 400 submissions under
   torch.profiler (the device's busy share); Engine(device="cpu") takes the
   stream through a depth-1 combiner: responses must be equal, and so must
   the table rows at every key the directory holds. Then direct
   launch_windows groups of distinct keys at (K, W) in {2, 8} x {64, 1024,
   8192}, each launched behind ~0.5 s of busy card (its slot's event must
   still be pending when the launch returns: no launch waits on the card),
   against the CPU twin. The stream runs again on fresh card engines at
   depth 1, 1 and 3 (in turns with the first). Then 8 windows as wire
   columns through launch_columnar_windows / collect_columnar_windows
   (depth 3 and 1 in turns, scan 8, everything collected on a cut,
   leftovers through get_rate_limits) against lock-step submit_columnar /
   complete_columnar on a CPU twin. Prints decisions/s of every run, host
   us per launch_windows and collect_windows, the combiner's stats, the
   decide launches by format, form, K and W with the scan launches by the
   path csrc/decide.cu takes (chunked or one launch a window), the slot
   refills and inject-staging frees that had to wait;
7. persistence: the link's page-locked copy rates (1 GiB each way); a
   binary snapshot file of 10,000,000 buckets (in the shape of
   tests/test_snapshot_scale.py's, made from --seed, every 16th expired)
   in a temporary directory, restored by Engine(device="cuda",
   capacity=10_000_001).load_snapshot_slabs (every chunk's inject through
   the pinned entry point) and by a CPU twin (tables equal); the card
   engine's snapshot_slabs streamed into a second file (each slab one
   copy into a page-locked buffer, timed against the slab's bytes over the
   measured card-to-host rate), equal slab for slab to the twin's stream;
   that file restored into a fresh card engine through Engine(loader=...),
   rows equal at every live key. Prints restore and snapshot seconds and
   rows/s, the file sizes and each stage. Then the Store path: phase 3's
   first 8 windows through an engine with a MockStore (both Stores holding
   the 100,000 hottest keys' buckets at the start) against a CPU twin with
   its own: answers, Store contents and calls, and rows at every key
   equal, injects and gathers all through the pinned entry points; and
   rows_for_keys, device_hit_counts and resolve_slots at 1,000 keys against
   the twin;
8. the device directory: (8a) the probe kernel (csrc/devdir.cu, one
   cooperative launch) against its plain version on fingerprint and stamp
   columns of 10,000,001 positions made from --seed (about half occupied, a
   region filled solid, half of it stamped this batch) at W in {64, 1024,
   8192}, lanes of matches, new keys, keys based in the solid region and
   distinct keys of one base, and padding; with and without eviction, and
   at 5 and 16 positions; then the ordering stimuli of ops/devdir.py
   (ordering_stimulus) at 10,000,001, 4096, 16 and 5 positions and B in
   {64, 8192}; slot, fresh, retry, both columns and the staging's rows 0
   and 8 bit-equal; the vacancy sweep at 10,000,001 positions; each timed
   against its plain version and its bound, the probe warm and cold (L2
   flushed before every launch) beside the empty kernel launched as it
   is; (8b) DevDirEngine(device=
   "cuda", capacity=10_000_001, widths 64-8192) after warmup() on phase
   3's first 24 windows against a DevDirEngine(device="cpu") twin
   (responses, columns, table and EngineStats equal) and the host-directory
   Engine on the card (responses equal but where the device directory
   answers with its contention error); (8c) DevDirEngine(capacity=65,536)
   on 320 windows of 256 requests of the same stream against its CPU twin,
   sweeps on the path, then capacity 8,192 on 80 such windows, full, so
   that claims evict; (8d) phase 3's first 8 windows as
   wire columns through native.prep_pack_interned and
   decide_packed_interned on the card (the leftovers through an Engine
   whose dispatches ship interned when eligible, so the interned scan
   runs too), against a CPU twin and against prep_pack_columnar with the
   compact kernel on a second card table: answers and tables equal;
9. the sharded engine, 8 owners x 1,250,000 rows (10,000,000, 640 MB):
   (9a) the sharded decide (csrc/decide.cu, one launch for every owner)
   against its plain version on make_sharded_table's table populated from
   --seed, wide and lean, at W in {64, 1024, 8192} an owner and the scan
   at K in {2, 32}, W = 64, every window of every owner with a lane past
   the owner's table beside a lane that writes the owner's row C-1 (even
   owners; odd owners in odd windows of a scan), some lean windows with
   the sign bit set, at R x S = 1 x 8 (timed, beside the same window as 8
   launches of the single-table kernel on the owners' views) and 2 x 4;
   the sharded gather and inject (csrc/rows.cu) at m in {1, 64, 4096} an
   owner (padding, past-table lanes, row C-1, values past int32) at R x S
   = 1 x 8 and 2 x 4, timed at 1 x 8 over 16 stimuli cycled with the L2
   flushed before every launch, beside one indexing of the flattened table
   and index_copy_ timed the same way and an empty kernel on their grid
   (the launch's floor); (9b)
   ShardedEngine(device="cuda", n_shards=8, capacity_per_shard=1_250_000)
   after warmup() on phase 3's first 12 windows with Behavior.GLOBAL on
   every 8th of the 4,096 hottest keys, global_sync() after every window,
   and a CPU twin on the first 6 of them: responses, tables, mirrors,
   registries and counters equal after each of those, then a keyspace
   harvest over the card engine (no error, one hbm entry per owner shard,
   the report equal to the twin's); (9c) the Store path on 8 windows
   (both Stores holding the 100,000 hottest keys' buckets); (9d) 8
   windows as wire columns through submit_columnar / complete_columnar,
   then BackendCombiner depth 3 on the card against depth 1 on the CPU
   twin. Prints decisions/s, the stage split, the GLOBAL sync ms a step,
   mirror answers and registry fallbacks, and the sharded launches by
   shape;
10. the host tier: (10a) two local processes form a gloo group through
   parallel/multihost.py initialize_from_env and step
   CollectiveGlobalChannel and CrossHostHitSync at G in {1024, 65,536} on
   contributions made from --seed (one checked step, then 30 timed a rank
   and size): every output equal to a numpy fold; prints the median step
   and its spread beside the bound (16 i64 lanes a slot a rank over the
   host's measured copy rate); (10b) cmd/daemon.py build_backend at
   GUBER_CACHE_SIZE=10000001 (the Engine on the card) under a single-node
   Instance, its metrics, hot-key tracker, profiler and ledger hooks wired,
   phase 3's first 12 windows as 99 batches of <= 1000 with a fixed
   now_ms a batch, against a CPU-twin Instance at depth 1: answers, rows at
   every key, ledger totals and hot-key counts equal; then its debug
   plane through an HTTP gateway: /v1/debug/keyspace (a harvest with no
   error, equal to the twin's, hbm listing the card's table once at its
   size), /v1/debug/kernels (every record with its bytes_accessed) and
   /v1/debug/ledger (the run's totals); (10c) two daemons
   (python -m gubernator_tpu_torch.cmd.daemon, the Engine on the card,
   10,000,000 slots each) in one gloo group, the gRPC GLOBAL pipelines
   frozen: GLOBAL hits taken at the non-owner converge at the owner over
   the collective, then 20,000 token requests of one-hour buckets over
   gRPC to one daemon, status, limit and remaining equal to a CPU-twin
   Instance and reset_time inside the phase; both daemons must exit 0 on
   SIGTERM. Prints decisions/s of 10b and 10c, the time from the pours to
   the owner's converged read, and the collective tick's period;
11. the entry points: (11a) python -m gubernator_tpu_torch.cmd.cluster_main
   on six free ports with no GUBER_DEVICE (six Engines of 4096 slots, the
   binary's size, on the card; the card's free memory must drop by more
   than 100 MiB while it runs): every node healthy with six peers; 4,000
   token requests of one-hour buckets through client.V1Client (batches of
   1000, one node after another) and 4,000 through client.HttpClient to
   an HTTP gateway over a front Instance that owns no key (its peers are
   the binary's six nodes, so it forwards every request there):
   status, limit and remaining equal to a CPU-twin Instance, reset_time
   inside the phase; python -m gubernator_tpu_torch.cmd.cli for 5 s: exit
   0 and its throughput line, no error; exit 0 on SIGTERM; then the
   binary again with --etcd: every node's health_check().peer_count is 6
   through the client, exit 0 on SIGTERM; (11b) every scenario of the
   atlas (scenarios/spec.py SCENARIO_NAMES) at its short profile, and
   bot-storm at its full profile (60 s, one node), through
   scenarios/runner.py run_scenario on a LocalCluster on the card of
   10,000,001 slots a node (a restarted node at the harness's 4096),
   booted as the runner boots its own: every verdict PASS within the spec's
   envelope, decide launches in every card run; prints p50 and p99,
   goodput, error share, batches, the largest pacing lag, the decide and
   row launches by form, and each node's capacity after the run; (11c)
   each scenario's short schedule cut into the runner's 50 ms windows
   through a card Instance of 10,000,001 slots (the harness's widths, the
   runner's behaviors) and a CPU twin at depth 1, now_ms = NOW + the
   window's offset: answers, rows at every key and ledger totals equal;
12. the wire v2 owner path: phase 3's first 10 windows (81,920 requests)
   regrouped by connection (key k rides connection k % 24, in stream order)
   into frames of MAX_FRAME_ITEMS = 1024, sent by 24 PeerLinkClients at
   once, one frame in flight each, on the clock frozen at NOW (as 11c
   freezes it: the wire carries no clock), to PeerLinkService(wire_v2=True,
   columnar_pipeline=True) over a single-node Instance over
   Engine(device="cuda", capacity=10,000,001, widths 64-8192) (12a), then
   to a wire_v2=False server over a fresh card engine (12b); a CPU-twin
   Instance over Engine(device="cpu") takes each connection's frames in
   order through apply_owner_batch_direct: answers and rows at every key
   equal; every 12a client at wire version 2 and pls_v2_conns >= 1, at
   least one pull of MAX_N = 8192 requests; every 12b client at version 1
   and pls_v2_conns 0. Prints decisions/s, pls_v2_conns, partial posts,
   the pulls by frames, the columnar launches by windows and width (the
   service serves a pull in runs of at most MAX_BATCH_SIZE = 1000, so no
   wire window is wider than 1000 lanes) and the decide launches by shape.
13. the overload path: a two-node port LocalCluster (an Instance behind
   its gRPC server a node, the harness's behaviors, forwards over gRPC),
   each node's Engine of 10,000,001 slots with the daemon's widths 64-8192
   on the card; 32 sender threads send batches of 1000 requests of phase
   3's mix (Zipf(1.1) over 1,000,000 keys, 80% token / 20% leaky, limits
   10-10,000, one-hour durations, no gregorian) through
   Instance.get_rate_limits to both nodes in turn, so about half of each
   call is forwarded: (13a) closed loop for 5 s with max_pending 0 (the
   GUBER_MAX_PENDING=0 escape hatch) and no budget, its decisions/s R;
   (13b) open loop at 2 x R for 10 s with max_pending 8192 and each call
   under its own 20 s deadline budget (service/deadline.py), 2 s of it
   under torch.profiler (the device's busy share), health_check() polled
   every 50 ms; (13c) open loop at R / 2 for 3 s. Fails unless: 13a and
   13c shed nothing; 13b sheds; the calls a saturated node refuses
   (RESOURCE_EXHAUSTED) come back with p99 under 50 ms; owner-local work
   is shed at no higher a share than forwarded work (the brownout order);
   no budget dies and no answer fails outside those classes; every
   decided answer's limit and status agree with its key; and at every
   token key the steps touched, limit - remaining on its owner's row
   (Engine.rows_for_keys) equals the hits of the UNDER_LIMIT answers the
   callers got. Prints each step's offered, decided, shed and deadline
   counts by owner-local and forwarded work, goodput, the nodes' shed
   counters and deadline-expired dequeues, latency of refused calls,
   calls carrying sheds and admitted calls, the health states seen, and
   the decide launches by shape with the widest window.
14. the fault path: (14a) gubernator_tpu_torch.soak's run (its 8 workers,
   24 keys at limit 1000, a quarter GLOBAL, one request a call; a node
   stopped and restarted on its port every 3 s for 70% of 20 s, then the
   settle and the GLOBAL convergence probes) over four card nodes built as
   phase 13's (Engines of 10,000,001 slots, widths 64-8192), every restart
   at that size, each node with the daemon's peer link (PeerLinkService at
   its gRPC port + an offset); beside it 4 senders cycle phase 13's pool
   over gRPC and 2 send its requests one a call with no deadline, so that
   a forwarded one is a peer-link frame of one item and takes the lone
   path (the IO thread's decision against the owner's row mirror, or
   seed_mirror's one-row gather by value; the soak's own calls carry a
   deadline, which rides the frame as a carrier item). The launches count
   the traffic served: a restart's Engine warm-up is counted apart. Fails
   unless the soak's result is ok (no admission over the limit within a
   bucket epoch, no error after the settle, GLOBAL views converged), the
   senders meet no error after the settle, every restarted node answers,
   the card's allocated memory after the chaos is within one table of its
   level before, the pinned bytes held once every node has stopped are
   within one Engine's fixed staging of their level before the boot, and
   the traffic served launched a decide kernel and a gather by value.
   Prints decisions/s and errors of the three traffics before the first
   kill, in the chaos and in the settle, each restart's seconds to warmup
   done, to serving and to the node's first answer, the card's and the
   pinned allocator's bytes, the lone decisions the peer links made in C,
   and the launches by form. (14b) three gubernator_tpu_torch.cmd.daemon
   processes on the card (10,000,001 slots, the daemon's widths, the reshard handoff
   armed) whose only membership source is the memberlist gossip pool, as
   tests/test_memberlist_cluster.py sets them up, with its steps and
   shared-bucket checks (peerCount 3; SIGKILL fd3; survivors at 2;
   restart on the same ports; 3 again), while one sender sends phase 13's
   pool to fd1 and fd2 through V1Clients. Fails unless no answer errs
   after the rejoin and every daemon exits 0 on SIGTERM. Prints each
   transition's seconds, the errors by window, the reshard counters, each
   daemon's decide windows (/v1/debug/kernels) and its row kernel launches
   by form after its boot's warm-up (/v1/debug/vars); fails unless a
   daemon that exported rows launched a gather and one that imported rows
   an inject. (14c) `python -m gubernator_tpu_torch.soak_collective` with its two daemons on the card
   at 10,000,001 slots: fails unless its result is ok and both daemons
   exit 0 on SIGTERM; prints the seconds from the SIGKILL to the
   survivor's unhealthy health check, whether the survivor's gloo call
   raised (its log), the restarted daemon's boot and the accounting;
15. the sharded backend over a mesh (parallel/mesh.py make_mesh: a table,
   a stream and a launch of each kernel a mesh entry). On one card the
   entries all name cuda:0 and run the code distinct cards run, each on
   its own stream, but for the cross-card all-reduce, which sums entries
   that share a card in one launch and reads distinct cards behind flags
   in peer memory. (15a) the cross-card all-reduce (csrc/ring.cu
   ring_mesh_launch, ops/ring.py ring_all_reduce_mesh: one launch a card)
   at n in {2, 4, 8} entries and L in {1024, 4096}, values over the whole
   int64 range: every entry's sum bit-equal to the plain version's and to
   the wrapping total, each entry on a stream of its own, one launch a
   distinct card an all-reduce; then 64 all-reduces queued back to back on
   the same input buffers, each rewritten on its entry's stream with fresh
   values before the next call, with no synchronisation between them, and
   one all-reduce issued while entry 0's stream holds a long busy kernel,
   every sum bit-equal to the plain version's; timed a launch and a call
   on the device (torch.profiler), an all-reduce's span (CUDA events) and
   a call (host clock), with the host time of a call split into the
   wrapper and the C entry point, beside its bound (16nL bytes in HBM, and
   over NVLink the bytes a card reads from the others), and the library's
   call (phase 4 times the single-card ring_all_reduce at n = 8):
   torch.stack(xs).sum(0) and n copies where the entries share one card,
   torch.cuda.nccl.all_reduce where every entry has a card of its own;
   (15b) ShardedEngine over
   an 8-entry mesh, 8 x 1,250,000 rows, collectives="ring", beside phase
   9's one-tensor engine, both on the card (2 x 640 MB), on phase 9b's
   windows with their GLOBAL keys, global_sync() after each: responses,
   tables, mirrors, registries and counters equal after every window;
   decisions/s of both and the launches by form; then phase 9c's Store
   path through a mesh engine and the one-tensor engine, each with a
   MockStore: answers, tables, Store contents and calls equal, the mesh
   engine's gathers and injects one an entry; then 8 entries of 65,536
   rows on their streams, 16 windows an entry that write row C-1 beside
   lanes past the table, all 128 launches queued behind a busy card
   (more than the published-copy scratch's 64 slots): responses and tables
   equal to the plain version's; (15c) on that engine's
   tables, 1024 GLOBAL keys, five steps of its ring step against a "psum"
   twin on copies: mirrors and tables equal after every step, the first
   and the steady step's ms beside the psum twin's and phase 4's
   one-tensor step, the launches counted around the ring step alone (the
   twin's are the reference's): two all-reduces a step, one launch a card
   each;
   (15d)
   torch.cuda.device_count() and the backend build_backend picks under
   GUBER_BACKEND=auto (the Engine on one card, one owner a card on
   more). With two cards or more 15a-15c run again over distinct cards;
   with one, a line says they were not run, and why.

Device times come from torch.profiler, for the kernels and for each
library call they are compared with; where the profiler gives none the
record holds null, never a host-clock time, except for the kernels timed
through kernel_ms (the sweep and phase 9's), which then take CUDA events
around back-to-back calls and say so (`ms_source`). Every line with a time ends
with the card and its power limit as nvidia-smi gives them.

Kernel launch counts are set to 0 just before each main path (phases 3,
3b, 4, the bench_rows loop, each run of phase 6, phase 7's restores and
Store path, phase 8b-8d, 9b-9d, 10b, each card run of 11b, each
scenario of 11c, 12a and 12b, phase 13, 14a and each call of 15b and each
run of 15c) and read just after; every kernel
must have launched (each decide form and format on phases 3-8 together,
the interned ones on 8d), inject and gather on phase 3, both through their
pinned entry points only, the probe and the sweep on 8b-8c, the sharded
decide's four forms on 9b-9d and the sharded gather and inject on 9c, the
cross-card ring on 15b-15c. The last two lines are the
{"kernels": [...]} record and the contract line {"ok": true, "device":
{...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import datetime as dt
import gc
import importlib
import itertools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np
import torch

from gubernator_tpu_torch import bench_rows
from gubernator_tpu_torch.client import HttpClient, V1Client
from gubernator_tpu_torch.cluster.harness import (
    ClusterInstance,
    LocalCluster,
    test_behaviors,
    wire_peerlink,
)
from gubernator_tpu_torch.cmd.daemon import build_backend
from gubernator_tpu_torch.cmd.envconf import config_from_env
from gubernator_tpu_torch.models.engine import Engine, EngineStats
from gubernator_tpu_torch.models.devdir_engine import DevDirEngine
from gubernator_tpu_torch.obs.keyspace import KeyspaceCartographer
from gubernator_tpu_torch.ops import _build, _launch, devdir as ddk, ring as rk, rows as rowk
from gubernator_tpu_torch.parallel import (MeshPlan, make_global_sync, make_mesh,
                                           make_sharded_table, shard_of_key)
from gubernator_tpu_torch.parallel.global_sync import GlobalConfig, GlobalMirror, _psum
from gubernator_tpu_torch.scenarios import run_scenario
from gubernator_tpu_torch.scenarios import runner as scen_runner
from gubernator_tpu_torch.scenarios.generator import WorkloadGenerator, windowed
from gubernator_tpu_torch.scenarios.spec import SCENARIO_NAMES, get_scenario
from gubernator_tpu_torch.service import deadline as deadline_mod, faults
from gubernator_tpu_torch.service.config import InstanceConfig
from gubernator_tpu_torch.service.grpc_api import dial_v1
from gubernator_tpu_torch.service.http_gateway import HttpGateway
from gubernator_tpu_torch.service.instance import Instance
from gubernator_tpu_torch.service.leases import HotKeyTracker
from gubernator_tpu_torch.service.metrics import Metrics
from gubernator_tpu_torch.service.peerlink import (
    MAX_FRAME_ITEMS,
    METHOD_GET_PEER_RATE_LIMITS,
    PeerLinkClient,
    PeerLinkService,
)
from gubernator_tpu_torch.service.pb import gubernator_pb2 as pb
from gubernator_tpu_torch.service.server import make_server
from gubernator_tpu_torch.store import BinarySnapshotLoader, BucketSnapshot, MockStore
from gubernator_tpu_torch.types import Behavior, PeerInfo, RateLimitReq, Status
from gubernator_tpu_torch.utils import interval
from gubernator_tpu_torch.utils.gregorian import gregorian_duration, gregorian_expiration

# the module (the package's `ops.decide` is the plain request-object decide)
dk = importlib.import_module("gubernator_tpu_torch.ops.decide")

NOW = 1_700_000_000_000
CAPACITY = 10_000_001  # the north star's 10M keys; fits the 24-bit lean slot
WINDOW = 8192  # requests per client batch, the engine's max_width
N_KEYS = 1_000_000  # distinct keys of the main-path stream
LONE_KEYS = 16  # hottest keys of each window sent as lone requests
PYTHON_DIR_WINDOWS = 10  # phase 3b
INJECT_M = (1, 16, 64, 4096)  # phase 3 injects at most LONE_KEYS rows
GATHER_M = (1, 64, 8192)  # phase 3 gathers 1 slot per seed_mirror
# the pinned forms at their class edges (the library's by-value limits, 64
# slots and 448 rows, ops/rows.py by_value_max; phase 5 checks each m's form
# and launches by form): the by-value size classes up to the largest, that
# class + 1 (the mapped form) and 4096; the inject also at 1024-3072, where
# the copy up overtakes the mapped read (the library's copy_min, measured
# from ab_rows.py's cold rows at these m), and at WINDOW, a restore's chunk.
# Literals, so that ab_rows.py can run this file's helpers on a tree whose
# library has no such limits.
PINNED_GATHER_M = (1, 16, 64, 65, 4096)
PINNED_INJECT_M = (1, 16, 64, 448, 449, 1024, 2048, 3072, 4096, WINDOW)
INJECT_FORMS = ("by_value", "mapped", "copy")
# the host link's rate each way: PCIe 5.0 x16, the H100 SXM's host
# interface (NVIDIA's H100 data sheet: "PCIe Gen5: 128 GB/s", both ways)
LINK_BYTES_PER_S = 64e9
GLOBAL_SHARDS, GLOBAL_ROWS, GLOBAL_KEYS = 8, 1_250_000, 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# Peak scalar rate used for integer work: the card's 67 TFLOP/s of float32
# outside the tensor cores, with each int64 operation counted as two
# 32-bit operations.
SCALAR_OPS_PER_S = 67e12
DECIDE_OPS_PER_LANE = 2 * 100  # ~100 int64 operations in the lattice
RESET = int(Behavior.RESET_REMAINING)
GREG = int(Behavior.DURATION_IS_GREGORIAN)
FORMATS = {"wide": dk.WIDE, "compact": dk.COMPACT, "lean": dk.LEAN, "interned": dk.INTERNED}
ENGINE_FORMATS = ("wide", "compact", "lean")  # what the Engine ships; the sweep's
REPLACES = {"decide_wide": "gubernator_tpu/ops/decide.py:464",
            "decide_compact": "gubernator_tpu/ops/decide.py:536",
            "decide_lean": "gubernator_tpu/ops/decide.py:844",
            "decide_scan_wide": "gubernator_tpu/ops/decide.py:495",
            "decide_scan_compact": "gubernator_tpu/ops/decide.py:575",
            "decide_scan_lean": "gubernator_tpu/ops/decide.py:872",
            "decide_interned": "gubernator_tpu/ops/decide.py:650",
            "decide_scan_interned": "gubernator_tpu/ops/decide.py:675",
            "probe_assign_evict": "gubernator_tpu/ops/devdir.py:131",
            "probe_assign": "gubernator_tpu/ops/devdir.py:83",
            "refresh_vacancies": "gubernator_tpu/ops/devdir.py:196",
            "ring_all_reduce": "gubernator_tpu/ops/ring.py:39",
            "ring_all_reduce_mesh": "gubernator_tpu/ops/ring.py:39",
            "inject_rows": "gubernator_tpu/models/engine.py:74",
            "gather_rows": "gubernator_tpu/models/engine.py:86",
            "row_bump": "scripts/bench_pallas_rows.py:36",
            "decide_sharded_wide": "gubernator_tpu/parallel/sharded.py:95",
            "decide_sharded_scan_wide": "gubernator_tpu/parallel/sharded.py:126",
            "decide_sharded_lean": "gubernator_tpu/parallel/sharded.py:158",
            "decide_sharded_scan_lean": "gubernator_tpu/parallel/sharded.py:190",
            "gather_sharded": "gubernator_tpu/parallel/sharded.py:216",
            "inject_sharded": "gubernator_tpu/parallel/sharded.py:243"}
SOURCES = {**{name: "gubernator_tpu_torch/csrc/decide.cu" for name in dk.launch_counts},
           "gather_sharded": "gubernator_tpu_torch/csrc/rows.cu",
           "inject_sharded": "gubernator_tpu_torch/csrc/rows.cu",
           "ring_all_reduce": "gubernator_tpu_torch/csrc/ring.cu",
           "ring_all_reduce_mesh": "gubernator_tpu_torch/csrc/ring.cu",
           "inject_rows": "gubernator_tpu_torch/csrc/rows.cu",
           "gather_rows": "gubernator_tpu_torch/csrc/rows.cu",
           "row_bump": "gubernator_tpu_torch/csrc/rows.cu",
           **{name: "gubernator_tpu_torch/csrc/devdir.cu" for name in ddk.launch_counts}}
# the shape and form the row entries of the kernels line are timed at: the
# main path's own (phase 3 injects up to LONE_KEYS rows and gathers 1 slot,
# both from page-locked host memory); row_bump's is the probe's BATCH;
# the inject's copy form at a restore's chunk of WINDOW rows, its mapped
# form at the largest m of PINNED_INJECT_M that is mapped (the Store path's
# injects of 1,140-2,446 rows), set in main(); the mapped gather at 4096
# (the Store path's gathers of up to WINDOW slots)
ROW_MAIN_M = {"inject_rows": LONE_KEYS, "gather_rows": 1, "inject_rows_copy": WINDOW,
              "gather_rows_mapped": 4096}
ROW_MAIN_FORM = {"inject_rows": "by_value", "gather_rows": "by_value", "row_bump": "device",
                 "inject_rows_mapped": "mapped", "inject_rows_copy": "copy",
                 "gather_rows_mapped": "mapped"}
INJECT_KEYS = ("inject_rows", "inject_rows_by_value", "inject_rows_mapped", "inject_rows_copy")
REUSE_INJECTS = 64  # pinned injects from one staging buffer in the reuse check


SMI = "card not read yet"  # main() sets it: nvidia-smi's name, power limit


def log(*a):
    print(*a, flush=True)


def tlog(*a):
    """log() for a line that carries a time: the card and its power limit
    go with it, as nvidia-smi gives them."""
    log(*a, f"[{SMI}]")


def fms(v, digits=5):
    """A device time for the log: null where the profiler gave none."""
    return "null" if v is None else f"{v:.{digits}f}"


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def event_ms(fn, iters):
    """Mean device-timeline milliseconds per call over `iters` back-to-back
    calls (CUDA events), after one warm call."""
    fn(0)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(iters):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def profiled_ms(fn, iters, kernel_substr=None, per_call=False, flush_each=None):
    """Mean device milliseconds from torch.profiler over `iters` calls: per
    launch of the kernels whose name holds `kernel_substr` (per call of
    them when `per_call`: a wrapper that launches several), or, when it is
    None, per call of everything the call ran on the device (kernels and
    copies: a library call's device time). With `flush_each` (l2_flush's),
    the L2 is flushed before every call and the flush's copy is left out of
    every sum. A trace that shows no device time is taken once more (the
    profiler now and then records none). None, logged, when the profiler
    fails or neither trace shows device time: the caller records null,
    never a host-clock time in its place."""
    from torch.profiler import ProfilerActivity, profile

    for _attempt in range(2):
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(iters):
                    if flush_each is not None:
                        flush_each()
                    fn(i)
                torch.cuda.synchronize()
        except RuntimeError as e:
            log(f"  profiler failed ({e}): device ms recorded as null")
            return None
        total_us, count = 0.0, 0
        seen = []
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                seen.append(e.key[:60])
            if flush_each is not None and e.key.startswith("Memcpy DtoD"):
                continue
            if kernel_substr is None or kernel_substr in e.key:
                total_us += e.self_device_time_total
                count += e.count
        if kernel_substr is None or per_call:
            count = iters
        if count and total_us > 0:
            return total_us / count / 1e3
        log(f"  the trace shows no device time for {kernel_substr or 'the call'} "
            f"(device time under {seen[:3]})")
    log("  device ms recorded as null")
    return None


def host_us(fn, iters):
    """Mean host-clock microseconds per call over `iters` calls, after one
    warm call; for calls that end with their result on the host."""
    fn(0)
    t = time.perf_counter_ns()
    for i in range(iters):
        fn(i)
    return (time.perf_counter_ns() - t) / iters / 1e3


FLUSH_BYTES = 64 << 20  # one L2 flush: a copy of 64 MB, more than the card's 50 MB L2


def l2_flush(dev):
    """A flush of the card's L2 for profiled_ms(flush_each=): one 64 MB
    device-to-device copy, a "Memcpy DtoD" on the trace, which profiled_ms
    leaves out of its sums."""
    src = torch.zeros(FLUSH_BYTES // 8, dtype=torch.int64, device=dev)
    dst = torch.empty_like(src)
    return lambda: dst.copy_(src)


def bound_ms(n_bytes, n_ops, link_bytes=0):
    """The least time for the work: the larger of its device-memory bytes
    over HBM_BYTES_PER_S, its host-link bytes the busier way over
    LINK_BYTES_PER_S and its operations over SCALAR_OPS_PER_S."""
    t_bytes = max(n_bytes / HBM_BYTES_PER_S, link_bytes / LINK_BYTES_PER_S) * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- phase 2

def populate_table(rows: int, seed: int, device) -> torch.Tensor:
    """i64[rows, 8] made on the card from `seed`: ~30% vacant, 40% token,
    30% leaky rows, drained to full, about half expired at NOW, sticky
    OVER_LIMIT on some, nonzero hit counters."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def ri(lo, hi):
        return torch.randint(lo, hi, (rows,), generator=g, device=device, dtype=torch.int64)

    pick = ri(0, 10)
    algo = torch.where(pick < 3, -1, torch.where(pick < 7, 0, 1))
    limit = torch.tensor([1, 5, 10, 100, 1000], device=device)[ri(0, 5)]
    dur = torch.tensor([1000, 60_000, 3_600_000], device=device)[ri(0, 3)]
    stamp = NOW - ri(0, 1 << 40) % (2 * dur)
    t = torch.stack([algo, limit, ri(0, 1 << 40) % (limit + 1), dur, stamp,
                     stamp + dur, ri(0, 2), ri(0, 1_000_000)], dim=1)
    return t.contiguous()


def stimulus(rng, table, width, fmt, *, slots=None, live=0.9):
    """One wide i64[9, width] window over distinct slots of `table`, with
    padding lanes at random positions, eligible for `fmt`. Requests mostly
    match the row (so existing, vacant and expired rows all occur); some
    change the limit or duration, peek, over-ask, reset, are fresh, and on
    the wide format run on a gregorian calendar."""
    C = table.shape[0]
    n = max(1, int(width * live))
    s = rng.choice(C if slots is None else slots, n, replace=False)
    rows = table[torch.from_numpy(s).to(table.device)].cpu().numpy()
    p = np.zeros((9, width), np.int64)
    lanes = rng.permutation(width)[:n]  # padding lanes land anywhere
    p[0, :] = -1
    p[0, lanes] = s
    limits = np.array([1, 5, 10, 100, 1000])
    durs = np.array([1000, 60_000, 3_600_000])
    keep = rng.random(n) < 0.7
    p[2, lanes] = np.where(keep, rows[:, 1], rng.choice(limits, n))
    p[3, lanes] = np.where(rng.random(n) < 0.7, rows[:, 3], rng.choice(durs, n))
    p[4, lanes] = np.where((rng.random(n) < 0.8) & (rows[:, 0] >= 0), rows[:, 0],
                           rng.integers(0, 2, n))
    p[5, lanes] = np.where(rng.random(n) < 0.05, RESET, 0)
    p[8, lanes] = rng.random(n) < 0.1
    if fmt == "lean":
        p[1, lanes] = 1
    else:
        p[1, lanes] = rng.choice([0, 1, 1, 1, 1, 2, 5, 2000], n)
    if fmt == "wide":
        g = rng.random(n) < 0.1
        local = dt.datetime.fromtimestamp(NOW / 1000.0)
        codes = rng.integers(0, 3, n)
        p[3, lanes] = np.where(g, codes, p[3, lanes])
        p[5, lanes] |= np.where(g, GREG, 0)
        p[6, lanes] = np.where(g, [gregorian_expiration(local, int(c)) for c in codes], 0)
        p[7, lanes] = np.where(g, [gregorian_duration(local, int(c)) for c in codes], 0)
    return p


def staged(fmt, wide, capacity, device):
    """The wide host window as the device tensors of `fmt` (lean and
    interned: the staging and the config table; else cfg None)."""
    if fmt == "wide":
        return torch.from_numpy(wide).to(device), None
    if fmt == "compact":
        c = dk.compact_window(wide)
        check(c is not None, "compact stimulus not eligible")
        return torch.from_numpy(c).to(device), None
    if fmt == "interned":
        iw = dk.intern_window(wide)
        check(iw is not None, "interned stimulus not eligible")
        return torch.from_numpy(iw[0]).to(device), torch.from_numpy(iw[1]).to(device)
    ln = dk.lean_window(wide, capacity)
    check(ln is not None, "lean stimulus not eligible")
    return torch.from_numpy(ln[0]).to(device), torch.from_numpy(ln[1]).to(device)


def decide_times(run_k, run_p, iters=64):
    """A decide kernel's numbers on one stimulus set: device ms per launch
    (torch.profiler, null where it gives none), ms per wrapper call (CUDA
    events, back to back) and the plain version's ms per call."""
    call_ms = event_ms(run_k, iters)
    return dict(ms=profiled_ms(run_k, 32, "decide_kernel"), call_ms=call_ms,
                plain_ms=event_ms(run_p, 8))


def decide_bound(fmt, wide, rows):
    """The decide bound of one staging (wide i64[.., 9, W] on the host) that
    touches `rows` distinct rows: each row read and written once, the
    staging read and the responses written once (dk.decide_bytes, the count
    /v1/debug/kernels reports); the lattice's operations for each live lane."""
    lanes = wide[..., 0, :].size
    live = int((wide[..., 0, :] >= 0).sum())
    n_bytes = dk.decide_bytes(fmt, lanes, rows)
    b_ms, b_by = bound_ms(n_bytes, live * DECIDE_OPS_PER_LANE)
    return dict(live_lanes=live, rows=rows, bytes=n_bytes, bound_ms=b_ms, bound_by=b_by)


def touched_rows(wide, C):
    """Distinct table rows a staging touches (slots past the table read C-1)."""
    s = wide[..., 0, :]
    return int(np.unique(np.minimum(s[s >= 0], C - 1)).size)


def herd(rng, table, fmt, k=32, width=64):
    """A hot-key herd as the engine's scan tail sends it: k windows of
    `width` lanes, one live lane each at a random position, all on one row
    with the same request."""
    one = stimulus(rng, table, width, fmt, live=1.0 / width)
    col = one[:, one[0] >= 0][:, 0]
    wide = np.zeros((k, 9, width), np.int64)
    wide[:, 0, :] = -1
    for w in range(k):
        wide[w, :, rng.integers(width)] = col
    wide[1:, 8, :] = 0  # only the first visit may find the slot fresh
    return wide


def phase_decide(seed, dev, results):
    log("== phase 2: decide kernels vs their plain version, "
        f"table {CAPACITY} rows ({CAPACITY * 64 / 1e6:.0f} MB)")
    rng = np.random.default_rng(seed)
    kern = populate_table(CAPACITY, seed, dev)
    plain = kern.clone()
    shapes = [(fmt, w, 0, "windows") for fmt in FORMATS for w in (64, 1024, WINDOW)]
    shapes += [(fmt, 64, k, "windows") for fmt in FORMATS for k in (2, 32)]
    shapes += [(fmt, 64, 32, "herd") for fmt in FORMATS]
    errs = {}

    def make(fmt, width, k, kind):
        if kind == "herd":
            return herd(rng, kern, fmt)
        if k:
            pool = rng.choice(CAPACITY, 256, replace=False)  # windows overlap
            return np.stack([stimulus(rng, kern, width, fmt, slots=pool) for _ in range(k)])
        return stimulus(rng, kern, width, fmt)

    for fmt, width, k, kind in shapes:
        f = FORMATS[fmt]
        scan = k > 0
        wide = make(fmt, width, k, kind)
        packed, cfg = staged(fmt, wide, CAPACITY, dev)
        hold(f, kern, plain, packed, cfg, scan, f"{fmt} W={width} K={k} {kind}", errs, wide)

        # timing: 16 distinct stimuli, cycled, so rows come cold from HBM
        stims = [staged(fmt, make(fmt, width, k, kind), CAPACITY, dev) for _ in range(16)]

        def run_k(i):
            pk, cf = stims[i % 16]
            dk.decide_cuda(f, kern, pk, cf, NOW, scan)

        def run_p(i):
            pk, cf = stims[i % 16]
            dk.decide_plain(f, plain, pk, cf, NOW, scan)

        t = decide_times(run_k, run_p)
        plain.copy_(kern)  # the timing runs mutated the two tables differently
        rec = dict(kernel=dk._COUNT_NAMES[f, scan], fmt=fmt, width=width, scan_k=k, kind=kind,
                   **decide_bound(fmt, wide, touched_rows(wide, CAPACITY)), **t)
        results["decide_shapes"].append(rec)
        tlog(f"  {fmt:7s} W={width:5d} K={k:2d} {kind:7s}: bit-equal; kernel {fms(t['ms'])} ms "
             f"on the device, {t['call_ms']:.4f} ms per wrapper call; plain "
             f"{t['plain_ms']:.4f} ms; bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    results["decide_sweep"] = sweep(rng, kern, plain, dev, errs)
    edge_cases(kern, plain, dev, errs)  # last: its rows leave the compact range
    del kern, plain
    torch.cuda.empty_cache()
    return errs


def hold(f, kern, plain, packed, cfg, scan, what, errs, wide=None):
    """One decide through the kernel and the plain version: bit-equal
    responses and tables, or the run fails. An interned staging (`wide` its
    wide window) is also held to the compact kernel on the same window,
    from the same table."""
    twin = kern.clone() if f == dk.INTERNED else None
    out_k = dk.decide_cuda(f, kern, packed, cfg, NOW, scan)
    out_p = dk.decide_plain(f, plain, packed, cfg, NOW, scan)
    torch.cuda.synchronize()
    name = dk._COUNT_NAMES[f, scan]
    errs[name] = max(errs.get(name, 0), max_abs_err(out_k, out_p), max_abs_err(kern, plain))
    check(torch.equal(out_k, out_p), f"{what}: responses differ")
    check(torch.equal(kern, plain), f"{what}: tables differ")
    if twin is not None:
        c = dk.compact_window(wide)
        check(c is not None, f"{what}: not compact-eligible")
        out_c = dk.decide_cuda(dk.COMPACT, twin, torch.from_numpy(c).to(kern.device), None,
                               NOW, scan)
        check(torch.equal(out_k, out_c) and torch.equal(kern, twin),
              f"{what}: the interned kernel and the compact kernel differ")
        del twin


def last_row_window(rng, kern, fmt, width, writer=True):
    """A window whose lane 5 writes row C-1 (a live token bucket) and whose
    lanes past the table (slots C, C + 1, C + 7, in other blocks of the
    window kernel) read it; the other lanes random. The readers must see
    row C-1 as it stood before the window."""
    C = kern.shape[0]
    wide = stimulus(rng, kern, width, fmt)
    wide[0, wide[0] == C - 1] = -1
    req = [1, 10, 60_000, 0, 0, 0, 0, 0]  # hits, limit, duration, algo, ...
    edge = [(width - 1, C), (width // 2 + 3, C + 1), (100 % width, C + 7)]
    for lane, s in [(5, C - 1)] * writer + edge:
        wide[0, lane] = s
        wide[1:, lane] = req
    return wide


def edge_cases(kern, plain, dev, errs):
    """The lanes tests/test_torch_decide.py holds the plain version to on the
    CPU, now kernel against plain on the card: a slot past the table (the
    gather clamps, the store drops), int64 wraparound, negative durations,
    a sticky status past i32, algorithm 7, padding between live lanes; a
    lean window of 128 configs, whose ids set the lane word's sign bit; an
    interned window of 256 configs (id 255) with lanes past the table beside
    lanes on its last rows; and lanes past the table beside the lane that
    writes row C-1, in one window of 8192 lanes and in scan groups (K = 4,
    W = 64; one window without the writer), every format; a wide scan group
    of token and leaky herds on live rows with a negative duration; and
    scans the engine never sends: lean K = 40 at W = 64, compact K = 32 and
    interned K = 33 at W = 256 (chunks of whole windows), wide K = 3 at
    W = 8192 (a window a launch). Every interned case is also held to the compact
    kernel on the same window."""
    C = kern.shape[0]
    big = np.iinfo(np.int64).max
    for r, v in {0: [0, 10, 4, 5, big - 3, NOW + 1000, 0, 0],
                 3: [0, 10, 4, 60_000, NOW - 5, NOW + 60_000, (1 << 33) + 5, 3],
                 C - 1: [0, 10, 4, 60_000, NOW - 5, NOW + 60_000, 1, 3]}.items():
        kern[r] = plain[r] = torch.tensor(v, device=dev)
    wide = np.zeros((9, 9), np.int64)
    wide[0] = [C + 5, 0, 1, 2, -1, 3, 4, -1, 5]
    wide[1] = [1, 1, 3, 0, 9, 1, 1, 9, 2]
    wide[2] = [10, big, 7, 5, 9, 10, 10, 9, 3]
    wide[3] = [60_000, big, -7_001, 60_000, 9, 60_000, 1000, 9, -1]
    wide[4] = [0, 0, 1, 0, 0, 0, 7, 0, 1]
    lean = np.zeros((9, dk.LEAN_MAX_CFG), np.int64)
    lean[0] = np.arange(dk.LEAN_MAX_CFG) + (C - dk.LEAN_MAX_CFG - 1)
    lean[0, -3:] = -1
    lean[1] = 1
    lean[2] = np.arange(dk.LEAN_MAX_CFG) + 1
    lean[3] = 60_000
    # interned: 256 configs (the last id 255), lanes clamped past the table
    # beside lanes on its last rows
    interned = np.zeros((9, dk.INTERN_MAX_CFG), np.int64)
    interned[0] = np.arange(dk.INTERN_MAX_CFG) + (C - dk.INTERN_MAX_CFG - 1)
    interned[0, -3:] = [C + 5, -1, C]
    interned[1] = np.arange(dk.INTERN_MAX_CFG) % 4
    interned[2] = np.arange(dk.INTERN_MAX_CFG) + 1
    interned[3] = 60_000
    interned[4] = np.arange(dk.INTERN_MAX_CFG) % 2
    for fmt, p in (("wide", wide), ("lean", lean), ("interned", interned)):
        packed, cfg = staged(fmt, p, C, dev)
        if fmt == "lean":
            check(bool((packed < 0).any()), "lean edge window sets no sign bit")
        if fmt == "interned":
            check(int(((packed[1] >> 23) & 0xFF).max()) == 255, "no interned config id 255")
        hold(FORMATS[fmt], kern, plain, packed, cfg, False, f"{fmt} edge lanes", errs, p)
    rng = np.random.default_rng(99)
    row = torch.tensor([0, 10, 4, 60_000, NOW - 5, NOW + 60_000, 0, 3], device=dev)
    for fmt in FORMATS:
        kern[C - 1] = plain[C - 1] = row
        wide = last_row_window(rng, kern, fmt, WINDOW)
        packed, cfg = staged(fmt, wide, C, dev)
        hold(FORMATS[fmt], kern, plain, packed, cfg, False,
             f"{fmt} row C-1 written beside lanes past the table", errs, wide)
        kern[C - 1] = plain[C - 1] = row
        pool = rng.choice(C - 1, 256, replace=False)
        group = np.stack([last_row_window(rng, kern, fmt, 64, writer=w != 2)
                          for w in range(4)])
        for w in range(4):  # the random lanes of the group overlap
            live = (group[w, 0] >= 0) & (group[w, 0] < C - 1)
            group[w, 0, live] = rng.choice(pool, int(live.sum()), replace=False)
        packed, cfg = staged(fmt, group, C, dev)
        hold(FORMATS[fmt], kern, plain, packed, cfg, True,
             f"{fmt} scan, row C-1 written beside lanes past the table", errs, group)
    # a herd on live rows whose duration is negative: the first deduct leaves
    # each row expired, so the scan's run of plain requests must stop there
    rows = rng.choice(C - 1, 2, replace=False)
    group = np.zeros((6, 9, 64), np.int64)
    group[:, 0, :] = -1
    for i, (r, algo) in enumerate(zip(rows.tolist(), (0, 1))):
        kern[r] = plain[r] = torch.tensor([algo, 5, 4, -7_001, NOW - 5, NOW + 60_000, 0, 3],
                                          device=dev)
        group[:, :, 10 + i] = [r, 1, 5, -7_001, algo, 0, 0, 0, 0]
    packed, cfg = staged("wide", group, C, dev)
    hold(dk.WIDE, kern, plain, packed, cfg, True, "wide scan, herds with a negative duration", errs)
    # scans the engine never sends, which the kernel runs in chunks of whole
    # windows (more than 32 windows; a staging past shared memory) or as one
    # window launch a window (a window past shared memory); windows share rows
    for fmt, k, width in (("lean", 40, 64), ("compact", 32, 256), ("wide", 3, WINDOW),
                          ("interned", 33, 256)):
        pool = rng.choice(C - 1, 2 * width, replace=False)
        group = np.stack([stimulus(rng, kern, width, fmt, slots=pool) for _ in range(k)])
        packed, cfg = staged(fmt, group, C, dev)
        hold(FORMATS[fmt], kern, plain, packed, cfg, True, f"{fmt} scan K={k} W={width}", errs,
             group)
    log("  edge lanes (clamp, wraparound, negative durations, i32 status, "
        "algorithm 7, lean sign bit, interned config id 255; row C-1 written beside "
        "lanes past the table, "
        "one window and scan; herds on a negative duration; scans in chunks and "
        "window by window): bit-equal")


SWEEP_THREADS = (64, 128)  # the one-window kernel's block sizes
SWEEP_SPREAD = (1, 2, 4, 8)  # blocks a scan group's rows are spread over


def sweep(rng, kern, plain, dev, errs):
    """The block-size sweep of the one-window kernel (blocks of 64 and 128
    at W = 64, 1024 and 8192) and the scan's spread (1, 2 and 4 blocks at
    K = 32, W = 64), every format: device ms per launch, each variant first
    held bit-equal to the plain version. The library's constants are what
    the sweep chose; it is restored after."""
    lib = dk._load()
    recs = []
    cases = [("window", t, w) for t in SWEEP_THREADS for w in (64, 1024, WINDOW)]
    cases += [("scan", n, 64) for n in SWEEP_SPREAD]
    try:
        for what, v, width in cases:
            check(lib.decide_tune(v if what == "window" else 0,
                                  v if what == "scan" else 0) == 0, "decide_tune refused")
            for fmt in ENGINE_FORMATS:
                f = FORMATS[fmt]
                scan = what == "scan"

                def make():
                    if not scan:
                        return stimulus(rng, kern, width, fmt)
                    pool = rng.choice(CAPACITY, 256, replace=False)
                    return np.stack([stimulus(rng, kern, width, fmt, slots=pool)
                                     for _ in range(32)])

                packed, cfg = staged(fmt, make(), CAPACITY, dev)
                hold(f, kern, plain, packed, cfg, scan, f"sweep {what} {v} {fmt}", errs)
                stims = [staged(fmt, make(), CAPACITY, dev) for _ in range(16)]
                ms = profiled_ms(lambda i: dk.decide_cuda(f, kern, *stims[i % 16], NOW, scan),
                                 32, "decide_kernel")
                plain.copy_(kern)
                recs.append(dict(form=what, value=v, width=width, fmt=fmt, ms=ms))
                tlog(f"  sweep: {what} kernel, {'threads' if what == 'window' else 'blocks'} "
                     f"{v:3d}, {fmt:7s} W={width:5d}{' K=32' if scan else ''}: "
                     f"{fms(ms)} ms on the device")
    finally:
        lib.decide_tune(0, 0)
    for what, unit in (("window", "threads"), ("scan", "blocks")):
        best = {}
        for r in recs:
            if r["form"] == what and r["ms"] is not None:
                key = f"{r['fmt']} W={r['width']}"
                best[key] = min(best.get(key, (float("inf"), 0)), (r["ms"], r["value"]))
        tlog(f"  sweep: fastest {what} kernel {unit} by shape: "
             + ", ".join(f"{k} {v[1]}" for k, v in best.items()))
    return recs


# ----------------------------------------------------------------- phase 3

def request_stream(seed, n_windows, width=None):
    """Client batches of `width` requests over N_KEYS Zipf(1.1) keys: 80%
    token / 20% leaky keys with per-key limits and durations. Batches come
    from three kinds of client, in turn: of every ten batches six send
    hits = 1 only (the lean format), three send hits of 2-5 on a tenth of
    their requests (compact), and one also puts a tenth on a gregorian
    calendar (wide) — about 1% of all requests. Returns the batches and
    each key's (algorithm, limit, duration)."""
    width, n_keys = width or WINDOW, N_KEYS
    rng = np.random.default_rng(seed + 1)
    p = 1.0 / np.arange(1, n_keys + 1, dtype=np.float64) ** 1.1
    p /= p.sum()
    key_algo = (rng.random(n_keys) < 0.2).astype(np.int64)
    key_limit = rng.choice([10, 100, 1000, 10_000], n_keys)
    key_dur = rng.choice([1000, 60_000, 3_600_000], n_keys)
    batches = []
    for i in range(n_windows):
        keys = rng.choice(n_keys, width, p=p)
        kind = i % 10
        hits = np.where((kind < 6) | (rng.random(width) < 0.9), 1,
                        rng.integers(2, 6, width))
        greg = (kind == 9) & (rng.random(width) < 0.1)
        codes = rng.integers(0, 3, width)
        batch = []
        for j, k in enumerate(keys.tolist()):
            batch.append(RateLimitReq(
                name="api", unique_key=f"k{k}", hits=int(hits[j]),
                limit=int(key_limit[k]),
                duration=int(codes[j]) if greg[j] else int(key_dur[k]),
                algorithm=int(key_algo[k]), behavior=GREG if greg[j] else 0))
        batches.append((keys, batch))
    return batches, (key_algo, key_limit, key_dur)


def lone_requests(keys, key_cfg):
    """One hits = 1 request for each of the LONE_KEYS hottest keys of a
    window, on the key's own configuration."""
    algo, limit, dur = key_cfg
    uniq, counts = np.unique(keys, return_counts=True)
    hot = uniq[np.argsort(-counts, kind="stable")[:LONE_KEYS]]
    return [RateLimitReq(name="api", unique_key=f"k{k}", hits=1, limit=int(limit[k]),
                         duration=int(dur[k]), algorithm=int(algo[k]))
            for k in hot.tolist()]


def resp_tuples(rs):
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in rs]


def drive_engines(gpu, cpu, batches, key_cfg, lone, spent):
    """Run every window through the card engine and its CPU twin, then (when
    `lone`) the window's hottest keys through seed_mirror and three
    decide_native_single calls each, a miss going through get_rate_limits
    as a one-request window. Everything must be equal. Returns the
    measurements of the card engine."""
    m = dict(gpu_s=0.0, cpu_s=0.0, busy_us=0.0, traced_s=0.0, n_req=0, lone_s=0.0,
             lone_calls=0, lone_native=0, lone_miss=0, seeded=0, seed_s=0.0,
             seed_calls=0)
    for i, (keys, batch) in enumerate(batches):
        now = NOW + i * 50
        trace = i < 2  # the first two windows also run under the profiler
        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        t = time.perf_counter()
        got = gpu.get_rate_limits(batch, now_ms=now)
        elapsed = time.perf_counter() - t
        if trace:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            m["busy_us"] += sum(e.self_device_time_total for e in prof.key_averages())
            m["traced_s"] += elapsed
        else:
            m["gpu_s"] += elapsed
            m["n_req"] += len(batch)
        t = time.perf_counter()
        want = cpu.get_rate_limits(batch, now_ms=now)
        m["cpu_s"] += time.perf_counter() - t
        check(resp_tuples(got) == resp_tuples(want),
              f"window {i}: card and CPU engines answer differently")
        if not lone:
            continue
        for req in lone_requests(keys, key_cfg):
            key = req.hash_key()
            t = time.perf_counter()
            seeded = gpu.seed_mirror(key)
            m["seed_s"] += time.perf_counter() - t
            m["seed_calls"] += 1
            check(seeded == cpu.seed_mirror(key), f"window {i}: seed_mirror({key}) differs")
            m["seeded"] += seeded
            for j in range(3):
                t_ms = now + 1 + j
                t = time.perf_counter()
                g = gpu.decide_native_single(req, now_ms=t_ms)
                if g is None:
                    g = gpu.get_rate_limits([req], now_ms=t_ms)[0]
                    m["lone_miss"] += 1
                else:
                    m["lone_native"] += 1
                m["lone_s"] += time.perf_counter() - t
                m["lone_calls"] += 1
                w = cpu.decide_native_single(req, now_ms=t_ms)
                if w is None:
                    w = cpu.get_rate_limits([req], now_ms=t_ms)[0]
                check(resp_tuples([g]) == resp_tuples([w]),
                      f"window {i}: lone request for {key} answered differently")
    check(torch.equal(gpu.state.cpu(), cpu.state), "engine tables differ")
    gs, cs = gpu.stats.as_dict(), cpu.stats.as_dict()
    for c in ("requests", "batches", "rounds", "over_limit", "errors", "native_singles"):
        check(gs[c] == cs[c], f"EngineStats.{c} differs: card {gs[c]}, CPU {cs[c]}")
    m.update(spent)
    return m


def timed_hooks(gpu):
    """Host clock around the card engine's device round trips: staging
    upload + launch (dispatch) and wait + readback (fetch)."""
    spent = {"dispatch_s": 0.0, "fetch_s": 0.0}
    for hook, name in (("_dispatch_staged", "dispatch_s"),
                       ("_dispatch_scan_staged", "dispatch_s"), ("_fetch_staged", "fetch_s")):
        def timed(*a, _fn=getattr(gpu, hook), _name=name):
            t0 = time.perf_counter()
            out = _fn(*a)
            spent[_name] += time.perf_counter() - t0
            return out

        setattr(gpu, hook, timed)
    return spent


CAPTURE_GROUPS = 16  # scan groups of phase 3 kept for the replay, per format


def record_launches(gpu):
    """Wrap the card engine's two dispatches (around them, not on the
    wrapper's path): each launch's launch_counts key, width and K, and for
    a scan the live lanes of each real window and the longest per-row
    chain (the most windows that touch one row). Each dispatch must have
    made exactly one decide launch. The first CAPTURE_GROUPS scan groups of
    each format are kept: the wide staging, the rows it touches as they
    stood before the launch, now and the format."""
    mix = {"launches": [], "captured": []}
    C = gpu.capacity

    def launched(before):
        keys = [k for k, v in dk.launch_counts.items() if v != before[k]]
        check(len(keys) == 1 and dk.launch_counts[keys[0]] == before[keys[0]] + 1,
              f"an engine dispatch made decide launches {keys}, not one")
        return keys[0]

    def one(packed, now_ms, _fn=gpu._dispatch_staged):
        before = dict(dk.launch_counts)
        out = _fn(packed, now_ms)
        mix["launches"].append(dict(key=launched(before), width=packed.shape[-1], k=0))
        return out

    def scan(stacked, now_ms, _fn=gpu._dispatch_scan_staged):
        s = stacked[:, 0, :]
        live = (s >= 0).sum(1)
        _, per_row = np.unique(np.minimum(s[s >= 0], C - 1), return_counts=True)
        kept = [g["fmt"] for g in mix["captured"]]
        want = any(kept.count(f) < CAPTURE_GROUPS for f in ENGINE_FORMATS)
        if want:  # the rows as they stand before the launch
            slots = np.unique(np.minimum(s[s >= 0], C - 1))
            rows = gpu.state[torch.from_numpy(slots).to(gpu.state.device)].cpu()
        before = dict(dk.launch_counts)
        out = _fn(stacked, now_ms)
        key = launched(before)
        fmt = key.rsplit("_", 1)[1]
        mix["launches"].append(dict(key=key, width=s.shape[-1], k=s.shape[0],
                                    live=live[live > 0].tolist(),
                                    chain=int(per_row.max()) if per_row.size else 0))
        if want and kept.count(fmt) < CAPTURE_GROUPS:
            mix["captured"].append(dict(stacked=stacked.copy(), slots=slots, rows=rows,
                                        now=now_ms, fmt=fmt))
        return out

    gpu._dispatch_staged = one
    gpu._dispatch_scan_staged = scan
    return mix


def launch_histogram(launches):
    """The decide launches by format, scan or not, width and K; for the
    scans the live lanes per window and the longest per-row chain."""
    by_shape = {}
    for r in launches:
        k = f"{r['key']} W={r['width']}" + (f" K={r['k']}" if r["k"] else "")
        by_shape[k] = by_shape.get(k, 0) + 1
    scans = [r for r in launches if r["k"]]
    live = np.array([n for r in scans for n in r["live"]], np.int64)
    chain = np.array([r["chain"] for r in scans], np.int64)
    windows = np.array([len(r["live"]) for r in scans], np.int64)

    def dist(a, edges):
        return {f"{lo}-{hi}": int(((a >= lo) & (a <= hi)).sum()) for lo, hi in edges}

    hist = dict(launches=len(launches), by_shape=dict(sorted(by_shape.items())),
                scan_launches=len(scans),
                scan_real_windows=dist(windows, [(1, 2), (3, 4), (5, 8), (9, 16), (17, 32)]),
                scan_live_per_window=dist(live, [(1, 1), (2, 4), (5, 16), (17, 64)]),
                scan_live_mean=float(live.mean()) if live.size else None,
                scan_longest_chain=dist(chain, [(1, 1), (2, 4), (5, 8), (9, 16), (17, 32)]),
                scan_chain_mean=float(chain.mean()) if chain.size else None)
    tlog(f"  decide launches by shape: {json.dumps(hist['by_shape'])}")
    tlog(f"  scan launches {len(scans)}: real windows per group {hist['scan_real_windows']}; "
         f"live lanes per window {hist['scan_live_per_window']} (mean "
         f"{hist['scan_live_mean']}); longest per-row chain {hist['scan_longest_chain']} "
         f"(mean {hist['scan_chain_mean']})")
    return hist


def replay_groups(groups, dev, results, errs):
    """The captured scan groups against a fresh 10,000,001-row table: each
    group's rows written as they stood, then kernel against plain version,
    bit-equal; then each format's groups timed, cycled."""
    kern = dk.make_table(CAPACITY, dev)
    plain = kern.clone()
    runs = {fmt: [] for fmt in FORMATS}
    for i, g in enumerate(groups):
        slots = torch.from_numpy(g["slots"]).to(dev)
        kern[slots] = plain[slots] = g["rows"].to(dev)
        packed, cfg = staged(g["fmt"], g["stacked"], CAPACITY, dev)
        hold(FORMATS[g["fmt"]], kern, plain, packed, cfg, True, f"captured scan group {i}", errs)
        runs[g["fmt"]].append((packed, cfg, g["now"], g))
    recs = []
    for fmt, sel in runs.items():
        if not sel:
            continue
        f, n = FORMATS[fmt], len(sel)

        def run_k(i):
            pk, cf, now, _ = sel[i % n]
            dk.decide_cuda(f, kern, pk, cf, now, True)

        def run_p(i):
            pk, cf, now, _ = sel[i % n]
            dk.decide_plain(f, plain, pk, cf, now, True)

        t = decide_times(run_k, run_p)
        bounds = [decide_bound(fmt, g["stacked"], len(g["slots"])) for *_, g in sel]
        rec = dict(kernel=dk._COUNT_NAMES[f, True], fmt=fmt, groups=n,
                   k=sorted({g["stacked"].shape[0] for *_, g in sel}),
                   live_lanes=float(np.mean([b["live_lanes"] for b in bounds])),
                   bound_ms=float(np.mean([b["bound_ms"] for b in bounds])),
                   bound_by=bounds[0]["bound_by"], **t)
        recs.append(rec)
        tlog(f"  captured {fmt:7s} scan groups ({n}, K in {rec['k']}, {rec['live_lanes']:.1f} "
             f"live lanes a group): bit-equal; kernel {fms(t['ms'])} ms on the device, "
             f"{t['call_ms']:.4f} ms per wrapper call; plain {t['plain_ms']:.4f} ms; mean bound "
             f"{rec['bound_ms']:.6f} ms")
    results["decide_captured"] = recs
    del kern, plain
    torch.cuda.empty_cache()


def phase_engine(seed, n_windows, dev, results):
    log(f"== phase 3: main path, Engine(capacity={CAPACITY}) on the native directory, "
        f"{dev} vs cpu, {n_windows} windows of {WINDOW} requests, then the "
        f"{LONE_KEYS} hottest keys of each window as lone requests")
    t = time.perf_counter()
    batches, key_cfg = request_stream(seed, n_windows)
    tlog(f"  stream built in {time.perf_counter() - t:.1f} s")
    os.environ.pop("GUBER_NO_NATIVE", None)
    t = time.perf_counter()
    gpu = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    cpu = Engine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    check(gpu._prep_fast is not None and cpu._prep_fast is not None,
          "the engines did not take the native fast window")
    gpu.warmup()
    tlog(f"  engines built and warmed in {time.perf_counter() - t:.2f} s")
    # fast windows taken, their wall time, and the share of it in the
    # leftover tail (the python pipeline after round 0)
    fast = {"taken": 0, "s": 0.0, "tail_requests": 0, "tail_s": 0.0}

    def counted(*a, _fn=gpu._fast_window):
        t0 = time.perf_counter()
        out = _fn(*a)
        fast["s"] += time.perf_counter() - t0
        fast["taken"] += out is not None
        return out

    def tail(requests, now_ms, count_batch=True, _fn=gpu._slow_window):
        t0 = time.perf_counter()
        out = _fn(requests, now_ms, count_batch)
        if not count_batch:
            fast["tail_s"] += time.perf_counter() - t0
            fast["tail_requests"] += len(requests)
        return out

    # host time of the injects that had rows (the others return at once)
    injected = {"calls": 0, "rows": 0, "s": 0.0}

    def timed_inject(inject, _fn=gpu._apply_inject_rows):
        if inject is None or len(inject) == 0:
            return _fn(inject)
        t0 = time.perf_counter()
        out = _fn(inject)
        injected["s"] += time.perf_counter() - t0
        injected["calls"] += 1
        injected["rows"] += len(inject)
        return out

    gpu._fast_window = counted
    gpu._slow_window = tail
    gpu._apply_inject_rows = timed_inject
    spent = timed_hooks(gpu)
    mix = record_launches(gpu)
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    waits0 = gpu._inject.waits
    m = drive_engines(gpu, cpu, batches, key_cfg, True, spent)
    launches = {**dk.launch_counts, **rowk.launch_counts}
    staging_waits = gpu._inject.waits - waits0
    check(len(mix["launches"]) == sum(dk.launch_counts.values()),
          f"{sum(dk.launch_counts.values())} decide launches, {len(mix['launches'])} "
          "engine dispatches")
    pinned = dict(rowk.pinned_counts)
    check(fast["taken"] > 0, "no window took the fast path")
    check(launches["inject_rows"] > 0 and launches["gather_rows"] > 0,
          f"the lone path launched no row kernel: {launches}")
    forms = {f"{name}_{form}": launches[f"{name}_{form}"]
             for name, names in (("inject_rows", INJECT_FORMS),
                                 ("gather_rows", ("by_value", "mapped")))
             for form in names}
    for name in ("inject_rows", "gather_rows"):
        check(pinned[name] == launches[name],
              f"{name}: {launches[name]} launches, {pinned[name]} through the pinned entry point")
        check(sum(n for k, n in forms.items() if k.startswith(name)) == launches[name],
              f"{name}: {launches[name]} launches, by form {forms}")
    check(staging_waits <= forms["inject_rows_mapped"] + forms["inject_rows_copy"],
          f"{staging_waits} waits on the inject staging, {forms['inject_rows_mapped']} "
          f"mapped injects and {forms['inject_rows_copy']} copied up")
    check(injected["calls"] == launches["inject_rows"],
          f"{injected['calls']} injects with rows, {launches['inject_rows']} inject launches")
    stats = gpu.stats.as_dict()
    stage_s = {s: stats[f"{s}_ns"] / 1e9 for s in gpu.stats.STAGES}
    rate = m["n_req"] / m["gpu_s"]
    busy = m["busy_us"] / 1e6 / m["traced_s"] if m["traced_s"] else None
    total = WINDOW * n_windows
    results["engine"] = dict(
        m, requests=total, windows=n_windows, decisions_per_s=rate,
        cpu_decisions_per_s=total / m["cpu_s"], device_busy_share=busy,
        fast_windows=fast["taken"], fast_window_s=fast["s"],
        tail_requests=fast["tail_requests"], tail_s=fast["tail_s"], stats=stats,
        stage_s=stage_s,
        lone_per_s=m["lone_calls"] / m["lone_s"] if m["lone_s"] else None,
        launches_per_window={k: v / n_windows for k, v in launches.items()},
        keys=gpu.key_count(), launches=launches, pinned_launches=pinned,
        launches_by_form=forms, inject_staging_waits=staging_waits,
        inject_calls=injected["calls"], inject_rows=injected["rows"],
        inject_apply_us=injected["s"] / injected["calls"] * 1e6)
    seed_calls = m["seed_calls"]
    results["engine"]["seed_mirror_us"] = m["seed_s"] / seed_calls * 1e6
    tlog(f"  equal responses, lone responses, tables and stats; card engine {rate:,.0f} "
         f"decisions/s ({m['n_req']} requests in {m['gpu_s']:.2f} s, the 2 traced windows "
         f"left out; CPU twin {total / m['cpu_s']:,.0f}/s); device busy {busy} of the "
         f"traced windows' wall time")
    tlog(f"  {fast['taken']} fast windows taken in {fast['s']:.2f} s; their leftover "
         f"tail (duplicate, gregorian, invalid lanes through the python pipeline): "
         f"{fast['tail_requests']} of {total} requests, {fast['tail_s']:.2f} s")
    tlog(f"  stage seconds (card engine, all windows and lone misses): "
         + ", ".join(f"{s} {v:.3f}" for s, v in stage_s.items())
         + f"; dispatch {m['dispatch_s']:.3f} s, fetch {m['fetch_s']:.3f} s")
    tlog(f"  lone path: {m['lone_calls']} calls in {m['lone_s']:.3f} s ({m['lone_native']} "
         f"native, {m['lone_miss']} misses as one-request windows); seed_mirror "
         f"{seed_calls} calls ({m['seeded']} seeded) in {m['seed_s']:.3f} s, "
         f"{m['seed_s'] / seed_calls * 1e6:.1f} us per call through the pinned gather; "
         f"native_singles {stats['native_singles']}; {gpu.key_count()} keys; "
         f"launches {launches}")
    tlog(f"  injects: {injected['calls']} Engine._apply_inject_rows calls with rows "
         f"({injected['rows']} rows), {injected['s'] / injected['calls'] * 1e6:.2f} us per "
         f"call on the host clock; pinned launches {pinned}, by form {forms}; "
         f"{staging_waits} waits on the inject staging")
    # the lone path's host split, after every check above: it re-seeds
    # mirrors from the table and so leaves the two engines apart
    hot = [r.hash_key() for r in lone_requests(batches[-1][0], key_cfg)]
    results["host_split_seed_mirror"] = split_seed_mirror(
        gpu, [k for k in hot if gpu.directory.peek_slot(k) >= 0])
    results["decide_launch_mix"] = launch_histogram(mix["launches"])
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches, mix["captured"]


def phase_engine_python(seed, n_windows, dev, results):
    log(f"== phase 3b: Engine on the python directory (GUBER_NO_NATIVE=1), "
        f"{dev} vs cpu, {n_windows} windows")
    batches, key_cfg = request_stream(seed, n_windows)
    os.environ["GUBER_NO_NATIVE"] = "1"
    try:
        gpu = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
        cpu = Engine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    finally:
        del os.environ["GUBER_NO_NATIVE"]
    check(gpu._prep_fast is None, "GUBER_NO_NATIVE did not pick the python directory")
    gpu.warmup()
    spent = timed_hooks(gpu)
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    m = drive_engines(gpu, cpu, batches, key_cfg, False, spent)
    launches = {**dk.launch_counts, **rowk.launch_counts}
    rate = m["n_req"] / m["gpu_s"]
    results["engine_python"] = dict(m, windows=n_windows, decisions_per_s=rate,
                                    stats=gpu.stats.as_dict(), launches=launches)
    tlog(f"  equal responses, tables and stats; card engine {rate:,.0f} decisions/s; "
         f"launches {launches}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- host-stage split

HOST_SPLIT_CALLS = 10_000
RING_STAGES = ("checks", "lookups", "allocation", "stream_device", "ctypes_call")
SEED_STAGES = ("lock_peek", "slot_write", "gather_wrapper", "wait_read", "mirror_seed")


def log_split(what, us):
    tlog(f"  host split, {what}: " + ", ".join(f"{k} {v:.2f}" for k, v in us.items())
         + f"; {sum(us.values()):.2f} us per call in all")


def split_ring(x):
    """Host microseconds per ring wrapper call, by stage (RING_STAGES), over
    HOST_SPLIT_CALLS calls of the sequence ring_all_reduce_cuda runs; then
    whole wrapper calls beside torch.sum(x, 0), both on the host clock."""
    k = rk._load()
    launch, pc = k.ring_all_reduce_launch, time.perf_counter_ns
    ns = dict.fromkeys(RING_STAGES, 0)
    for i in range(HOST_SPLIT_CALLS):
        if i % 1000 == 0:
            torch.cuda.synchronize()  # the launch queue never fills
        t0 = pc()
        index = _launch.cuda_index(x, "x")
        _launch.check(x, "x", torch.int64, (None, None), index)
        S, L = x.shape
        t1 = pc()
        kk = rk._kernels or rk._load()
        if S > kk.max_shards:
            raise SystemExit("ring split: too many shards")
        t2 = pc()
        out = torch.empty_like(x)
        t3 = pc()
        stream = kk.stream(index)
        t4 = pc()
        err = launch(index, x.data_ptr(), out.data_ptr(), S, L, stream)
        t5 = pc()
        check(err == 0, f"ring split: launch error {err}")
        for stage, a, b in zip(RING_STAGES, (t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
            ns[stage] += b - a
    split = {"stages_us": {st: v / HOST_SPLIT_CALLS / 1e3 for st, v in ns.items()}}
    torch.cuda.synchronize()
    # whole calls on the host clock (no wait): the wrapper and its yardstick
    split["wrapper_us"] = host_us(lambda i: rk.ring_all_reduce_cuda(x), HOST_SPLIT_CALLS)
    split["torch_sum_us"] = host_us(lambda i: torch.sum(x, 0), HOST_SPLIT_CALLS)
    torch.cuda.synchronize()
    log_split(f"ring_all_reduce_cuda S={x.shape[0]} L={x.shape[1]}", split["stages_us"])
    tlog(f"  host clock per call, no wait: ring_all_reduce_cuda {split['wrapper_us']:.2f} us, "
         f"torch.sum(x, 0) {split['torch_sum_us']:.2f} us")
    return split


def check_raw_stream(dev):
    """The launch path's stream lookup (ops/_launch.py, a private torch
    function) must give what torch.cuda.current_stream gives, on the
    default stream and inside a side-stream context."""
    raw = rk._load().stream
    for st in (torch.cuda.current_stream(dev), torch.cuda.Stream(dev)):
        with torch.cuda.stream(st):
            check(raw(dev.index) == torch.cuda.current_stream(dev).cuda_stream,
                  "the raw stream lookup differs from torch.cuda.current_stream")
    log("  the launch path's raw stream handle equals torch.cuda.current_stream's, "
        "default and side stream")


def split_seed_mirror(engine, keys):
    """Host microseconds per Engine.seed_mirror, by stage (SEED_STAGES),
    over HOST_SPLIT_CALLS calls cycling over `keys`, of the sequence it
    runs: the slot written into the page-locked buffer, the pinned gather
    (its by-value form), one wait on the stream and the row read from the
    buffer (wait_read holds the kernel), the mirror written. Then whole
    seed_mirror calls."""
    check(len(keys) > 0, "host split: no seeded key to gather")
    d, state, g = engine.directory, engine.state, engine._gather_buf
    pc = time.perf_counter_ns
    ns = dict.fromkeys(SEED_STAGES, 0)
    for i in range(HOST_SPLIT_CALLS):
        key = keys[i % len(keys)]
        t0 = pc()
        with engine._lock:
            slot = d.peek_slot(key)
            t1 = pc()
            g.slot_np[0] = slot
            t2 = pc()
            rowk.gather_rows_pinned(state, g.slot, g.rows, 1)
            t3 = pc()
            rowk.sync_stream(g.index)
            row = g.row_np
            t4 = pc()
            check(row[0] >= 0, f"host split: {key} has a vacant row")
            d.mirror_seed(key, row)
        t5 = pc()
        for stage, a, b in zip(SEED_STAGES, (t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
            ns[stage] += b - a
    split = {"stages_us": {st: v / HOST_SPLIT_CALLS / 1e3 for st, v in ns.items()}}
    split["seed_mirror_us"] = host_us(lambda i: engine.seed_mirror(keys[i % len(keys)]),
                                      HOST_SPLIT_CALLS)
    log_split("seed_mirror", split["stages_us"])
    tlog(f"  host clock per call: Engine.seed_mirror {split['seed_mirror_us']:.2f} us "
         f"over {HOST_SPLIT_CALLS} calls")
    return split


# ----------------------------------------------------------------- phase 4

def phase_global(seed, dev, results):
    S, C, G = GLOBAL_SHARDS, GLOBAL_ROWS, GLOBAL_KEYS
    log(f"== phase 4: GLOBAL sync, S={S} shards x {C} rows, G={G}")
    rng = np.random.default_rng(seed + 2)
    ring_rec = {}
    for L in (G, 4 * G):
        x = torch.from_numpy(rng.integers(-2**62, 2**62, (S, L), dtype=np.int64)).to(dev)
        got, want = rk.ring_all_reduce_cuda(x), rk.ring_all_reduce_plain(x)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"ring L={L}: kernel and plain version differ")
        check(torch.equal(got, _psum(x)), f"ring L={L}: ring and psum differ")
        call_ms = event_ms(lambda i: rk.ring_all_reduce_cuda(x), 200)
        ms = profiled_ms(lambda i: rk.ring_all_reduce_cuda(x), 200, "ring_kernel")
        plain_ms = event_ms(lambda i: rk.ring_all_reduce_plain(x), 50)
        lib_ms = event_ms(lambda i: torch.sum(x, 0), 200)
        lib_dev_ms = profiled_ms(lambda i: torch.sum(x, 0), 200)
        b_ms, b_by = bound_ms(2 * S * L * 8, 2 * (S - 1) * L)
        ring_rec[L] = dict(L=L, S=S, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=max_abs_err(got, want))
        tlog(f"  ring L={L}: bit-equal; kernel {fms(ms)} ms on the device, {call_ms:.4f} ms "
             f"per wrapper call; plain {plain_ms:.4f} ms; torch.sum {lib_ms:.4f} ms per "
             f"call, {fms(lib_dev_ms)} ms on the device; bound {b_ms:.6f} ms ({b_by})")
    results["ring"] = list(ring_rec.values())
    check_raw_stream(dev)
    results["host_split_ring"] = split_ring(x)

    plan = MeshPlan(n_shards=S, capacity_per_shard=C)
    card = make_sharded_table(plan, dev)
    card.copy_(populate_table(S * C, seed + 3, dev).view(1, S, C, 8))
    host = card.to("cpu", copy=True)
    keys = [f"global_{i}" for i in range(G)]
    owner = np.array([shard_of_key(k, S) for k in keys], np.int32)
    slot = np.full(G, -1, np.int32)
    for s in range(S):
        mine = np.flatnonzero(owner == s)
        slot[mine] = rng.choice(C, len(mine), replace=False)
    slot[rng.random(G) < 0.05] = -1  # not registered yet
    greg = rng.random(G) < 0.05
    dur = np.where(greg, rng.integers(0, 3, G), rng.choice([1000, 60_000], G)).astype(np.int64)
    local = dt.datetime.fromtimestamp(NOW / 1000.0)
    cfg_np = dict(
        slot=slot, owner=owner, limit=rng.choice([10, 100, 10_000], G).astype(np.int64),
        duration=dur, algorithm=(rng.random(G) < 0.2).astype(np.int32),
        behavior=np.where(greg, GREG, 0).astype(np.int32),
        greg_expire=np.array([gregorian_expiration(local, int(c)) if g else 0
                              for g, c in zip(greg, dur)], np.int64),
        greg_interval=np.array([gregorian_duration(local, int(c)) if g else 0
                                for g, c in zip(greg, dur)], np.int64),
        fresh=np.ones(G, np.bool_))
    ring_sync = make_global_sync(plan, collectives="ring", device=dev)
    psum_sync = make_global_sync(plan, collectives="psum", device="cpu")
    dk.reset_launch_counts()
    rk.reset_launch_counts()
    t_ring = 0.0
    steps = 5
    for step in range(steps):
        now = NOW + step * 1000
        delta = rng.integers(0, 5, (1, S, G)).astype(np.int64)
        cfg_d = GlobalConfig(**{k: torch.from_numpy(v).to(dev) for k, v in cfg_np.items()})
        cfg_h = GlobalConfig(**{k: torch.from_numpy(v) for k, v in cfg_np.items()})
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m_card, _ = ring_sync(card, torch.from_numpy(delta).to(dev), cfg_d, now)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        t_ring += step_s
        if not step:  # the first step may pay the libraries' first loads
            first_ms = step_s * 1e3
        _, m_host, _ = psum_sync(host, torch.from_numpy(delta), cfg_h, now)
        for f in m_card._fields:
            check(torch.equal(getattr(m_card, f).cpu(), getattr(m_host, f)),
                  f"sync step {step}: mirror.{f} differs")
        check(torch.equal(card.cpu(), host), f"sync step {step}: shard tables differ")
        cfg_np["fresh"] = np.zeros(G, np.bool_)
    launches = {**dk.launch_counts, **rk.launch_counts}
    # step_ms: the mean of all steps, as before; steady_step_ms leaves the first out
    step_ms = t_ring / steps * 1e3
    steady_ms = (t_ring * 1e3 - first_ms) / (steps - 1)
    results["global"] = dict(S=S, C=C, G=G, steps=steps, step_ms=step_ms,
                             steady_step_ms=steady_ms, first_step_ms=first_ms,
                             launches=launches)
    tlog(f"  {steps} sync steps: equal mirrors and shard tables; ring step {step_ms:.3f} ms "
         f"(steps 1-{steps}; steps 2-{steps} {steady_ms:.3f} ms, the first {first_ms:.3f} ms); "
         f"launches {launches}")
    del card, host
    torch.cuda.empty_cache()
    return launches, ring_rec[4 * G]


# ----------------------------------------------------------------- phase 5

def inject_stimulus(rng, C, m, device):
    """i64[m, 8] inject rows over distinct slots; about one lane in eight
    is dropped (-1, C, C + 5) and algo/status overflow int32 on some."""
    rows = rng.integers(-(1 << 40), 1 << 40, (m, 8), dtype=np.int64)
    rows[:, 0] = rng.choice(C, m, replace=False)
    bad = rng.random(m) < 0.125
    rows[bad, 0] = rng.choice([-1, C, C + 5], int(bad.sum()))
    rows[:, 1] = np.where(rng.random(m) < 0.8, rng.integers(0, 2, m), rows[:, 1])
    rows[:, 7] = np.where(rng.random(m) < 0.8, rng.integers(0, 2, m), rows[:, 7])
    return torch.from_numpy(rows).to(device)


def gather_stimulus(rng, C, m, device):
    """i32[m] slots, some below 0 or at and past C (they clamp)."""
    s = rng.integers(0, C, m).astype(np.int32)
    bad = rng.random(m) < 0.125
    s[bad] = rng.choice([-1, -9, C, C + 3], int(bad.sum()))
    return torch.from_numpy(s).to(device)


def in_turns(measure, run_a, run_b):
    """measure(run_a) and measure(run_b) taken in turns a, b, b, a; the mean
    of each pair, so neither side gains from going first."""
    a0, b0, b1, a1 = measure(run_a), measure(run_b), measure(run_b), measure(run_a)
    return (a0 + a1) / 2, (b0 + b1) / 2


def timed_kernel(run_k, run_p, run_lib, kernel_name, iters=64, flush=None):
    """Device ms (profiler) of the kernel and of the library call, each
    session after flush() when given; call ms of both (CUDA events, back to
    back) in turns; the plain version's ms."""
    def profiled(run, name):
        if flush is not None:
            flush()
        return profiled_ms(run, 32, name)

    call_ms, library_ms = in_turns(lambda f: event_ms(f, iters), run_k, run_lib)
    return dict(ms=profiled(run_k, kernel_name), call_ms=call_ms,
                plain_ms=event_ms(run_p, 8), library_ms=library_ms,
                library_device_ms=profiled(run_lib, None))


def index_copy_rows(st, C):
    """The yardstick's operands for inject rows `st` (i64[m, 8], on the card):
    the kept slots and the rows as the inject writes them, for one
    index_copy_."""
    keep = (st[:, 0] >= 0) & (st[:, 0] < C)
    r = torch.cat([st[:, 1:2].to(torch.int32).to(torch.int64), st[:, 2:7],
                   st[:, 7:8].to(torch.int32).to(torch.int64), torch.zeros_like(st[:, :1])], 1)
    return st[keep, 0].contiguous(), r[keep].contiguous()


def inject_edge_stimuli(rng, C, m, n):
    """n host stimuli i64[m, 8] (inject_stimulus): the slots -1, C - 1 and
    C in lanes 0-2 of the first (at m = 1, one each in the first three),
    and no other lane of those on row C - 1."""
    host = [inject_stimulus(rng, C, m, "cpu").numpy() for _ in range(n)]
    edges = [(host[0], j) for j in range(3)] if m >= 3 else [(a, 0) for a in host[:3]]
    for a in host[:3]:
        a[a[:, 0] == C - 1, 0] = -1
    for (a, j), v in zip(edges, (-1, C - 1, C)):
        a[j, 0] = v
    return host


def inject_form(kern, staging, m, form):
    """The pinned inject of the staging's first m rows in `form`, whatever
    form m picks: the library's entry point called as ops/rows.py calls it,
    with the form named here (no path of the package can name one). Records
    no event and counts nothing: phase 5 holds every form at every m with
    it, and ab_rows.py times the mapped and copy forms at every m."""
    k = rowk._kernels or rowk._load()
    index = kern.get_device()
    _launch.raise_on(k.inject_rows_pinned_launch(
        index, kern.data_ptr(), kern.shape[0], staging.rows.data_ptr(), m, k.stream(index),
        None, rowk._INJECT_FORM[form], int(staging.checked),
        staging.scratch.data_ptr() if form == "copy" else None), f"inject_rows ({form})")


def pinned_inject(rng, kern, plain, dev):
    """The inject's pinned forms, as the engine runs them: the rows in the
    page-locked staging (rowk.InjectStaging), by value up to by_value_max
    rows (copied into the launch's parameters), mapped above (read by the
    kernel through their mapped address), copied up into the staging's
    device scratch from copy_min rows (the form edges checked). An unpinned
    host inject is refused, through the public wrapper and from a staging
    built over pageable memory, in every form; bit-equal to
    inject_rows_plain at every m of PINNED_INJECT_M and at copy_min - 1 and
    copy_min (slots -1, C - 1, C and dropped and int32-overflowing lanes),
    in the form m picks through the staging and in every other form the
    library takes at that m through its entry point (inject_form); then
    timed in the form m picks: device ms per launch (torch.profiler: all
    the launch ran on the device, a copy up included) and, on the host
    clock, ms per round trip from a numpy i64[m, 8] to the rows in the
    table (copied into the staging, launched, one wait on the stream) as
    call_ms, beside the plain version and the yardstick
    torch.from_numpy(a).to(dev) followed by index_copy_ of the prepared rows,
    with the same wait. Returns records and the largest difference."""
    C, index = kern.shape[0], kern.get_device()
    top, low = rowk.by_value_max("inject_rows"), rowk.copy_min()
    forms = [rowk.pinned_form("inject_rows", m) for m in PINNED_INJECT_M]
    check(forms == sorted(forms, key=INJECT_FORMS.index) and set(forms) == set(INJECT_FORMS)
          and [rowk.pinned_form("inject_rows", m) for m in (top, top + 1, low - 1, low)]
          == ["by_value", "mapped", "mapped", "copy"] and top in PINNED_INJECT_M
          and top + 1 in PINNED_INJECT_M,
          f"PINNED_INJECT_M misses a form's edge: {dict(zip(PINNED_INJECT_M, forms))}")
    staging = rowk.InjectStaging.allocate(max(PINNED_INJECT_M), dev)
    pageable = rowk.InjectStaging(torch.zeros((low, rowk.ROW_FIELDS), dtype=torch.int64),
                                  staging.done, staging.scratch[:low])
    for m in (1, top + 1, low):  # every form refuses pageable memory, from either entry
        for what, run in (("inject", lambda: rowk.inject_rows_cuda(
                kern, torch.zeros((m, rowk.ROW_FIELDS), dtype=torch.int64))),
                          ("staging", lambda: pageable.launch(kern, m))):
            try:
                run()
            except ValueError as e:
                check("page-locked" in str(e), f"unpinned {what} m={m}: wrong refusal {e}")
            else:
                check(False, f"pinned inject m={m} took an unpinned host {what}")
    recs, err = [], 0
    for m in sorted(set(PINNED_INJECT_M) | {low - 1, low}):
        form = rowk.pinned_form("inject_rows", m)
        host = inject_edge_stimuli(rng, C, m, 16)
        on_card = [torch.from_numpy(a).to(dev) for a in host]
        plain.copy_(kern)
        before = dict(rowk.launch_counts)
        for a, d in zip(host[:4], on_card[:4]):
            staging.free()[:m] = a
            staging.launch(kern, m)
            rowk.inject_rows_plain(plain, d)
        torch.cuda.synchronize()
        check(rowk.launch_counts[f"inject_rows_{form}"] - before[f"inject_rows_{form}"] == 4,
              f"pinned inject m={m}: not launched in the {form} form")
        err = max(err, max_abs_err(kern, plain))
        check(torch.equal(kern, plain), f"pinned inject m={m} ({form}): tables differ")
        held = [form]
        for other in INJECT_FORMS:
            if other == form or (other == "by_value" and m > top):
                continue
            for a, d in zip(host[4:6], on_card[4:6]):
                staging.free()[:m] = a
                inject_form(kern, staging, m, other)
                torch.cuda.synchronize()  # read before the next rows are written
                rowk.inject_rows_plain(plain, d)
            err = max(err, max_abs_err(kern, plain))
            check(torch.equal(kern, plain), f"pinned inject m={m} ({other}, through the "
                  "entry point): tables differ")
            held.append(other)
        check(rowk.launch_counts == {**before, "inject_rows": before["inject_rows"] + 4,
                                     f"inject_rows_{form}": before[f"inject_rows_{form}"] + 4},
              f"pinned inject m={m}: the entry point's launches were counted")
        if m not in PINNED_INJECT_M:
            log(f"  inject_rows ({form}) m={m:5d}: bit-equal in the forms {held}")
            continue
        lib_in = [index_copy_rows(d, C) for d in on_card]

        def run_k(i):
            staging.launch(kern, m)

        def round_trip(i):
            staging.inject(kern, host[i % 16])
            rowk.sync_stream(index)

        def run_lib(i):
            torch.from_numpy(host[i % 16]).to(dev)
            plain.index_copy_(0, *lib_in[i % 16])
            rowk.sync_stream(index)

        def run_p(i):
            rowk.inject_rows_plain(plain, torch.from_numpy(host[i % 16]).to(dev))
            rowk.sync_stream(index)

        b_ms, b_by = bound_ms(m * 64, 0, m * 64)
        call_us, lib_us = in_turns(lambda f: host_us(f, 2000), round_trip, run_lib)
        recs.append(dict(
            kernel="inject_rows", form=form, m=m, ms=profiled_ms(run_k, 32),
            call_ms=call_us / 1e3, plain_ms=host_us(run_p, 200) / 1e3,
            library_ms=lib_us / 1e3, library_device_ms=profiled_ms(run_lib, 32),
            library="torch.from_numpy(a).to(dev) + index_copy_", bound_ms=b_ms, bound_by=b_by,
            bytes=m * 64, link_bytes=m * 64, forms_held=held))
    plain.copy_(kern)
    return recs, err, staging


def inject_reuse(rng, kern, plain, staging, dev):
    """REUSE_INJECTS pinned injects from one staging buffer, back to back
    behind a stream kept busy for about a millisecond, in each form:
    LONE_KEYS rows a launch (by value), by_value_max + 1 (mapped) and
    copy_min (copied up). Before each, the host writes new rows into
    staging.free() (which waits on the staging's event only for a mapped
    inject or a copy before) and launches, with no wait of its own; after
    each by-value launch it rewrites the whole buffer at once with rows of
    other slots, which the table must not show. The table must equal the
    plain version's after the same injects in order, and only the mapped
    and copied launches may have waited. The mapped and copied sequences
    with the rows written straight into the buffer, skipping free()'s wait,
    are logged beside them: they show whether the hazard the wait guards
    against occurs on this card. Returns the largest difference, and
    whether that hazard showed, by form."""
    C = kern.shape[0]
    hazard, err = {}, 0
    for m in (LONE_KEYS, rowk.by_value_max("inject_rows") + 1, rowk.copy_min()):
        form = rowk.pinned_form("inject_rows", m)
        pending = form != "by_value"
        seq = [inject_stimulus(rng, C, m, "cpu").numpy() for _ in range(REUSE_INJECTS)]
        poison = inject_stimulus(rng, C, len(staging.rows_np), "cpu").numpy()
        plain.copy_(kern)
        unguarded = kern.clone() if pending else None
        staging.free()  # the launches before this sequence have run
        waits = staging.waits
        for guarded in (True, False) if pending else (True,):
            table = kern if guarded else unguarded
            torch.cuda.synchronize()
            torch.cuda._sleep(2_000_000)  # the injects queue behind ~1 ms of work
            for a in seq:
                buf = staging.free() if guarded else staging.rows_np
                buf[:m] = a
                if guarded:
                    staging.launch(table, m)
                else:
                    rowk.inject_rows_pinned(table, staging.rows, m, None, True, staging.scratch)
                if not pending:
                    staging.rows_np[:] = poison  # at once: the launch took its rows
            torch.cuda.synchronize()
        for a in seq:
            rowk.inject_rows_plain(plain, torch.from_numpy(a).to(dev))
        torch.cuda.synchronize()
        err = max(err, max_abs_err(kern, plain))
        check(torch.equal(kern, plain), f"inject reuse m={m} ({form}): the table does not "
              "hold the rows as launched (tables differ)")
        waited = staging.waits - waits
        check(waited == (REUSE_INJECTS - 1 if pending else 0),
              f"inject reuse m={m} ({form}): free() waited {waited} times")
        if pending:
            hazard[form] = not torch.equal(unguarded, plain)
            del unguarded
            log(f"  inject reuse, {form}: {REUSE_INJECTS} injects of {m} rows from one "
                f"staging behind a busy stream, {waited} waits in free(): table equal to the "
                f"plain version's; without the staging's wait the table "
                f"{'differs' if hazard[form] else 'is equal too'}")
        else:
            log(f"  inject reuse, by value: {REUSE_INJECTS} injects of {m} rows from one "
                "staging behind a busy stream, no wait in free(), the whole buffer rewritten "
                "right after each launch: table equal to the plain version's of the rows "
                "as launched")
    return err, hazard


def pinned_gather(rng, kern, dev):
    """The gather's pinned forms (slots and rows in page-locked host memory;
    the rows written through out's mapped address; the slots by value up to
    by_value_max, read through their mapped address above), as
    Engine.seed_mirror (m = 1) and the Store path run them: an unpinned slot
    or out is refused; bit-equal to gather_rows_plain at every m of
    PINNED_GATHER_M (at m = 1 the slots -1, C - 1, C, C + 8 and random ones,
    one call each; above, the four among random ones), through the public
    wrapper and through gather_rows_pinned, the engine's entry; then timed:
    device ms per launch (torch.profiler), and, on the host clock, ms per
    whole round trip (launch, one wait on the stream, the rows read) as
    call_ms, beside the plain version and the yardstick
    state[slot, :7].tolist() doing the same work on the same clock, each
    with its readback. Returns records and the largest difference."""
    C, index = kern.shape[0], kern.get_device()
    check([rowk.pinned_form("gather_rows", m) for m in PINNED_GATHER_M]
          == ["by_value"] * 3 + ["mapped"] * 2, "PINNED_GATHER_M misses the class edge")
    recs, err = [], 0
    for m in PINNED_GATHER_M:
        form = rowk.pinned_form("gather_rows", m)
        if m == 1:
            vals = [np.array([v], np.int32) for v in (-1, C - 1, C, C + 8)]
            vals += [rng.integers(0, C, 1).astype(np.int32) for _ in range(12)]
        else:
            first = rng.integers(0, C, m).astype(np.int32)
            first[:4] = [-1, C - 1, C, C + 8]
            vals = [first] + [gather_stimulus(rng, C, m, "cpu").numpy() for _ in range(15)]
        slots = [torch.from_numpy(v).pin_memory() for v in vals]
        out = torch.empty((rowk.GATHER_FIELDS, m), dtype=torch.int64, pin_memory=True)
        out_np = out.numpy()
        for bad, what in ((torch.from_numpy(vals[0].copy()), "slots"),
                          (torch.empty((rowk.GATHER_FIELDS, m), dtype=torch.int64), "out")):
            try:  # pageable host memory has no device address
                rowk.gather_rows_cuda(kern, *((bad, out) if what == "slots" else (slots[0], bad)))
            except ValueError as e:
                check("page-locked" in str(e), f"unpinned {what}: wrong refusal {e}")
            else:
                check(False, f"pinned gather m={m} took an unpinned {what}")
        try:  # the engine's entry: m + 1 slots do not fit buffers of m
            rowk.gather_rows_pinned(kern, slots[0], out, m + 1)
        except ValueError:
            pass
        else:
            check(False, f"gather_rows_pinned took {m + 1} slots into buffers of {m}")
        before = dict(rowk.launch_counts)
        for s in slots:
            want = rowk.gather_rows_plain(kern, s.to(dev)).cpu()
            for engine_entry in (False, True):
                out.fill_(-7)
                if engine_entry:
                    rowk.gather_rows_pinned(kern, s, out, m)
                else:
                    rowk.gather_rows_cuda(kern, s, out)
                rowk.sync_stream(index)
                err = max(err, max_abs_err(out, want))
                check(torch.equal(out, want), f"pinned gather m={m} ({form}, "
                      f"{'engine' if engine_entry else 'public'} entry) slots "
                      f"{s.tolist()[:4]}: differs")
        check(rowk.launch_counts[f"gather_rows_{form}"] - before[f"gather_rows_{form}"]
              == 2 * len(slots), f"pinned gather m={m}: not launched in the {form} form")
        idx = [torch.from_numpy(v.astype(np.int64).clip(0, C - 1)).to(dev) for v in vals]
        if m == 1:  # the lone path's own yardstick: an int index, one readback
            ints = [int(i.item()) for i in idx]
            run_lib = lambda i: kern[ints[i % 16], :7].tolist()  # noqa: E731
        else:
            run_lib = lambda i: kern[idx[i % 16], :7].tolist()  # noqa: E731

        def run_k(i):
            rowk.gather_rows_pinned(kern, slots[i % 16], out, m)

        def round_trip(i):
            rowk.gather_rows_pinned(kern, slots[i % 16], out, m)
            rowk.sync_stream(index)
            return out_np.tolist()

        b_ms, b_by = bound_ms(m * 56, 0, m * 56)  # rows read; rows out, the busier way
        call_us, lib_us = in_turns(lambda f: host_us(f, 2000), round_trip, run_lib)
        recs.append(dict(
            kernel="gather_rows", form=form, m=m, ms=profiled_ms(run_k, 32, "gather_kernel"),
            call_ms=call_us / 1e3,
            plain_ms=host_us(lambda i: rowk.gather_rows_plain(kern, idx[i % 16]).tolist(),
                             200) / 1e3,
            library_ms=lib_us / 1e3, library_device_ms=profiled_ms(run_lib, 32),
            library="state[slot, :7].tolist()", bound_ms=b_ms, bound_by=b_by, bytes=m * 56,
            link_bytes=m * 56))
    return recs, err


def phase_rows(seed, dev, results):
    log(f"== phase 5: row kernels vs their plain versions on the card, table "
        f"{CAPACITY} rows; row_bump on int32[{bench_rows.CAP}, 128] "
        f"({bench_rows.CAP * 512 / 1e9:.2f} GB)")
    rng = np.random.default_rng(seed + 4)
    kern = populate_table(CAPACITY, seed + 5, dev)
    plain = kern.clone()
    C = CAPACITY
    recs, errs = [], {"inject_rows": 0, "gather_rows": 0, "row_bump": 0}
    for m in INJECT_M:
        stims = [inject_stimulus(rng, C, m, dev) for _ in range(16)]
        plain.copy_(kern)  # the timing runs below mutate the two tables differently
        rowk.inject_rows_cuda(kern, stims[0])
        rowk.inject_rows_plain(plain, stims[0])
        torch.cuda.synchronize()
        errs["inject_rows"] = max(errs["inject_rows"], max_abs_err(kern, plain))
        check(torch.equal(kern, plain), f"inject m={m}: tables differ")
        # the yardstick: one index_copy_ of the prepared rows at the kept slots
        lib_in = [index_copy_rows(st, C) for st in stims]
        t = timed_kernel(lambda i: rowk.inject_rows_cuda(kern, stims[i % 16]),
                         lambda i: rowk.inject_rows_plain(plain, stims[i % 16]),
                         lambda i: plain.index_copy_(0, *lib_in[i % 16]),
                         "inject_kernel")
        b_ms, b_by = bound_ms(m * 128, 0)
        recs.append(dict(kernel="inject_rows", form="device", m=m, library="index_copy_",
                         bound_ms=b_ms, bound_by=b_by, bytes=m * 128, **t))
    pinned, errs["inject_rows_pinned"], staging = pinned_inject(rng, kern, plain, dev)
    recs += pinned
    errs["inject_reuse"], results["inject_reuse_hazard"] = inject_reuse(
        rng, kern, plain, staging, dev)
    errs["inject_rows"] = max(errs["inject_rows"], errs["inject_rows_pinned"],
                              errs["inject_reuse"])
    del staging
    plain.copy_(kern)
    for m in GATHER_M:
        stims = [gather_stimulus(rng, C, m, dev) for _ in range(16)]
        got, want = rowk.gather_rows_cuda(kern, stims[0]), rowk.gather_rows_plain(kern, stims[0])
        torch.cuda.synchronize()
        errs["gather_rows"] = max(errs["gather_rows"], max_abs_err(got, want))
        check(torch.equal(got, want), f"gather m={m}: rows differ")
        lib_idx = [s.to(torch.int64).clamp(0, C - 1) for s in stims]
        t = timed_kernel(lambda i: rowk.gather_rows_cuda(kern, stims[i % 16]),
                         lambda i: rowk.gather_rows_plain(kern, stims[i % 16]),
                         lambda i: torch.index_select(kern, 0, lib_idx[i % 16]),
                         "gather_kernel")
        b_ms, b_by = bound_ms(m * (4 + 56 + 56), 0)
        recs.append(dict(kernel="gather_rows", form="device", m=m, library="index_select",
                         bound_ms=b_ms, bound_by=b_by, bytes=m * 116, **t))
    pinned, errs["gather_rows_pinned"] = pinned_gather(rng, kern, dev)
    recs += pinned
    errs["gather_rows"] = max(errs["gather_rows"], errs["gather_rows_pinned"])
    del kern, plain
    torch.cuda.empty_cache()

    N, B = bench_rows.CAP, bench_rows.BATCH
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 6)
    kern = torch.randint(-(1 << 31), (1 << 31) - 1, (N, 128), generator=g, device=dev,
                         dtype=torch.int32)
    srng = np.random.RandomState(5)
    sets = [torch.from_numpy(srng.choice(N, B, replace=False).astype(np.int32)).to(dev)
            for _ in range(16)]
    kern[sets[0][:4].to(torch.int64)] = torch.iinfo(torch.int32).max  # the +1 wraps
    plain = kern.clone()
    out = torch.full((1,), -7, dtype=torch.int32, device=dev)  # the caller's out
    for j, s in enumerate(sets[:4]):
        out_k = rowk.row_bump_cuda(kern, s, out if j % 2 else None)
        out_p = rowk.row_bump_plain(plain, s)
        torch.cuda.synchronize()
        check(out_k is out if j % 2 else out_k is not out, "row_bump: out not used as given")
        errs["row_bump"] = max(errs["row_bump"], max_abs_err(kern, plain),
                               max_abs_err(out_k, out_p))
        check(torch.equal(out_k, out_p), "row_bump: outputs differ")
        check(torch.equal(kern, plain), "row_bump: tables differ")
    ones = torch.ones((B, 128), dtype=torch.int32, device=dev)
    idx = [s.to(torch.int64) for s in sets]
    # 16 slot sets cycled: 64 MB of rows, more than the 50 MB L2; and 128 MB
    # written before each profiled session, so that neither session finds
    # rows the other left in L2
    scratch = torch.empty(32 << 20, dtype=torch.int32, device=dev)
    t = timed_kernel(lambda i: rowk.row_bump_cuda(kern, sets[i % 16], out),
                     lambda i: rowk.row_bump_plain(plain, sets[i % 16], out),
                     lambda i: kern.index_add_(0, idx[i % 16], ones), "row_bump_kernel",
                     flush=lambda: scratch.fill_(0))
    n_bytes = B * 512 * 2 + B * 4 + 4
    b_ms, b_by = bound_ms(n_bytes, B * 128)
    recs.append(dict(kernel="row_bump", form="device", m=B, library="index_add_",
                     bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, **t))
    del kern, plain, ones, idx, sets, out, scratch
    torch.cuda.empty_cache()
    for r in recs:
        if r["form"] != "device":
            how = ("per round trip on the host clock (rows in or out of page-locked memory, "
                   f"launch, wait); plain {r['plain_ms']:.4f} ms, yardstick {r['library']} "
                   f"{r['library_ms']:.4f} ms, the same")
        else:
            how = (f"per wrapper call; plain {r['plain_ms']:.4f} ms; library {r['library']} "
                   f"{r['library_ms']:.4f} ms per call")
        tlog(f"  {r['kernel']:11s} ({r['form']}) m={r['m']:5d}: bit-equal; kernel {fms(r['ms'])} ms on "
             f"the device, {r['call_ms']:.4f} ms {how}, {fms(r['library_device_ms'])} ms on "
             f"the device; bound {r['bound_ms']:.6f} ms ({r['bound_by']})")

    log(f"  bench_rows (python3 -m gubernator_tpu_torch.bench_rows): {B} rows per call")
    rowk.reset_launch_counts()
    probe = bench_rows.run(dev)
    launches = dict(rowk.launch_counts)
    tlog(f"  {json.dumps(probe)}")
    torch.cuda.empty_cache()
    results["rows"] = recs
    results["bench_rows"] = probe
    return errs, recs, launches["row_bump"]


# ----------------------------------------------------------------- phase 6

PIPE_WINDOWS = 24  # phase 3's windows the serving stream takes: 196,608 requests
COL_WINDOWS = 8  # of them again, as wire columns
PIPE_DEPTH, PIPE_SCAN = 3, 8
BIG_SUBMISSION = 10_000  # over max_width: the combiner's serial path
SUBS_PER_MS = 64  # submissions sharing one now_ms
MAX_SUBMISSION = 512
TRACED_SUBS = 400  # the first submissions of the depth-3 run, under the profiler
COL_SLOW = GREG | int(Behavior.GLOBAL) | int(Behavior.MULTI_REGION)
# direct group launches held against the CPU twin: (K, W) of distinct-key windows
GROUP_SHAPES = ((2, 64), (8, 64), (2, 1024), (8, 1024), (2, 8192), (8, 8192))
SLEEP_CYCLES = 1_000_000_000  # ~0.5 s of busy card queued before a group launch


def serving_stream(seed):
    """Phase 3's first PIPE_WINDOWS windows, flat, cut into client
    submissions of 1-512 requests (log-uniform, from the seed) with one of
    BIG_SUBMISSION requests half way."""
    batches, _ = request_stream(seed, PIPE_WINDOWS)
    flat = [r for _, batch in batches for r in batch]
    rng = np.random.default_rng(seed + 6)
    subs, pos, big = [], 0, len(flat) // 2
    while pos < len(flat):
        if big is not None and pos >= big:
            n, big = BIG_SUBMISSION, None
        else:
            n = int(np.exp(rng.uniform(0.0, np.log(MAX_SUBMISSION + 1))))
        subs.append(flat[pos:pos + n])
        pos += n
    return flat, subs


def sub_now(i):
    return NOW + i // SUBS_PER_MS


def timed_methods(eng, names):
    """Host clock around engine methods (instance attributes, so the
    combiner calls the wrappers): {name: [calls, ns]}."""
    spent = {n: [0, 0] for n in names}
    for n in names:
        def timed(*a, _fn=getattr(eng, n), _n=n, **kw):
            t0 = time.perf_counter_ns()
            out = _fn(*a, **kw)
            rec = spent[_n]
            rec[0] += 1
            rec[1] += time.perf_counter_ns() - t0
            return out

        setattr(eng, n, timed)
    return spent


class TimedLock:
    """The engine lock with its waits added up by thread name (the combiner's
    worker launches, its drainer collects)."""

    def __init__(self, inner):
        self.inner = inner
        self.wait_ns = {}

    def __enter__(self):
        t0 = time.perf_counter_ns()
        self.inner.acquire()
        name = threading.current_thread().name
        self.wait_ns[name] = self.wait_ns.get(name, 0) + time.perf_counter_ns() - t0
        return self

    def __exit__(self, *exc):
        self.inner.release()


def timed_fetch():
    """Host clock around WindowStaging.fetch (the wait on a slot's event and
    the copy out of its response), for every engine; undo() restores it."""
    from gubernator_tpu_torch.ops.staging import WindowStaging

    spent = {"calls": 0, "ns": 0}
    orig = WindowStaging.fetch

    def fetch(handle):
        t0 = time.perf_counter_ns()
        out = orig(handle)
        spent["calls"] += 1
        spent["ns"] += time.perf_counter_ns() - t0
        return out

    WindowStaging.fetch = staticmethod(fetch)
    spent["undo"] = lambda: setattr(WindowStaging, "fetch", staticmethod(orig))
    return spent


def drive_combiner(eng, subs, depth, traced=0):
    """One async submitter through BackendCombiner(eng, depth, PIPE_SCAN):
    the first `traced` submissions under torch.profiler (drained before the
    rest go in), the rest timed on the host clock up to the last response.
    Returns the responses as tuples and the measurements."""
    from gubernator_tpu_torch.service.combiner import BackendCombiner

    c = BackendCombiner(eng, depth=depth, scan=PIPE_SCAN)
    check(c.pipelined == (depth > 1), f"the depth-{depth} combiner's pipeline is "
          f"{'on' if c.pipelined else 'off'}")
    m = dict(traced_s=0.0, busy_us=0.0)
    got = []
    try:
        if traced:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                futs = [c.submit_async(s, sub_now(i)) for i, s in enumerate(subs[:traced])]
                got += [f.result(timeout=600) for f in futs]
                torch.cuda.synchronize()
                m["traced_s"] = time.perf_counter() - t
            m["busy_us"] = sum(e.self_device_time_total for e in prof.key_averages())
        t = time.perf_counter()
        futs = [c.submit_async(s, sub_now(i)) for i, s in enumerate(subs[traced:], traced)]
        got += [f.result(timeout=600) for f in futs]
        m["s"] = time.perf_counter() - t
        m["n_req"] = sum(len(s) for s in subs[traced:])
        m["stats"] = c.stats
        m["slot_waits"] = sum(st.waits for slot in c._staging for st in slot.values())
    finally:
        c.close()
    return [resp_tuples(rs) for rs in got], m


def rows_by_key(eng):
    """(keys sorted, their table rows) over every key the directory holds."""
    items = sorted(eng.directory.items())
    slots = torch.tensor([s for _, s in items], dtype=torch.int64)
    return [k for k, _ in items], eng.state[slots.to(eng.state.device)].cpu()


def chunk_paths(index, shapes):
    """Scan launches by the path csrc/decide.cu takes (scan_chunk's rule):
    {"chunked": n, "per_window": n} and the same by 'name K=.. W=..'."""
    paths, by_shape = {"chunked": 0, "per_window": 0}, {}
    for (name, k, w), n in sorted(shapes.items()):
        if "_scan_" not in name:
            continue
        kc = dk.scan_chunk(index, FORMATS[name.rsplit("_", 1)[1]], k, w)
        path = "chunked" if kc else "per_window"
        paths[path] += n
        by_shape[f"{name} K={k} W={w}"] = f"{n} {path}" + (f" (chunks of {kc})" if kc else "")
    return paths, by_shape


def shapes_line(shapes):
    return {f"{name} K={k} W={w}": n for (name, k, w), n in sorted(shapes.items())}


def distinct_group(flat, cursor, k, w):
    """K windows of w requests in stream order from flat[cursor:], each
    with distinct keys and no gregorian lane (nothing cuts the group;
    hot keys recur across its windows). Returns the windows and the
    cursor after them."""
    wins = []
    for _ in range(k):
        seen, win = set(), []
        while len(win) < w:
            r = flat[cursor % len(flat)]
            cursor += 1
            key = r.hash_key()
            if key not in seen and not r.behavior & GREG:
                seen.add(key)
                win.append(r)
        wins.append(win)
    return wins, cursor


def group_checks(gpu, cpu, flat, now):
    """Direct launch_windows / collect_windows of distinct-key groups at
    every GROUP_SHAPES (K, W) on the card engine and its CPU twin, equal
    answers. Each card launch goes in behind SLEEP_CYCLES of busy card:
    its slot's event must still be pending when launch_windows returns (the
    launch did not wait on the card). Returns the launch shapes, counted
    between a reset and a read."""
    dk.reset_launch_counts()
    cursor, waited = 0, 0
    for i, (k, w) in enumerate(GROUP_SHAPES):
        wins, cursor = distinct_group(flat, cursor, k, w)
        torch.cuda._sleep(SLEEP_CYCLES)
        h = gpu.launch_windows(wins, now_ms=now + i, staging={})
        check(h is not None and len(h[0]) == 1, f"group K={k} W={w} was not one launch")
        waited += h[0][0][0][0].done.query()
        got = gpu.collect_windows(h)
        want = cpu.collect_windows(cpu.launch_windows(wins, now_ms=now + i, staging={}))
        check([resp_tuples(r) for r in got] == [resp_tuples(r) for r in want],
              f"group K={k} W={w}: card and CPU engines answer differently")
    check(waited == 0, f"{waited} of {len(GROUP_SHAPES)} group launches returned after "
          "the card had finished them: launch_windows waited on the card")
    return dict(dk.launch_shapes)


def columnar_cols(reqs):
    """The peerlink wire layout of one sub-window, as a launch tuple."""
    names = [r.name.encode() for r in reqs]
    ukeys = [r.unique_key.encode() for r in reqs]
    off = np.zeros(len(reqs) + 1, np.int32)
    np.cumsum([len(a) + len(b) for a, b in zip(names, ukeys)], out=off[1:])
    return (len(reqs), b"".join(a + b for a, b in zip(names, ukeys)), off,
            np.array([len(a) for a in names], np.int32),
            np.array([r.hits for r in reqs], np.int64),
            np.array([r.limit for r in reqs], np.int64),
            np.array([r.duration for r in reqs], np.int64),
            np.array([int(r.algorithm) for r in reqs], np.int32),
            np.array([int(r.behavior) for r in reqs], np.int32))


def columnar_loop(eng, reqs, now, depth):
    """The peerlink loop: sub-windows by bucket_splits, scan groups of
    PIPE_SCAN launched with `depth` in flight, collected in launch order;
    on a cut, everything in flight is collected and the leftovers retire
    through get_rate_limits, in order. depth 0: lock-step submit_columnar /
    complete_columnar. Returns the four response columns and the host
    seconds."""
    import collections

    from gubernator_tpu_torch.models.prep import bucket_pow2, bucket_splits, bucket_width

    n = len(reqs)
    outs = (np.zeros(n, np.int32), np.zeros(n, np.int64), np.zeros(n, np.int64),
            np.zeros(n, np.int64))
    spans, s0 = [], 0
    for ln in bucket_splits(n, eng.min_width, eng.max_width):
        spans.append((s0, s0 + ln))
        s0 += ln
    cols = [columnar_cols(reqs[a:b]) for a, b in spans]

    def retire(a, left):
        if len(left):
            idx = (a + left).tolist()
            for i, r in zip(idx, eng.get_rate_limits([reqs[i] for i in idx], now_ms=now)):
                outs[0][i], outs[1][i], outs[2][i], outs[3][i] = (
                    r.status, r.limit, r.remaining, r.reset_time)

    slots = [dict() for _ in range(depth + 2)] if depth else []
    widths = {bucket_width(b - a, eng.min_width, eng.max_width) for a, b in spans}
    for slot in slots:  # set-up: every slot's page-locked staging, every shape
        for k in {bucket_pow2(k) for k in range(1, PIPE_SCAN + 1)}:
            for w in widths:
                eng._slot_staging(slot, k, w)
    t = time.perf_counter()
    if depth == 0:
        for (a, b), c in zip(spans, cols):
            h = eng.submit_columnar(*c, COL_SLOW, now_ms=now)
            check(h is not None, "submit_columnar refused a window")
            retire(a, eng.complete_columnar(h, *(o[a:b] for o in outs)))
        return outs, time.perf_counter() - t
    inflight = collections.deque()
    wi = seq = 0

    def drain_one():
        h, gspans = inflight.popleft()
        gouts = [tuple(o[a:b] for o in outs) for a, b in gspans]
        for (a, _b), left in zip(gspans, eng.collect_columnar_windows(h, gouts)):
            retire(a, left)

    while wi < len(spans) or inflight:
        barrier = False
        while wi < len(spans) and len(inflight) < depth:
            group = cols[wi:wi + PIPE_SCAN]
            h = eng.launch_columnar_windows(group, COL_SLOW, now_ms=now,
                                            staging=slots[seq % len(slots)])
            check(h is not None and h[1] is None, f"launch_columnar_windows: {h and h[1]}")
            seq += 1
            consumed = len(h[0])
            inflight.append((h, spans[wi:wi + consumed]))
            wi += consumed
            if consumed < len(group) or len(h[0][-1][-1]):  # a cut: barrier
                barrier = True
                break
        if barrier or wi >= len(spans):
            while inflight:
                drain_one()
        elif inflight:
            drain_one()
    return outs, time.perf_counter() - t


def phase_pipeline(seed, dev, results):
    log(f"== phase 6: the serving pipeline, Engine(capacity={CAPACITY}, widths 64-{WINDOW}) "
        f"behind BackendCombiner: {PIPE_WINDOWS} windows of phase 3's stream as client "
        f"submissions, depth {PIPE_DEPTH} scan {PIPE_SCAN} and depth 1 on the card, depth 1 "
        f"on the CPU twin; then {COL_WINDOWS} windows as wire columns")
    flat, subs = serving_stream(seed)
    check(len(flat) == PIPE_WINDOWS * WINDOW and sum(map(len, subs)) == len(flat),
          "the serving stream lost requests")
    tlog(f"  {len(subs)} submissions of 1-{MAX_SUBMISSION} requests and one of "
         f"{BIG_SUBMISSION}, {len(flat)} requests, now_ms + 1 every {SUBS_PER_MS}")
    os.environ.pop("GUBER_NO_NATIVE", None)
    out = results["pipeline"] = {}
    launches = dict.fromkeys([*dk.launch_counts, *rowk.launch_counts], 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # 1. build and warm the card engine; the depth probe
    t = time.perf_counter()
    gpu = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    gpu.warmup()
    gpu.warmup_pipeline(max_group=PIPE_SCAN)
    from gubernator_tpu_torch.service.combiner import BackendCombiner

    probe = BackendCombiner(gpu, depth="auto", scan=PIPE_SCAN)
    try:
        picked = probe.autotune(depths=(1, 3, 6))
    finally:
        probe.close()
    check(gpu.key_count() == 0, "the depth probe touched the table")
    out["autotune_depth"] = picked
    tlog(f"  engine built, warmed (warmup + warmup_pipeline) and probed in "
         f"{time.perf_counter() - t:.2f} s; autotune over (1, 3, 6) picked depth {picked}")

    # 2. the stream at depth 3, its first TRACED_SUBS submissions traced
    spent = timed_methods(gpu, ("launch_windows", "collect_windows"))
    tails = {"calls": 0, "requests": 0, "ns": 0}

    def tail(requests, now_ms, count_batch=True, _fn=gpu._slow_window):
        t0 = time.perf_counter_ns()
        resp = _fn(requests, now_ms, count_batch)
        if not count_batch:  # a leftover tail
            tails["calls"] += 1
            tails["requests"] += len(requests)
            tails["ns"] += time.perf_counter_ns() - t0
        return resp

    gpu._slow_window = tail
    gpu._inject.waits = 0
    lock = gpu._lock = TimedLock(gpu._lock)
    fetched = timed_fetch()
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    try:
        got3, m3 = drive_combiner(gpu, subs, PIPE_DEPTH, traced=TRACED_SUBS)
    finally:
        fetched.pop("undo")()
    # the combiner's calls only: the group checks below call the engine too
    lock_wait_s = {k: v / 1e9 for k, v in lock.wait_ns.items()}
    calls = {n: list(v) for n, v in spent.items()}
    tails3, inject_waits = dict(tails), gpu._inject.waits
    add(dk.launch_counts)
    add(rowk.launch_counts)
    shapes3 = dict(dk.launch_shapes)
    index = gpu.state.get_device()
    paths3, path_shapes3 = chunk_paths(index, shapes3)
    st = m3["stats"]
    check(st["pipelined_windows"] > 0 and st["group_launches"] > 0,
          f"the depth-{PIPE_DEPTH} run launched nothing pipelined: {st}")

    # 3. the CPU twin at depth 1: equal answers
    cpu = Engine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    want, mc = drive_combiner(cpu, subs, 1)
    check(got3 == want, f"depth {PIPE_DEPTH} on the card and depth 1 on the CPU answer "
          "differently")
    group_shapes = group_checks(gpu, cpu, flat, sub_now(len(subs)) + 1)
    group_paths, group_path_shapes = chunk_paths(index, group_shapes)
    gk, gr = rows_by_key(gpu)
    ck, cr = rows_by_key(cpu)
    check(gk == ck and torch.equal(gr, cr), "the card and CPU tables differ at the "
          "directory's keys")
    rate3 = m3["n_req"] / m3["s"]
    busy = m3["busy_us"] / 1e6 / m3["traced_s"] if m3["traced_s"] else None
    launch_us = calls["launch_windows"][1] / max(calls["launch_windows"][0], 1) / 1e3
    collect_us = calls["collect_windows"][1] / max(calls["collect_windows"][0], 1) / 1e3
    del gpu
    torch.cuda.empty_cache()

    # the timing pairs, in turns: the same stream at depth 1, 1 and PIPE_DEPTH,
    # each on a fresh card engine warmed as the first
    rates = {PIPE_DEPTH: [m3["n_req"] / m3["s"]], 1: []}
    for depth in (1, 1, PIPE_DEPTH):
        eng = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
        eng.warmup()
        eng.warmup_pipeline(max_group=PIPE_SCAN)
        dk.reset_launch_counts()
        rowk.reset_launch_counts()
        got, m = drive_combiner(eng, subs, depth, traced=TRACED_SUBS)
        add(dk.launch_counts)
        add(rowk.launch_counts)
        check(got == want, f"depth {depth} on the card and depth 1 on the CPU answer "
              "differently")
        rates[depth].append(m["n_req"] / m["s"])
        del eng
        torch.cuda.empty_cache()
    rate3, rate1 = float(np.mean(rates[PIPE_DEPTH])), float(np.mean(rates[1]))
    launch_tail_free_us = ((calls["launch_windows"][1] - tails3["ns"])
                           / max(calls["launch_windows"][0], 1) / 1e3)
    out.update(
        submissions=len(subs), requests=len(flat), decisions_per_s_depth3=rate3,
        decisions_per_s_depth1=rate1, decisions_per_s_runs=rates,
        cpu_twin_decisions_per_s=mc["n_req"] / mc["s"],
        device_busy_share=busy, traced_submissions=TRACED_SUBS, stats=st,
        launch_windows_us=launch_us, launch_windows_tail_free_us=launch_tail_free_us,
        collect_windows_us=collect_us, fetch_calls=fetched["calls"],
        fetch_us=fetched["ns"] / max(fetched["calls"], 1) / 1e3, lock_wait_s=lock_wait_s,
        launch_windows_calls=calls["launch_windows"][0],
        tail_retires=tails3, inject_waits=inject_waits, slot_waits=m3["slot_waits"],
        decide_shapes=shapes_line(shapes3), scan_paths=paths3,
        scan_path_shapes=path_shapes3, group_check_shapes=shapes_line(group_shapes),
        group_check_paths=group_paths, group_check_path_shapes=group_path_shapes,
        keys=len(gk))
    tlog(f"  equal answers (4 card runs, depth 1 CPU) and equal rows at all {len(gk)} keys; "
         f"object path, runs in turns ({PIPE_DEPTH}, 1, 1, {PIPE_DEPTH}): depth {PIPE_DEPTH} "
         + ", ".join(f"{r:,.0f}" for r in rates[PIPE_DEPTH]) + " decisions/s, depth 1 "
         + ", ".join(f"{r:,.0f}" for r in rates[1]) + f" decisions/s (CPU twin "
         f"{mc['n_req'] / mc['s']:,.0f}/s); {m3['n_req']} requests timed a run, the first "
         f"{TRACED_SUBS} submissions traced apart")
    tlog(f"  device busy {busy} of the traced stretch's wall time ({m3['traced_s']:.3f} s)")
    tlog(f"  host us per launch_windows {launch_us:.1f} ({calls['launch_windows'][0]} calls, "
         f"leftover tails included: {tails3['calls']} tails, {tails3['requests']} requests, "
         f"{tails3['ns'] / 1e9:.3f} s; {launch_tail_free_us:.1f} without them), per "
         f"collect_windows {collect_us:.1f} (first depth-{PIPE_DEPTH} run), of which the "
         f"slot's event wait and copy-out {fetched['ns'] / max(fetched['calls'], 1) / 1e3:.1f} "
         f"({fetched['calls']} fetches); engine-lock waits by thread (s) "
         f"{json.dumps(lock_wait_s)}")
    tlog(f"  combiner stats {json.dumps(st)}; slot refills that waited {m3['slot_waits']}; "
         f"windows that waited on the inject staging {inject_waits}")
    tlog(f"  decide launches by format, form, K and W (depth {PIPE_DEPTH} run): "
         f"{json.dumps(shapes_line(shapes3))}")
    tlog(f"  scan launches by path (depth {PIPE_DEPTH} run): {json.dumps(paths3)} "
         f"{json.dumps(path_shapes3)}")
    tlog(f"  group checks (distinct keys, launch behind a busy card, each still pending "
         f"when launch_windows returned; equal to the CPU twin): {json.dumps(group_paths)} "
         f"{json.dumps(group_path_shapes)}")

    # 4. columnar: COL_WINDOWS windows as wire columns, depth 3 and 1 on the card
    # against lock-step submit_columnar / complete_columnar on the CPU
    reqs = flat[:COL_WINDOWS * WINDOW]
    col_now = NOW + 10_000
    twin = Engine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    want_cols, twin_s = columnar_loop(twin, reqs, col_now, 0)
    tk, tr = rows_by_key(twin)
    col = {PIPE_DEPTH: [], 1: []}
    for depth in (PIPE_DEPTH, 1, 1, PIPE_DEPTH):
        eng = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
        eng.warmup()
        dk.reset_launch_counts()
        rowk.reset_launch_counts()
        got_cols, secs = columnar_loop(eng, reqs, col_now, depth)
        add(dk.launch_counts)
        add(rowk.launch_counts)
        for g, w_ in zip(got_cols, want_cols):
            check(np.array_equal(g, w_), f"columnar depth {depth}: card and CPU twin "
                  "answer differently")
        ek, er = rows_by_key(eng)
        check(ek == tk and torch.equal(er, tr), f"columnar depth {depth}: tables differ")
        col[depth].append(len(reqs) / secs)
        del eng
        torch.cuda.empty_cache()
    out.update(columnar_requests=len(reqs),
               columnar_decisions_per_s_depth3=float(np.mean(col[PIPE_DEPTH])),
               columnar_decisions_per_s_depth1=float(np.mean(col[1])),
               columnar_decisions_per_s_runs=col,
               columnar_cpu_twin_decisions_per_s=len(reqs) / twin_s, launches=launches)
    tlog(f"  columnar ({len(reqs)} requests), runs in turns ({PIPE_DEPTH}, 1, 1, "
         f"{PIPE_DEPTH}), staging allocated before the clock: equal answers and rows; depth "
         f"{PIPE_DEPTH} " + ", ".join(f"{r:,.0f}" for r in col[PIPE_DEPTH])
         + " decisions/s, depth 1 " + ", ".join(f"{r:,.0f}" for r in col[1])
         + f" decisions/s (CPU twin lock-step {len(reqs) / twin_s:,.0f}/s); phase 6 "
         f"launches {launches}")
    del cpu, twin
    return launches


# ----------------------------------------------------------------- phase 7

SNAP_KEYS = 10_000_000  # buckets in phase 7a's snapshot file
SNAP_NOW = 4_000_000_000_000  # tests/test_snapshot_scale.py's far-future epoch
SNAP_EXPIRED_EVERY = 16  # every 16th bucket of the file expired long ago
SNAP_FILE_ROWS = 1 << 18  # rows per chunk of the stimulus file
STORE_WINDOWS = 8  # phase 3's windows the Store path takes: 65,536 requests
STORE_HELD = 100_000  # the hottest keys, whose buckets the Stores hold at the start
HOST_READ_KEYS = 1000  # keys of phase 7c's host-state reads
LINK_BYTES = 1 << 30  # each page-locked copy the link's rates are read from


class Timed:
    """Host seconds spent in wrapped callables and iterators, by name."""

    def __init__(self):
        self.s, self.n, self.each = {}, {}, {}

    def _add(self, name, d, keep):
        self.s[name] = self.s.get(name, 0.0) + d
        self.n[name] = self.n.get(name, 0) + 1
        if keep:
            self.each.setdefault(name, []).append(d)

    def wrap(self, name, fn, keep=False):
        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self._add(name, time.perf_counter() - t, keep)

        return timed

    def iterate(self, name, items):
        """`items`, with the time each next() takes added to `name`."""
        it = iter(items)
        while True:
            t = time.perf_counter()
            try:
                x = next(it)
            except StopIteration:
                self._add(name, time.perf_counter() - t, False)
                return
            self._add(name, time.perf_counter() - t, False)
            yield x


def link_rates(dev):
    """The page-locked host <-> card copy rates in bytes/s, each the best of
    three copies of LINK_BYTES timed with CUDA events."""
    host = torch.empty(LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(LINK_BYTES, dtype=torch.uint8, device=dev)
    rates = {}
    for name, dst, src in (("h2d", card, host), ("d2h", host, card)):
        best = None
        for _ in range(3):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            dst.copy_(src, non_blocking=True)
            e1.record()
            e1.synchronize()
            ms = e0.elapsed_time(e1)
            best = ms if best is None else min(best, ms)
        rates[name] = LINK_BYTES / (best / 1e3)
    del host, card
    torch.cuda.empty_cache()
    tlog(f"  link, page-locked, {LINK_BYTES:,} bytes a copy (best of 3, CUDA events): "
         f"host to card {rates['h2d'] / 1e9:.3f} GB/s, card to host "
         f"{rates['d2h'] / 1e9:.3f} GB/s")
    return rates


def synthetic_slabs(seed, n, chunk):
    """n buckets in tests/test_snapshot_scale.py _synthetic's shape, made in
    numpy from `seed`: keys ss_<i>, token or leaky, limit 1000, remaining
    and status drawn, duration one hour, stamp SNAP_NOW - 1000, expiry
    SNAP_NOW but every SNAP_EXPIRED_EVERY-th long ago; as (key_blob,
    offsets, rows) chunks of `chunk` rows, the binary Loader's shape."""
    rng = np.random.default_rng(seed + 7)
    for a in range(0, n, chunk):
        i = np.arange(a, min(a + chunk, n), dtype=np.int64)
        m = len(i)
        blob = "".join(map("ss_{}".format, range(a, a + m))).encode()
        lens = np.full(m, 4, np.int64)  # "ss_" and the first digit
        for p in range(1, 10):
            lens += i >= 10 ** p
        off = np.zeros(m + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        rows = np.empty((m, 7), np.int64)
        rows[:, 0] = rng.integers(0, 2, m)
        rows[:, 1] = 1000
        rows[:, 2] = rng.integers(4, 1001, m)
        rows[:, 3] = 3_600_000
        rows[:, 4] = SNAP_NOW - 1000
        rows[:, 5] = np.where(i % SNAP_EXPIRED_EVERY == 0, 1000, SNAP_NOW)
        rows[:, 6] = rng.random(m) < 1 / 997
        yield blob, off, rows


def check_row_launches(what, want_injects):
    """The row kernels a persistence run launched: every inject through the
    pinned entry point (the engine's inject staging), `want_injects` of
    them when given, and no gather."""
    launches, pinned = dict(rowk.launch_counts), dict(rowk.pinned_counts)
    check(launches["inject_rows"] > 0 and pinned["inject_rows"] == launches["inject_rows"],
          f"{what}: {launches['inject_rows']} inject launches, {pinned['inject_rows']} "
          "through the pinned entry point")
    if want_injects is not None:
        check(launches["inject_rows"] == want_injects,
              f"{what}: {launches['inject_rows']} inject launches for {want_injects} chunks")
    check(launches["gather_rows"] == 0, f"{what} gathered rows")
    return launches


def persistence_at_scale(seed, dev, rates, tmp, results):
    """Phase 7a: restore SNAP_KEYS buckets from a binary snapshot file on
    the card and on the CPU (equal tables), snapshot the card engine into a
    second file (equal, slab for slab, to the CPU twin's stream), restore
    that file into a fresh card engine (equal rows at every live key).
    Returns the inject launches of the two card restores."""
    first, second = os.path.join(tmp, "stimulus.snap"), os.path.join(tmp, "card.snap")
    t = time.perf_counter()
    BinarySnapshotLoader(first).save_slabs(synthetic_slabs(seed, SNAP_KEYS, SNAP_FILE_ROWS))
    gen_s = time.perf_counter() - t
    size = os.path.getsize(first)
    n_live = SNAP_KEYS - (SNAP_KEYS + SNAP_EXPIRED_EVERY - 1) // SNAP_EXPIRED_EVERY
    tlog(f"  stimulus: {SNAP_KEYS:,} buckets ({SNAP_KEYS - n_live:,} expired) in a "
        f"{size:,}-byte file, made and written in {gen_s:.2f} s")

    # restore on the card
    gpu = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    tr = Timed()
    gpu.directory.lookup_raw = tr.wrap("lookup_raw", gpu.directory.lookup_raw)
    gpu._apply_inject_rows = tr.wrap("inject", gpu._apply_inject_rows)
    chunks = sum(-(-min(SNAP_FILE_ROWS, SNAP_KEYS - a) // WINDOW)
                 for a in range(0, SNAP_KEYS, SNAP_FILE_ROWS))
    torch.cuda.synchronize()
    rowk.reset_launch_counts()
    t = time.perf_counter()
    n = gpu.load_snapshot_slabs(tr.iterate("file_read", BinarySnapshotLoader(first).load_slabs()))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    launches = check_row_launches("the card restore", chunks)
    check(n == SNAP_KEYS and gpu.key_count() == SNAP_KEYS,
          f"the card restore took {n} rows, {gpu.key_count()} keys")
    rest_s = restore_s - tr.s["lookup_raw"] - tr.s["inject"] - tr.s["file_read"]
    tlog(f"  restore on the card (load_snapshot_slabs): {restore_s:.3f} s, "
         f"{SNAP_KEYS / restore_s:,.0f} rows/s; {chunks} chunks of <= {WINDOW} rows, "
         f"{launches['inject_rows']} inject launches, all pinned")
    tlog(f"  restore split: file read {tr.s['file_read']:.3f} s, lookup_raw "
         f"{tr.s['lookup_raw']:.3f} s ({tr.s['lookup_raw'] / chunks * 1e6:.1f} us a chunk), "
         f"inject {tr.s['inject']:.3f} s ({tr.s['inject'] / chunks * 1e6:.1f} us a chunk on "
         f"the host clock), the rest (slicing, staging fill, lock) {rest_s:.3f} s")

    # the CPU twin
    cpu = Engine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    t = time.perf_counter()
    cpu.load_snapshot_slabs(BinarySnapshotLoader(first).load_slabs())
    twin_restore_s = time.perf_counter() - t
    check(torch.equal(gpu.state.cpu(), cpu.state), "the restored tables differ")
    tlog(f"  the card's table equals the CPU twin's ({twin_restore_s:.3f} s to restore on the CPU)")

    # snapshot on the card, streamed into the second file
    ts = Timed()
    gpu._read_slab = ts.wrap("slab", gpu._read_slab, keep=True)
    gpu.directory.items_raw = ts.wrap("items_raw", gpu.directory.items_raw)
    gpu.directory.peek_slots_raw = ts.wrap("peek_slots_raw", gpu.directory.peek_slots_raw)
    t = time.perf_counter()
    BinarySnapshotLoader(second).save_slabs(ts.iterate("stream", gpu.snapshot_slabs()))
    snap_s = time.perf_counter() - t
    split = dict(ts.s)  # the checks below peek through the same wrapper
    write_s = snap_s - split["stream"]
    filter_s = split["stream"] - split["slab"] - split["items_raw"] - split["peek_slots_raw"]
    S = len(gpu._slab.rows_np)
    check(gpu._slab.reads == ts.n["slab"] > 0,
          f"{ts.n['slab']} slab reads, {gpu._slab.reads} through the page-locked slab")
    slab_ms = [d * 1e3 for d in ts.each["slab"]]
    steady = slab_ms[1:] or slab_ms
    slab_bound = 8 * rowk.ROW_FIELDS * S / rates["d2h"] * 1e3
    # the copy alone on the device timeline: 20 slabs back to back
    slab_dev_ms = event_ms(lambda i: gpu._slab.rows.copy_(
        gpu.state.narrow(0, i * S % (CAPACITY - S), S), non_blocking=True), 20)
    size2 = os.path.getsize(second)
    tlog(f"  snapshot on the card (snapshot_slabs into save_slabs): {snap_s:.3f} s, "
         f"{n_live / snap_s:,.0f} rows/s, a {size2:,}-byte file")
    tlog(f"  snapshot split: items_raw {split['items_raw']:.3f} s; {ts.n['slab']} slab copies of "
         f"{S:,} rows, {split['slab']:.3f} s ({np.mean(steady):.4f} ms a slab after the "
         f"first on the host clock, copy and wait, {slab_ms[0]:.4f} ms the first with its "
         f"allocation; the copy alone {slab_dev_ms:.4f} ms on the device timeline, 20 back "
         f"to back; bound {slab_bound:.4f} ms at the measured card-to-host rate); "
         f"peek_slots_raw "
         f"{split['peek_slots_raw']:.3f} s; argsort, numpy filter and key gather "
         f"{filter_s:.3f} s; file write {write_s:.3f} s")

    # the CPU twin's stream equals the card's, as save_slabs wrote it
    n_slabs = n_rows = 0
    for twin, card in itertools.zip_longest(cpu.snapshot_slabs(),
                                            BinarySnapshotLoader(second).load_slabs()):
        check(twin is not None and card is not None,
              f"the card's and the twin's snapshots differ in length at slab {n_slabs}")
        check(bytes(twin[0]) == bytes(card[0]) and np.array_equal(twin[1], card[1])
              and np.array_equal(twin[2], card[2]), f"snapshot slab {n_slabs} differs")
        n_slabs += 1
        n_rows += len(card[1]) - 1
    check(n_rows == n_live, f"the snapshot holds {n_rows} rows, {n_live} live")
    log(f"  the CPU twin's slab stream equals the card's: {n_slabs} slabs, {n_rows:,} rows")
    del cpu

    # re-restore the card's file into a fresh card engine
    rowk.reset_launch_counts()
    t = time.perf_counter()
    gpu2 = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW,
                  loader=BinarySnapshotLoader(second))
    torch.cuda.synchronize()
    rerestore_s = time.perf_counter() - t
    again = check_row_launches("the re-restore", None)
    blob, off, slots2 = gpu2.directory.items_raw()
    slots1 = gpu.directory.peek_slots_raw(blob, off)
    check(len(slots2) == n_live and bool((slots1 >= 0).all()),
          f"the re-restored engine holds {len(slots2)} keys, "
          f"{int((slots1 < 0).sum())} unknown to the first")
    rows1 = gpu.state[torch.from_numpy(slots1.astype(np.int64)).to(dev)]
    rows2 = gpu2.state[torch.from_numpy(slots2.astype(np.int64)).to(dev)]
    check(torch.equal(rows1, rows2), "the re-restored rows differ from the first engine's")
    tlog(f"  re-restore of the card's file (Engine(loader=...)): {rerestore_s:.3f} s with the "
         f"table's allocation, {n_live / rerestore_s:,.0f} rows/s; rows equal at all "
         f"{n_live:,} live keys; {again['inject_rows']} inject launches, all pinned")
    results["persistence"] = dict(
        keys=SNAP_KEYS, live=n_live, file_bytes=size, snapshot_bytes=size2,
        stimulus_s=gen_s, restore_s=restore_s, restore_rows_per_s=SNAP_KEYS / restore_s,
        restore_split_s=dict(tr.s), restore_chunks=chunks, twin_restore_s=twin_restore_s,
        snapshot_s=snap_s, snapshot_rows_per_s=n_live / snap_s,
        snapshot_split_s=dict(split, filter=filter_s, write=write_s),
        slab_rows=S, slab_reads=ts.n["slab"], slab_ms=slab_ms,
        slab_steady_ms=float(np.mean(steady)), slab_device_ms=slab_dev_ms,
        slab_bound_ms=slab_bound,
        rerestore_s=rerestore_s, link_bytes_per_s=rates,
        inject_launches=launches["inject_rows"] + again["inject_rows"])
    del gpu, gpu2, rows1, rows2
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] + again[k] for k in INJECT_KEYS}


def held_buckets(seed, key_cfg):
    """The buckets a Store holds for the STORE_HELD hottest keys of phase 3's
    stream (Zipf rank k is key k) before 7b: drawn from `seed`, on each
    key's own configuration, one in 50 on the other algorithm, some
    expired."""
    algo, limit, dur = key_cfg
    rng = np.random.default_rng(seed + 9)
    k = np.arange(STORE_HELD)
    flip = rng.random(STORE_HELD) < 0.02
    remaining = rng.integers(0, limit[k] + 1)
    stamp = SNAP_NOW - rng.integers(0, 2 * dur[k])
    return [BucketSnapshot(key=f"api_k{i}", algo=int(algo[i] ^ f), limit=int(limit[i]),
                           remaining=int(r), duration=int(dur[i]), stamp=int(st),
                           expire_at=int(st + dur[i]), status=int(r == 0))
            for i, f, r, st in zip(k.tolist(), flip.tolist(), remaining.tolist(),
                                   stamp.tolist())]


def store_path(seed, dev, results):
    """Phase 7b: phase 3's first STORE_WINDOWS windows through a card engine
    with a MockStore and a CPU twin with its own, both holding the same
    buckets at the start; the clock is SNAP_NOW + 50 ms a window, so the
    rows are live for 7c's reads. Returns the engines and the launches."""
    batches, key_cfg = request_stream(seed, STORE_WINDOWS)
    held = held_buckets(seed, key_cfg)
    stores = (MockStore(), MockStore())
    for st in stores:
        st.data.update((b.key, dataclasses.replace(b)) for b in held)
    gpu = Engine(device=dev, capacity=CAPACITY, store=stores[0], min_width=64,
                 max_width=WINDOW)
    cpu = Engine(device="cpu", capacity=CAPACITY, store=stores[1], min_width=64,
                 max_width=WINDOW)
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    gpu_s = cpu_s = 0.0
    for i, (_keys, batch) in enumerate(batches):
        now = SNAP_NOW + i * 50
        t = time.perf_counter()
        got = gpu.get_rate_limits(batch, now_ms=now)
        gpu_s += time.perf_counter() - t
        t = time.perf_counter()
        want = cpu.get_rate_limits(batch, now_ms=now)
        cpu_s += time.perf_counter() - t
        check(resp_tuples(got) == resp_tuples(want),
              f"Store window {i}: card and CPU engines answer differently")
    launches = {**dk.launch_counts, **rowk.launch_counts}
    pinned = dict(rowk.pinned_counts)
    check(launches["inject_rows"] > 0 and pinned["inject_rows"] == launches["inject_rows"],
          f"the Store path's injects: {launches['inject_rows']}, pinned {pinned['inject_rows']}")
    check(launches["gather_rows"] > 0 and pinned["gather_rows"] == launches["gather_rows"],
          f"the Store path's gathers: {launches['gather_rows']}, pinned {pinned['gather_rows']}")
    check(sum(dk.launch_counts.values()) > 0, "the Store path launched no decide")
    check({k: dataclasses.astuple(v) for k, v in stores[0].data.items()}
          == {k: dataclasses.astuple(v) for k, v in stores[1].data.items()},
          "the Stores' contents differ")
    check(stores[0].called == stores[1].called,
          f"Store calls differ: card {stores[0].called}, CPU {stores[1].called}")
    keys_g, rows_g = rows_by_key(gpu)
    keys_c, rows_c = rows_by_key(cpu)
    check(keys_g == keys_c and torch.equal(rows_g, rows_c), "the Store path's rows differ")
    n_req = sum(len(b) for _, b in batches)
    stage_s = {s: ns / 1e9 for s, ns in gpu.stats.stage_ns.items()}
    tlog(f"  Store path: {n_req:,} requests in {gpu_s:.3f} s, {n_req / gpu_s:,.0f} "
         f"decisions/s (CPU twin {n_req / cpu_s:,.0f}/s); answers, Store contents, "
         f"Store calls {stores[0].called} and rows at all {len(keys_g):,} keys equal")
    tlog(f"  Store path stage seconds: " + ", ".join(f"{s} {v:.3f}" for s, v in stage_s.items())
         + f"; launches {launches} (injects and gathers all pinned)")
    results["store_path"] = dict(requests=n_req, decisions_per_s=n_req / gpu_s,
                                 cpu_decisions_per_s=n_req / cpu_s, stage_s=stage_s,
                                 store_calls=dict(stores[0].called), keys=len(keys_g),
                                 launches=dict(launches))
    return gpu, cpu, launches


def host_reads(gpu, cpu, results):
    """Phase 7c: rows_for_keys, device_hit_counts and resolve_slots at
    HOST_READ_KEYS keys (a few of them absent) on 7b's engines."""
    keys = [k for k, _ in sorted(gpu.directory.items())[:HOST_READ_KEYS - 10]]
    keys += [f"api_absent{i}" for i in range(10)]
    out = {}
    t = time.perf_counter()
    found, rows = gpu.rows_for_keys(keys)
    out["rows_for_keys_ms"] = (time.perf_counter() - t) * 1e3
    want_found, want_rows = cpu.rows_for_keys(keys)
    check(found == want_found and len(found) > 0 and np.array_equal(rows, want_rows),
          f"rows_for_keys differs ({len(found)} found on the card, {len(want_found)} on the CPU)")
    t = time.perf_counter()
    hits = gpu.device_hit_counts(keys)
    out["device_hit_counts_ms"] = (time.perf_counter() - t) * 1e3
    check(hits == cpu.device_hit_counts(keys) and len(hits) == HOST_READ_KEYS - 10,
          "device_hit_counts differs")
    slots = [gpu.directory.peek_slot(k) for k in keys]
    t = time.perf_counter()
    names = gpu.resolve_slots(slots)
    out["resolve_slots_ms"] = (time.perf_counter() - t) * 1e3
    check(names == cpu.resolve_slots(slots) and len(names) == HOST_READ_KEYS - 10,
          "resolve_slots differs")
    tlog(f"  host-state reads at {HOST_READ_KEYS} keys equal the twin's ({len(found)} live "
         f"rows): rows_for_keys {out['rows_for_keys_ms']:.3f} ms, device_hit_counts "
         f"{out['device_hit_counts_ms']:.3f} ms, resolve_slots {out['resolve_slots_ms']:.3f} ms")
    results["host_reads"] = out


def phase_persistence(seed, dev, results):
    log(f"== phase 7: persistence at {SNAP_KEYS:,} keys on Engine(capacity={CAPACITY}): "
        "binary restore, streamed snapshot and re-restore against a CPU twin; the Store "
        f"path on {STORE_WINDOWS} windows of phase 3's stream; the host-state reads")
    t0 = time.perf_counter()
    rates = link_rates(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_snap_")
    try:
        restore_injects = persistence_at_scale(seed, dev, rates, tmp, results)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gpu, cpu, launches = store_path(seed, dev, results)
    host_reads(gpu, cpu, results)
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in restore_injects.items():
        launches[k] += n
    tlog(f"  phase 7 in {time.perf_counter() - t0:.1f} s")
    return launches

# ----------------------------------------------------------------- phase 8

PROBE_W = (64, 1024, WINDOW)  # 8a's probe widths: the engine's buckets
PROBE_SMALL_C = (5, 16)  # wrapped and repeated candidates
SOLID = 4096  # 8a's region filled solid, its first half stamped this batch
DEVDIR_WINDOWS = PIPE_WINDOWS  # 8b: phase 3's first 24 windows, 196,608 requests
PRESSURE_WIDTH = 256  # 8c's windows
# 8c's (positions, windows): the 65,536 the device directory was sized at,
# about a third full on this stream, and 8,192, full, where claims evict
PRESSURE_RUNS = ((65_536, 320), (8_192, 80))
INTERNED_WINDOWS = 8  # 8d: phase 3's first 8 windows as wire columns
CONTENTION = "device directory contention: probe window exhausted after retries"


def devdir_columns(seed, C, now, dev):
    """fps and touch i64[C] made on the card from `seed`: about half the
    positions occupied, each by a key whose probe window holds it (so a
    probe of that key matches), stamps below `now`, and a region of SOLID positions
    (fewer when C is smaller) every one occupied, its first half stamped
    `now`. Returns fps, touch and the region's positions (host)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    def keys_at(pos):
        # a key whose probe starts 0-3 positions before `pos`, as a probe
        # would have placed it
        back = torch.randint(0, 4, pos.shape, generator=g, device=dev)
        span = torch.randint(1, 1 << 38, pos.shape, generator=g, device=dev)
        return (pos - back) % C + C * span

    occ = torch.rand(C, generator=g, device=dev) < 0.5
    fps = keys_at(torch.arange(C, device=dev)) * occ
    touch = torch.randint(0, now, (C,), generator=g, device=dev)
    n = min(C, SOLID)
    lo = int(torch.randint(0, C, (1,), generator=g, device=dev))
    solid = (lo + torch.arange(n, device=dev)) % C
    fps[solid] = keys_at(solid)
    touch[solid[: n // 2]] = now
    return fps, touch, solid.cpu().numpy()


def probe_hashes(rng, fps, solid, W):
    """i64[W] probe hashes on the card: a fifth each of matches of occupied
    positions, new keys (first empties), keys based in the solid region
    (evictions; no victim where all 16 candidates lie in its stamped half),
    distinct keys of one base (in-batch contention), and padding or new
    keys."""
    C = fps.shape[0]
    kind = rng.integers(0, 5, W)
    pos = torch.from_numpy(rng.integers(0, C, 4 * W)).to(fps.device)
    live = fps[pos].cpu().numpy()
    live = live[live != 0]
    h = rng.integers(1, 1 << 62, W)
    span = 1 << 38  # C * span stays below 2^63 at C = 10,000,001
    for k, vals in ((0, lambda n: rng.choice(live, n)),
                    (2, lambda n: rng.choice(solid, n) + C * rng.integers(1, span, n)),
                    (3, lambda n: int(rng.integers(0, C)) + C * rng.integers(1, span, n))):
        m = kind == k
        if m.any() and (k != 0 or live.size):
            h[m] = vals(int(m.sum()))
    h[(kind == 4) & (rng.random(W) < 0.5)] = 0
    return torch.from_numpy(h.astype(np.int64)).to(fps.device)


def probe_bound(fps_before, h, won, evict, staged):
    """The probe's bound for one call, as it is timed: the hashes read, the
    outputs written (slot, fresh and retry, and the staging's rows 0 and 8
    when `staged`), the 16 candidate fingerprints of each active lane and a
    fingerprint a winner; with eviction also the 16 candidate stamps of each
    lane with no match and no empty, a stamp a match and a stamp a winner
    (this call's data, not the most it could need; the kernel's own scratch
    is not counted). Bytes bind."""
    C, W = fps_before.shape[0], h.shape[0]
    cand = fps_before[ddk._candidates(C, h)]
    active = h != 0
    matched = ((cand == h[:, None]) & active[:, None]).any(1)
    victim = active & ~matched & ~(cand == 0).any(1)
    n_bytes = (W * (8 + 4 + 1 + 1 + (16 if staged else 0)) + int(active.sum()) * 128
               + int(won) * 8)
    if evict:
        n_bytes += int(victim.sum()) * 128 + int(matched.sum()) * 8 + int(won) * 8
    b_ms, b_by = bound_ms(n_bytes, int(active.sum()) * ddk.PROBE_DEPTH * 4)
    return dict(bytes=n_bytes, bound_ms=b_ms, bound_by=b_by, active=int(active.sum()),
                matched=int(matched.sum()), victim_lanes=int(victim.sum()))


def hold_probe(fk, tk, fp, tp, h, seq, evict, what, errs):
    """One probe through the kernel (with a staging) and the plain version
    on twin columns: slot, fresh, retry, both columns and the staging's
    rows 0 and 8 bit-equal, or the run fails. Returns the winners and the
    kernel's outputs."""
    name = "probe_assign_evict" if evict else "probe_assign"
    W = h.shape[0]
    if evict:
        pk = torch.zeros((9, W), dtype=torch.int64, device=h.device)
        got = ddk.probe_cuda(fk, tk, h, seq, pk)
        want = ddk.probe_assign_evict_plain(fp, tp, h, seq)
        check(torch.equal(pk[0], want[0].long()) and torch.equal(pk[8], want[1].long()),
              f"{what}: the staging's slot and fresh rows differ")
    else:
        got = ddk.probe_cuda(fk, None, h, seq)[:2]
        want = ddk.probe_assign_plain(fp, h)
    torch.cuda.synchronize()
    errs[name] = max(errs.get(name, 0), max_abs_err(fk, fp),
                     *(max_abs_err(a, b) for a, b in zip(got, want)),
                     max_abs_err(tk, tp) if evict else 0)
    for a, b, field in zip(got, want, ("slot", "fresh", "retry")):
        check(torch.equal(a, b), f"{what}: {field} differs")
    check(torch.equal(fk, fp), f"{what}: fingerprints differ")
    check(not evict or torch.equal(tk, tp), f"{what}: stamps differ")
    return int(want[1].sum()), got


ORDERING_C = (CAPACITY, 4096, *PROBE_SMALL_C)  # 4096: every window overlaps at B = 8192
ORDERING_B = (64, WINDOW)


def ordering_probes(seed, dev, errs):
    """8a: the ordering stimuli (ops/devdir.py ordering_stimulus, the
    tests' differential's own) through the kernel and the plain version, at
    every C of ORDERING_C and B of ORDERING_B, both lane orders (flip), with
    and without eviction: bit-equal (hold_probe). At C >= 4096 the
    structures hold on the kernel's outputs: a lane whose oldest candidate
    another lane matches takes its second oldest (retries without
    eviction); of four keys claiming one empty position the highest lane
    wins; a lane loses its claim to a higher lane whose window shares only
    that position. Returns the probes held."""
    n = 0
    for C in ORDERING_C:
        for B in ORDERING_B:
            for flip in (False, True):
                st = ddk.ordering_stimulus(C, B, 1000, seed=seed + C + B + int(flip), flip=flip)
                h = torch.from_numpy(st.hashes).to(dev)
                for evict in (True, False):
                    fk = torch.from_numpy(st.fps).to(dev, copy=True)
                    tk = torch.from_numpy(st.touch).to(dev, copy=True)
                    fp, tp = fk.clone(), tk.clone()
                    what = (f"ordering {'probe_assign_evict' if evict else 'probe_assign'} "
                            f"C={C} B={B} flip={flip}")
                    _won, got = hold_probe(fk, tk, fp, tp, h, st.seq, evict, what, errs)
                    n += 1
                    del fk, tk, fp, tp
                    if C < 4096:
                        continue
                    slot, fresh = got[0].cpu().numpy(), got[1].cpu().numpy()
                    for x, y, q, second in st.cases["victim"]:
                        check(slot[y] == q and (int(slot[x]), bool(fresh[x]))
                              == ((second, True) if evict else (-1, False)),
                              f"{what}: lane {x} against lane {y}'s match of its oldest "
                              f"candidate {q}: slots {slot[x]}, {slot[y]}")
                    claimers, pos = st.cases["contention"]
                    check([int(slot[i]) for i in claimers] == [-1, -1, -1, pos],
                          f"{what}: claims of position {pos}: {[int(slot[i]) for i in claimers]}")
                    a, b, p = st.cases["window_loss"]
                    check((int(slot[a]), int(slot[b])) == (-1, p),
                          f"{what}: lanes {a} < {b} claiming {p}: slots {slot[a]}, {slot[b]}")
    return n


def devdir_kernels(seed, dev, errs, results):
    """8a: the probe (with and without eviction) and the sweep against their
    plain versions, bit-equal, then timed."""
    rng = np.random.default_rng(seed + 8)
    recs = []
    seq = 1000
    index = dev.index or 0
    flush = l2_flush(dev)
    for C in (CAPACITY, *PROBE_SMALL_C):
        fk, tk, solid = devdir_columns(seed, C, seq + 1, dev)
        fp, tp = fk.clone(), tk.clone()
        for W in PROBE_W if C == CAPACITY else (64, 1024):
            for evict in (True, False):
                name = "probe_assign_evict" if evict else "probe_assign"
                seq += 1
                h = probe_hashes(rng, fk, solid, W)
                before = fk.clone() if C == CAPACITY else None
                won, _got = hold_probe(fk, tk, fp, tp, h, seq, evict,
                                       f"{name} C={C} W={W}", errs)
                if C != CAPACITY:
                    continue
                bound = probe_bound(before, h, won, evict, staged=evict)  # as run_k runs
                del before
                hs = [probe_hashes(rng, fk, solid, W) for _ in range(16)]
                pk = torch.zeros((9, W), dtype=torch.int64, device=dev)
                base = seq

                def run_k(i):
                    if evict:
                        ddk.probe_cuda(fk, tk, hs[i % 16], base + 1 + i, pk)
                    else:
                        ddk.probe_cuda(fk, None, hs[i % 16], 0)

                def run_p(i):
                    if evict:
                        ddk.probe_assign_evict_plain(fp, tp, hs[i % 16], base + 1 + i)
                    else:
                        ddk.probe_assign_plain(fp, hs[i % 16])

                call_ms = event_ms(run_k, 64)
                ms = profiled_ms(run_k, 32, "probe_", per_call=True)
                cold_ms = profiled_ms(run_k, 32, "probe_", per_call=True, flush_each=flush)
                grid, threads = ddk.probe_grid(index, W, evict)
                floor_ms = profiled_ms(lambda i: ddk.probe_floor_cuda(index, W, evict), 32,
                                       "probe_empty", flush_each=flush)
                barrier_ms = profiled_ms(lambda i: ddk.probe_floor_cuda(index, W, evict, True),
                                         32, "probe_empty", flush_each=flush)
                plain_ms = event_ms(run_p, 8)
                seq = base + 200
                fp.copy_(fk)  # the timing runs moved the two apart
                tp.copy_(tk)
                rec = dict(kernel=name, C=C, W=W, ms=ms, cold_ms=cold_ms, floor_ms=floor_ms,
                           barrier_ms=barrier_ms, grid=grid, threads=threads, call_ms=call_ms,
                           plain_ms=plain_ms,
                           winners=won, **bound)
                recs.append(rec)
                tlog(f"  {name:18s} C={C} W={W:5d}: bit-equal ({bound['active']} active, "
                     f"{bound['matched']} matched, {won} claims won, {bound['victim_lanes']} "
                     f"lanes with neither match nor empty); kernel {fms(ms)} ms on the device "
                     f"warm, {fms(cold_ms)} cold (L2 flushed before every launch; one "
                     f"cooperative launch of {grid} blocks of {threads}; the empty kernel "
                     f"launched so {fms(floor_ms)}, with the two barriers {fms(barrier_ms)}, "
                     f"cold), "
                     f"{call_ms:.4f} ms per wrapper call; plain "
                     f"{plain_ms:.4f} ms; bound {bound['bound_ms']:.6f} ms ({bound['bound_by']})")
        log(f"  probe at C={C}: every width bit-equal, with and without eviction")
        del fk, tk, fp, tp
    n = ordering_probes(seed, dev, errs)
    log(f"  ordering stimuli: {n} probes at C in {ORDERING_C}, B in {ORDERING_B}, both lane "
        "orders, with and without eviction: bit-equal; at C >= 4096 every structure held "
        "(matches stamped before victims, the highest claimer winning)")
    del flush
    # the sweep, on a populated table
    table = populate_table(CAPACITY, seed, dev)
    fk, _tk, _solid = devdir_columns(seed + 1, CAPACITY, NOW, dev)
    fp = fk.clone()
    ddk.refresh_cuda(fk, table, NOW)
    ddk.refresh_vacancies_plain(fp, table, NOW)
    torch.cuda.synchronize()
    errs["refresh_vacancies"] = max_abs_err(fk, fp)
    check(torch.equal(fk, fp), "refresh_vacancies: fingerprints differ")
    cleared = int((fp == 0).sum())
    # every timed sweep writes the fingerprint of each dead row again
    dead = int(((table[:, dk.ROW_ALGO] < 0) | (NOW > table[:, dk.ROW_EXPIRE])).sum())
    ms, ms_source = kernel_ms(lambda i: ddk.refresh_cuda(fk, table, NOW), 16, "refresh_kernel")
    call_ms = event_ms(lambda i: ddk.refresh_cuda(fk, table, NOW), 32)
    plain_ms = event_ms(lambda i: ddk.refresh_vacancies_plain(fp, table, NOW), 8)
    # both 32-byte sectors of each 64-byte row are read; fps is only written
    n_bytes = CAPACITY * 64 + dead * 8
    b_ms, b_by = bound_ms(n_bytes, CAPACITY * 4)
    recs.append(dict(kernel="refresh_vacancies", C=CAPACITY, W=None, ms=ms, ms_source=ms_source,
                     call_ms=call_ms,
                     plain_ms=plain_ms, bytes=n_bytes, bound_ms=b_ms, bound_by=b_by,
                     cleared=cleared, dead_rows=dead))
    tlog(f"  refresh_vacancies C={CAPACITY}: bit-equal ({cleared} fingerprints 0 after, "
         f"{dead} rows vacant or expired); "
         f"kernel {fms(ms)} ms on the device ({ms_source}), {call_ms:.4f} ms per wrapper "
         f"call; plain {plain_ms:.4f} ms; bound {b_ms:.6f} ms ({b_by})")
    lib_ms = profiled_ms(lambda i: torch.count_nonzero(fk), 16)
    lib_call = event_ms(lambda i: torch.count_nonzero(fk), 32)
    results["key_count_library"] = dict(call="torch.count_nonzero", C=CAPACITY, ms=lib_ms,
                                        call_ms=lib_call)
    tlog(f"  key_count's torch.count_nonzero over {CAPACITY} fingerprints: {fms(lib_ms)} ms "
         f"on the device, {lib_call:.4f} ms per call")
    del table, fk, fp
    torch.cuda.empty_cache()
    return recs


def counted_dispatch(eng, tally, twin=False):
    """Wrap a DevDirEngine's dispatch: retry lanes (and, on the CPU twin,
    evictions: fresh claims of positions whose fingerprint was not 0)."""
    def dispatch(up, now_ms, _fn=eng._dispatch):
        before = eng.fps.clone() if twin else None
        out, retry = _fn(up, now_ms)
        tally["dispatches"] += 1
        tally["retry_lanes"] += int(retry.sum())
        if twin:
            fresh = up[8] != 0
            slots = torch.from_numpy(up[0][fresh])
            tally["evictions"] += int((before[slots] != 0).sum())
        return out, retry

    eng._dispatch = dispatch


def devdir_engine(seed, dev, results):
    """8b: DevDirEngine at full width on phase 3's first windows, against a
    CPU twin and the host-directory Engine on the card."""
    batches, _ = request_stream(seed, DEVDIR_WINDOWS)
    gpu = DevDirEngine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    cpu = DevDirEngine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    host = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    for e in (gpu, cpu, host):
        e.warmup()
    tally = {"dispatches": 0, "retry_lanes": 0, "evictions": 0}
    counted_dispatch(gpu, tally)
    secs = {"card": 0.0, "cpu": 0.0, "host_directory": 0.0}
    contention = 0
    for i, (_keys, batch) in enumerate(batches):
        now = NOW + i * 50
        got = {}
        for name, e in (("card", gpu), ("cpu", cpu), ("host_directory", host)):
            t = time.perf_counter()
            got[name] = resp_tuples(e.get_rate_limits(batch, now_ms=now))
            secs[name] += time.perf_counter() - t
        check(got["card"] == got["cpu"], f"8b window {i}: card and CPU twin answer differently")
        for a, b in zip(got["card"], got["host_directory"]):
            if a[4] == CONTENTION:
                contention += 1
            else:
                check(a == b, f"8b window {i}: the device and host directories answer "
                              f"differently: {a} against {b}")
    check(torch.equal(gpu.fps.cpu(), cpu.fps) and torch.equal(gpu.touch.cpu(), cpu.touch),
          "8b: the directories' columns differ")
    check(torch.equal(gpu.state.cpu(), cpu.state), "8b: the tables differ")
    gs, cs = gpu.stats.as_dict(), cpu.stats.as_dict()
    for c in ("requests", "batches", "rounds", "over_limit", "errors"):
        check(gs[c] == cs[c], f"8b: EngineStats.{c} differs: card {gs[c]}, CPU {cs[c]}")
    n = sum(len(b) for _, b in batches)
    rates = {k: n / v for k, v in secs.items()}
    stage_s = {s: ns / 1e9 for s, ns in gpu.stats.stage_ns.items()}
    rec = dict(requests=n, windows=len(batches), decisions_per_s=rates, seconds=secs,
               stage_s=stage_s, rounds=gs["rounds"], exhausted=gs["errors"],
               contention_answers=contention, keys=gpu.key_count(), **tally)
    results["devdir_engine"] = rec
    tlog(f"  8b: {n:,} requests: DevDirEngine on the card {rates['card']:,.0f} decisions/s, "
         f"its CPU twin {rates['cpu']:,.0f}/s, the host-directory Engine on the card "
         f"{rates['host_directory']:,.0f}/s; responses, columns, table and stats equal to "
         f"the twin's; equal to the host directory's on every lane but the {contention} "
         f"answered with the contention error")
    tlog(f"  8b: {gs['rounds']} rounds in {tally['dispatches']} dispatches, "
         f"{tally['retry_lanes']} retry lanes, {gs['errors']} lanes exhausted; "
         f"{rec['keys']:,} fingerprints held; stage seconds "
         + ", ".join(f"{s} {v:.3f}" for s, v in stage_s.items()))
    del gpu, cpu, host
    gc.collect()
    torch.cuda.empty_cache()


def devdir_pressure(seed, dev, capacity, n_windows, results):
    """8c: a small DevDirEngine on the card against its CPU twin on windows
    of PRESSURE_WIDTH requests, evictions and sweeps included."""
    batches, _ = request_stream(seed, n_windows, PRESSURE_WIDTH)
    gpu = DevDirEngine(device=dev, capacity=capacity, min_width=64, max_width=PRESSURE_WIDTH)
    cpu = DevDirEngine(device="cpu", capacity=capacity, min_width=64, max_width=PRESSURE_WIDTH)
    gpu.warmup()
    cpu.warmup()
    tally = {"dispatches": 0, "retry_lanes": 0, "evictions": 0}
    twin_tally = dict(tally)
    counted_dispatch(gpu, tally)
    counted_dispatch(cpu, twin_tally, twin=True)
    sweeps0 = ddk.launch_counts["refresh_vacancies"]
    gpu_s = 0.0
    for i, (_keys, batch) in enumerate(batches):
        now = NOW + i * 50
        t = time.perf_counter()
        got = gpu.get_rate_limits(batch, now_ms=now)
        gpu_s += time.perf_counter() - t
        check(resp_tuples(got) == resp_tuples(cpu.get_rate_limits(batch, now_ms=now)),
              f"8c window {i}: card and CPU twin answer differently")
    check(torch.equal(gpu.fps.cpu(), cpu.fps) and torch.equal(gpu.touch.cpu(), cpu.touch),
          "8c: the directories' columns differ")
    check(torch.equal(gpu.state.cpu(), cpu.state), "8c: the tables differ")
    sweeps = ddk.launch_counts["refresh_vacancies"] - sweeps0
    rounds, exhausted = gpu.stats.rounds, gpu.stats.errors
    check(rounds == cpu.stats.rounds and exhausted == cpu.stats.errors,
          "8c: the rounds or the exhausted lanes differ")
    check(tally["retry_lanes"] == twin_tally["retry_lanes"], "8c: the retry lanes differ")
    check(sweeps > 0, "8c: no sweep ran")
    n = sum(len(b) for _, b in batches)
    rec = dict(requests=n, windows=len(batches), capacity=capacity, rounds=rounds,
               evictions=twin_tally["evictions"], retry_lanes=tally["retry_lanes"],
               exhausted=exhausted, sweeps=sweeps, decisions_per_s=n / gpu_s)
    results.setdefault("devdir_pressure", []).append(rec)
    tlog(f"  8c: {n:,} requests at {capacity} positions, bit-equal to the twin: "
         f"{rounds} rounds, {rec['evictions']} evictions, {rec['retry_lanes']} retry lanes, "
         f"{exhausted} lanes exhausted, {sweeps} sweeps; {rec['decisions_per_s']:,.0f} "
         f"decisions/s on the card")
    del gpu, cpu


class InternedEngine(Engine):
    """The Engine with its one-window and scan dispatches shipping the
    interned format whenever a window is eligible (the Engine of either
    package ships lean, compact or wide; nothing there ships interned).
    8d's leftover tails run through it."""

    def _dispatch_staged(self, packed, now_ms):
        iw = dk.intern_window(packed)
        if iw is None:
            return super()._dispatch_staged(packed, now_ms)
        return dk.decide_packed_interned(self.state, self._up(iw[0]), self._up(iw[1]),
                                         now_ms), now_ms

    def _dispatch_scan_staged(self, stacked, now_ms):
        iw = dk.intern_window(stacked)
        if iw is None:
            return super()._dispatch_scan_staged(stacked, now_ms)
        return dk.decide_scan_packed_interned(self.state, self._up(iw[0]), self._up(iw[1]),
                                              now_ms), now_ms


def prepped_window(eng, reqs, now, istate, tally):
    """One window of wire columns: round 0 through the native prep (interned
    when `istate` is given, re-prepped through prep_pack_columnar on a
    config overflow; else columnar with the compact kernel), its injects
    first; the leftovers through get_rate_limits, in order. Returns the
    answers as response tuples."""
    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.models.prep import bucket_width

    n = len(reqs)
    cols = columnar_cols(reqs)
    W = bucket_width(n, eng.min_width, eng.max_width)
    out_rows = None
    with eng._lock:
        if istate is not None:
            iw = np.empty((2, W), np.int32)
            n0, lane, left, inj = native.prep_pack_interned(
                eng.directory, *cols, COL_SLOW, iw, istate, inject=eng._inject_rows_out())
            check(n0 >= 0 or n0 == native.PREP_CFG_OVERFLOW,
                  f"prep_pack_interned refused a window: {n0}")
            if n0 == native.PREP_CFG_OVERFLOW:
                tally["overflows"] += 1
            else:
                eng._apply_inject_rows(inj)
                out = dk.decide_packed_interned(eng.state, eng._up(iw), eng._up(istate.cfg), now)
                out_rows = dk.widen_compact_out(out.cpu().numpy(), now)
        if out_rows is None:
            packed = np.zeros((9, W), np.int64)
            n0, lane, left, inj = native.prep_pack_columnar(
                eng.directory, *cols, COL_SLOW, packed, eng._inject_rows_out())
            check(n0 >= 0, f"prep_pack_columnar refused a window: {n0}")
            eng._apply_inject_rows(inj)
            if istate is not None:
                out_rows = eng._fetch_staged(eng._dispatch_staged(packed, now))
            else:
                c = dk.compact_window(packed)
                check(c is not None, "8d: a columnar window is not compact-eligible")
                out_rows = dk.widen_compact_out(
                    dk.decide_packed_compact(eng.state, eng._up(c), now).cpu().numpy(), now)
    answers = [None] * n
    for j, i in enumerate(lane.tolist()):
        answers[i] = (int(out_rows[0, j]), int(out_rows[1, j]), int(out_rows[2, j]),
                      int(out_rows[3, j]), "")
    tally["lanes"] += n0
    tally["leftover"] += len(left)
    if len(left):
        idx = left.tolist()
        for i, r in zip(idx, eng.get_rate_limits([reqs[i] for i in idx], now_ms=now)):
            answers[i] = resp_tuples([r])[0]
    return answers


def devdir_interned(seed, dev, results):
    """8d: phase 3's first windows as wire columns through the interned prep
    and kernel on the card, against a CPU twin and the columnar prep with
    the compact kernel on a second card table."""
    from gubernator_tpu_torch import native

    batches, _ = request_stream(seed, INTERNED_WINDOWS)
    card = InternedEngine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    twin = InternedEngine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
    compact = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    states = (native.InternPrepState(), native.InternPrepState())
    tallies = [{"lanes": 0, "leftover": 0, "overflows": 0} for _ in range(3)]
    secs = [0.0, 0.0, 0.0]
    for i, (_keys, batch) in enumerate(batches):
        now = NOW + i * 50
        got = []
        for k, (eng, st) in enumerate(((card, states[0]), (twin, states[1]), (compact, None))):
            t = time.perf_counter()
            got.append(prepped_window(eng, batch, now, st, tallies[k]))
            secs[k] += time.perf_counter() - t
        check(got[0] == got[1], f"8d window {i}: the card's interned path and its twin differ")
        check(got[0] == got[2], f"8d window {i}: the interned and the compact paths differ")
    check(torch.equal(card.state, compact.state), "8d: the interned and compact tables differ")
    check(torch.equal(card.state.cpu(), twin.state), "8d: the card's and the twin's tables differ")
    check(all((t["lanes"], t["leftover"]) == (tallies[2]["lanes"], tallies[2]["leftover"])
              for t in tallies), f"8d: the preps packed different lanes: {tallies}")
    n = sum(len(b) for _, b in batches)
    rec = dict(requests=n, windows=len(batches), interned_lanes=tallies[0]["lanes"],
               leftover=tallies[0]["leftover"], overflows=tallies[0]["overflows"],
               n_cfg=states[0].n_cfg, decisions_per_s=[n / s for s in secs])
    results["devdir_interned"] = rec
    tlog(f"  8d: {n:,} requests as wire columns, {rec['interned_lanes']:,} through "
         f"prep_pack_interned and decide_packed_interned ({rec['n_cfg']} configs, "
         f"{rec['overflows']} overflows), {rec['leftover']:,} leftovers through the interned "
         f"engine tail; answers and tables equal to the CPU twin's and to the columnar + "
         f"compact path's; decisions/s card {rec['decisions_per_s'][0]:,.0f}, twin "
         f"{rec['decisions_per_s'][1]:,.0f}, compact path {rec['decisions_per_s'][2]:,.0f}")
    del card, twin, compact


def phase_devdir(seed, dev, results):
    log(f"== phase 8: the device directory: probe and sweep kernels vs their plain "
        f"versions at C={CAPACITY}, then DevDirEngine(capacity={CAPACITY}) on "
        f"{DEVDIR_WINDOWS} windows, eviction pressure at "
        f"{' and '.join(str(c) for c, _ in PRESSURE_RUNS)} positions, and the interned "
        f"path on {INTERNED_WINDOWS} windows")
    t0 = time.perf_counter()
    errs = {}
    recs = devdir_kernels(seed, dev, errs, results)
    results["devdir_kernels"] = recs
    dk.reset_launch_counts()
    ddk.reset_launch_counts()
    rowk.reset_launch_counts()
    devdir_engine(seed, dev, results)
    for capacity, n_windows in PRESSURE_RUNS:
        devdir_pressure(seed, dev, capacity, n_windows, results)
    devdir_interned(seed, dev, results)
    launches = {**dk.launch_counts, **ddk.launch_counts, **rowk.launch_counts}
    for name in ("probe_assign_evict", "refresh_vacancies", "decide_interned",
                 "decide_scan_interned"):
        check(launches[name] > 0, f"phase 8 launched no {name}")
    results["devdir_launches"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    tlog(f"  phase 8 launches {launches}; phase 8 in {time.perf_counter() - t0:.1f} s")
    return launches, errs, recs


# ----------------------------------------------------------------- phase 9

SHARDS, SHARD_ROWS = 8, 1_250_000  # the sharded engine's 8 x 1,250,000 = 10,000,000 rows
SHARD_GEOMS = ((1, SHARDS), (2, SHARDS // 2))  # (R, S): 9a holds the decide at both
SHARD_W = (64, 1024, WINDOW)  # 9a's one-window widths, per owner
SHARD_K = (2, 32)  # 9a's scan depths at W = 64
SHARD_M = (1, 64, 4096)  # 9a's gather and inject lanes, per owner
GLOBAL_HOT, GLOBAL_EVERY = 4096, 8  # 9b's GLOBAL keys: every 8th of the 4,096 hottest
SHARDED_WINDOWS = 12  # 9b: phase 3's first 12 windows, 98,304 requests
# 9b's CPU twin follows the first 6 (cut from 12 for phase 15's time; 15b
# holds the card's one-tensor engine to the mesh engine on all 12)
SHARDED_TWIN_WINDOWS = 6
SHARDED_STORE_WINDOWS = STORE_WINDOWS  # 9c
SHARDED_COL_WINDOWS = 8  # 9d
SHARDED_KERNELS = ("decide_sharded_wide", "decide_sharded_scan_wide", "decide_sharded_lean",
                   "decide_sharded_scan_lean", "gather_sharded", "inject_sharded")


def kernel_ms(fn, iters, kernel_substr, per_call=False, flush_each=None):
    """A kernel's device ms per launch: torch.profiler's (L2 flushed before
    every launch with `flush_each`), or, where its trace shows no device time
    for the kernel, CUDA events around `iters` calls back to back, L2 not
    flushed. Returns (ms, source) and logs the source it fell back to."""
    ms = profiled_ms(fn, iters, kernel_substr, per_call, flush_each)
    if ms is not None:
        return ms, "torch.profiler"
    log(f"  {kernel_substr}: device ms from CUDA events instead (the profiler recorded none)")
    return event_ms(fn, iters), ("cuda events" if flush_each is None
                                 else "cuda events, L2 not flushed")


def sharded_table(R, S, seed, dev):
    """The sharded engine's i64[R, S, 1,250,000, 8] table (make_sharded_table,
    as ShardedEngine makes it), populated from `seed` by populate_table."""
    t = make_sharded_table(MeshPlan(n_shards=S, capacity_per_shard=SHARD_ROWS,
                                    n_regions=R), dev)
    t.copy_(populate_table(R * S * SHARD_ROWS, seed, dev).view(R, S, SHARD_ROWS, 8))
    return t


def shard_edges(wide, C):
    """The edge lanes in every window of every owner of a wide staging
    [R, S, (K,) 9, W]: lane 0 reads past the owner's own table (slot C + o),
    lane 1 writes the owner's row C-1 in the same window in even owners (and
    in odd windows of a scan in odd owners), both on a live lane's request;
    the last lane is padding."""
    S = wide.shape[1]
    for idx in np.ndindex(*wide.shape[:-2]):
        w = wide[idx]
        o, k = idx[0] * S + idx[1], idx[2] if len(idx) > 2 else 0
        src = w[1:, np.flatnonzero(w[0] >= 0)[-1]].copy()
        w[:, 0] = [C + o, *src]
        if o % 2 == 0 or k % 2 == 1:
            w[:, 1] = [C - 1, *src]
        w[0, -1] = -1
        w[1:, -1] = 0
    return wide


def shard_stimulus(rng, kern, fmt, W, K=0):
    """A wide staging [R, S, (K,) 9, W] of phase 2's stimulus for each owner
    (its rows, the slots below C-1; a scan's windows overlap on a pool of
    256 rows) with shard_edges' lanes."""
    R, S, C = kern.shape[:3]
    per = []
    for r in range(R):
        for s in range(S):
            if K:
                pool = rng.choice(C - 1, 256, replace=False)
                per.append(np.stack([stimulus(rng, kern[r, s], W, fmt, slots=pool)
                                     for _ in range(K)]))
            else:
                per.append(stimulus(rng, kern[r, s], W, fmt, slots=C - 1))
    wide = np.stack(per).reshape(R, S, *per[0].shape)
    if fmt == "lean":
        # rows that wide windows wrote carry calendar durations; a lean
        # window keeps to the configurations lean_window can intern
        d = wide[..., 3, :]
        wide[..., 3, :] = np.where(np.isin(d, (1000, 60_000, 3_600_000)), d, 60_000)
    return shard_edges(wide, C)


def blank_windows(wide, K):
    """Windows with no live lane, which the plain version answers without a
    call: owner 3's window (a scan: its window 1) all padding, and in a
    scan every window of owner 5."""
    S = wide.shape[1]
    blank = [divmod(3, S) + ((1,) if K else ())] + ([divmod(5, S)] if K else [])
    for idx in blank:
        wide[idx + (Ellipsis, 0, slice(None))] = -1
        wide[idx + (Ellipsis, slice(1, None), slice(None))] = 0
    return wide


def lean_signed(lanes, cfg):
    """A lean staging with every config id moved up by 64 (mod 128), so that
    ids from 64 set the lane word's sign bit; the config table rolled to
    match. Padding words stay."""
    u = lanes.view(np.uint32)
    pad = (u & dk._LEAN_SLOT_MASK) == dk._LEAN_PAD
    ids = ((u >> dk._LEAN_CFG_SHIFT) + 64) % dk.LEAN_MAX_CFG
    moved = (u & ((1 << dk._LEAN_CFG_SHIFT) - 1)) | (ids << dk._LEAN_CFG_SHIFT)
    return np.where(pad, u, moved).astype(np.uint32).view(np.int32), np.roll(cfg, 64, axis=0)


def shard_staged(fmt, wide, C, dev, signed=False):
    if fmt == "wide":
        return torch.from_numpy(wide).to(dev), None
    ln = dk.lean_window(wide, C)
    check(ln is not None, "sharded lean stimulus not eligible")
    lanes, cfg = lean_signed(*ln) if signed else ln
    return torch.from_numpy(lanes).to(dev), torch.from_numpy(cfg).to(dev)


def hold_sharded(f, kern, plain, packed, cfg, scan, what, errs):
    """One sharded decide through the kernel and the plain version: equal
    responses and whole tables, or the run fails."""
    out_k = dk.decide_sharded_cuda(f, kern, packed, cfg, NOW, scan)
    out_p = dk.decide_sharded_plain(f, plain, packed, cfg, NOW, scan)
    torch.cuda.synchronize()
    name = dk._SHARDED_COUNT_NAMES[f, scan]
    errs[name] = max(errs.get(name, 0), max_abs_err(out_k, out_p), max_abs_err(kern, plain))
    check(torch.equal(out_k, out_p), f"{what}: responses differ")
    check(torch.equal(kern, plain), f"{what}: tables differ")


def shard_rows_touched(wide, C):
    R, S = wide.shape[:2]
    return sum(touched_rows(wide[r, s], C) for r in range(R) for s in range(S))


def sharded_decide(seed, dev, errs, results):
    """9a, the sharded decide: every shape at R = 1, S = 8 held and timed (the
    kernel, its plain version, the R*S launches of the single-table kernel
    on the owners' views); the edge cases at R = 2, S = 4 too."""
    rng = np.random.default_rng(seed + 10)
    recs = []
    for R, S in SHARD_GEOMS:
        kern = sharded_table(R, S, seed + 11, dev)
        plain = kern.clone()
        C, n = SHARD_ROWS, R * S
        timed = (R, S) == SHARD_GEOMS[0]
        for fmt in ("wide", "lean"):
            f = FORMATS[fmt]
            for W, K in [(w, 0) for w in SHARD_W] + [(64, k) for k in SHARD_K]:
                scan = K > 0
                wide = shard_stimulus(rng, kern, fmt, W, K)
                packed, cfg = shard_staged(fmt, wide, C, dev, signed=(W == 1024 or K == 2))
                what = f"sharded {fmt} R={R} S={S} W={W} K={K}"
                hold_sharded(f, kern, plain, packed, cfg, scan, what, errs)
                if W == 64:
                    blank = blank_windows(shard_stimulus(rng, kern, fmt, W, K), K)
                    hold_sharded(f, kern, plain, *shard_staged(fmt, blank, C, dev), scan,
                                 what + " with padded owner windows", errs)
                if not timed:
                    continue
                stims = [shard_staged(fmt, shard_stimulus(rng, kern, fmt, W, K), C, dev)
                         for _ in range(16)]
                views = [(pk.view(n, *pk.shape[2:]), cf) for pk, cf in stims]
                tables = kern.view(n, C, 8)

                def run_k(i):
                    pk, cf = stims[i % 16]
                    dk.decide_sharded_cuda(f, kern, pk, cf, NOW, scan)

                def run_p(i):
                    pk, cf = stims[i % 16]
                    dk.decide_sharded_plain(f, plain, pk, cf, NOW, scan)

                def run_loop(i):
                    pk, cf = views[i % 16]
                    for o in range(n):
                        dk.decide_cuda(f, tables[o], pk[o], cf, NOW, scan)

                call_ms = event_ms(run_k, 64)
                ms, src = kernel_ms(run_k, 32, "decide_kernel")
                plain_ms = event_ms(run_p, 2 if K == 32 else 8)  # K = 32: ~1 s a call
                loop_call_ms = event_ms(run_loop, 32)
                loop_ms = profiled_ms(run_loop, 16, "decide_kernel", per_call=True)
                plain.copy_(kern)  # the timing runs moved the two tables apart
                rec = dict(kernel=dk._SHARDED_COUNT_NAMES[f, scan], fmt=fmt, R=R, S=S, C=C,
                           width=W, scan_k=K, ms=ms, ms_source=src, call_ms=call_ms,
                           plain_ms=plain_ms, loop_ms=loop_ms, loop_call_ms=loop_call_ms,
                           **decide_bound(fmt, wide, shard_rows_touched(wide, C)))
                recs.append(rec)
                tlog(f"  {what}: bit-equal; kernel {fms(ms)} ms on the device ({src}), "
                     f"{call_ms:.4f} ms per wrapper call; {n} single-table launches "
                     f"{fms(loop_ms)} ms on the device, {loop_call_ms:.4f} ms per {n} calls; "
                     f"plain {plain_ms:.4f} ms; bound {rec['bound_ms']:.6f} ms "
                     f"({rec['bound_by']})")
        if not timed:
            log(f"  sharded decide at R={R} S={S}: every shape bit-equal")
        del kern, plain
        torch.cuda.empty_cache()
    return recs


def sharded_rows_stimulus(rng, R, S, C, m, dev):
    """Per owner m distinct slots below C-1 (padding -1 and past-table lanes
    C, C + 3 among them; the owner's row C-1 written by lane 3 in even
    owners), and i64[R, S, 7, m] rows with values past int32 in every field."""
    slot = np.stack([rng.choice(C - 1, m, replace=False) for _ in range(R * S)])
    slot = slot.reshape(R, S, m).astype(np.int32)
    if m >= 4:
        slot[..., :3] = (-1, C, C + 3)
        slot[:, ::2, 3] = C - 1
    rows = rng.integers(-(1 << 40), 1 << 40, (R, S, 7, m), dtype=np.int64)
    return torch.from_numpy(slot).to(dev), torch.from_numpy(rows).to(dev)


def hold_sharded_rows(kern, plain, slot, rows, what, errs):
    """The sharded gather and inject on the card against their plain
    versions on `plain` (equal to `kern` on entry, and again on return)."""
    got, want = rowk.gather_sharded_cuda(kern, slot), rowk.gather_sharded_plain(plain, slot)
    torch.cuda.synchronize()
    errs["gather_sharded"] = max(errs.get("gather_sharded", 0), max_abs_err(got, want))
    check(torch.equal(got, want), f"gather_sharded {what}: rows differ")
    rowk.inject_sharded_cuda(kern, slot, rows)
    rowk.inject_sharded_plain(plain, slot, rows)
    torch.cuda.synchronize()
    errs["inject_sharded"] = max(errs.get("inject_sharded", 0), max_abs_err(kern, plain))
    check(torch.equal(kern, plain), f"inject_sharded {what}: tables differ")


ROW_STIMULI = 16  # stimuli cycled through each timing: 64 MB of rows at m = 4096 an owner


def sharded_row_runs(kern, plain, stims):
    """The timed calls of the sharded gather and inject over `stims` (cycled),
    beside their library calls on the flattened table: one indexing with each
    owner's base offset, and index_copy_ of the rows the inject writes.
    Returns (name, kernel name, run_k, run_p, run_lib, bytes) for each; the
    bytes are what the call must move (slots read, rows read and written
    once; only the kept lanes' rows for the inject)."""
    R, S, C = kern.shape[:3]
    n, m = R * S, stims[0][0].shape[2]
    flat = kern.view(n * C, 8)
    base = (torch.arange(n, device=kern.device, dtype=torch.int64) * C).view(R, S, 1)
    idx, lib_in = [], []
    for slot, rows in stims:
        idx.append((slot.to(torch.int64).clamp(0, C - 1) + base).view(-1))
        keep = ((slot >= 0) & (slot < C)).view(-1)
        lib_in.append(((slot.to(torch.int64) + base).view(-1)[keep],
                       torch.cat([rows.transpose(2, 3).reshape(-1, 7),
                                  rows.new_zeros((n * m, 1))], dim=1)[keep]))
    kept = len(lib_in[0][0])
    k = len(stims)
    return (("gather_sharded", "gather_kernel",
             lambda i: rowk.gather_sharded_cuda(kern, stims[i % k][0]),
             lambda i: rowk.gather_sharded_plain(plain, stims[i % k][0]),
             lambda i: flat[idx[i % k]], n * m * (4 + 56 + 56)),
            ("inject_sharded", "inject_sharded_kernel",
             lambda i: rowk.inject_sharded_cuda(kern, *stims[i % k]),
             lambda i: rowk.inject_sharded_plain(plain, *stims[i % k]),
             lambda i: flat.index_copy_(0, *lib_in[i % k]), n * m * 4 + kept * (56 + 64)))


def sharded_rows(seed, dev, errs, results):
    """9a, the sharded gather and inject at m lanes an owner: held against
    their plain versions at R x S = 1 x 8 and 2 x 4 (padding, past-table
    lanes, row C-1, values past int32), then timed at 1 x 8 over 16 stimuli
    cycled with the L2 flushed before every launch, beside their library
    calls timed the same way and an empty kernel on their grid (the floor)."""
    rng = np.random.default_rng(seed + 12)
    C = SHARD_ROWS
    recs = []
    flush = l2_flush(dev)
    for R, S in SHARD_GEOMS:
        n = R * S
        kern = sharded_table(R, S, seed + 13, dev)
        plain = kern.clone()
        for m in SHARD_M:
            stims = [sharded_rows_stimulus(rng, R, S, C, m, dev) for _ in range(ROW_STIMULI)]
            hold_sharded_rows(kern, plain, *stims[0], f"R={R} S={S} m={m}", errs)
            if (R, S) != SHARD_GEOMS[0]:
                continue
            floor_ms = profiled_ms(lambda i: rowk.floor_cuda(dev.index or 0, m, n), 32,
                                   "empty_kernel")
            for name, kname, run_k, run_p, run_lib, n_bytes in sharded_row_runs(
                    kern, plain, stims):
                call_ms, lib_call = in_turns(lambda f: event_ms(f, 64), run_k, run_lib)
                ms, src = kernel_ms(run_k, 32, kname, flush_each=flush)
                plain_ms = event_ms(run_p, 8)
                lib_ms = profiled_ms(run_lib, 32, flush_each=flush)
                b_ms, b_by = bound_ms(n_bytes, 0)
                rec = dict(kernel=name, R=R, S=S, C=C, m=m, ms=ms, ms_source=src,
                           call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_call,
                           library_device_ms=lib_ms, floor_ms=floor_ms, bytes=n_bytes,
                           bound_ms=b_ms, bound_by=b_by, l2="flushed before every launch")
                recs.append(rec)
                tlog(f"  {name} R={R} S={S} m={m}: bit-equal; kernel {fms(ms)} ms on the device "
                     f"({src}, L2 flushed before every launch, {ROW_STIMULI} stimuli cycled); "
                     f"empty kernel on its grid {fms(floor_ms)} ms; {call_ms:.4f} ms per "
                     f"wrapper call; plain {plain_ms:.4f} ms; library "
                     f"{'indexing' if name == 'gather_sharded' else 'index_copy_'} "
                     f"{lib_call:.4f} ms per call, {fms(lib_ms)} ms on the device, timed the "
                     f"same way; bound {b_ms:.6f} ms ({b_by})")
            torch.cuda.synchronize()
            plain.copy_(kern)
        log(f"  sharded gather and inject at R={R} S={S}: every m bit-equal")
        del kern, plain
        torch.cuda.empty_cache()
    del flush
    return recs


def global_stream(seed, n_windows):
    """Phase 3's first windows with Behavior.GLOBAL on the keys of every
    GLOBAL_EVERY-th Zipf rank among the GLOBAL_HOT hottest (Zipf rank k is
    key k). Returns the batches, the key configs and the GLOBAL request
    count."""
    batches, key_cfg = request_stream(seed, n_windows)
    hot = np.zeros(N_KEYS, np.bool_)
    hot[:GLOBAL_HOT:GLOBAL_EVERY] = True
    n_global = 0
    for keys, batch in batches:
        for k, r in zip(keys.tolist(), batch):
            if hot[k]:
                r.behavior |= int(Behavior.GLOBAL)
                n_global += 1
    return batches, key_cfg, n_global


def sharded_state_equal(gpu, cpu, what, counters=True):
    """Tables, GLOBAL mirrors and registries, and (when `counters`) the
    counters of a card ShardedEngine and its CPU twin, or the run fails."""
    check(torch.equal(gpu.state.cpu(), cpu.state), f"{what}: tables differ")
    for f in GlobalMirror._fields:
        check(np.array_equal(getattr(gpu._mirror, f), getattr(cpu._mirror, f)),
              f"{what}: mirror.{f} differs")
    reg = lambda e: [(k, v.gidx, v.owner, v.seen, v.last_ms) for k, v in e._globals.items()]
    check(reg(gpu) == reg(cpu) and gpu._gfree == cpu._gfree and gpu._gnext == cpu._gnext
          and np.array_equal(gpu._gdelta, cpu._gdelta), f"{what}: GLOBAL registries differ")
    if counters:
        c = lambda e: {k: v for k, v in e.stats.items() if not k.endswith("_ns")}
        check(c(gpu) == c(cpu), f"{what}: counters differ: card {c(gpu)}, CPU {c(cpu)}")


def sharded_launches():
    return {**{k: dk.launch_counts[k] for k in dk.launch_counts if "sharded" in k},
            "gather_sharded": rowk.launch_counts["gather_sharded"],
            "inject_sharded": rowk.launch_counts["inject_sharded"]}


def sharded_shapes():
    return {f"{name} K={k} W={w}": c for (name, k, w), c in sorted(dk.launch_shapes.items())
            if "sharded" in name}


def sharded_engines(dev, store=None, twin_store=None):
    # imported here: ab_rows.py runs this file's phase 4 against parent trees
    from gubernator_tpu_torch.parallel.sharded import ShardedEngine

    kw = dict(n_shards=SHARDS, capacity_per_shard=SHARD_ROWS, min_width=64, max_width=WINDOW)
    return (ShardedEngine(device=dev, store=store, **kw),
            ShardedEngine(device="cpu", store=twin_store, **kw))


def sharded_engine_run(seed, dev, results):
    """9b: the card engine after warmup() on phase 3's first SHARDED_WINDOWS
    windows with the GLOBAL keys, global_sync() after every window, and its
    CPU twin on the first SHARDED_TWIN_WINDOWS of them: all state equal after
    each of those, and the keyspace harvest equal after the last."""
    batches, _cfg, n_global = global_stream(seed, SHARDED_WINDOWS)
    gpu, cpu = sharded_engines(dev)
    t = time.perf_counter()
    gpu.warmup()
    warm_s = time.perf_counter() - t
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    gpu_s = cpu_s = sync_s = 0.0
    n_req = n_twin = broadcast = 0
    for i, (_keys, batch) in enumerate(batches):
        now = NOW + i * 50
        t = time.perf_counter()
        got = gpu.get_rate_limits(batch, now_ms=now)
        gpu_s += time.perf_counter() - t
        n_req += len(batch)
        twin = i < SHARDED_TWIN_WINDOWS
        if twin:
            t = time.perf_counter()
            want = cpu.get_rate_limits(batch, now_ms=now)
            cpu_s += time.perf_counter() - t
            n_twin += len(batch)
            check(resp_tuples(got) == resp_tuples(want),
                  f"sharded window {i}: card and CPU engines answer differently")
        t = time.perf_counter()
        b = gpu.global_sync(now_ms=now + 25)
        torch.cuda.synchronize()
        sync_s += time.perf_counter() - t
        broadcast += b
        if twin:
            check(b == cpu.global_sync(now_ms=now + 25), f"sharded window {i}: broadcasts differ")
            sharded_state_equal(gpu, cpu, f"sharded window {i}")
        if i == SHARDED_TWIN_WINDOWS - 1:
            out_keyspace = sharded_keyspace(gpu, cpu, dev)  # reads tables, launches nothing
            del cpu
            gc.collect()
    launches, shapes = sharded_launches(), sharded_shapes()
    st = gpu.stats
    stage_s = {s: st[f"{s}_ns"] / 1e9 for s in EngineStats.STAGES}
    out = dict(requests=n_req, global_requests=n_global, warmup_s=warm_s,
               decisions_per_s=n_req / gpu_s, cpu_decisions_per_s=n_twin / cpu_s,
               twin_windows=SHARDED_TWIN_WINDOWS,
               sync_ms=sync_s / len(batches) * 1e3, keys_broadcast=broadcast,
               mirror_answers=st["global_mirror_answers"],
               registry_fallbacks=st["global_registry_fallbacks"],
               global_evictions=st["global_evictions"], registry=gpu.global_registry_size(),
               lean_windows=st["lean_windows"], rounds=st["rounds"], stage_s=stage_s,
               launches=launches, shapes=shapes, keyspace=out_keyspace)
    results["sharded_engine"] = out
    tlog(f"  9b: {n_req:,} requests ({n_global:,} GLOBAL) in {gpu_s:.3f} s, "
         f"{n_req / gpu_s:,.0f} decisions/s (CPU twin {n_twin / cpu_s:,.0f}/s), warmup "
         f"{warm_s:.1f} s; responses, tables, mirrors, registries and counters equal to the "
         f"CPU twin's after each of the first {SHARDED_TWIN_WINDOWS} windows")
    tlog(f"  9b GLOBAL: sync {out['sync_ms']:.3f} ms a step (host clock, with the mirror's "
         f"read back), {broadcast} keys broadcast, {out['mirror_answers']:,} mirror answers, "
         f"{out['registry_fallbacks']} registry fallbacks, {out['global_evictions']} "
         f"evictions, registry {out['registry']}")
    tlog("  9b stage seconds: " + ", ".join(f"{s} {v:.3f}" for s, v in stage_s.items())
         + f"; {st['rounds']} rounds, {st['lean_windows']} lean windows")
    log(f"  9b launches {launches}; by shape {shapes}")
    del gpu
    gc.collect()
    return launches


def sharded_keyspace(gpu, cpu, dev):
    """9b's keyspace harvest over the card engine: no error, one hbm entry
    per owner shard at C * 64 bytes, the report equal to the CPU twin's."""
    carto = KeyspaceCartographer(types.SimpleNamespace(backend=gpu))
    t = time.perf_counter()
    rep = carto.harvest()
    harvest_s = time.perf_counter() - t
    check(carto.errors == 0 and rep is not None,
          f"9b: the keyspace harvest failed on the card ({carto.errors} errors)")
    per = rep["hbm"]["per_device"]
    check(per == [{"device": str(dev), "state_bytes": SHARD_ROWS * 64}] * SHARDS,
          f"9b: hbm_bytes per device {per}")
    keyspace_equal(rep, KeyspaceCartographer(types.SimpleNamespace(backend=cpu)).harvest(), "9b")
    tlog(f"  9b keyspace harvest {harvest_s * 1e3:.1f} ms, 0 errors, equal to the CPU "
         f"twin's; hbm: {len(per)} owner entries of {per[0]['state_bytes']:,} bytes")
    return dict(harvest_s=harvest_s, owners=len(per), state_bytes=per[0]["state_bytes"],
                tracked_hits=rep["hit_mass"]["tracked_hits"])


def sharded_store_run(seed, dev, results):
    """9c: the Store path on phase 3's first 8 windows (both Stores holding the
    100,000 hottest keys' buckets), through the sharded gather and inject."""
    batches, key_cfg = request_stream(seed, SHARDED_STORE_WINDOWS)
    held = held_buckets(seed, key_cfg)
    stores = (MockStore(), MockStore())
    for st in stores:
        st.data.update((b.key, dataclasses.replace(b)) for b in held)
    gpu, cpu = sharded_engines(dev, *stores)
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    gpu_s = 0.0
    for i, (_keys, batch) in enumerate(batches):
        now = SNAP_NOW + i * 50
        t = time.perf_counter()
        got = gpu.get_rate_limits(batch, now_ms=now)
        gpu_s += time.perf_counter() - t
        want = cpu.get_rate_limits(batch, now_ms=now)
        check(resp_tuples(got) == resp_tuples(want),
              f"sharded Store window {i}: card and CPU engines answer differently")
    launches = sharded_launches()
    sharded_state_equal(gpu, cpu, "sharded Store path")
    check({k: dataclasses.astuple(v) for k, v in stores[0].data.items()}
          == {k: dataclasses.astuple(v) for k, v in stores[1].data.items()},
          "the sharded Stores' contents differ")
    check(stores[0].called == stores[1].called,
          f"sharded Store calls differ: card {stores[0].called}, CPU {stores[1].called}")
    check(launches["gather_sharded"] > 0 and launches["inject_sharded"] > 0,
          f"the sharded Store path's row launches: {launches}")
    n_req = sum(len(b) for _, b in batches)
    stage_s = {s: gpu.stats[f"{s}_ns"] / 1e9 for s in EngineStats.STAGES}
    results["sharded_store"] = dict(requests=n_req, decisions_per_s=n_req / gpu_s,
                                    stage_s=stage_s, store_calls=dict(stores[0].called),
                                    launches=launches)
    tlog(f"  9c Store path: {n_req:,} requests, {n_req / gpu_s:,.0f} decisions/s; answers, "
         f"tables, Store contents and calls {stores[0].called} equal; launches {launches}")
    del gpu, cpu
    gc.collect()
    return launches


def sharded_columnar_run(seed, dev, results):
    """9d: 8 windows as wire columns through submit_columnar /
    complete_columnar on the card and the CPU twin, then the same windows'
    requests cut into submissions through BackendCombiner at depth 3 on the
    card against depth 1 on the CPU twin."""
    from gubernator_tpu_torch.service.combiner import BackendCombiner

    batches, _ = request_stream(seed, SHARDED_COL_WINDOWS)
    gpu, cpu = sharded_engines(dev)
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    col_s = 0.0
    for i, (_keys, batch) in enumerate(batches):
        now = NOW + i * 50
        cols = columnar_cols(batch)
        answers = []
        for eng in (gpu, cpu):
            n = len(batch)
            outs = (np.zeros(n, np.int32), np.zeros(n, np.int64), np.zeros(n, np.int64),
                    np.zeros(n, np.int64))
            t = time.perf_counter()
            h = eng.submit_columnar(*cols, COL_SLOW, now_ms=now)
            check(h is not None, "submit_columnar refused a sharded window")
            left = eng.complete_columnar(h, *outs).tolist()
            for j, r in zip(left, eng.get_rate_limits([batch[j] for j in left], now_ms=now)):
                for o, v in zip(outs, (r.status, r.limit, r.remaining, r.reset_time)):
                    o[j] = v
            if eng is gpu:  # leftovers included
                col_s += time.perf_counter() - t
            answers.append([o.tolist() for o in outs])
        check(answers[0] == answers[1], f"sharded columnar window {i}: answers differ")
    sharded_state_equal(gpu, cpu, "sharded columnar path")
    col_launches = sharded_launches()
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    # the combiner over fresh engines: submissions of 1-512 requests
    flat = [r for _, b in batches for r in b]
    rng = np.random.default_rng(seed + 14)
    subs, pos = [], 0
    while pos < len(flat):
        n = int(np.exp(rng.uniform(0.0, np.log(MAX_SUBMISSION + 1))))
        subs.append(flat[pos:pos + n])
        pos += n
    gpu, cpu = sharded_engines(dev)
    got = []
    for eng, depth in ((gpu, PIPE_DEPTH), (cpu, 1)):
        c = BackendCombiner(eng, depth=depth, scan=PIPE_SCAN)
        check(c.pipelined == (depth > 1), "the sharded combiner's pipeline is "
              f"{'on' if c.pipelined else 'off'} at depth {depth}")
        try:
            t = time.perf_counter()
            futs = [c.submit_async(s, sub_now(i)) for i, s in enumerate(subs)]
            got.append([resp_tuples(f.result(timeout=600)) for f in futs])
            if eng is gpu:
                comb_s = time.perf_counter() - t
                comb_stats = c.stats
        finally:
            c.close()
    check(got[0] == got[1], "the sharded combiner at depth 3 and its CPU twin answer differently")
    check(comb_stats["pipelined_windows"] > 0, "the sharded combiner pipelined nothing")
    # depth 3 and depth 1 merge submissions into different windows: the
    # window counters differ, the answers and the state may not
    sharded_state_equal(gpu, cpu, "sharded combiner", counters=False)
    comb_launches = sharded_launches()
    launches = {k: v + comb_launches[k] for k, v in col_launches.items()}
    n_req = len(flat)
    results["sharded_columnar"] = dict(requests=n_req, columnar_decisions_per_s=n_req / col_s,
                                       combiner_decisions_per_s=n_req / comb_s,
                                       combiner=dict(comb_stats), launches=launches,
                                       columnar_launches=col_launches,
                                       combiner_launches=comb_launches)
    tlog(f"  9d: {n_req:,} requests as wire columns, {n_req / col_s:,.0f} decisions/s; the "
         f"same through BackendCombiner depth {PIPE_DEPTH} scan {PIPE_SCAN}: "
         f"{n_req / comb_s:,.0f} decisions/s ({len(subs)} submissions, "
         f"{comb_stats['pipelined_windows']} pipelined windows); answers and state equal to "
         f"the CPU twins; launches {launches}")
    del gpu, cpu
    gc.collect()
    return launches


def phase_sharded(seed, dev, results):
    log(f"== phase 9: the sharded engine, {SHARDS} x {SHARD_ROWS:,} rows "
        f"({SHARDS * SHARD_ROWS * 64 / 1e6:.0f} MB): the sharded kernels vs their plain "
        f"versions; ShardedEngine on {SHARDED_WINDOWS} windows with GLOBAL keys, the Store "
        f"path, the columnar path and the combiner, each against a CPU twin")
    t0 = time.perf_counter()
    errs = {}
    recs = sharded_decide(seed, dev, errs, results) + sharded_rows(seed, dev, errs, results)
    results["sharded_kernels"] = recs
    launches = dict.fromkeys(SHARDED_KERNELS, 0)
    for run in (sharded_engine_run, sharded_store_run, sharded_columnar_run):
        for k, v in run(seed, dev, results).items():
            launches[k] += v
    torch.cuda.empty_cache()
    tlog(f"  phase 9 in {time.perf_counter() - t0:.1f} s; engine-path launches {launches}")
    return launches, errs, recs


# ------------------------------------------------------------------ phase 10
# The host tier: the cross-host exchange over a gloo group (10a), an
# Instance over the daemon's own backend (10b) and two daemons on the card
# in one gloo group (10c).

EXCHANGE_G = (1024, 65_536)  # the default capacity; the largest the sizing note names
EXCHANGE_STEPS = 30  # timed steps a size and rank, after one checked step
EXCHANGE_SETS = 4  # seeded contributions, cycled over the steps
HOST_WINDOWS = 12  # 10b: phase 3's first 12 windows
HOST_BATCH = 1000  # MAX_BATCH_SIZE: the largest client batch an Instance takes
DAEMON_CAPACITY = 10_000_000
DAEMON_STREAM = 20  # 10c: batches of HOST_BATCH token requests over gRPC
DAEMON_DURATION = 3_600_000  # one hour: the wall clock moves no answer
ROOT = os.path.dirname(os.path.abspath(__file__))

# One rank of 10a: join the 2-host group through initialize_from_env, read
# the host's memory-copy rate (bytes read plus written per second, best of
# 5 copies of 256 MiB), then at each G step CollectiveGlobalChannel and
# CrossHostHitSync on seeded contributions. Both ranks' contributions come
# from the seed, so each rank holds its outputs to a numpy fold itself.
EXCHANGE_WORKER = r"""
import json, sys, time
import numpy as np
from gubernator_tpu_torch.parallel.multihost import (
    CollectiveGlobalChannel, CrossHostHitSync, initialize_from_env)

rank, coord, seed, out = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4]
sizes = [int(g) for g in sys.argv[5].split(",")]
steps, sets = int(sys.argv[6]), int(sys.argv[7])
assert initialize_from_env(coord, 2, rank)
src = np.ones(32 << 20, np.int64)
dst = np.empty_like(src)
best = float("inf")
for _ in range(5):
    t = time.perf_counter()
    np.copyto(dst, src)
    best = min(best, time.perf_counter() - t)
res = {"rank": rank, "copy_bytes_per_s": 2 * src.nbytes / best, "sizes": {}}
for G in sizes:
    rng = np.random.default_rng(seed * 1_000_003 + G)
    delta = rng.integers(0, 1 << 20, (sets, 2, G), dtype=np.int64)
    claim = np.where(rng.random((sets, 2, G)) < 0.5,
                     rng.integers(1, 1 << 55, (sets, 1, G), dtype=np.int64), 0)
    clash = rng.random((sets, 2, G)) < 0.05
    claim[clash] = rng.integers(1, 1 << 55, int(clash.sum()), dtype=np.int64)
    state = rng.integers(-(1 << 40), 1 << 40, (sets, 2, 5, G), dtype=np.int64)
    want = [(delta[s].sum(0), claim[s].sum(0), claim[s].max(0),
             (claim[s] != 0).sum(0), state[s].sum(0)) for s in range(sets)]
    chan, sync = CollectiveGlobalChannel(G), CrossHostHitSync(G)
    chan.warm()
    chan_ms, sync_ms, exact = [], [], True
    for t in range(steps + 1):
        s = t % sets
        t0 = time.perf_counter()
        got = chan.step(delta[s, rank], claim[s, rank], state[s, rank])
        t1 = time.perf_counter()
        tot = sync.step(delta[s, rank])
        t2 = time.perf_counter()
        exact &= all(np.array_equal(g, w) for g, w in zip(got, want[s]))
        exact &= bool(np.array_equal(tot, want[s][0]))
        if t:  # the first step after warm is checked, not timed
            chan_ms.append((t1 - t0) * 1e3)
            sync_ms.append((t2 - t1) * 1e3)
    res["sizes"][G] = {"exact": bool(exact), "chan_ms": chan_ms, "sync_ms": sync_ms,
                       "steps": chan.steps}
with open(out, "w") as f:
    json.dump(res, f)
"""


def spread(ms):
    a = np.asarray(ms, np.float64)
    return dict(median=float(np.median(a)), min=float(a.min()),
                p10=float(np.percentile(a, 10)), p90=float(np.percentile(a, 90)),
                max=float(a.max()), n=len(a))


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def exchange_run(seed, results):
    """10a: two local processes form a gloo group through initialize_from_env
    and step CollectiveGlobalChannel and CrossHostHitSync at each G; every
    output must equal a numpy fold of the contributions."""
    tmp = tempfile.mkdtemp(prefix="guber-exchange-")
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", EXCHANGE_WORKER, str(r), coord, str(seed),
         os.path.join(tmp, f"rank{r}.json"), ",".join(map(str, EXCHANGE_G)),
         str(EXCHANGE_STEPS), str(EXCHANGE_SETS)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"exchange rank {r} failed (rc {p.returncode}):\n{out[-3000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    rate = min(x["copy_bytes_per_s"] for x in ranks)
    rec = results["exchange"] = {"copy_bytes_per_s": rate, "sizes": {}}
    for G in EXCHANGE_G:
        per = [x["sizes"][str(G)] for x in ranks]
        for r, p in enumerate(per):
            check(p["exact"], f"exchange at G={G}: rank {r}'s outputs differ from the numpy fold")
        n_bytes = 16 * 8 * G  # 7 i64 lanes a slot in and 9 out, per rank
        chan = spread([m for p in per for m in p["chan_ms"]])
        sync = spread([m for p in per for m in p["sync_ms"]])
        rec["sizes"][G] = dict(channel_ms=chan, hit_sync_ms=sync, bytes_per_rank=n_bytes,
                               bound_ms=n_bytes / rate * 1e3, steps=per[0]["steps"])
        tlog(f"  10a G={G:,}: CollectiveGlobalChannel.step median {fms(chan['median'])} ms "
             f"(min {fms(chan['min'])}, p10 {fms(chan['p10'])}, p90 {fms(chan['p90'])}, "
             f"max {fms(chan['max'])}; {chan['n']} steps over 2 ranks), "
             f"CrossHostHitSync.step median {fms(sync['median'])} ms; bound "
             f"{fms(n_bytes / rate * 1e3)} ms ({n_bytes:,} B a rank over the host's copy "
             f"rate {rate / 1e9:.2f} GB/s); outputs equal to the numpy fold")


def host_batches(seed):
    """Phase 3's first HOST_WINDOWS windows, cut into client batches of
    HOST_BATCH requests."""
    batches, _ = request_stream(seed, HOST_WINDOWS)
    flat = [r for _, batch in batches for r in batch]
    return [flat[i:i + HOST_BATCH] for i in range(0, len(flat), HOST_BATCH)]


def single_instance(backend, **conf):
    """A self-owned Instance over `backend`, the decision ledger on."""
    inst = Instance(InstanceConfig(backend=backend, ledger_enabled=True, **conf),
                    advertise_address="127.0.0.1:1")
    inst.set_peers([PeerInfo(address="127.0.0.1:1")])
    return inst


def instance_run(seed, dev, results):
    """10b: the daemon's build_backend at GUBER_CACHE_SIZE=10000001 under a
    single-node Instance, with the metrics, hot-key tracker, profiler and
    ledger hooks wired as the daemon and the Instance wire them, against a
    CPU-twin Instance at depth 1."""
    saved = {k: os.environ.get(k) for k in ("GUBER_CACHE_SIZE", "GUBER_DEVICE")}
    os.environ["GUBER_CACHE_SIZE"] = str(CAPACITY)
    os.environ.pop("GUBER_DEVICE", None)  # the card, as the daemon defaults
    try:
        conf = config_from_env([])
        gpu_eng = build_backend(conf)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(type(gpu_eng) is Engine and gpu_eng.device.type == "cuda"
          and gpu_eng.capacity == CAPACITY, f"build_backend gave {gpu_eng!r}")
    t = time.perf_counter()
    gpu_eng.warmup()
    tlog(f"  10b: build_backend -> Engine on {gpu_eng.device}, {CAPACITY:,} slots, widths "
         f"{gpu_eng.min_width}-{gpu_eng.max_width}, warmed in {time.perf_counter() - t:.2f} s")
    cpu_eng = Engine(device="cpu", capacity=CAPACITY, min_width=gpu_eng.min_width,
                     max_width=gpu_eng.max_width)
    metrics = Metrics()
    gpu_eng.metrics = metrics  # as the daemon sets it
    for eng in (gpu_eng, cpu_eng):
        eng.hot_tracker = HotKeyTracker(CAPACITY, rate_threshold=1e18, window_s=3600.0,
                                        resolver=eng.resolve_slots)
    gpu, cpu = single_instance(gpu_eng), single_instance(cpu_eng, pipeline_depth=1)
    check(gpu.profiler is gpu_eng.profiler and gpu_eng.ledger is gpu.ledger,
          "the Instance did not take the engine's profiler and set its ledger")
    for inst in (gpu, cpu):
        # room for every window and key of the run: a full ring drops
        # windows, and a full key table declines the keys seen last, so
        # the twins' totals would depend on the order each path parks its
        # windows in (leftover tails first on the pipelined path)
        inst.ledger.pending_cap = 1 << 20
        inst.ledger.key_capacity = 1 << 21
    batches = host_batches(seed)
    n_req = sum(map(len, batches))
    dk.reset_launch_counts()
    rowk.reset_launch_counts()
    t = time.perf_counter()
    got = [resp_tuples(gpu.get_rate_limits(b, now_ms=NOW + i)) for i, b in enumerate(batches)]
    torch.cuda.synchronize(dev)
    gpu_s = time.perf_counter() - t
    launches = {**dk.launch_counts, **rowk.launch_counts}
    t = time.perf_counter()
    want = [resp_tuples(cpu.get_rate_limits(b, now_ms=NOW + i)) for i, b in enumerate(batches)]
    cpu_s = time.perf_counter() - t
    for i, (g, w) in enumerate(zip(got, want)):
        check(g == w, f"10b batch {i}: the card Instance and its CPU twin answer differently")
    gk, grows = rows_by_key(gpu_eng)
    ck, crows = rows_by_key(cpu_eng)
    check(gk == ck and torch.equal(grows, crows), "10b: table rows differ from the twin's")
    end = NOW + 24 * 3_600_000
    for inst in (gpu, cpu):
        inst.ledger.audit(inst.backend, now_ms=end, force=True)
    gl, cl = gpu.ledger.totals(), cpu.ledger.totals()
    sums = ("admits", "attempted", "rejected", "pending_dropped", "key_overflow")
    check(all(gl[k] == cl[k] for k in sums) and gl["attempted"] == sum(
        r.hits for b in batches for r in b) and gl["pending_dropped"] == 0
        and gl["key_overflow"] == 0, f"10b: ledger totals differ: {gl} vs {cl}")
    check(np.array_equal(gpu_eng.hot_tracker._counts, cpu_eng.hot_tracker._counts)
          and gpu_eng.hot_tracker._key_counts == cpu_eng.hot_tracker._key_counts,
          "10b: the hot-key trackers counted differently")
    debug = debug_plane(gpu, cpu, gpu_eng, gl)
    dispatch = metrics.registry.get_sample_value("engine_device_dispatch_milliseconds_count") or 0
    phases = {k: v["n"] for k, v in gpu_eng.profiler.totals().items()}
    check(dispatch > 0 and phases.get("dispatch", 0) > 0,
          f"10b: the metrics and profiler hooks saw no window ({dispatch}, {phases})")
    decides = {k: v for k, v in launches.items() if k.startswith("decide_") and v}
    check(sum(decides.values()) > 0, "10b: the Instance launched no decide kernel")
    results["instance"] = dict(
        requests=n_req, batches=len(batches), decisions_per_s=n_req / gpu_s,
        twin_decisions_per_s=n_req / cpu_s, launches=launches,
        ledger_admits=gl["admits"], ledger_attempted=gl["attempted"],
        ledger_rejected=gl["rejected"], hot_slots_counted=int(
            np.count_nonzero(gpu_eng.hot_tracker._counts)),
        device_dispatch_observations=dispatch, profiler_windows=phases,
        combiner=dict(gpu.combiner.stats), debug=debug)
    tlog(f"  10b: {n_req:,} requests in {len(batches)} batches of <= {HOST_BATCH} through "
         f"Instance.get_rate_limits: {n_req / gpu_s:,.0f} decisions/s on the card "
         f"({n_req / cpu_s:,.0f} on the CPU twin); answers, rows at {len(gk):,} keys, ledger "
         f"totals (admits {gl['admits']}, attempted {gl['attempted']:,}, rejected "
         f"{gl['rejected']:,}) and hot-key counts equal to the twin's; launches "
         f"{ {k: v for k, v in launches.items() if v} }")
    gpu.close()
    cpu.close()
    del gpu, cpu, gpu_eng, cpu_eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def keyspace_equal(got, want, what):
    """Two harvest reports agree on everything but the clock and the devices
    (hbm's per-device entries name each side's own)."""
    drop = ("captured_at", "harvest_ms", "hbm")
    check({k: v for k, v in got.items() if k not in drop}
          == {k: v for k, v in want.items() if k not in drop}
          and got["hbm"]["arrays"] == want["hbm"]["arrays"],
          f"{what}: the card's keyspace report differs from the CPU twin's")


def debug_plane(gpu, cpu, eng, totals):
    """10b's debug plane: /v1/debug/keyspace, /v1/debug/kernels and
    /v1/debug/ledger through an HTTP gateway on the CUDA Instance. The
    harvest must succeed (errors 0) and equal the CPU twin's, hbm must list
    the card's table once at its size, every kernel record must carry the
    bytes a window of its width moves, and the ledger's totals must be the
    run's."""
    gw = HttpGateway(gpu, "127.0.0.1:0")
    gw.start()
    try:
        def get(path):
            with urllib.request.urlopen(f"http://{gw.address}{path}", timeout=60) as r:
                return json.loads(r.read())

        t = time.perf_counter()
        keyspace = get("/v1/debug/keyspace?refresh=1")
        harvest_s = time.perf_counter() - t
        kernels = get("/v1/debug/kernels")["kernels"]
        ledger = get("/v1/debug/ledger")
    finally:
        gw.close()
    rep = keyspace["report"]
    check(gpu.keyspace.errors == 0 and gpu.keyspace.harvests > 0 and rep is not None,
          f"10b: the keyspace harvest failed on the card ({gpu.keyspace.errors} errors)")
    check(rep["hbm"]["per_device"] == [{"device": str(eng.state.device),
                                        "state_bytes": eng.state.nbytes}],
          f"10b: hbm_bytes per device {rep['hbm']['per_device']}")
    keyspace_equal(rep, cpu.keyspace.harvest(), "10b")
    fp = dk.kernel_fingerprint()
    bad = {name: rec["cost"] for name, rec in kernels.items()
           if rec["cost"] != {"fingerprint": fp, "bytes_accessed": float(dk.decide_bytes(
               name.split("@")[0].rsplit("_", 1)[1], int(name.split("@")[1]),
               int(name.split("@")[1])))}}
    check(kernels and not bad, f"10b: kernel cost records without their bytes: {bad}")
    check(all(ledger["totals"][k] == totals[k] for k in ("admits", "attempted", "rejected")),
          f"10b: /v1/debug/ledger totals {ledger['totals']} are not the run's {totals}")
    out = dict(harvest_s=harvest_s, keyspace_errors=gpu.keyspace.errors,
               per_device=rep["hbm"]["per_device"], top_keys=len(rep["top_keys"]),
               tracked_hits=rep["hit_mass"]["tracked_hits"], kernel_records=len(kernels))
    tlog(f"  10b debug plane: keyspace harvest {harvest_s * 1e3:.1f} ms through the "
         f"gateway, 0 errors, equal to the CPU twin's ({out['top_keys']} top keys, "
         f"{out['tracked_hits']:,} hits); hbm per device {out['per_device']}; "
         f"{len(kernels)} kernel records, each with its bytes_accessed; ledger totals "
         f"the run's")
    return out


def spawn_daemon(env_overrides, log_path, ready_timeout=240.0,
                 module="gubernator_tpu_torch.cmd.daemon", args=()):
    """The port's daemon (or another of its binaries, `module` with `args`)
    as a subprocess; waits for its Ready line."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("GUBER_DEVICE", None)  # the card, the daemon's default
    env.update(env_overrides)
    with open(log_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", module, *args],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err,
                                text=True)
    ready = threading.Event()

    def wait_ready():
        for line in proc.stdout:
            if "Ready" in line:
                ready.set()
                return

    threading.Thread(target=wait_ready, daemon=True).start()
    deadline = time.time() + ready_timeout
    while time.time() < deadline and not ready.is_set() and proc.poll() is None:
        time.sleep(0.05)
    return proc, ready.is_set()


def daemon_log(path):
    with open(path) as f:
        return f.read()[-3000:]


def metric_series(http_port, name):
    """A /metrics family's series: {labels: value} ("" for none)."""
    text = urllib.request.urlopen(f"http://127.0.0.1:{http_port}/metrics",
                                  timeout=10).read().decode()
    return {line.rsplit(" ", 1)[0][len(name):]: float(line.rsplit(" ", 1)[1])
            for line in text.splitlines() if line.startswith((name + " ", name + "{"))}


def metric(http_port, name, label=""):
    """The sum of a /metrics family's series whose labels hold `label`
    (0.0 when the family has none)."""
    return sum(v for k, v in metric_series(http_port, name).items() if label in k)


def daemons_run(seed, results):
    """10c: two port daemons on the card in one gloo group: GLOBAL hits
    taken at the non-owner converge at the owner over the collective (the
    gRPC GLOBAL pipelines frozen), then a token-bucket stream over gRPC to
    daemon 0 against a CPU-twin Instance."""
    tmp = tempfile.mkdtemp(prefix="guber-daemons-")
    coord = f"127.0.0.1:{free_port()}"
    grpc_ports = [free_port(), free_port()]
    http_ports = [free_port(), free_port()]
    addrs = [f"127.0.0.1:{p}" for p in grpc_ports]
    logs = [os.path.join(tmp, f"daemon{i}.log") for i in range(2)]
    booted = [None, None]
    t = time.perf_counter()

    def boot(i):
        booted[i] = spawn_daemon({
            "GUBER_GRPC_ADDRESS": addrs[i],
            "GUBER_HTTP_ADDRESS": f"127.0.0.1:{http_ports[i]}",
            "GUBER_PEERS": ",".join(addrs),
            "GUBER_CACHE_SIZE": str(DAEMON_CAPACITY),
            "GUBER_COORDINATOR_ADDRESS": coord,
            "GUBER_NUM_HOSTS": "2",
            "GUBER_HOST_ID": str(i),
            "GUBER_CROSS_HOST_SYNC": "50ms",
            "GUBER_CROSS_HOST_CAPACITY": "1024",
            "GUBER_GLOBAL_SYNC_WAIT": "1h",
        }, logs[i])

    threads = [threading.Thread(target=boot, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    procs = [b[0] for b in booted]
    boot_s = time.perf_counter() - t
    rec = results["daemons"] = {"boot_s": boot_s}
    try:
        for i, (proc, ok) in enumerate(booted):
            check(ok, f"10c: daemon {i} did not come up (rc {proc.poll()}):\n"
                      f"{daemon_log(logs[i])}")
        stubs = [dial_v1(a) for a in addrs]

        def ask(stub, reqs):
            return stub.GetRateLimits(pb.GetRateLimitsReq(requests=reqs),
                                      timeout=30).responses

        def greq(key, hits):
            return pb.RateLimitReq(name="xhost", unique_key=key, hits=hits, limit=100,
                                   duration=60_000, behavior=int(Behavior.GLOBAL))

        # GLOBAL convergence (tests/test_multihost.py's two-daemon case)
        key = None
        for i in range(32):
            r = ask(stubs[1], [greq(f"{i}conv", 5)])[0]
            check(r.error == "", f"10c: GLOBAL probe: {r.error}")
            if r.metadata["owner"] == addrs[0]:
                key = f"{i}conv"
                break
        check(key is not None, "10c: daemon 0 owns none of 32 probe keys")
        deadline = time.time() + 30
        while time.time() < deadline and \
                metric(http_ports[1], "cross_host_broadcasts_applied_total") < 1:
            time.sleep(0.1)
        check(metric(http_ports[1], "cross_host_broadcasts_applied_total") >= 1,
              "10c: the owner's broadcast never reached the non-owner")
        t_pour = time.perf_counter()
        for _ in range(4):
            check(ask(stubs[1], [greq(key, 3)])[0].error == "", "10c: GLOBAL pour failed")
        deadline = time.time() + 20
        remaining = None
        while time.time() < deadline:
            remaining = ask(stubs[0], [greq(key, 0)])[0].remaining
            if remaining == 83:
                break
            time.sleep(0.1)
        check(remaining == 83, f"10c: owner remaining {remaining}, want 83 (100 - 5 - 12)")
        converge_s = time.perf_counter() - t_pour  # pours sent to the owner's read of 83
        synced = metric(http_ports[1], "cross_host_hits_synced_total")
        applied = metric(http_ports[0], "cross_host_deltas_applied_total")
        conflicts = metric(http_ports[0], "cross_host_conflicts_total")
        check(synced >= 12 and applied >= 12 and conflicts == 0,
              f"10c: collective counters synced {synced}, applied {applied}, "
              f"conflicts {conflicts}")
        # the token-bucket stream, against a CPU-twin Instance
        batches, _ = request_stream(seed + 10, DAEMON_STREAM, width=HOST_BATCH)
        twin = single_instance(Engine(device="cpu", capacity=1 << 20, min_width=64,
                                      max_width=WINDOW), pipeline_depth=1)
        ticks0, tick_t0 = metric(http_ports[0], "cross_host_ticks_total"), time.time()
        t0_ms = int(time.time() * 1000)
        t = time.perf_counter()
        got = []
        for _, batch in batches:
            got.append(ask(stubs[0], [pb.RateLimitReq(
                name=r.name, unique_key=r.unique_key, hits=r.hits, limit=r.limit,
                duration=DAEMON_DURATION) for r in batch]))
        stream_s = time.perf_counter() - t
        t1_ms = int(time.time() * 1000)
        ticks1, tick_t1 = metric(http_ports[0], "cross_host_ticks_total"), time.time()
        n_req = 0
        for i, ((_, batch), rs) in enumerate(zip(batches, got)):
            want = twin.get_rate_limits([dataclasses.replace(
                r, algorithm=0, behavior=0, duration=DAEMON_DURATION) for r in batch],
                now_ms=NOW)
            for j, (g, w) in enumerate(zip(rs, want)):
                check(g.error == "" and (g.status, g.limit, g.remaining)
                      == (w.status, w.limit, w.remaining),
                      f"10c batch {i} item {j}: daemon {(g.status, g.limit, g.remaining)} "
                      f"vs twin {(w.status, w.limit, w.remaining)}")
                check(t0_ms + DAEMON_DURATION <= g.reset_time <= t1_ms + DAEMON_DURATION,
                      f"10c batch {i} item {j}: reset_time {g.reset_time} outside the "
                      f"phase's span")
            n_req += len(rs)
        twin.close()
        tick_ms = (tick_t1 - tick_t0) * 1e3 / max(ticks1 - ticks0, 1)
        kernels = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{http_ports[0]}/v1/debug/kernels", timeout=10).read())
        windows = {k: v["windows"] for k, v in kernels["kernels"].items()}
        check(sum(windows.values()) > 0, "10c: daemon 0 launched no decide window")
        rec.update(converge_s=converge_s, grpc_requests=n_req,
                   grpc_decisions_per_s=n_req / stream_s,
                   tick_period_ms=tick_ms, ticks=ticks1, hits_synced=synced,
                   deltas_applied=applied, daemon0_windows=windows)
        tlog(f"  10c: two daemons booted in {boot_s:.1f} s (Engine on the card, "
             f"{DAEMON_CAPACITY:,} slots each, one gloo group); GLOBAL hits at the non-owner "
             f"converged at the owner over the collective in {converge_s:.3f} s (pours sent to "
             f"the owner's read; polled every 0.1 s; synced {synced:.0f}, applied "
             f"{applied:.0f}, no conflict); {n_req:,} token requests over gRPC to daemon 0: "
             f"{n_req / stream_s:,.0f} decisions/s, status/limit/remaining equal to a CPU-twin "
             f"Instance, reset_time inside the phase; collective tick period "
             f"{fms(tick_ms)} ms over {ticks1 - ticks0:.0f} ticks (cadence 50 ms); daemon 0's "
             f"kernel windows {windows}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        rcs = []
        for proc in procs:
            try:
                rcs.append(proc.wait(timeout=60))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rcs.append("killed")
    check(rcs == [0, 0], f"10c: the daemons did not stop cleanly: {rcs}\n"
                         + "\n".join(daemon_log(p) for p in logs))
    rec["exit_codes"] = rcs
    shutil.rmtree(tmp, ignore_errors=True)


def phase_host_tier(seed, dev, results):
    log("== phase 10: the host tier: the cross-host exchange over a gloo group (10a), "
        "Instance over the daemon's backend (10b), two daemons on the card (10c)")
    t0 = time.perf_counter()
    exchange_run(seed, results)
    launches = instance_run(seed, dev, results)
    daemons_run(seed, results)
    tlog(f"  phase 10 in {time.perf_counter() - t0:.1f} s")
    return launches


BINARY_NODES = 6  # cmd/cluster_main.py's DEFAULT_PORTS
BINARY_STREAM = 4  # 11a: batches of HOST_BATCH token requests through each client
CLI_SECONDS = 5
FULL_RUN = "bot-storm"  # 11b: also at its full profile (60 s, one node)
THROUGHPUT = re.compile(r"sent=(\d+) over_limit=(\d+) errors=(\d+) rps=(\d+)")


def free_device_bytes(dev):
    return torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else 0


def stop_binary(proc):
    """SIGTERM, then the binary's exit code (it must be 0)."""
    if proc.poll() is None:
        proc.terminate()
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed"
    return rc


def binary_stream(seed, dev, addrs, rec):
    """11a's token stream: BINARY_STREAM batches through V1Client, one node
    after another, then BINARY_STREAM through HttpClient to an HTTP gateway
    over a front Instance that owns no key (its peers are the binary's six
    nodes, so it forwards every request to the binary); answers against a
    CPU-twin Instance."""
    front = Instance(InstanceConfig(
        backend=Engine(device=dev, capacity=4096, min_width=32, max_width=256),
        behaviors=test_behaviors()), advertise_address="127.0.0.1:1")
    front.set_peers([PeerInfo(address=a) for a in addrs])
    gw = HttpGateway(front, "127.0.0.1:0")
    gw.start()
    twin = single_instance(Engine(device="cpu", capacity=1 << 20, min_width=64,
                                  max_width=WINDOW), pipeline_depth=1)
    try:
        grpc_clients = [V1Client(a) for a in addrs]
        http = HttpClient(gw.address)
        batches, _ = request_stream(seed + 20, 2 * BINARY_STREAM, width=HOST_BATCH)
        t0_ms = int(time.time() * 1000)
        secs = {"grpc": 0.0, "http": 0.0}
        over = 0
        for i, (_, batch) in enumerate(batches):
            reqs = [RateLimitReq(name=r.name, unique_key=r.unique_key, hits=r.hits,
                                 limit=r.limit, duration=DAEMON_DURATION) for r in batch]
            kind = "grpc" if i < BINARY_STREAM else "http"
            client = grpc_clients[i % len(addrs)] if kind == "grpc" else http
            t = time.perf_counter()
            got = client.get_rate_limits(reqs, timeout=60)
            secs[kind] += time.perf_counter() - t
            want = twin.get_rate_limits(reqs, now_ms=NOW)
            over += sum(w.status for w in want)
            t1_ms = int(time.time() * 1000)
            check(len(got) == len(reqs), f"11a {kind} batch {i}: {len(got)} answers")
            for j, (g, w) in enumerate(zip(got, want)):
                check(g.error == "" and (g.status, g.limit, g.remaining)
                      == (w.status, w.limit, w.remaining),
                      f"11a {kind} batch {i} item {j}: binary "
                      f"{(g.status, g.limit, g.remaining, g.error)} vs twin "
                      f"{(w.status, w.limit, w.remaining)}")
                check(t0_ms + DAEMON_DURATION <= g.reset_time <= t1_ms + DAEMON_DURATION,
                      f"11a {kind} batch {i} item {j}: reset_time {g.reset_time} outside "
                      f"the phase's span")
        n = BINARY_STREAM * HOST_BATCH
        rec.update(grpc_requests=n, grpc_decisions_per_s=n / secs["grpc"],
                   http_requests=n, http_decisions_per_s=n / secs["http"],
                   over_limit=over)
    finally:
        gw.close()
        front.close()
        twin.close()


def binary_run(seed, dev, results):
    """11a: python -m gubernator_tpu_torch.cmd.cluster_main on six free
    ports, with no GUBER_DEVICE (the card): Ready, a token stream through the
    port's V1Client and HttpClient against a CPU twin, the CLI for
    CLI_SECONDS, exit 0 on SIGTERM; then once more with --etcd: every node
    sees six peers through etcdlite, exit 0 on SIGTERM."""
    tmp = tempfile.mkdtemp(prefix="guber-binary-")
    rec = results["binary"] = {}
    for mode in ("peers", "etcd"):
        ports = [free_port() for _ in range(BINARY_NODES)]
        addrs = [f"127.0.0.1:{p}" for p in ports]
        log_path = os.path.join(tmp, f"binary-{mode}.log")
        free0 = free_device_bytes(dev)
        t = time.perf_counter()
        proc, ok = spawn_daemon(
            {}, log_path, module="gubernator_tpu_torch.cmd.cluster_main",
            args=(["--etcd"] if mode == "etcd" else []) + [str(p) for p in ports])
        boot_s = time.perf_counter() - t
        held = free0 - free_device_bytes(dev)
        r = rec[mode] = {"boot_s": boot_s, "device_bytes_taken": held}
        try:
            check(ok, f"11a: the cluster binary ({mode}) did not print Ready "
                      f"(rc {proc.poll()}):\n{daemon_log(log_path)}")
            # the child's CUDA context and engines take memory on the card
            check(dev.type != "cuda" or held > 100 << 20,
                  f"11a: the binary took {held:,} B of the card's memory")
            health = [V1Client(a).health_check(timeout=30) for a in addrs]
            check(all(h.status == "healthy" and h.peer_count == BINARY_NODES
                      for h in health),
                  f"11a ({mode}): health {[(h.status, h.peer_count) for h in health]}")
            if mode == "peers":
                binary_stream(seed, dev, addrs, r)
                cli = subprocess.run(
                    [sys.executable, "-m", "gubernator_tpu_torch.cmd.cli", addrs[0],
                     "--seconds", str(CLI_SECONDS)], cwd=ROOT, capture_output=True,
                    text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
                lines = cli.stdout.strip().splitlines()
                m = THROUGHPUT.fullmatch(lines[-1]) if lines else None
                check(cli.returncode == 0 and m is not None,
                      f"11a: the CLI exited {cli.returncode}, last line "
                      f"{lines[-1] if lines else None!r}:\n{cli.stderr[-2000:]}")
                sent, over, errs, rps = map(int, m.groups())
                check(sent > 0 and errs == 0, f"11a: the CLI's line {lines[-1]!r}")
                r.update(cli=dict(sent=sent, over_limit=over, errors=errs, rps=rps))
        finally:
            r["exit_code"] = stop_binary(proc)
        check(r["exit_code"] == 0, f"11a: the binary ({mode}) exited {r['exit_code']} "
                                   f"on SIGTERM:\n{daemon_log(log_path)}")
    shutil.rmtree(tmp, ignore_errors=True)
    p, e = rec["peers"], rec["etcd"]
    tlog(f"  11a: cluster_main, {BINARY_NODES} nodes on the card (Ready in "
         f"{fms(p['boot_s'], 1)} s, {p['device_bytes_taken'] / 2**20:,.0f} MiB of the card "
         f"taken): {p['grpc_requests']:,} token requests through V1Client "
         f"({p['grpc_decisions_per_s']:,.0f} decisions/s) and {p['http_requests']:,} through "
         f"HttpClient via a forwarding front ({p['http_decisions_per_s']:,.0f}/s), equal to "
         f"a CPU twin ({p['over_limit']:,} OVER_LIMIT); the CLI for {CLI_SECONDS} s: "
         f"{p['cli']}; exit {p['exit_code']} on SIGTERM. With --etcd: Ready in "
         f"{fms(e['boot_s'], 1)} s, every node's "
         f"peer_count {BINARY_NODES} through the client, exit {e['exit_code']} on SIGTERM")


def counts_now():
    return {**dk.launch_counts, **rowk.launch_counts}


def add_counts(total, more):
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def atlas_run(name, profile, dev, capacity):
    """One scenario through the runner on a LocalCluster of `capacity`
    slots a node on `dev`, booted as run_scenario boots its own (the
    runner's behaviors, its boot grace); launch counts set to 0 just before
    the run and read just after."""
    scaled = get_scenario(name).for_profile(profile)
    behaviors = scen_runner._cluster_behaviors(scaled)
    t = time.perf_counter()
    cluster = LocalCluster(device=dev).start(
        scaled.nodes, capacity=capacity, behaviors=dataclasses.replace(behaviors))
    time.sleep(0.3)
    boot_s = time.perf_counter() - t
    try:
        dk.reset_launch_counts()
        rowk.reset_launch_counts()
        v = run_scenario(get_scenario(name), cluster=cluster, profile=profile)
        launches = counts_now()
        caps = [ci.instance.backend.capacity for ci in cluster.instances]
    finally:
        faults.clear()
        cluster.stop()
        del cluster
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return v, launches, caps, boot_s


def verdict_line(v):
    st = v["stats"]
    lat = st["latency_ms"]
    return (f"p50 {lat['p50']} ms, p99 {lat['p99']} ms, goodput {v['goodput']}, "
            f"error share {v['error_share']}, over-limit share {v['over_limit_share']}, "
            f"{st['offered']:,} offered in {st['batches']} batches, largest pacing lag "
            f"{st['max_lag_s']} s")


def atlas_runs(dev, results):
    """11b: every scenario of the atlas at its short profile, and FULL_RUN
    at its full profile, on port clusters of CAPACITY slots a node on the
    card. Every verdict must PASS, and every run must have launched decide
    kernels. (The traced rerun of FULL_RUN short and its run on a CPU
    cluster were cut for phase 13's time; phase 13 traces the card.)"""
    rec = results["atlas"] = {}
    total = {}
    runs = [(n, "short") for n in SCENARIO_NAMES] + [(FULL_RUN, "full")]
    for name, profile in runs:
        v, launches, caps, boot_s = atlas_run(name, profile, dev, CAPACITY)
        failed = [c for c in v["checks"] if not c["ok"]]
        check(v["passed"], f"11b {name} ({profile}): FAIL {failed}")
        decides = {k: n for k, n in launches.items() if k.startswith("decide_") and n}
        rows = {k: n for k, n in launches.items() if not k.startswith("decide_") and n}
        check(sum(decides.values()) > 0, f"11b {name} ({profile}): no decide launch")
        add_counts(total, launches)
        rec[f"{name}/{profile}/{dev.type}"] = dict(
            passed=v["passed"], checks=v["checks"], goodput=v["goodput"],
            error_share=v["error_share"], over_limit_share=v["over_limit_share"],
            stats={k: v["stats"][k] for k in (
                "offered", "ok", "over_limit", "errors", "batches", "max_lag_s",
                "latency_ms", "detectors_tripped", "conservation", "events")},
            decide_launches=decides, row_launches=rows, capacities=caps, boot_s=boot_s)
        tlog(f"  11b {name} ({profile}, the card, "
             f"{len(caps)} nodes of {caps} slots after the run, booted in {boot_s:.2f} s): "
             f"PASS; {verdict_line(v)}; decide launches {decides}, row launches {rows}; "
             f"events {[(e['action'], e['fired_at_s'], e['error']) for e in v['stats']['events']]}")
    return total


def atlas_frozen(dev, results):
    """11c: each scenario's short schedule, cut into the runner's windows,
    through a card Instance of CAPACITY slots (the harness's widths, the
    runner's behaviors) and a CPU twin at depth 1, now_ms = NOW + the
    window's offset: answers, rows at every key and ledger totals equal."""
    rec = results["atlas_frozen"] = {}
    total = {}
    for name in SCENARIO_NAMES:
        scaled = get_scenario(name).for_profile("short")
        schedule = WorkloadGenerator(scaled).schedule()
        behaviors = scen_runner._cluster_behaviors(scaled)
        gpu_eng = Engine(device=dev, capacity=CAPACITY, min_width=32, max_width=256)
        gpu_eng.warmup()
        cpu_eng = Engine(device="cpu", capacity=CAPACITY, min_width=32, max_width=256)
        gpu = single_instance(gpu_eng, behaviors=dataclasses.replace(behaviors))
        cpu = single_instance(cpu_eng, behaviors=dataclasses.replace(behaviors),
                              pipeline_depth=1)
        windows = list(windowed(schedule, scen_runner.BATCH_WINDOW_S))
        dk.reset_launch_counts()
        rowk.reset_launch_counts()
        t = time.perf_counter()
        got = [resp_tuples(gpu.get_rate_limits([a.to_request() for a in arr],
                                               now_ms=NOW + int(round(s * 1000))))
               for s, arr in windows]
        gpu_s = time.perf_counter() - t
        launches = counts_now()
        add_counts(total, launches)
        for i, (s, arr) in enumerate(windows):
            want = resp_tuples(cpu.get_rate_limits([a.to_request() for a in arr],
                                                   now_ms=NOW + int(round(s * 1000))))
            check(got[i] == want, f"11c {name} window {i}: the card Instance and its CPU "
                                  f"twin answer differently")
        gk, grows = rows_by_key(gpu_eng)
        ck, crows = rows_by_key(cpu_eng)
        check(gk == ck and torch.equal(grows, crows), f"11c {name}: rows differ from the twin's")
        end = NOW + 24 * 3_600_000
        for inst in (gpu, cpu):
            inst.ledger.audit(inst.backend, now_ms=end, force=True)
        gl, cl = gpu.ledger.totals(), cpu.ledger.totals()
        check(gl == cl and gl["attempted"] == sum(a.hits for a in schedule),
              f"11c {name}: ledger totals differ: {gl} vs {cl}")
        decides = {k: n for k, n in launches.items() if k.startswith("decide_") and n}
        check(sum(decides.values()) > 0, f"11c {name}: no decide launch")
        rec[name] = dict(requests=len(schedule), windows=len(windows), keys=len(gk),
                         card_decisions_per_s=len(schedule) / gpu_s, launches=decides,
                         ledger_admits=gl["admits"])
        tlog(f"  11c {name}: {len(schedule):,} requests in {len(windows)} windows, "
             f"{len(schedule) / gpu_s:,.0f} decisions/s on the card; answers, rows at "
             f"{len(gk):,} keys and ledger totals (admits {gl['admits']}) equal to the CPU "
             f"twin's; decide launches {decides}")
        gpu.close()
        cpu.close()
        del gpu, cpu, gpu_eng, cpu_eng
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return total


def phase_atlas(seed, dev, results):
    log("== phase 11: the entry points: the cluster binary and its clients (11a), the "
        f"scenario atlas on port clusters of {CAPACITY:,} slots a node on the card (11b), "
        "the atlas's schedules on a frozen clock against a CPU twin (11c)")
    t0 = time.perf_counter()
    binary_run(seed, dev, results)
    launches = atlas_runs(dev, results)
    add_counts(launches, atlas_frozen(dev, results))
    tlog(f"  phase 11 in {time.perf_counter() - t0:.1f} s; launches "
         f"{ {k: v for k, v in launches.items() if v} }")
    return launches


WIRE_PULLS = 10  # 12: pulls' worth of WINDOW requests of phase 3's stream (81,920);
# 20 made the phase 93.5 s, 74.4 s of it the CPU twin (cut for phase 13's time)
WIRE_CONNS = 24  # sender connections; all of a key's requests ride one of them


def wire_frames(seed):
    """Phase 3's first WIRE_PULLS windows as frames of MAX_FRAME_ITEMS: key k's
    requests ride connection k % WIRE_CONNS in stream order, so the order of
    a key's requests is the order of its connection's frames."""
    batches, _ = request_stream(seed, WIRE_PULLS)
    per_conn = [[] for _ in range(WIRE_CONNS)]
    for keys, batch in batches:
        for k, r in zip(keys.tolist(), batch):
            per_conn[k % WIRE_CONNS].append(r)
    return [[reqs[i:i + MAX_FRAME_ITEMS] for i in range(0, len(reqs), MAX_FRAME_ITEMS)]
            for reqs in per_conn]


@contextlib.contextmanager
def frozen_now(now):
    """Every module of the port that took millisecond_now reads `now` (the
    wire carries no clock: the owner decides on its own, so the card and its
    CPU twin must read one)."""
    orig = interval.millisecond_now
    patched = [m for name, m in list(sys.modules.items())
               if name.startswith("gubernator_tpu_torch")
               and getattr(m, "millisecond_now", None) is orig]
    for m in patched:
        m.millisecond_now = lambda: now
    try:
        yield
    finally:
        for m in patched:
            m.millisecond_now = orig


def record_columnar(eng):
    """Every columnar launch of `eng` (launch_columnar_windows for a group of
    sub-windows, submit_columnar for a pull served lock-step, as a pull of
    one sub-window is): the launches by (windows consumed, bucket width),
    and the item counts of the windows consumed."""
    from gubernator_tpu_torch.models.prep import bucket_width

    rec = {"shapes": {}, "items": []}
    group, single = eng.launch_columnar_windows, eng.submit_columnar

    def note(ns):
        key = (len(ns), max(bucket_width(n, eng.min_width, eng.max_width) for n in ns))
        rec["shapes"][key] = rec["shapes"].get(key, 0) + 1
        rec["items"].extend(ns)

    def launch(windows, slow_mask, now_ms=None, staging=None):
        h = group(windows, slow_mask, now_ms=now_ms, staging=staging)
        if h is not None and h[0]:
            note([wc[0] for wc in windows[:len(h[0])]])
        return h

    def submit(n, *cols, now_ms=None):
        h = single(n, *cols, now_ms=now_ms)
        if h is not None:
            note([n])
        return h

    eng.launch_columnar_windows, eng.submit_columnar = launch, submit
    return rec


def send_frames(port, frames):
    """One PeerLinkClient a connection, all started together, each with one
    frame in flight (a frame goes out when the last one is answered). Returns
    the answers by connection, frame and item, the seconds from the start
    until the last answer, and each client's wire version."""
    clients = [PeerLinkClient(f"127.0.0.1:{port}") for _ in frames]
    got, errs = [None] * len(frames), []
    start = threading.Barrier(len(frames) + 1)

    def run(i):
        try:
            start.wait()
            got[i] = [resp_tuples(clients[i].call(METHOD_GET_PEER_RATE_LIMITS, f, 120.0))
                      for f in frames[i]]
        except Exception as e:  # noqa: BLE001 — reported below, the phase fails
            errs.append(f"connection {i}: {e!r}")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(frames))]
    for th in threads:
        th.start()
    start.wait()
    t = time.perf_counter()
    for th in threads:
        th.join()
    secs = time.perf_counter() - t
    versions = [c.wire_version for c in clients]
    for c in clients:
        c.close()
    check(not errs, f"12: senders failed: {errs[:3]}")
    return got, secs, versions


def wire_run(dev, frames, want, wire_v2, twin_eng, results):
    """One card engine of CAPACITY slots (widths 64-WINDOW) under a
    single-node Instance behind PeerLinkService(wire_v2=...,
    columnar_pipeline=True); every frame of `frames` sent over the link, the
    launch counts set to 0 just before and read just after. Answers must
    equal the twin's (`want`), and so must the rows at every key."""
    tag = "12a" if wire_v2 else "12b"
    eng = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    eng.warmup()
    inst = single_instance(eng)
    svc = PeerLinkService(inst, port=0, wire_v2=wire_v2, columnar_pipeline=True)
    rec = record_columnar(eng)
    pulls = []  # the items of each pull (pls_next_batch), frames of every connection
    handle = svc._handle_batch

    def handle_batch(got, *a, **kw):
        pulls.append(got)
        return handle(got, *a, **kw)

    svc._handle_batch = handle_batch
    try:
        dk.reset_launch_counts()
        rowk.reset_launch_counts()
        got, secs, versions = send_frames(svc.port, frames)
        launches = counts_now()
        shapes = shapes_line(dk.launch_shapes)
        wire, stats = svc.wire_debug(), dict(svc.stats)
    finally:
        svc.close()
    n = sum(len(f) for conn in frames for f in conn)
    for i, conn in enumerate(got):
        for j, frame in enumerate(conn):
            check(frame == want[i][j], f"{tag} connection {i} frame {j}: the card and its "
                                       "CPU twin answer differently")
    gk, grows = rows_by_key(eng)
    ck, crows = rows_by_key(twin_eng)
    check(gk == ck and torch.equal(grows, crows), f"{tag}: rows differ from the twin's")
    decides = {k: v for k, v in launches.items() if k.startswith("decide_") and v}
    check(sum(decides.values()) > 0, f"{tag}: no decide launch")
    check(rec["items"], f"{tag}: no columnar launch")
    full = sum(1 for m in pulls if m == PeerLinkService.MAX_N)
    by_shape = {f"K={k} W={w}": c for (k, w), c in sorted(rec["shapes"].items())}
    if wire_v2:
        check(set(versions) == {2} and wire["v2_conns"] >= 1,
              f"12a: clients at wire versions {sorted(set(versions))}, "
              f"pls_v2_conns {wire['v2_conns']}")
        check(full >= 1, f"12a: no pull aggregated {PeerLinkService.MAX_N} requests "
                         f"(largest {max(pulls)})")
    else:
        check(set(versions) == {1} and wire["v2_conns"] == 0,
              f"12b: clients at wire versions {sorted(set(versions))}, "
              f"pls_v2_conns {wire['v2_conns']} on the pinned server")
    results[tag] = dict(
        requests=n, seconds=secs, decisions_per_s=n / secs, v2_conns=wire["v2_conns"],
        partial_posts=wire["partial_posts"], pull_boundary_stalls=stats["pull_boundary_stalls"],
        columnar_windows=stats["columnar_windows"], columnar_groups=stats["columnar_groups"],
        columnar_cuts=stats["columnar_cuts"], launches_by_shape=by_shape,
        pulls=len(pulls), full_pulls=full, pull_items=np.bincount(
            np.minimum(np.asarray(pulls) // MAX_FRAME_ITEMS, 8)).tolist(),
        widest_window=max(rec["items"]), columnar_windows_launched=len(rec["items"]),
        decide_launches=decides,
        decide_shapes=shapes, row_launches={k: v for k, v in launches.items()
                                            if not k.startswith("decide_") and v},
        keys=len(gk))
    tlog(f"  {tag} wire_v2={wire_v2}: {n:,} requests in {secs:.3f} s, {n / secs:,.0f} "
         f"decisions/s over {len(frames)} connections; pls_v2_conns {wire['v2_conns']}, "
         f"partial posts {wire['partial_posts']}, pull-boundary stalls "
         f"{stats['pull_boundary_stalls']}, columnar windows {stats['columnar_windows']} "
         f"in {stats['columnar_groups']} groups ({stats['columnar_cuts']} cuts); {len(pulls)} "
         f"pulls, {full} of {PeerLinkService.MAX_N} requests, by whole frames of "
         f"{MAX_FRAME_ITEMS} {results[tag]['pull_items']}; columnar launches by windows and "
         f"width {by_shape} (widest window {max(rec['items'])} lanes: the service serves a "
         f"pull in runs of at most MAX_BATCH_SIZE); decide launches {decides} by shape "
         f"{shapes}; "
         f"answers and rows at {len(gk):,} keys equal to the CPU twin's")
    inst.close()
    del inst, eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def phase_wire(seed, dev, results):
    """12: the wire v2 owner path at full width. The clock is frozen at NOW
    (as 11c freezes it); the CPU twin is an Instance over Engine(device=
    "cpu") fed each connection's frames in order through
    apply_owner_batch_direct (keys never share a connection, so a key's
    requests reach both in one order)."""
    log(f"== phase 12: the wire v2 owner path: {WIRE_PULLS} pulls' worth of {WINDOW} "
        f"requests of phase 3's stream over {WIRE_CONNS} peerlink connections, frames of "
        f"{MAX_FRAME_ITEMS}, into Engine(capacity={CAPACITY}, widths 64-{WINDOW}) on the "
        "card behind PeerLinkService(wire_v2=True, columnar_pipeline=True) (12a), then a "
        "wire_v2=False server (12b), each against a CPU-twin Instance")
    t0 = time.perf_counter()
    rec = results["wire"] = {}
    frames = wire_frames(seed)
    with frozen_now(NOW):
        twin_eng = Engine(device="cpu", capacity=CAPACITY, min_width=64, max_width=WINDOW)
        twin = single_instance(twin_eng)
        t = time.perf_counter()
        want = [[resp_tuples(twin.apply_owner_batch_direct(f, now_ms=NOW, from_peer_rpc=True))
                 for f in conn] for conn in frames]
        rec["twin_s"] = time.perf_counter() - t
        twin.close()
        launches = {}
        for wire_v2 in (True, False):
            add_counts(launches, wire_run(dev, frames, want, wire_v2, twin_eng, rec))
    rec["seconds"] = time.perf_counter() - t0
    tlog(f"  phase 12 in {rec['seconds']:.1f} s (the CPU twin {rec['twin_s']:.1f} s); "
         f"launches { {k: v for k, v in launches.items() if v} }")
    return launches


OVERLOAD_NODES = 2
OVERLOAD_SENDERS = 32  # sender threads of each step; in 13b-13c each call has its own budget
OVERLOAD_POOL = 400  # client batches of HOST_BATCH drawn once and cycled (400,000 requests)
CALM_S, OVERLOAD_S, RECOVERY_S = 5.0, 10.0, 3.0  # 13a closed loop; 13b at 2R, 13c at R/2
OVERLOAD_FACTOR, RECOVERY_FACTOR = 2.0, 0.5
# each call's budget in 13b-13c: twice the overload step, so no budget dies
# before the step's last call returns. A call whose owner-local part dies
# in a combiner queue raises DeadlineExceededError whole while its
# forwarded part may already be applied at the owner (5 s budgets did die
# so on the card), and conservation could then not be checked exactly
OVERLOAD_BUDGET_MS = 2 * OVERLOAD_S * 1000
SHED_P99_MS = 50.0  # tests/test_overload.py (c): a saturated node refuses in < 50 ms
OVERLOAD_TRACE_S = 2.0  # 13b's stretch under torch.profiler, from its third second
HEALTH_POLL_S = 0.05
UNDER_LIMIT = int(Status.UNDER_LIMIT)


def overload_stream(seed):
    """OVERLOAD_POOL client batches of HOST_BATCH requests of phase 3's mix:
    Zipf(1.1) over N_KEYS keys, 80% token / 20% leaky, limits of 10 to
    10,000; of every ten batches six send hits = 1, four hits of 2-5 on a
    tenth. Every duration is one hour and none is gregorian, so no bucket
    refills inside the phase. Returns the batches, each batch's key indices
    and hits, and each key's (algorithm, limit)."""
    rng = np.random.default_rng(seed + 13)
    cdf = np.cumsum(1.0 / np.arange(1, N_KEYS + 1, dtype=np.float64) ** 1.1)
    cdf /= cdf[-1]
    key_algo = (rng.random(N_KEYS) < 0.2).astype(np.int64)
    key_limit = rng.choice([10, 100, 1000, 10_000], N_KEYS)
    batches, cols = [], []
    for i in range(OVERLOAD_POOL):
        keys = np.minimum(np.searchsorted(cdf, rng.random(HOST_BATCH)), N_KEYS - 1)
        hits = np.where((i % 10 < 6) | (rng.random(HOST_BATCH) < 0.9), 1,
                        rng.integers(2, 6, HOST_BATCH))
        batches.append([RateLimitReq(name="ovl", unique_key=f"k{k}", hits=h,
                                     limit=int(key_limit[k]), duration=DAEMON_DURATION,
                                     algorithm=int(key_algo[k]))
                        for k, h in zip(keys.tolist(), hits.tolist())])
        cols.append((keys, hits))
    return batches, cols, (key_algo, key_limit)


def card_node(dev, port=0, times=None):
    """One node as LocalCluster.start_instance builds one (an Instance behind
    its gRPC server on `port`, 0 for any, the harness's behaviors, peers
    over gRPC), its Engine at CAPACITY slots with the daemon's widths
    64-WINDOW on `dev`. `times`, when given, gets the clock reading when
    the Engine's warmup is done (`warm_t`)."""
    eng = Engine(device=dev, capacity=CAPACITY, min_width=64, max_width=WINDOW)
    eng.warmup()
    if times is not None:
        times["warm_t"] = time.perf_counter()
    metrics = Metrics()
    eng.metrics = metrics
    inst = Instance(InstanceConfig(behaviors=test_behaviors(), backend=eng,
                                   metrics=metrics), advertise_address="pending")
    server, port = make_server(inst, f"127.0.0.1:{port}")
    inst.advertise_address = f"127.0.0.1:{port}"
    server.start()
    return ClusterInstance(address=inst.advertise_address, datacenter="", instance=inst,
                           server=server, metrics=metrics)


def overload_cluster(dev):
    """A two-node port LocalCluster of card_node's nodes."""
    cluster = LocalCluster(device=dev)
    cluster.instances = [card_node(dev) for _ in range(OVERLOAD_NODES)]
    cluster.sync_peers()
    return cluster


ERR_NONE, ERR_SHED, ERR_DEADLINE, ERR_OTHER = range(4)


def error_class(text):
    if not text:
        return ERR_NONE
    if "RESOURCE_EXHAUSTED" in text:
        return ERR_SHED
    if "DEADLINE_EXCEEDED" in text or "budget" in text:
        return ERR_DEADLINE
    return ERR_OTHER


def answer_columns(rs):
    """One call's answers as arrays (status, remaining, limit, error class)
    and its first few unclassified errors: the sender keeps these, not the
    answer objects, so the step's own bookkeeping holds no objects the
    interpreter's collector must walk while the cluster serves."""
    n = len(rs)
    err = np.fromiter((error_class(r.error) for r in rs), np.int8, n)
    other = [r.error[:300] for r, e in zip(rs, err) if e == ERR_OTHER][:3]
    return (np.fromiter((r.status for r in rs), np.int64, n),
            np.fromiter((r.remaining for r in rs), np.int64, n),
            np.fromiter((r.limit for r in rs), np.int64, n), err, other)


class GcPauses:
    """The interpreter's collector pauses while armed (gc.callbacks): how
    many collections of the oldest generation, and the seconds all
    collections held every thread."""

    def __init__(self):
        self.n2, self.total_s, self.max_s, self._t = 0, 0.0, 0.0, None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            d = time.perf_counter() - self._t
            self.total_s += d
            self.max_s = max(self.max_s, d)
            self.n2 += info["generation"] == 2

    def take(self):
        out = dict(gen2_collections=self.n2, pause_s=self.total_s, longest_s=self.max_s)
        self.n2, self.total_s, self.max_s = 0, 0.0, 0.0
        return out

    def close(self):
        gc.callbacks.remove(self._cb)


def overload_send(cluster, pool, seconds, rate=None, budget_ms=None):
    """OVERLOAD_SENDERS threads send pool batches (call i: batch i % pool to
    node i % nodes) through Instance.get_rate_limits, each call under its
    own deadline budget when `budget_ms` is given. Closed loop when `rate`
    is None, else open loop: call i is due at start + i * HOST_BATCH /
    rate, and a sender that is late sends at once. Returns the started
    threads, the list they append each call to as (i, node, seconds late,
    seconds taken, answer_columns of the answers or the exception), and the
    start time."""
    nodes = [ci.instance for ci in cluster.instances]
    lock, state, calls = threading.Lock(), {"next": 0}, []
    start = threading.Barrier(OVERLOAD_SENDERS + 1)

    def sender():
        start.wait()
        t0 = state["t0"]
        while True:
            with lock:
                i = state["next"]
                state["next"] += 1
            due = t0 + (i * HOST_BATCH / rate if rate else 0.0)
            if due >= t0 + seconds or (rate is None and time.perf_counter() >= t0 + seconds):
                return
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            token = deadline_mod.use(deadline_mod.capture(budget_ms))
            t = time.perf_counter()
            try:
                got = nodes[i % len(nodes)].get_rate_limits(pool[i % len(pool)])
            except Exception as e:  # noqa: BLE001 — classified below
                got = e
            finally:
                deadline_mod.reset(token)
            took = time.perf_counter() - t
            if not isinstance(got, BaseException):
                got = answer_columns(got)
            with lock:
                calls.append((i, i % len(nodes), max(t - due, 0.0) if rate else 0.0,
                              took, got))

    threads = [threading.Thread(target=sender) for _ in range(OVERLOAD_SENDERS)]
    for th in threads:
        th.start()
    state["t0"] = time.perf_counter()
    start.wait()
    return threads, calls, state["t0"]


def overload_join(threads, t0):
    for th in threads:
        th.join()
    return time.perf_counter() - t0


def pct(a, q):
    return float(np.percentile(a, q)) * 1e3 if len(a) else None


def overload_account(tag, calls, cols, owner, key_cfg, admitted, sent):
    """Each answer of `calls` by class: decided (UNDER_LIMIT, OVER_LIMIT),
    shed (RESOURCE_EXHAUSTED: a saturated node's refusal of the whole call,
    a brownout shed of a forward, an owner's refusal of a forwarded batch),
    deadline (DEADLINE_EXCEEDED) or failed (anything else), split by owner-
    local and forwarded requests. Adds the hits of UNDER_LIMIT token answers
    to `admitted` (by key index), the pool batches sent to `sent`, and checks
    every decided answer's limit and status against its key. Returns the
    step's record."""
    algo, limit = key_cfg
    n_pool = len(cols)
    rec = dict(calls=len(calls), refused_calls=0, deadline_calls=0, failed=[],
               offered=dict(local=0, forward=0), decided=dict(local=0, forward=0),
               shed=dict(local=0, forward=0), deadline=dict(local=0, forward=0),
               under_limit=0, over_limit=0)
    lat = dict(refused=[], with_sheds=[], admitted=[])
    lateness = []
    for i, node, late, took, got in calls:
        keys, hits = cols[i % n_pool]
        sent.add(i % n_pool)
        local = owner[keys] == node
        n_local = int(local.sum())
        rec["offered"]["local"] += n_local
        rec["offered"]["forward"] += len(keys) - n_local
        lateness.append(late)
        if isinstance(got, BaseException):
            text = f"{type(got).__name__}: {got}"
            if isinstance(got, deadline_mod.AdmissionRejectedError):
                cls = "shed"
                rec["refused_calls"] += 1
                lat["refused"].append(took)
            elif isinstance(got, deadline_mod.DeadlineExceededError):
                cls = "deadline"
                rec["deadline_calls"] += 1
            else:
                rec["failed"].append(text[:300])
                continue
            rec[cls]["local"] += n_local
            rec[cls]["forward"] += len(keys) - n_local
            continue
        status, remaining, lim, err, other_text = got
        ok, shed, late_dl = err == ERR_NONE, err == ERR_SHED, err == ERR_DEADLINE
        if (err == ERR_OTHER).any():
            rec["failed"].extend(other_text or [f"{int((err == ERR_OTHER).sum())} errors"])
        for cls, m in (("decided", ok), ("shed", shed), ("deadline", late_dl)):
            rec[cls]["local"] += int((m & local).sum())
            rec[cls]["forward"] += int((m & ~local).sum())
        (lat["with_sheds"] if shed.any() else lat["admitted"]).append(took)
        k_ok = keys[ok]
        check(np.array_equal(lim[ok], limit[k_ok]) and np.isin(status[ok], (0, 1)).all()
              and (remaining[ok] >= 0).all() and (remaining[ok] <= lim[ok]).all(),
              f"{tag} call {i}: a decided answer's limit, status or remaining disagrees "
              "with its key")
        under = ok & (status == UNDER_LIMIT)
        rec["under_limit"] += int(under.sum())
        rec["over_limit"] += int((ok & (status != UNDER_LIMIT)).sum())
        token = under & (algo[keys] == 0)
        np.add.at(admitted, keys[token], hits[token])
    for cls in ("refused", "with_sheds", "admitted"):
        a = np.asarray(lat[cls])
        rec[f"{cls}_calls_ms"] = dict(n=len(a), p50=pct(a, 50), p99=pct(a, 99),
                                      max=float(a.max()) * 1e3 if len(a) else None)
    rec["lateness_ms"] = dict(p50=pct(np.asarray(lateness), 50),
                              p99=pct(np.asarray(lateness), 99))
    rec["shed_share"] = {c: rec["shed"][c] / max(rec["offered"][c], 1)
                         for c in ("local", "forward")}
    rec["goodput"] = {c: rec["decided"][c] / max(rec["offered"][c], 1)
                      for c in ("local", "forward")}
    return rec


def node_sheds(cluster):
    """Each node's admission shed counters and its combiner's
    deadline-expired dequeues."""
    return [dict(ci.instance.admission.stats,
                 deadline_shed=ci.instance.combiner.stats["deadline_shed"])
            for ci in cluster.instances]


def node_work(cluster):
    """Each node's engine counters and stage clocks (seconds) and its
    combiner's submissions and windows."""
    out = []
    for ci in cluster.instances:
        d = ci.instance.backend.stats.as_dict()
        st = ci.instance.combiner.stats
        out.append(dict({k: d[k] for k in ("requests", "batches", "rounds",
                                            "native_singles")},
                        **{s: d[f"{s}_ns"] / 1e9 for s in EngineStats.STAGES},
                        submissions=st["submissions"], windows=st["windows"]))
    return out


def deltas(before, after):
    return [{k: a[k] - b.get(k, 0) for k in a} for b, a in zip(before, after)]


def overload_conservation(cluster, owner, key_cfg, admitted, touched):
    """At every token key the three steps touched, on its owner's engine
    (Engine.rows_for_keys, lone-path mirrors injected first): limit -
    remaining equals the hits of every UNDER_LIMIT answer the callers got,
    so no shed request, at the forwarder or the owner, charged a bucket.
    A key no answer admitted must hold no charged row."""
    algo, limit = key_cfg
    token = touched[algo[touched] == 0]
    n_rows = 0
    for node, ci in enumerate(cluster.instances):
        mine = token[owner[token] == node]
        names = [f"ovl_k{k}" for k in mine.tolist()]
        found, rows = ci.instance.backend.rows_for_keys(names)
        pos = {name: j for j, name in enumerate(found)}
        n_rows += len(found)
        for k, name in zip(mine.tolist(), names):
            j = pos.get(name)
            if j is None:
                check(admitted[k] == 0, f"13: key {name} answered {admitted[k]} admitted "
                                        f"hits but its owner (node {node}) holds no row")
                continue
            row = rows[j]
            check(row[0] == 0 and row[1] == limit[k], f"13: key {name}'s row {row.tolist()}"
                                                       " is not its token bucket")
            check(row[1] - row[2] == admitted[k],
                  f"13: key {name} on node {node}: limit - remaining = {row[1] - row[2]}, "
                  f"but the callers were admitted {admitted[k]} hits")
    return len(token), n_rows


def phase_overload(seed, dev, results):
    """13: the overload path (admission, deadline budgets, shedding) on the
    card through a two-node port cluster's Instances (see the module
    docstring, phase 13)."""
    log(f"== phase 13: the overload path: a two-node port LocalCluster, each Engine of "
        f"{CAPACITY:,} slots (widths 64-{WINDOW}) on the card; {OVERLOAD_SENDERS} senders "
        f"of {HOST_BATCH}-request batches of phase 3's mix (one-hour durations) to both "
        f"nodes: 13a closed loop with max_pending 0 for {CALM_S} s (its rate R), 13b open "
        f"loop at {OVERLOAD_FACTOR} x R for {OVERLOAD_S} s with max_pending 8192 and a "
        f"{OVERLOAD_BUDGET_MS:.0f} ms budget a call, 13c at {RECOVERY_FACTOR} x R for "
        f"{RECOVERY_S} s")
    t0 = time.perf_counter()
    rec = results["overload"] = {}
    pool, cols, key_cfg = overload_stream(seed)
    cluster = overload_cluster(dev)
    rec["boot_s"] = time.perf_counter() - t0
    try:
        owner = np.full(N_KEYS, -1, np.int64)
        in_pool = np.unique(np.concatenate([k for k, _ in cols]))
        addr = {ci.address: n for n, ci in enumerate(cluster.instances)}
        router = cluster.instances[0].instance
        owner[in_pool] = [addr[router.get_peer(f"ovl_k{k}").info.address]
                          for k in in_pool.tolist()]
        sent = set()
        local_share = float(np.mean([np.mean(owner[k] == i % OVERLOAD_NODES)
                                     for i, (k, _) in enumerate(cols)]))
        admitted = np.zeros(N_KEYS, np.int64)
        behaviors = [ci.instance.conf.behaviors for ci in cluster.instances]
        # the request pool and the booted cluster live through the phase:
        # moved out of the collector's walks, as a long-running client's
        # and server's start-up objects are after their first collections
        gc.collect()
        gc.freeze()
        pauses = GcPauses()
        check(all(b.max_pending == 8192 for b in behaviors),
              f"13: the harness's max_pending is {[b.max_pending for b in behaviors]}, "
              "not the default 8192")
        health = {"saturated": 0, "brownout": 0, "polls": 0, "max_pending": 0}
        dk.reset_launch_counts()
        rowk.reset_launch_counts()

        # 13a: admission off (GUBER_MAX_PENDING=0), no budgets, closed loop
        for b in behaviors:
            b.max_pending = 0
        before, work = node_sheds(cluster), node_work(cluster)
        threads, calls, t = overload_send(cluster, pool, CALM_S)
        secs = overload_join(threads, t)
        a = overload_account("13a", calls, cols, owner, key_cfg, admitted, sent)
        a.update(seconds=secs, sheds=deltas(before, node_sheds(cluster)),
                 work=deltas(work, node_work(cluster)),
                 gc=pauses.take())
        answered = a["decided"]["local"] + a["decided"]["forward"]
        R = answered / secs
        a["decisions_per_s"] = R
        rec["13a"] = a

        # 13b: admission at its default, a budget a call, open loop at 2R
        for b in behaviors:
            b.max_pending = 8192
        stop_poll = threading.Event()

        def poll():
            while not stop_poll.is_set():
                for ci in cluster.instances:
                    msg = ci.instance.health_check().message
                    health["saturated"] += "admission saturated" in msg
                    health["brownout"] += "admission brownout" in msg
                    health["max_pending"] = max(health["max_pending"],
                                                ci.instance.admission.pending())
                health["polls"] += 1
                time.sleep(HEALTH_POLL_S)

        poller = threading.Thread(target=poll, daemon=True)
        before, work = node_sheds(cluster), node_work(cluster)
        poller.start()
        threads, calls, t = overload_send(cluster, pool, OVERLOAD_S,
                                          rate=OVERLOAD_FACTOR * R, budget_ms=OVERLOAD_BUDGET_MS)
        busy = None
        if dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile as trace

            time.sleep(max(2.0 - (time.perf_counter() - t), 0.0))
            with trace(activities=[ProfilerActivity.CUDA]) as prof:
                tt = time.perf_counter()
                time.sleep(OVERLOAD_TRACE_S)
                torch.cuda.synchronize(dev)
                traced_s = time.perf_counter() - tt
            busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e6 / traced_s
        secs = overload_join(threads, t)
        stop_poll.set()
        poller.join()
        b13 = overload_account("13b", calls, cols, owner, key_cfg, admitted, sent)
        b13.update(seconds=secs, sheds=deltas(before, node_sheds(cluster)),
                   work=deltas(work, node_work(cluster)),
                   gc=pauses.take(),
                   offered_per_s=(b13["offered"]["local"] + b13["offered"]["forward"]) / secs,
                   target_per_s=OVERLOAD_FACTOR * R, device_busy_share=busy, health=health)
        rec["13b"] = b13

        # 13c: recovery at R/2, admission and budgets as in 13b, once every
        # node's pending reading is back at 0 (forwards of 13b's last calls)
        tt = time.perf_counter()
        while any(ci.instance.admission.pending() for ci in cluster.instances):
            check(time.perf_counter() - tt < 30, "13b's pending work never drained")
            time.sleep(0.01)
        b13["drain_s"] = time.perf_counter() - tt
        before, work = node_sheds(cluster), node_work(cluster)
        threads, calls, t = overload_send(cluster, pool, RECOVERY_S,
                                          rate=RECOVERY_FACTOR * R, budget_ms=OVERLOAD_BUDGET_MS)
        secs = overload_join(threads, t)
        c13 = overload_account("13c", calls, cols, owner, key_cfg, admitted, sent)
        c13.update(seconds=secs, sheds=deltas(before, node_sheds(cluster)),
                   work=deltas(work, node_work(cluster)),
                   gc=pauses.take())
        rec["13c"] = c13
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        launches = counts_now()
        shapes = dict(dk.launch_shapes)

        for tag, r in (("13a", a), ("13b", b13), ("13c", c13)):
            tot = {k: r[k]["local"] + r[k]["forward"] for k in
                   ("offered", "decided", "shed", "deadline")}
            node = r["sheds"]
            tlog(f"  {tag}: {r['calls']} calls in {r['seconds']:.3f} s, offered "
                 f"{tot['offered']:,} (local {r['offered']['local']:,}, forwarded "
                 f"{r['offered']['forward']:,}), decided {tot['decided']:,} "
                 f"({tot['decided'] / r['seconds']:,.0f}/s; UNDER_LIMIT {r['under_limit']:,}, "
                 f"OVER_LIMIT {r['over_limit']:,}), shed {tot['shed']:,} (refused calls "
                 f"{r['refused_calls']}), deadline {tot['deadline']:,}; goodput local "
                 f"{r['goodput']['local']:.4f} forwarded {r['goodput']['forward']:.4f}; shed "
                 f"share local {r['shed_share']['local']:.4f} forwarded "
                 f"{r['shed_share']['forward']:.4f}; by node {node}; latency ms: refused "
                 f"calls {r['refused_calls_ms']}, calls carrying sheds "
                 f"{r['with_sheds_calls_ms']}, admitted calls {r['admitted_calls_ms']}; "
                 f"lateness {r['lateness_ms']}; collector {r['gc']}; engine and combiner "
                 f"by node {[{k: round(v, 3) for k, v in w.items()} for w in r['work']]}")
        tlog(f"  13b: offered {b13['offered_per_s']:,.0f}/s against a target of "
             f"{b13['target_per_s']:,.0f}/s (R {R:,.0f}/s); health_check polls "
             f"{health['polls']}: 'admission saturated' {health['saturated']} times, "
             f"'admission brownout' {health['brownout']} times; the largest pending reading "
             f"{health['max_pending']:,}; pending back at 0 {b13['drain_s']:.3f} s after "
             f"13b's last answer; device busy {busy} of a {OVERLOAD_TRACE_S} s stretch "
             f"under torch.profiler")

        decides = {k: v for k, v in launches.items() if k.startswith("decide_") and v}
        widths = [B for (name, K, B), n in shapes.items() if n] or [0]
        at_full = sum(n * K for (name, K, B), n in shapes.items() if B == WINDOW)
        rec.update(R=R, local_share=local_share, launches=launches,
                   decide_shapes=shapes_line(shapes), widest_window=max(widths),
                   windows_at_full_width=at_full)
        tlog(f"  13: decide launches {decides} by shape {rec['decide_shapes']}; widest "
             f"window W = {max(widths)}, {at_full} windows at W = {WINDOW}; row launches "
             f"{ {k: v for k, v in launches.items() if not k.startswith('decide_') and v} }")

        # the checks
        check(sum(decides.values()) > 0, "13: no decide launch")
        for tag, r in (("13a", a), ("13b", b13), ("13c", c13)):
            check(not r["failed"], f"{tag}: answers failed outside the overload classes: "
                                   f"{r['failed'][:3]}")
            check(r["deadline_calls"] == 0 and r["deadline"]["local"] + r["deadline"][
                "forward"] == 0, f"{tag}: {r['deadline']} requests' budgets died: a "
                                 "forward's outcome at its owner is then unknown")
        for tag, r in (("13a", a), ("13c", c13)):
            sheds = r["shed"]["local"] + r["shed"]["forward"]
            counted = sum(v for d in r["sheds"] for v in d.values())
            check(sheds == 0 and counted == 0,
                  f"{tag} shed {sheds} requests (node counters {r['sheds']}); it sheds none")
        check(b13["shed"]["local"] + b13["shed"]["forward"] > 0,
              f"13b at {OVERLOAD_FACTOR} x R shed nothing: the overload path never ran")
        p99 = b13["refused_calls_ms"]["p99"]
        check(p99 is None or p99 < SHED_P99_MS,
              f"13b: refused calls' p99 {p99} ms, not under {SHED_P99_MS} ms")
        check(b13["shed_share"]["local"] <= b13["shed_share"]["forward"],
              f"13b: owner-local work shed at {b13['shed_share']['local']:.4f}, above the "
              f"forwards' {b13['shed_share']['forward']:.4f}: the brownout order broke")
        touched = np.unique(np.concatenate([cols[j][0] for j in sorted(sent)]))
        n_token, n_rows = overload_conservation(cluster, owner, key_cfg, admitted, touched)
        rec.update(token_keys_checked=n_token, rows_read=n_rows, keys_touched=len(touched))
        tlog(f"  13: conservation holds at {n_token:,} token keys ({n_rows:,} rows read on "
             f"their owners; {len(touched):,} keys touched, {local_share:.3f} of each call's "
             f"requests owner-local)")
    finally:
        if "pauses" in locals():
            pauses.close()
        gc.unfreeze()
        cluster.stop()
        del cluster
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    tlog(f"  phase 13 in {rec['seconds']:.1f} s (boot {rec['boot_s']:.1f} s)")
    return launches


# ------------------------------------------------------------------ phase 14

SOAK_NODES = 4
# gubernator_tpu_torch/soak.py's own traffic (8 threads, 24 keys at limit
# 1000, a quarter GLOBAL, one request a call) on --seconds 20 --chaos-period 3
SOAK_ARGS = dict(seconds=20.0, nodes=SOAK_NODES, threads=8, keys=24, limit=1000,
                 chaos_period=3.0)
SOAK_RECONNECT_S = 2.0  # soak.py: the grace after the chaos before the settle
SOAK_SENDERS = 4  # background senders cycling phase 13's pool beside the soak
# senders of lone pool requests with no deadline beside the soak: the soak's
# own calls carry one (timeout=10), and a forwarded request with a deadline
# rides its peer-link frame with a carrier item, so it never takes the lone
# path (service/peerlink.py `lone_seed`: a frame of one item, no flag)
SOAK_LONE_SENDERS = 2
# a lone sender sends each request this many calls in a row: the first
# misses the owner's row mirror and seeds it (a gather by value), the next
# decide in the peer link's IO thread unless a batch touched the key, and
# the pool's next batch on the key flushes the mirror (an inject by value)
LONE_BURST = 4
FAILED_CALL_PAUSE_S = 0.05  # a sender's pause after a call that failed whole
TABLE_BYTES = CAPACITY * 8 * 8  # one Engine's i64[C, 8] table
# one Engine's fixed page-locked staging at max_width WINDOW: the gather's
# i32 slots and i64[7] rows, the inject's i64[8] rows
PINNED_STAGING_BYTES = WINDOW * (4 + rowk.GATHER_FIELDS * 8 + rowk.ROW_FIELDS * 8)
FLEET = ("fd1", "fd2", "fd3")
FLEET_WAIT_S = 90.0  # tests/test_memberlist_cluster.py's bound on each transition
FLEET_PRE_KILL_S = 2.0  # 14b's load before the kill
REJOIN_HOLD_S = 5.0  # 14b's load after the rejoin
COLLECTIVE_STALL_S = 2.0  # soak_collective.py's GUBER_CROSS_HOST_STALL
COLLECTIVE_TIMEOUT_S = 300.0
LOG_TIME = "%Y-%m-%d %H:%M:%S,%f"  # the daemons' log lines begin so


def card_memory(dev, release=False):
    """The card's allocated bytes, and the pinned host allocator's bytes
    handed out (`pinned_active`) and held, cached blocks included
    (`pinned_held`); None where this torch does not report them. With
    `release`, first waits for the card and has the pinned allocator take
    back every freed block whose stream events are done and let go of its
    cache, so `pinned_held` counts only the blocks a live tensor holds.
    (`pinned_active` is kept as read: on torch 2.11 it drifts above
    `pinned_held`, which its definition rules out.)"""
    if dev.type != "cuda":
        return {"card_allocated": None, "pinned_active": None, "pinned_held": None}
    if release:
        torch.cuda.synchronize(dev)
        host_empty = getattr(torch._C, "_host_emptyCache", None)
        if host_empty is not None:
            host_empty()
    hs = torch.cuda.host_memory_stats()
    return {"card_allocated": torch.cuda.memory_allocated(dev),
            "pinned_active": hs.get("active_bytes.current"),
            "pinned_held": hs.get("allocated_bytes.current")}


_building = threading.local()  # `on` while this thread builds a node


class ServedCounts(dict):
    """A launch-count dict that keeps apart, in `warm`, the increments made
    on a thread while it builds a node (FaultCluster.start_instance: the
    restarted Engine's warm-up), so that it counts the traffic served."""

    def __init__(self, keys):
        super().__init__(dict.fromkeys(keys, 0))
        self.warm = dict.fromkeys(keys, 0)

    def __setitem__(self, key, value):
        if getattr(_building, "on", False):
            self.warm[key] += value - self[key]
        else:
            super().__setitem__(key, value)


@contextlib.contextmanager
def served_counts():
    """dk's and rowk's launch counts as ServedCounts at 0 for the block,
    yielded; the block's served launches are added to the originals, put
    back as it ends."""
    old = dk.launch_counts, rowk.launch_counts
    new = ServedCounts(old[0]), ServedCounts(old[1])
    dk.launch_counts, rowk.launch_counts = new
    try:
        yield new
    finally:
        dk.launch_counts, rowk.launch_counts = old
        for o, n in zip(old, new):
            o.update(n)


class FaultCluster(LocalCluster):
    """A LocalCluster whose every node, restarts included, is card_node's at
    CAPACITY slots, each with the daemon's peer link (a PeerLinkService at
    its gRPC port + the offset wire_peerlink bound; a forwarded lone request
    takes the owner engine's native single path there, as in a daemon
    fleet). A restart builds its node with the thread marked as building
    (ServedCounts). Notes each kill, restart and peer sync on the clock,
    and the card's memory as each restart begins. The soak's chaos thread
    syncs the peers after each restart and stops once time.monotonic()
    passes its deadline; the first sync at or past `chaos_deadline` (set
    by the caller no later than the soak's own) sets `chaos_over`. `stop`
    first runs `before_stop`, then reads the card's memory and the peer
    links' lone decisions in C (`native_hits`, the killed nodes' included)."""

    def __init__(self, dev, n, before_stop=None):
        super().__init__(device=dev)
        self.events, self.before_stop = [], before_stop
        self.chaos_deadline, self.chaos_over = None, threading.Event()
        self.memory_at_stop, self.native_hits = None, 0
        self.instances = [card_node(dev) for _ in range(n)]
        self.sync_peers()
        links = wire_peerlink(self)
        check(len(links) == n, "14a: no offset bound a peer link on every node")
        self.offset = self.instances[0].instance.conf.behaviors.peer_link_offset
        self.links = {ci.address: s for ci, s in zip(self.instances, links)}

    def start_instance(self, fixed_port=0, **_):
        t, times, memory = time.perf_counter(), {}, card_memory(self.device)
        _building.on = True
        try:
            ci = card_node(self.device, fixed_port, times)
        finally:
            _building.on = False
        b = ci.instance.conf.behaviors
        b.peer_link_offset = self.offset
        port = int(ci.address.rsplit(":", 1)[1])
        self.links[ci.address] = PeerLinkService(ci.instance, port=port + self.offset,
                                                 wire_v2=b.wire_v2)
        for i, old in enumerate(self.instances):
            if old.address == ci.address:
                self.instances[i] = ci
                break
        else:
            self.instances.append(ci)
        self.events.append(dict(kind="start", t=t, warm_t=times["warm_t"],
                                ready_t=time.perf_counter(), address=ci.address,
                                memory=memory))
        return ci

    def sync_peers(self):
        super().sync_peers()
        self.events.append(dict(kind="sync", t=time.perf_counter()))
        if self.chaos_deadline is not None and time.monotonic() >= self.chaos_deadline:
            self.chaos_over.set()

    def _close_link(self, address):
        link = self.links.pop(address, None)
        if link is not None:
            self.native_hits += link.native_hits()
            link.close()

    def stop_instance_at(self, idx):
        ci = self.instances[idx]
        self.events.append(dict(kind="kill", t=time.perf_counter(), address=ci.address))
        self._close_link(ci.address)
        ci.stop()

    def stop(self):
        if self.before_stop is not None:
            self.before_stop()
        self.memory_at_stop = card_memory(self.device, release=True)
        for address in list(self.links):
            self._close_link(address)
        super().stop()


class TalliedStub:
    """A V1 stub whose GetRateLimits notes each call that takes hits (the
    soak's convergence probes take none) as (clock at the answer, address,
    answers without error, errors, first error, clock at the send)."""

    def __init__(self, stub, address, tally):
        self._stub, self._address, self._tally = stub, address, tally

    def GetRateLimits(self, req, **kw):
        import grpc

        counted, sent = req.requests[0].hits > 0, time.perf_counter()
        try:
            out = self._stub.GetRateLimits(req, **kw)
        except grpc.RpcError as e:
            if counted:
                self._tally.append((time.perf_counter(), self._address, 0,
                                    len(req.requests), f"rpc:{e.code()}", sent))
            raise
        if counted:
            errs = [r.error for r in out.responses if r.error]
            self._tally.append((time.perf_counter(), self._address,
                                len(out.responses) - len(errs), len(errs),
                                errs[0][:120] if errs else None, sent))
        return out

    def __getattr__(self, name):
        return getattr(self._stub, name)


def pool_messages(pool):
    """Phase 13's request pool as GetRateLimitsReq messages, built once."""
    return [pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
        name=r.name, unique_key=r.unique_key, hits=r.hits, limit=r.limit,
        duration=r.duration, algorithm=r.algorithm) for r in batch]) for batch in pool]


def pool_senders(n, addresses, messages, stop, ready, tally, lone=False):
    """n threads send pool messages over gRPC (call i: message i % pool to
    address i % len(addresses()) of the moment) until `stop`, each call
    noted as TalliedStub notes one; `ready` set makes them wait for a
    reconnecting channel, as soak.py's workers do once the chaos is over.
    A sender whose call failed whole waits FAILED_CALL_PAUSE_S before its
    next, as a client backs off a refused connection. With `lone`, a call
    sends one request of the pool alone, with no deadline, each request
    LONE_BURST calls in a row."""
    import grpc

    def sender(s):
        i = s
        while not stop.is_set():
            addrs = addresses()
            addr = addrs[i % len(addrs)]
            if lone:
                k = i // (n * LONE_BURST)  # this sender's burst
                reqs = messages[k % len(messages)].requests
                msg = pb.GetRateLimitsReq(requests=[reqs[(k + s * len(reqs) // n) % len(reqs)]])
            else:
                msg = messages[i % len(messages)]
            try:
                TalliedStub(dial_v1(addr), addr, tally).GetRateLimits(
                    msg, timeout=None if lone else 10, wait_for_ready=ready.is_set())
            except grpc.RpcError:
                time.sleep(FAILED_CALL_PAUSE_S)
            i += n

    threads = [threading.Thread(target=sender, args=(s,), daemon=True) for s in range(n)]
    for th in threads:
        th.start()
    return threads


def tally_window(tally, t0, t1):
    """Answers without error, errors and error samples of the calls sent in
    [t0, t1) (a call sent before a window and answered in it is the
    earlier window's)."""
    rows = [r for r in tally if t0 <= r[5] < t1]
    samples = sorted({r[4] for r in rows if r[4]})[:3]
    return dict(answers=sum(r[2] for r in rows), errors=sum(r[3] for r in rows),
                calls=len(rows), seconds=t1 - t0,
                decisions_per_s=sum(r[2] for r in rows) / max(t1 - t0, 1e-9),
                error_samples=samples)


def soak_on_card(dev, messages, results):
    """14a: gubernator_tpu_torch.soak's run on a FaultCluster of SOAK_NODES
    card nodes, with SOAK_SENDERS senders of phase 13's pool and
    SOAK_LONE_SENDERS of its requests alone beside it. Returns the launches
    of the traffic served (the restarted Engines' warm-ups left out)."""
    from gubernator_tpu_torch import soak
    from gubernator_tpu_torch.service import grpc_api

    rec = results["fault_soak"] = {}
    t = time.perf_counter()
    tallies = {"soak": [], "pool": [], "lone": []}
    senders, stop_senders = [], threading.Event()

    def halt():
        stop_senders.set()
        for th in senders:
            th.join(timeout=30)
        rec["t_halt"] = time.perf_counter()

    gc.collect()
    rec["memory_before_boot"] = card_memory(dev, release=True)
    cluster = FaultCluster(dev, SOAK_NODES, before_stop=halt)
    rec["boot_s"] = time.perf_counter() - t
    gc.collect()
    rec["memory_before"] = card_memory(dev, release=True)

    def addresses():
        return [ci.address for ci in cluster.instances]

    real_dial = grpc_api.dial_v1
    grpc_api.dial_v1 = lambda a: TalliedStub(real_dial(a), a, tallies["soak"])
    with served_counts() as counts:
        t_run = time.perf_counter()
        # no later than the deadline the soak's chaos thread sets as it starts
        cluster.chaos_deadline = time.monotonic() + SOAK_ARGS["seconds"] * 0.7
        senders[:] = (pool_senders(SOAK_SENDERS, addresses, messages, stop_senders,
                                   cluster.chaos_over, tallies["pool"])
                      + pool_senders(SOAK_LONE_SENDERS, addresses, messages, stop_senders,
                                     cluster.chaos_over, tallies["lone"], lone=True))
        try:
            rc = soak.run(argparse.Namespace(**SOAK_ARGS), cluster)
        finally:
            grpc_api.dial_v1 = real_dial
            if cluster.instances:  # a soak that died before its own stop
                cluster.stop()
    launches = {**counts[0], **counts[1]}
    rec["warmup_launches"] = {k: v for k, v in {**counts[0].warm, **counts[1].warm}.items() if v}
    events, memory_at_stop, native_hits = cluster.events, cluster.memory_at_stop, cluster.native_hits
    del cluster
    gc.collect()
    rec["memory_after_stop"] = card_memory(dev, release=True)
    rec["memory_after_chaos"] = memory_at_stop

    # the run's windows on the clock: before the first kill, the chaos up
    # to the settle (the soak's reconnect grace after its last restart's
    # peer sync included), the settle to the senders' halt
    kills = [e for e in events if e["kind"] == "kill"]
    starts = [e for e in events if e["kind"] == "start"]
    check(kills and starts, f"14a: the soak's chaos never ran ({len(kills)} kills, "
                            f"{len(starts)} restarts)")
    chaos_end = max((e["t"] for e in events if e["kind"] == "sync" and e["t"] > starts[-1]["t"]),
                    default=starts[-1]["ready_t"])
    settled = chaos_end + SOAK_RECONNECT_S
    spans = {"before_kill": (t_run, kills[0]["t"]), "chaos": (kills[0]["t"], settled),
             "settle": (settled, rec.pop("t_halt"))}
    rec["windows"] = {name: {k: tally_window(v, a, b) for k, v in tallies.items()}
                      for name, (a, b) in spans.items()}
    restarts = []
    everything = [r for v in tallies.values() for r in v]
    for s in starts:
        kill = max((k for k in kills if k["address"] == s["address"] and k["t"] < s["t"]),
                   key=lambda k: k["t"])
        answered = [r[0] for r in everything
                    if r[1] == s["address"] and r[0] > s["t"] and r[2] > 0]
        restarts.append(dict(down_s=s["t"] - kill["t"], warmup_done_s=s["warm_t"] - s["t"],
                             serving_s=s["ready_t"] - s["t"],
                             first_answer_s=min(answered) - s["t"] if answered else None,
                             memory=s["memory"]))
    rec["events"] = [{**e, **{k: e[k] - t_run for k in ("t", "warm_t", "ready_t") if k in e}}
                     for e in events if e["kind"] != "sync"]
    rec["settle_errors"] = [(r[5] - t_run, r[0] - t_run, r[1], r[3], r[4])
                            for r in everything if r[5] >= settled and r[3]][:20]
    rec.update(rc=rc, cycles=len(starts), chaos_s=chaos_end - t_run, restarts=restarts,
               launches={k: v for k, v in launches.items() if v}, native_hits=native_hits,
               seconds=time.perf_counter() - t)
    w = rec["windows"]
    tlog(f"  14a: {SOAK_NODES} nodes of {CAPACITY:,} slots (widths 64-{WINDOW}, the daemon's "
         f"peer link) booted in {rec['boot_s']:.1f} s; soak {SOAK_ARGS} with {SOAK_SENDERS} "
         f"senders of phase 13's pool and {SOAK_LONE_SENDERS} of its requests alone; "
         f"{rec['cycles']} kill/restart cycles, the last peer sync at {rec['chaos_s']:.3f} s")
    for name in spans:
        tlog(f"  14a {name} over {w[name]['soak']['seconds']:.3f} s: " + "; ".join(
            f"{k} {v['decisions_per_s']:,.0f} decisions/s, {v['errors']} errors"
            for k, v in w[name].items()) + f"; samples "
            f"{sorted({x for v in w[name].values() for x in v['error_samples']})[:3]}")
    for i, r in enumerate(restarts):
        tlog(f"  14a restart {i}: down {r['down_s']:.3f} s; start_instance to warmup done "
             f"{r['warmup_done_s']:.3f} s, to serving {r['serving_s']:.3f} s, to the node's "
             f"first answer {fms(r['first_answer_s'], 3)} s; memory as it began {r['memory']}")
    log(f"  14a memory: before the boot {rec['memory_before_boot']}, booted {rec['memory_before']}, "
        f"after the chaos {memory_at_stop}, the cluster stopped {rec['memory_after_stop']} "
        f"(one table {TABLE_BYTES:,} B, one Engine's fixed pinned staging "
        f"{PINNED_STAGING_BYTES:,} B)")
    log(f"  14a launches of the traffic served {rec['launches']}; of the restarts' warm-ups "
        f"{rec['warmup_launches']}; lone requests decided in C by the peer links {native_hits}")

    check(rc == 0, f"14a: the soak failed (rc {rc}; its result line is above)")
    for k in ("pool", "lone"):
        check(w["settle"][k]["errors"] == 0,
              f"14a: calls the {k} senders sent after the settle began met "
              f"{w['settle'][k]['errors']} errors: {w['settle'][k]['error_samples']}")
    check(all(v["answers"] > 0 for v in w["settle"].values()), "14a: no answer in the settle")
    check(all(r["first_answer_s"] is not None for r in restarts),
          "14a: a restarted node never answered")
    if dev.type == "cuda":
        grew = memory_at_stop["card_allocated"] - rec["memory_before"]["card_allocated"]
        rec["card_growth"] = grew
        check(grew <= TABLE_BYTES, f"14a: the card's allocated memory grew {grew:,} B over "
                                   f"the chaos, more than one table ({TABLE_BYTES:,} B)")
        pinned = (rec["memory_after_stop"]["pinned_held"]
                  - rec["memory_before_boot"]["pinned_held"])
        rec["pinned_growth"] = pinned
        check(pinned <= PINNED_STAGING_BYTES,
              f"14a: with every node stopped, the pinned bytes held grew {pinned:,} B over "
              f"14a, more than one Engine's fixed staging ({PINNED_STAGING_BYTES:,} B)")
    check(sum(v for k, v in launches.items() if k.startswith("decide_")) > 0,
          "14a: the traffic served launched no decide kernel")
    check(launches["gather_rows_by_value"] > 0,
          "14a: no lone request seeded its mirror (no gather by value)")
    return launches


def health(http_port):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{http_port}/v1/HealthCheck",
                                    timeout=2) as r:
            return json.load(r)
    except Exception:  # noqa: BLE001 — a polling helper: down reads as None
        return None


def await_cond(cond, timeout_s):
    """Poll `cond` every 0.2 s up to `timeout_s`; the seconds it took, or None."""
    t = time.perf_counter()
    while time.perf_counter() - t < timeout_s:
        if cond():
            return time.perf_counter() - t
        time.sleep(0.2)
    return None


def bucket_hit(http_port, key):
    """tests/test_memberlist_cluster.py's _get: one hit on a shared bucket
    of limit 100; its remaining."""
    body = json.dumps({"requests": [{"name": "ml-e2e", "uniqueKey": key, "hits": "1",
                                     "limit": "100", "duration": "60000"}]}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{http_port}/v1/GetRateLimits", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return int(json.load(r)["responses"][0].get("remaining", -1))


def fleet_run(messages, results):
    """14b: three port daemons on the card whose only membership source is
    the memberlist gossip pool (tests/test_memberlist_cluster.py's fleet at
    CAPACITY slots, the daemon's widths, the reshard handoff armed): one
    SIGKILLed and restarted on its ports while one sender sends phase 13's
    pool to the two others through V1Clients."""
    tmp = tempfile.mkdtemp(prefix="guber-fleet-")
    grpc_p = {n: free_port() for n in FLEET}
    http_p = {n: free_port() for n in FLEET}
    gossip = {n: free_port() for n in FLEET}
    rec = results["fleet"] = {}
    logs = []

    def env_for(name, seeds):
        e = {"GUBER_GRPC_ADDRESS": f"127.0.0.1:{grpc_p[name]}",
             "GUBER_HTTP_ADDRESS": f"127.0.0.1:{http_p[name]}",
             "GUBER_ADVERTISE_ADDRESS": f"127.0.0.1:{grpc_p[name]}",
             "GUBER_MEMBERLIST_ADVERTISE_ADDRESS": f"127.0.0.1:{gossip[name]}",
             "GUBER_MEMBERLIST_NODE_NAME": name,
             "GUBER_CACHE_SIZE": str(CAPACITY),
             "GUBER_RESHARD": "1"}
        if seeds:
            e["GUBER_MEMBERLIST_KNOWN_NODES"] = ",".join(seeds)
        return e

    def boot(name, seeds, tag=""):
        path = os.path.join(tmp, f"{name}{tag}.log")
        logs.append(path)
        proc, ok = spawn_daemon(env_for(name, seeds), path)
        check(ok, f"14b: {name}{tag} did not come up (rc {proc.poll()}):\n{daemon_log(path)}")
        return proc

    def peer_counts():
        return [(health(http_p[n]) or {}).get("peerCount", 0) for n in FLEET]

    def debug_vars(name):
        return json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{http_p[name]}/v1/debug/vars", timeout=10).read())

    def row_launches(name):
        # the daemon's row kernel launches by form since it booted
        return debug_vars(name)["kernel"]["row_launches"]

    seed = [f"127.0.0.1:{gossip['fd1']}"]
    procs, tally, stop = {}, [], threading.Event()
    sender = None
    t0 = time.perf_counter()
    try:
        procs["fd1"] = boot("fd1", ())
        # a boot's own row launches (its Engine's warm-up), read before any
        # peer or request reaches fd1; every boot, fd3's restart too, makes these
        rec["row_warmup"] = row_launches("fd1")
        booted = {}
        threads = [threading.Thread(target=lambda n=n: booted.__setitem__(n, boot(n, seed)))
                   for n in ("fd2", "fd3")]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        procs.update(booted)
        check(set(procs) == set(FLEET), f"14b: booted only {sorted(procs)}")
        rec["boot_s"] = time.perf_counter() - t0
        rec["converge_s"] = await_cond(lambda: peer_counts() == [3, 3, 3], FLEET_WAIT_S)
        check(rec["converge_s"] is not None, f"14b: peer counts {peer_counts()}, not 3 each")
        got = [bucket_hit(http_p[n], "rk") for n in FLEET]
        check(got == [99, 98, 97], f"14b: the shared bucket read {got}, not 99, 98, 97")

        clients = [V1Client(a, stub=TalliedStub(dial_v1(a), a, tally))
                   for a in (f"127.0.0.1:{grpc_p[n]}" for n in ("fd1", "fd2"))]

        def send():
            i = 0
            while not stop.is_set():
                try:  # TalliedStub notes every call, failed ones included
                    clients[i % 2].get_rate_limits(messages[i % len(messages)].requests,
                                                   timeout=10)
                except Exception:  # noqa: BLE001
                    time.sleep(FAILED_CALL_PAUSE_S)
                i += 1

        sender = threading.Thread(target=send, daemon=True)
        t_load = time.perf_counter()
        sender.start()
        time.sleep(FLEET_PRE_KILL_S)

        # hard-kill fd3: SWIM demotes it; the survivors keep serving
        t_kill = time.perf_counter()
        procs["fd3"].send_signal(signal.SIGKILL)
        procs.pop("fd3").wait(timeout=10)
        rec["demote_s"] = await_cond(lambda: peer_counts()[:2] == [2, 2], FLEET_WAIT_S)
        check(rec["demote_s"] is not None, f"14b: survivors at {peer_counts()}, not 2")
        t_demoted = time.perf_counter()
        got = [bucket_hit(http_p[n], "rk2") for n in ("fd1", "fd2")]
        check(got == [99, 98], f"14b: rk2 read {got} on the survivors, not 99, 98")

        # restart fd3 on the same ports: push/pull and gossip bring it back
        t_restart = time.perf_counter()
        procs["fd3"] = boot("fd3", seed, "b")
        rec["restart_ready_s"] = time.perf_counter() - t_restart
        rec["rejoin_s"] = await_cond(lambda: peer_counts() == [3, 3, 3], FLEET_WAIT_S)
        check(rec["rejoin_s"] is not None, f"14b: peer counts {peer_counts()} after the restart")
        t_rejoined = time.perf_counter()
        got = [bucket_hit(http_p[n], "rk3") for n in ("fd3", "fd1", "fd2")]
        check(got == [99, 98, 97], f"14b: rk3 read {got}, not 99, 98, 97")
        time.sleep(REJOIN_HOLD_S)
        stop.set()
        sender.join(timeout=30)
        t_end = time.perf_counter()

        spans = {"before_kill": (t_load, t_kill), "demotion": (t_kill, t_demoted),
                 "down": (t_demoted, t_restart), "rejoin": (t_restart, t_rejoined),
                 "after_rejoin": (t_rejoined, t_end)}
        rec["windows"] = {k: tally_window(tally, a, b) for k, (a, b) in spans.items()}
        hp = {n: http_p[n] for n in FLEET}
        rec["reshard"] = {n: {"rows_exported": metric(p, "reshard_rows_moved_total", "export"),
                              "rows_imported": metric(p, "reshard_rows_moved_total", "import"),
                              "frames": metric(p, "reshard_frames_total"),
                              "committed": metric(p, "reshard_committed_total"),
                              "aborted": metric_series(p, "reshard_aborted_total"),
                              "proxied": metric(p, "reshard_proxied_total"),
                              "fresh_serves": metric(p, "reshard_fresh_serves_total")}
                          for n, p in hp.items()}
        rec["row_launches"] = {}
        for n in FLEET:
            dv = debug_vars(n)
            rec["reshard"][n]["recent"] = dv.get("reshard", {}).get("recent")
            rec["row_launches"][n] = {k: v - rec["row_warmup"][k]
                                      for k, v in dv["kernel"]["row_launches"].items()
                                      if v > rec["row_warmup"][k]}
        rec["kernels"] = {}
        for n, p in hp.items():
            body = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{p}/v1/debug/kernels", timeout=10).read())
            rec["kernels"][n] = {k: v["windows"] for k, v in body["kernels"].items()}
    finally:
        stop.set()
        if sender is not None:
            sender.join(timeout=30)
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
        rcs = {}
        for name, proc in procs.items():
            try:
                rcs[name] = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rcs[name] = "killed"
    rec["exit_codes"] = rcs
    rec["seconds"] = time.perf_counter() - t0
    w = rec["windows"]
    tlog(f"  14b: three daemons of {CAPACITY:,} slots up in {rec['boot_s']:.1f} s (fd1, then "
         f"fd2 and fd3 together), gossip at peerCount 3 in {rec['converge_s']:.3f} s; SIGKILL "
         f"fd3: survivors at 2 in {rec['demote_s']:.3f} s; fd3 Ready again in "
         f"{rec['restart_ready_s']:.3f} s, peerCount 3 everywhere {rec['rejoin_s']:.3f} s "
         f"later; shared buckets as the test reads them")
    for name, r in w.items():
        tlog(f"  14b {name}: {r['decisions_per_s']:,.0f} decisions/s over {r['seconds']:.3f} s, "
             f"{r['errors']} errors in {r['calls']} calls; samples {r['error_samples']}")
    log(f"  14b reshard by node {rec['reshard']}")
    log(f"  14b row kernel launches by daemon, its boot's warm-up {rec['row_warmup']} left "
        f"out (fd3: since its restart) {rec['row_launches']}")
    log(f"  14b decide windows by daemon {rec['kernels']}; exit codes {rcs}")
    check(w["after_rejoin"]["errors"] == 0,
          f"14b: {w['after_rejoin']['errors']} errors after the rejoin: "
          f"{w['after_rejoin']['error_samples']}")
    check(w["after_rejoin"]["answers"] > 0, "14b: no answer after the rejoin")
    for n, r in rec["reshard"].items():
        rl = rec["row_launches"][n]
        check(not r["rows_exported"] or rl.get("gather_rows", 0) > 0,
              f"14b: {n} exported {r['rows_exported']} rows with no gather launched")
        check(not r["rows_imported"] or rl.get("inject_rows", 0) > 0,
              f"14b: {n} imported {r['rows_imported']} rows with no inject launched")
    check(all(v == 0 for v in rcs.values()), f"14b: the daemons did not stop cleanly: {rcs}\n"
          + "\n".join(daemon_log(p) for p in logs))
    shutil.rmtree(tmp, ignore_errors=True)


def log_clock(path, marker):
    """The clock of the first line of a daemon log holding `marker`, as a
    datetime, or None."""
    with open(path) as f:
        for line in f:
            if marker in line:
                try:
                    return dt.datetime.strptime(line[:23], LOG_TIME)
                except ValueError:
                    continue
    return None


def collective_chaos_run(results):
    """14c: `python -m gubernator_tpu_torch.soak_collective` with its two
    daemons on the card at CAPACITY slots; reads its phase lines, its
    survivor's log (did the gloo call raise or block) and its restarted
    daemon's log (the restart's boot)."""
    tmp = tempfile.mkdtemp(prefix="guber-collective-")
    env = dict(os.environ, PYTHONPATH=ROOT, GUBER_CACHE_SIZE=str(CAPACITY), TMPDIR=tmp)
    env.pop("GUBER_DEVICE", None)  # the card, the daemons' default
    rec = results["collective_chaos"] = {}
    t0 = time.perf_counter()
    lines = []
    with open(os.path.join(tmp, "soak.err"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "gubernator_tpu_torch.soak_collective"],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err, text=True)

    def read():
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, time.time(), line.rstrip("\n")))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=COLLECTIVE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    reader.join(timeout=10)
    phases = {}
    for at, wall, line in lines:
        if line.startswith("{"):
            d = json.loads(line)
            phases[d.get("phase")] = dict(d, at_s=at, wall=wall)
    result, killed = phases.get("result"), phases.get("killed", {})
    stopped = phases.get("stopped", {})
    survivor = os.path.join(tmp, "soak_collective_d0.log")
    restarted = os.path.join(tmp, "soak_collective_d1.log")
    text = open(survivor).read() if os.path.exists(survivor) else ""
    raised = "collective GLOBAL sync failed" in text
    cause = next((ln for ln in text.splitlines() if ln.startswith("RuntimeError")), None)
    # the restart's boot: the script spawns it right after its "killed"
    # line; its HTTP gateway is the last step before its Ready line
    boot = None
    up = log_clock(restarted, "HTTP gateway on") if os.path.exists(restarted) else None
    if up is not None and "wall" in killed:
        boot = up.timestamp() - killed["wall"]
    rec.update(rc=rc, result=result, phases=phases, health_flip_s=killed.get("health_flip_s"),
               gloo_raised=raised, gloo_error=cause[:200] if cause else None,
               restart_boot_s=boot, exit_codes=stopped.get("exit_codes"),
               seconds=time.perf_counter() - t0)
    tlog(f"  14c: collective chaos soak, two daemons of {CAPACITY:,} slots in one gloo group: "
         f"converged (hits synced {phases.get('converged', {}).get('hits_synced')}); SIGKILL "
         f"of daemon 1 to the survivor's unhealthy health check {killed.get('health_flip_s')} s "
         f"(stall {COLLECTIVE_STALL_S} s); the survivor's gloo call "
         f"{'raised' if raised else 'did not raise (blocked to the stall)'}: {cause}; the "
         f"restarted daemon up {fms(boot, 3)} s after the kill line (its log's HTTP gateway "
         f"line), healthy after the settle; "
         f"accounting {phases.get('rejoined')}; exit codes on SIGTERM {rec['exit_codes']}; "
         f"{rec['seconds']:.1f} s")
    check(rc == 0 and result is not None and result["ok"],
          f"14c: the collective soak failed (rc {rc}): {result}\n"
          + "\n".join(line for _, _, line in lines[-20:]) + "\n" + text[-3000:])
    check(rec["exit_codes"] is not None and all(c == 0 for c in rec["exit_codes"]),
          f"14c: the daemons did not stop cleanly on SIGTERM: {rec['exit_codes']}")
    shutil.rmtree(tmp, ignore_errors=True)


def phase_faults(seed, dev, results):
    """14: the fault path on the card (see the module docstring, phase 14)."""
    log(f"== phase 14: the fault path: 14a the port soak (kill/restart every "
        f"{SOAK_ARGS['chaos_period']} s for {SOAK_ARGS['seconds']} s) on {SOAK_NODES} nodes of "
        f"{CAPACITY:,} slots with {SOAK_SENDERS} senders of phase 13's pool; 14b three daemons "
        f"on gossip alone, one SIGKILLed and restarted under load; 14c the collective chaos "
        f"soak at {CAPACITY:,} slots a daemon")
    t0 = time.perf_counter()
    pool, _, _ = overload_stream(seed)
    messages = pool_messages(pool)
    del pool
    rec = results["faults"] = {"pool_s": time.perf_counter() - t0}
    launches = soak_on_card(dev, messages, results)
    fleet_run(messages, results)
    collective_chaos_run(results)
    rec["seconds"] = time.perf_counter() - t0
    tlog(f"  phase 14 in {results['faults']['seconds']:.1f} s (14a "
         f"{results['fault_soak']['seconds']:.1f} s, 14b {results['fleet']['seconds']:.1f} s, "
         f"14c {results['collective_chaos']['seconds']:.1f} s)")
    return launches


# ------------------------------------------------------------------ phase 15
# The sharded backend over a mesh of cards (parallel/mesh.py make_mesh): a
# table, a stream and a launch of each kernel a mesh entry, the cross-card
# all-reduce (csrc/ring.cu ring_mesh_launch: one launch a card) between the
# entries. On one card the entries repeat cuda:0: one launch sums them all
# through local pointers, where distinct cards read each other over NVLink
# behind flags in peer memory.

MESH_N = (2, 4, 8)  # 15a's ring sizes
MESH_L = (GLOBAL_KEYS, 4 * GLOBAL_KEYS)  # the sync's two rings: G and 4G
MESH_ITERS = 100  # all-reduces timed a shape
MESH_BACK_TO_BACK = 64  # all-reduces queued with no synchronisation between them
MESH_SPLIT_CALLS = 500  # calls a host split
NVLINK_BYTES_PER_S = 450e9  # NVLink 4 on the H100 SXM, each way (NVIDIA's data sheet)


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_devices(devs, n):
    """n mesh entries over the cards `devs`, in turn (one card: n times the same)."""
    return [devs[d % len(devs)] for d in range(n)]


def mesh_allreduce_ms(xs, streams, iters):
    """Device-timeline ms per all-reduce over `iters` back to back (CUDA
    events on entry 0's card: every entry's stream waits for the start and
    the end waits for every entry's stream), after one warm call."""
    rk.ring_all_reduce_mesh_cuda(xs)
    sync_all()
    dev0 = xs[0].device
    cur = torch.cuda.current_stream(dev0)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record(cur)
    for st in streams:
        st.wait_event(e0)
    for _ in range(iters):
        rk.ring_all_reduce_mesh_cuda(xs)
    for st in streams:
        cur.wait_stream(st)
    e1.record(cur)
    sync_all()
    return e0.elapsed_time(e1) / iters


def mesh_gated_ms(xs, streams, iters):
    """Device ms an all-reduce with the host out of the way: entry 0's stream
    holds a busy kernel while `iters` calls are queued behind it, and CUDA
    events on that stream time them from the busy kernel's end to the last
    call's end (every entry's stream joined into entry 0's). Returns (ms,
    whether the busy kernel outlasted the queueing; if not, host gaps are
    in the time)."""
    rk.ring_all_reduce_mesh_cuda(xs)
    sync_all()
    s0 = streams[0]
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(s0):
        torch.cuda._sleep(SLEEP_CYCLES // 5)  # ~100 ms, past the queueing of `iters` calls
        e0.record(s0)
    for _ in range(iters):
        rk.ring_all_reduce_mesh_cuda(xs)
    busy = not e0.query()
    for st in streams[1:]:
        s0.wait_stream(st)
    e1.record(s0)
    sync_all()
    return e0.elapsed_time(e1) / iters, busy


def mesh_ring_times(xs, streams, kernel, launches):
    """An all-reduce over xs timed as 15a and ab_rows.py time it: device ms
    a launch of the kernels whose name holds `kernel` (torch.profiler) and
    a call (that times the call's `launches`), the span of an
    all-reduce on the device (CUDA events) and the same with every call
    queued behind a busy stream (mesh_gated_ms), a call on the host clock,
    and the plain version's call on the host clock (its copies and adds
    run on every entry's card, which one card's events do not see)."""
    call = lambda i: rk.ring_all_reduce_mesh_cuda(xs)
    gated_ms, gated_busy = mesh_gated_ms(xs, streams, 32)
    ms = profiled_ms(call, 50, kernel)
    out = dict(allreduce_ms=mesh_allreduce_ms(xs, streams, MESH_ITERS),
               gated_ms=gated_ms, gated_busy=gated_busy, ms=ms,
               device_call_ms=None if ms is None else ms * launches)
    sync_all()
    t = time.perf_counter()
    for _ in range(MESH_ITERS):
        call(0)
    out["call_ms"] = (time.perf_counter() - t) / MESH_ITERS * 1e3
    sync_all()
    rk.ring_all_reduce_mesh_plain(xs)
    sync_all()
    t = time.perf_counter()
    for _ in range(20):
        rk.ring_all_reduce_mesh_plain(xs)
    sync_all()
    out["plain_ms"] = (time.perf_counter() - t) / 20 * 1e3
    return out


def nccl_allreduce_ms(xs, want):
    """The library's form of the same sum where every entry has a card of its
    own: torch.cuda.nccl.all_reduce, in place, on copies of xs; compared
    with the plain sums once, then timed on the host clock over 20 calls
    after that warm one. None, with the reason logged, where NCCL refuses."""
    from torch.cuda import nccl

    ys = [x.clone() for x in xs]
    sync_all()
    try:
        nccl.all_reduce(ys)
        sync_all()
    except Exception as e:  # context, not a check: the port does not call NCCL
        log(f"  15a NCCL all_reduce refused: {type(e).__name__}: {e}")
        return None
    if not all(torch.equal(y, w) for y, w in zip(ys, want)):
        log("  15a NCCL all_reduce's sums differ from the plain version's: not timed")
        return None
    t = time.perf_counter()
    for _ in range(20):
        nccl.all_reduce(ys)
    sync_all()
    return (time.perf_counter() - t) / 20 * 1e3


def one_card_library_ms(xs, want):
    """The library's form of the same sum where the entries share one card:
    torch.stack(xs).sum(0) and a copy of it for each of the n outputs (two
    calls and n copies). Compared with the plain sums once, then timed as a
    call (host clock, 200 calls) and on the device (torch.profiler, every
    kernel and copy of a call). A yardstick: the port never calls it.
    (None, None), logged, where its sums differ."""
    def lib(i):
        total = torch.stack(xs).sum(0)
        return [total.clone() for _ in xs]

    got = lib(0)
    sync_all()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        log("  15a torch.stack(xs).sum(0)'s sums differ from the plain version's: not timed")
        return None, None
    t = time.perf_counter()
    for i in range(MESH_ITERS):
        lib(i)
    sync_all()
    return (time.perf_counter() - t) / MESH_ITERS * 1e3, profiled_ms(lib, 50)


def mesh_back_to_back(rng, ents, streams, L, tag):
    """MESH_BACK_TO_BACK all-reduces queued with no synchronisation between
    them, on the same input buffers, each rewritten on its entry's stream
    with fresh values before the next call (the caller's reuse the design's
    `done` flags guard): every sum bit-equal to the plain version's on that
    call's values."""
    n = len(ents)
    lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    src = [[torch.from_numpy(rng.integers(lo, hi, L, dtype=np.int64, endpoint=True)).to(d)
            for d in ents] for _ in range(MESH_BACK_TO_BACK)]
    bufs = [torch.empty(L, dtype=torch.int64, device=d) for d in ents]
    sync_all()
    outs = []
    for vals in src:
        for d in range(n):
            with torch.cuda.stream(streams[d]):
                bufs[d].copy_(vals[d])
        outs.append(rk.ring_all_reduce_mesh_cuda(bufs))
    sync_all()
    for i, vals in enumerate(src):
        want = rk.ring_all_reduce_mesh_plain(vals)
        for d in range(n):
            check(torch.equal(outs[i][d], want[d]),
                  f"15a{tag} n={n} L={L}: back-to-back call {i}, entry {d}'s sum differs "
                  "from the plain version's")


def mesh_behind_busy(xs, streams, want, tag):
    """One all-reduce issued while entry 0's stream holds a long busy kernel
    (the other entries' streams, or cards, reach their launches first):
    it ends, and every sum is bit-equal. Returns whether the busy kernel
    was still running when the call returned."""
    sync_all()
    gate = torch.cuda.Event()
    with torch.cuda.stream(streams[0]):
        torch.cuda._sleep(SLEEP_CYCLES // 10)  # ~50 ms
        gate.record()
    got = rk.ring_all_reduce_mesh_cuda(xs)
    pending = not gate.query()
    sync_all()
    for d in range(len(xs)):
        check(torch.equal(got[d], want[d]),
              f"15a{tag} n={len(xs)}: behind a busy card, entry {d}'s sum differs")
    return pending


def mesh_host_split(xs):
    """Host microseconds of a call, split: the whole wrapper call, the C
    entry point alone (ops/ring.py mesh_call's arguments, ready), and of the
    wrapper's Python (the difference) the n outputs allocated under n stream
    contexts alone, over MESH_SPLIT_CALLS calls each."""
    k, cs_, _outs, args = rk.mesh_call(xs)

    def outputs(i):
        for x, st in zip(xs, cs_.streams):
            with torch.cuda.stream(st):
                torch.empty_like(x)

    sync_all()
    call_us = host_us(lambda i: rk.ring_all_reduce_mesh_cuda(xs), MESH_SPLIT_CALLS)
    sync_all()
    entry_us = host_us(lambda i: k.ring_mesh_launch(*args), MESH_SPLIT_CALLS)
    sync_all()
    return dict(host_call_us=call_us, host_entry_us=entry_us,
                host_wrapper_us=call_us - entry_us,
                host_outputs_us=host_us(outputs, MESH_SPLIT_CALLS))


def mesh_ring(seed, devs, results, tag):
    """15a: ring_all_reduce_mesh over n entries on `devs` against its plain
    version on the same inputs (values over the whole int64 range, so sums
    wrap), each entry on its own stream, one launch a card; back to back
    on rewritten inputs and behind a busy card; timed (mesh_ring_times,
    mesh_host_split) beside its bounds and the library's call."""
    rng = np.random.default_rng(seed + 40)
    recs, err = [], 0
    for n in MESH_N:
        ents = mesh_devices(devs, n)
        cards = len(set(ents))
        streams = rk.entry_streams([d.index for d in ents])
        check(len({s.cuda_stream for s in streams}) == n and all(
            s.device == d for s, d in zip(streams, ents)),
            f"15a{tag}: the {n} entries do not each have a stream of their own on their card")
        for L in MESH_L:
            x = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, (n, L),
                             dtype=np.int64, endpoint=True)
            xs = [torch.from_numpy(x[d]).to(ents[d]) for d in range(n)]
            sync_all()
            before = rk.launch_counts["ring_all_reduce_mesh"]
            got = rk.ring_all_reduce_mesh_cuda(xs)
            sync_all()
            check(rk.launch_counts["ring_all_reduce_mesh"] - before == cards,
                  f"15a{tag} n={n} L={L}: not one launch a card ({cards}) an all-reduce")
            want = rk.ring_all_reduce_mesh_plain(xs)
            total = torch.from_numpy(x.view(np.uint64).sum(0, dtype=np.uint64).view(np.int64))
            for d in range(n):
                check(got[d].device == ents[d], f"15a{tag} n={n} L={L}: sum {d} on {got[d].device}")
                check(torch.equal(got[d], want[d]),
                      f"15a{tag} n={n} L={L}: entry {d}'s kernel and plain sums differ")
                check(torch.equal(got[d].cpu(), total),
                      f"15a{tag} n={n} L={L}: entry {d}'s sum is not the wrapping total")
                err = max(err, max_abs_err(got[d].cpu(), want[d].cpu()))
            check(torch.equal(torch.stack([t.cpu() for t in xs]), torch.from_numpy(x)),
                  f"15a{tag} n={n} L={L}: the inputs changed")
            mesh_back_to_back(rng, ents, streams, L, tag)
            pending = mesh_behind_busy(xs, streams, want, tag)
            times = mesh_ring_times(xs, streams, "ring_mesh_kernel", cards)
            split = mesh_host_split(xs)
            per_card = collections.Counter(ents)
            b_ms, b_by = bound_ms(2 * n * L * 8, cards * (n - 1) * L)
            nvlink_ms = (max(n - k for k in per_card.values()) * 8 * L / NVLINK_BYTES_PER_S * 1e3
                         if cards > 1 else 0.0)
            # one card an entry: NCCL computes the same function in one call
            library_ms = nccl_allreduce_ms(xs, want) if cards == n else None
            one = {}
            if cards == 1:  # one card: the library's sum
                lib_ms, lib_dev_ms = one_card_library_ms(xs, want)
                one = dict(one_card_library_ms=lib_ms, one_card_library_device_ms=lib_dev_ms)
            rec = dict(n=n, L=L, cards=cards, **times, bound_ms=b_ms, bound_by=b_by,
                       nvlink_bound_ms=nvlink_ms, library_ms=library_ms,
                       launches_per_allreduce=cards, back_to_back=MESH_BACK_TO_BACK,
                       pending_behind_busy=pending, max_abs_err=err, **split, **one)
            recs.append(rec)
            lib = (f"torch.stack(xs).sum(0) + {n} copies {fms(one['one_card_library_ms'], 4)} "
                   f"ms a call, {fms(one['one_card_library_device_ms'])} ms device"
                   if one else
                   "NCCL all_reduce " + (f"{library_ms:.4f} ms a call (host)"
                                         if library_ms is not None
                                         else "not run (entries share a card)"))
            tlog(f"  15a{tag} n={n} L={L} on {cards} card(s): bit-equal to the plain version "
                 f"and the wrapping total, {MESH_BACK_TO_BACK} back to back on rewritten "
                 f"inputs and one behind a busy card ({'still busy at return' if pending else 'done at return'}); "
                 f"{cards} launch(es) an all-reduce; launch {fms(times['ms'])} ms device, "
                 f"{fms(times['device_call_ms'])} a call; all-reduce {times['allreduce_ms']:.4f} ms "
                 f"(events), {times['gated_ms']:.4f} ms queued behind a busy stream (events"
                 f"{'' if times['gated_busy'] else ', the stream freed before the last call'}), "
                 f"{times['call_ms']:.4f} ms a call (host): wrapper "
                 f"{split['host_wrapper_us']:.1f} us (its outputs under stream contexts "
                 f"{split['host_outputs_us']:.1f} us) + entry point "
                 f"{split['host_entry_us']:.1f} us; "
                 f"plain {times['plain_ms']:.3f} ms (host clock); {lib}; bound {b_ms:.6f} ms "
                 f"({b_by}), NVLink bytes {nvlink_ms:.6f} ms"
                 f"{' (no link on one card)' if cards == 1 else ''}")
            del xs, got, want
    results[f"mesh_ring{tag}"] = recs
    return recs, err


def mesh_tables_equal(a, b):
    """Two placements' tables equal on the card: a mesh engine's entries
    (or a list of entry tables) against a one-tensor engine's table, or two
    lists of entry tables."""
    sync_all()
    flat = lambda s: (torch.cat([t.reshape(-1, 8).to(s[0].device) for t in s])
                      if isinstance(s, list) else s.reshape(-1, 8))
    return torch.equal(flat(a), flat(b).to(flat(a).device))


def mesh_path_launches():
    return {**sharded_launches(), "ring_all_reduce_mesh": rk.launch_counts["ring_all_reduce_mesh"],
            "ring_all_reduce": rk.launch_counts["ring_all_reduce"]}


def mesh_engine_run(seed, dev, devs, results, tag):
    """15b: a ShardedEngine over an 8-entry mesh on `devs` (collectives="ring")
    beside phase 9's one-tensor engine on `dev`, both on the card, on phase
    9b's windows (global_sync() after each): responses, tables, mirrors,
    registries and counters equal after every window. Returns the mesh
    engine and its launches."""
    from gubernator_tpu_torch.parallel.sharded import ShardedEngine

    batches, _cfg, n_global = global_stream(seed, SHARDED_WINDOWS)
    mesh = make_mesh(n_shards=SHARDS, devices=mesh_devices(devs, SHARDS))
    kw = dict(capacity_per_shard=SHARD_ROWS, min_width=64, max_width=WINDOW)
    # both tables fit at once: 2 x 640 MB of the card's 80 GB
    one = ShardedEngine(device=dev, n_shards=SHARDS, **kw)
    me = ShardedEngine(mesh=mesh, collectives="ring", **kw)
    check(isinstance(me.state, list) and len(me.state) == SHARDS
          and all(t.device == d for t, d in zip(me.state, mesh.entries)),
          f"15b{tag}: the mesh engine's tables are not one an entry on its card")
    warm = {}
    for name, eng in (("one", one), ("mesh", me)):
        t = time.perf_counter()
        eng.warmup()
        warm[name] = time.perf_counter() - t
    secs = {"one": 0.0, "mesh": 0.0}
    sync_s = {"one": 0.0, "mesh": 0.0}
    launches = {"one": {}, "mesh": {}}
    n_req = 0

    def run(name, fn):
        dk.reset_launch_counts()
        rowk.reset_launch_counts()
        rk.reset_launch_counts()
        t = time.perf_counter()
        out = fn()
        sync_all()
        dt_s = time.perf_counter() - t
        for k, v in mesh_path_launches().items():
            launches[name][k] = launches[name].get(k, 0) + v
        return out, dt_s

    for i, (_keys, batch) in enumerate(batches):
        now = NOW + i * 50
        want, s1 = run("one", lambda: one.get_rate_limits(batch, now_ms=now))
        got, s2 = run("mesh", lambda: me.get_rate_limits(batch, now_ms=now))
        secs["one"] += s1
        secs["mesh"] += s2
        n_req += len(batch)
        check(resp_tuples(got) == resp_tuples(want),
              f"15b{tag} window {i}: the mesh and one-tensor engines answer differently")
        b1, s1 = run("one", lambda: one.global_sync(now_ms=now + 25))
        b2, s2 = run("mesh", lambda: me.global_sync(now_ms=now + 25))
        sync_s["one"] += s1
        sync_s["mesh"] += s2
        check(b1 == b2, f"15b{tag} window {i}: broadcasts differ")
        check(mesh_tables_equal(me.state, one.state), f"15b{tag} window {i}: tables differ")
        for f in GlobalMirror._fields:
            check(np.array_equal(getattr(me._mirror, f), getattr(one._mirror, f)),
                  f"15b{tag} window {i}: mirror.{f} differs")
        c = lambda e: {k: v for k, v in e.stats.items() if not k.endswith("_ns")}
        check(c(me) == c(one), f"15b{tag} window {i}: counters differ")
    reg = lambda e: [(k, v.gidx, v.owner, v.seen, v.last_ms) for k, v in e._globals.items()]
    check(reg(me) == reg(one), f"15b{tag}: GLOBAL registries differ")
    for k in ("decide_sharded_wide", "decide_sharded_lean", "ring_all_reduce_mesh"):
        check(launches["mesh"][k] > 0, f"15b{tag}: the mesh engine launched no {k}")
    check(launches["one"]["ring_all_reduce_mesh"] == 0 and launches["mesh"]["ring_all_reduce"] == 0,
          f"15b{tag}: a placement ran the other's ring: {launches}")
    out = dict(requests=n_req, global_requests=n_global, warmup_s=warm,
               decisions_per_s={k: n_req / v for k, v in secs.items()},
               sync_ms={k: v / len(batches) * 1e3 for k, v in sync_s.items()},
               launches=launches, cards=len(set(mesh.entries)),
               stage_s={k: {s: e.stats[f"{s}_ns"] / 1e9 for s in EngineStats.STAGES}
                        for k, e in (("one", one), ("mesh", me))})
    results[f"mesh_engine{tag}"] = out
    tlog(f"  15b{tag}: {n_req:,} requests ({n_global:,} GLOBAL) on {SHARDS} x {SHARD_ROWS:,} "
         f"rows; mesh of {SHARDS} entries on {out['cards']} card(s) "
         f"{out['decisions_per_s']['mesh']:,.0f} decisions/s, one tensor "
         f"{out['decisions_per_s']['one']:,.0f}/s; sync {out['sync_ms']['mesh']:.3f} / "
         f"{out['sync_ms']['one']:.3f} ms a step; warmup {warm['mesh']:.3f} / {warm['one']:.3f} s; "
         "responses, tables, mirrors, registries and counters equal after every window "
         "(both tables on the card at once: 2 x 640 MB of 80 GB)")
    tlog("  15b stage seconds, mesh: " + ", ".join(
        f"{s} {v:.3f}" for s, v in out["stage_s"]["mesh"].items()) + "; one tensor: "
        + ", ".join(f"{s} {v:.3f}" for s, v in out["stage_s"]["one"].items()))
    log(f"  15b launches by form, mesh {launches['mesh']}; one tensor {launches['one']}")
    del one
    gc.collect()
    return me, launches["mesh"]


MESH_INFLIGHT_C, MESH_INFLIGHT_K = 65_536, 16  # 15b's in-flight check: rows, windows an entry


def mesh_inflight_check(seed, devs, results, tag):
    """15b, the published-copy scratch under launches in flight: SHARDS mesh
    entries on `devs`, each its own table of MESH_INFLIGHT_C rows whose row
    C-1 is a live bucket, and MESH_INFLIGHT_K windows of WINDOW lanes an
    entry, each with a lane that writes row C-1 and lanes past the table
    that read it (last_row_window). Every entry's stream first waits behind
    a busy card; the windows are queued entry by entry through the mesh
    engine's wrapper (decide_sharded, one owner), so SHARDS x K launches
    (more than the scratch's 64 slots) are pending at once and launches
    whose numbers differ by 64 lie on different streams. Each entry's
    responses and table equal its plain version's, run window by window."""
    from gubernator_tpu_torch.ops.decide import ROW_ALGO, TABLE_ROW_FIELDS, _VACANT

    rng = np.random.default_rng(seed + 42)
    C, K = MESH_INFLIGHT_C, MESH_INFLIGHT_K
    ents = mesh_devices(devs, SHARDS)
    streams = rk.entry_streams([d.index for d in ents])
    row = torch.tensor([0, 10, 4, 60_000, NOW - 5, NOW + 60_000, 0, 3])
    kerns, plains, windows = [], [], []
    for d in ents:
        t = torch.zeros((C, TABLE_ROW_FIELDS), dtype=torch.int64)
        t[:, ROW_ALGO] = _VACANT
        t[C - 1] = row
        plains.append(t)
        kerns.append(t.to(d, copy=True).view(1, 1, C, TABLE_ROW_FIELDS))
        ws = [last_row_window(rng, t, "wide", WINDOW) for _ in range(K)]
        windows.append([torch.from_numpy(w).to(d).view(1, 1, 9, WINDOW) for w in ws])
    sync_all()
    gate = torch.cuda.Event()
    torch.cuda._sleep(SLEEP_CYCLES // 10)  # ~50 ms of busy card while every launch is queued
    gate.record()
    for st in streams:
        st.wait_event(gate)
    dk.reset_launch_counts()
    outs = []
    for o in range(SHARDS):  # entry by entry: launch numbers 16 o + k
        with torch.cuda.stream(streams[o]):
            outs.append([dk.decide_sharded(dk.WIDE, kerns[o], windows[o][k], None, NOW + k)
                         for k in range(K)])
    pending = not gate.query()
    launched = dk.launch_counts["decide_sharded_wide"]
    sync_all()
    check(launched == SHARDS * K, f"15b{tag} in flight: {launched} launches, not {SHARDS * K}")
    for o in range(SHARDS):
        for k in range(K):
            want = dk.decide_sharded_plain(dk.WIDE, plains[o].view(1, 1, C, TABLE_ROW_FIELDS),
                                           windows[o][k].cpu(), None, NOW + k)
            check(torch.equal(outs[o][k].cpu(), want),
                  f"15b{tag} in flight: entry {o} window {k}: responses differ from plain")
        check(torch.equal(kerns[o].cpu().view(C, TABLE_ROW_FIELDS), plains[o]),
              f"15b{tag} in flight: entry {o}'s table differs from plain")
    out = dict(entries=SHARDS, windows_an_entry=K, launches=launched,
               pending_behind_gate=pending, cards=len(set(ents)))
    results[f"mesh_inflight{tag}"] = out
    tlog(f"  15b{tag} in flight: {launched} sharded decides on {SHARDS} entry streams over "
         f"{out['cards']} card(s), {'all' if pending else 'not all'} queued behind a busy card "
         f"(past the scratch's 64 slots), row C-1 written beside lanes past the table in every "
         "window: responses and tables equal to the plain version's")
    del kerns, windows, outs
    return launched


def mesh_store_run(seed, dev, devs, results, tag):
    """15b, the Store path: phase 9c's windows through a mesh engine with a
    MockStore and the one-tensor engine with its own (both holding the
    100,000 hottest keys' buckets), both on the card: answers, tables,
    Store contents and calls equal; each entry's read- and write-through
    gathers and injects on its own card."""
    from gubernator_tpu_torch.parallel.sharded import ShardedEngine

    batches, key_cfg = request_stream(seed, SHARDED_STORE_WINDOWS)
    held = held_buckets(seed, key_cfg)
    stores = (MockStore(), MockStore())
    for st in stores:
        st.data.update((b.key, dataclasses.replace(b)) for b in held)
    kw = dict(capacity_per_shard=SHARD_ROWS, min_width=64, max_width=WINDOW)
    one = ShardedEngine(device=dev, n_shards=SHARDS, store=stores[0], **kw)
    me = ShardedEngine(mesh=make_mesh(n_shards=SHARDS, devices=mesh_devices(devs, SHARDS)),
                       store=stores[1], **kw)
    secs = {"one": 0.0, "mesh": 0.0}
    launches = {}
    for i, (_keys, batch) in enumerate(batches):
        now = SNAP_NOW + i * 50
        t = time.perf_counter()
        want = one.get_rate_limits(batch, now_ms=now)
        secs["one"] += time.perf_counter() - t
        dk.reset_launch_counts()
        rowk.reset_launch_counts()
        rk.reset_launch_counts()
        t = time.perf_counter()
        got = me.get_rate_limits(batch, now_ms=now)
        secs["mesh"] += time.perf_counter() - t
        for k, v in mesh_path_launches().items():
            launches[k] = launches.get(k, 0) + v
        check(resp_tuples(got) == resp_tuples(want),
              f"15b{tag} Store window {i}: the mesh and one-tensor engines answer differently")
    check(mesh_tables_equal(me.state, one.state), f"15b{tag} Store path: tables differ")
    check({k: dataclasses.astuple(v) for k, v in stores[0].data.items()}
          == {k: dataclasses.astuple(v) for k, v in stores[1].data.items()},
          f"15b{tag} Store path: the Stores' contents differ")
    check(stores[0].called == stores[1].called,
          f"15b{tag} Store path: Store calls differ: one {stores[0].called}, "
          f"mesh {stores[1].called}")
    check(launches["gather_sharded"] > 0 and launches["inject_sharded"] > 0,
          f"15b{tag} Store path: the mesh engine's row launches {launches}")
    n_req = sum(len(b) for _, b in batches)
    results[f"mesh_store{tag}"] = dict(requests=n_req, launches=launches,
                                       decisions_per_s={k: n_req / v for k, v in secs.items()})
    tlog(f"  15b{tag} Store path: {n_req:,} requests, mesh {n_req / secs['mesh']:,.0f} "
         f"decisions/s, one tensor {n_req / secs['one']:,.0f}/s; answers, tables, Store "
         f"contents and calls equal; mesh launches {launches}")
    del one, me
    gc.collect()
    return launches


def mesh_global(seed, me, results, tag, count_check=True):
    """15c: on the mesh engine's tables, five GLOBAL steps of its own step
    (collectives="ring") with G = 1024 keys against a "psum" twin step on
    copies of the tables: mirrors and tables equal after every step; both
    steps timed. `count_check` holds the launches to this tree's design
    (ab_rows.py turns it off to time a parent tree's)."""
    rng = np.random.default_rng(seed + 41)
    plan, G, S, C = me.plan, GLOBAL_KEYS, SHARDS, SHARD_ROWS
    entries = plan.mesh.entries
    psum_step = make_global_sync(plan, collectives="psum")
    sync_all()
    twin = [t.clone() for t in me.state]
    keys = [f"mesh_global_{i}" for i in range(G)]
    owner = np.array([shard_of_key(k, S) for k in keys], np.int32)
    slot = np.full(G, -1, np.int32)
    for s in range(S):
        mine = np.flatnonzero(owner == s)
        slot[mine] = rng.choice(C, len(mine), replace=False)
    slot[rng.random(G) < 0.05] = -1  # not registered yet
    greg = rng.random(G) < 0.05
    dur = np.where(greg, rng.integers(0, 3, G), rng.choice([1000, 60_000], G)).astype(np.int64)
    local = dt.datetime.fromtimestamp(NOW / 1000.0)
    cfg_np = dict(
        slot=slot, owner=owner, limit=rng.choice([10, 100, 10_000], G).astype(np.int64),
        duration=dur, algorithm=(rng.random(G) < 0.2).astype(np.int32),
        behavior=np.where(greg, GREG, 0).astype(np.int32),
        greg_expire=np.array([gregorian_expiration(local, int(c)) if g else 0
                              for g, c in zip(greg, dur)], np.int64),
        greg_interval=np.array([gregorian_duration(local, int(c)) if g else 0
                                for g, c in zip(greg, dur)], np.int64),
        fresh=np.ones(G, np.bool_))
    steps, step_ms, psum_ms = 5, [], []
    launches = {}
    for step in range(steps):
        now = NOW + step * 1000
        delta = rng.integers(0, 5, (S, G)).astype(np.int64)
        deltas = [torch.from_numpy(delta[o]).to(d) for o, d in enumerate(entries)]
        cfgs = [GlobalConfig(**{k: torch.from_numpy(v).to(d) for k, v in cfg_np.items()})
                for d in entries]
        sync_all()
        # the counts read around the ring step alone: the psum twin's decides
        # below are the reference's, not the path's
        dk.reset_launch_counts()
        rk.reset_launch_counts()
        t = time.perf_counter()
        _, m_ring, _ = me._sync(me.state, deltas, cfgs, now)
        sync_all()
        step_ms.append((time.perf_counter() - t) * 1e3)
        for k, v in {**{k: v for k, v in dk.launch_counts.items() if "sharded" in k},
                     "ring_all_reduce_mesh": rk.launch_counts["ring_all_reduce_mesh"]}.items():
            launches[k] = launches.get(k, 0) + v
        t = time.perf_counter()
        _, m_psum, _ = psum_step(twin, deltas, cfgs, now)
        sync_all()
        psum_ms.append((time.perf_counter() - t) * 1e3)
        for f in m_ring._fields:
            check(torch.equal(getattr(m_ring, f).cpu(), getattr(m_psum, f).cpu()),
                  f"15c{tag} step {step}: mirror.{f} differs between ring and psum")
        check(mesh_tables_equal(me.state, twin), f"15c{tag} step {step}: tables differ")
        cfg_np["fresh"] = np.zeros(G, np.bool_)
    cards = len(set(entries))
    if count_check:
        check(launches["ring_all_reduce_mesh"] == 2 * steps * cards,
              f"15c{tag}: {launches['ring_all_reduce_mesh']} all-reduce launches, not two "
              f"all-reduces a step, one launch a card ({cards})")
        check(launches["decide_sharded_wide"] == steps * S,
              f"15c{tag}: {launches['decide_sharded_wide']} sharded decides, not one an entry "
              "a step")
    steady = sum(step_ms[1:]) / (steps - 1)
    psum_steady = sum(psum_ms[1:]) / (steps - 1)
    ph4 = results.get("global", {})
    out = dict(G=G, steps=steps, cards=cards, step_ms=step_ms, first_step_ms=step_ms[0],
               steady_step_ms=steady, launches=launches, psum_step_ms=psum_ms,
               psum_steady_step_ms=psum_steady, psum_first_step_ms=psum_ms[0],
               one_tensor_steady_step_ms=ph4.get("steady_step_ms"),
               one_tensor_first_step_ms=ph4.get("first_step_ms"))
    results[f"mesh_global{tag}"] = out
    p4 = (f"phase 4's one-tensor step {ph4['steady_step_ms']:.3f} ms steady, "
          f"{ph4['first_step_ms']:.3f} ms first" if ph4 else "phase 4 not run")
    tlog(f"  15c{tag}: {steps} steps, G={G}, ring mirrors and tables equal to the psum "
         f"twin's; step {steady:.3f} ms steady (steps 2-{steps}), {step_ms[0]:.3f} ms first "
         f"(host clock); the psum twin's {psum_steady:.3f} ms steady, {psum_ms[0]:.3f} ms "
         f"first; {p4}; launches {launches}")
    del twin
    return launches


def daemon_choice(results):
    """15d: what build_backend picks under GUBER_BACKEND=auto on the cards
    this process sees (a small cache; the engine is closed at once)."""
    from gubernator_tpu_torch.parallel.sharded import ShardedEngine

    n = torch.cuda.device_count()
    keys = ("GUBER_BACKEND", "GUBER_CACHE_SIZE", "GUBER_DEVICE")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(GUBER_BACKEND="auto", GUBER_CACHE_SIZE=str(n * 65_536))
    os.environ.pop("GUBER_DEVICE", None)
    try:
        eng = build_backend(config_from_env([]))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    picked = "sharded" if isinstance(eng, ShardedEngine) else type(eng).__name__
    want = "sharded" if n > 1 else "Engine"
    check(picked == want, f"15d: build_backend picked {picked} on {n} card(s), not {want}")
    if picked == "sharded":
        check(eng.mesh.entries == tuple(torch.device("cuda", i) for i in range(n)),
              f"15d: the daemon's mesh is {eng.mesh.entries}, not one owner a card")
    eng.close()
    del eng
    results["mesh_daemon"] = dict(device_count=n, backend=picked)
    log(f"  15d: torch.cuda.device_count() = {n}; build_backend under GUBER_BACKEND=auto "
        f"picked {'sharded, one owner a card' if picked == 'sharded' else 'engine (Engine)'}")


def phase_mesh(seed, dev, results):
    n_cards = torch.cuda.device_count()
    log(f"== phase 15: the sharded backend over a mesh: the cross-card ring at n in {MESH_N}, "
        f"L in {MESH_L}; ShardedEngine over {SHARDS} mesh entries of {SHARD_ROWS:,} rows "
        f"on {SHARDED_WINDOWS} windows against the one-tensor engine; {GLOBAL_KEYS} GLOBAL "
        f"keys, ring against psum; the daemon's choice ({n_cards} card(s))")
    t0 = time.perf_counter()
    layouts = [("", [dev])]
    if n_cards >= 2:
        layouts.append(("+distinct", [torch.device("cuda", i) for i in range(n_cards)]))
    ring_recs, ring_err = None, 0
    launches = {}
    for tag, devs in layouts:
        recs, err = mesh_ring(seed, devs, results, tag)
        if not tag:
            ring_recs, ring_err = recs, err
        rk.reset_launch_counts()
        me, eng_launches = mesh_engine_run(seed, dev, devs, results, tag)
        glob = mesh_global(seed, me, results, tag)
        del me
        gc.collect()
        mesh_inflight_check(seed, devs, results, tag)
        store = mesh_store_run(seed, dev, devs, results, tag)
        torch.cuda.empty_cache()
        for part in (eng_launches, glob, store):
            for k, v in part.items():
                launches[k] = launches.get(k, 0) + v
    if n_cards < 2:
        log("  15a-15c over distinct cards: not run, this machine has one card "
            f"(torch.cuda.device_count() = {n_cards}); peer access, memory order across "
            "cards and NVLink time wait for a machine with more than one")
    daemon_choice(results)
    results["mesh_launches"] = launches
    tlog(f"  phase 15 in {time.perf_counter() - t0:.1f} s; mesh-path launches {launches}")
    return launches, ring_recs, ring_err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--windows", type=int, default=30)
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    global SMI
    smi = SMI = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("== phase 1: build the CUDA kernels and the key directory")
    t = time.perf_counter()
    build_logs = _build.build()
    build_s = time.perf_counter() - t
    for name, (text, secs) in sorted(build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")
        tlog(f"  built {_build.source_path(name).name} in {secs:.1f} s")
    tlog(f"  built {sorted(build_logs) or 'nothing (cached)'} in {build_s:.1f} s in all")

    results = {"card": smi, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "seed": args.seed, "build_s": build_s,
               "build_each_s": {k: v[1] for k, v in build_logs.items()},
               "decide_shapes": []}
    decide_errs = phase_decide(args.seed, dev, results)
    eng_launches, captured = phase_engine(args.seed, args.windows, dev, results)
    check(len(captured) > 0, "phase 3 made no scan launch to capture")
    replay_groups(captured, dev, results, decide_errs)
    py_launches = phase_engine_python(args.seed, PYTHON_DIR_WINDOWS, dev, results)
    glob_launches, ring_main = phase_global(args.seed, dev, results)
    row_errs, row_recs, bump_launches = phase_rows(args.seed, dev, results)
    pipe_launches = phase_pipeline(args.seed, dev, results)
    persist_launches = phase_persistence(args.seed, dev, results)
    devdir_launches, devdir_errs, devdir_recs = phase_devdir(args.seed, dev, results)
    shard_launches, shard_errs, shard_recs = phase_sharded(args.seed, dev, results)
    host_launches = phase_host_tier(args.seed, dev, results)
    atlas_launches = phase_atlas(args.seed, dev, results)
    wire_launches = phase_wire(args.seed, dev, results)
    overload_launches = phase_overload(args.seed, dev, results)
    fault_launches = phase_faults(args.seed, dev, results)
    mesh_launches, mesh_recs, mesh_err = phase_mesh(args.seed, dev, results)

    kernels = []
    for name in dk.launch_counts:
        if name in SHARDED_KERNELS:
            continue
        scan = "_scan_" in name
        main_shape = next(r for r in results["decide_shapes"]
                          if r["kernel"] == name and r["kind"] == "windows"
                          and r["width"] == (64 if scan else WINDOW)
                          and r["scan_k"] == (32 if scan else 0))
        n = (eng_launches[name] + py_launches[name] + glob_launches[name]
             + pipe_launches[name] + persist_launches[name] + devdir_launches[name]
             + host_launches[name] + atlas_launches.get(name, 0)
             + wire_launches.get(name, 0) + overload_launches.get(name, 0)
             + fault_launches.get(name, 0))
        check(n > 0, f"{name} was never launched on the main path")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=n, max_abs_err=decide_errs[name], ms=main_shape["ms"],
            plain_ms=main_shape["plain_ms"], bound_ms=main_shape["bound_ms"],
            bound_by=main_shape["bound_by"], library_ms=None, library_device_ms=None,
            call_ms=main_shape["call_ms"], shape="K=32, W=64" if scan else f"W={WINDOW}"))
    n = glob_launches["ring_all_reduce"]
    check(n > 0, "ring_all_reduce was never launched on the GLOBAL sync path")
    kernels.append(dict(
        name="ring_all_reduce", route="cuda", source=SOURCES["ring_all_reduce"],
        replaces=REPLACES["ring_all_reduce"], launches=n,
        max_abs_err=ring_main["max_abs_err"], ms=ring_main["ms"],
        plain_ms=ring_main["plain_ms"], bound_ms=ring_main["bound_ms"],
        bound_by=ring_main["bound_by"], library_ms=ring_main["library_ms"],
        library_device_ms=ring_main["library_device_ms"], call_ms=ring_main["call_ms"],
        shape=f"S={GLOBAL_SHARDS}, L={ring_main['L']}"))
    # the pinned row kernels by form: "inject_rows" and "gather_rows" are the
    # by-value forms (the lone path's), "*_mapped" the mapped ones,
    # "inject_rows_copy" the inject copied up; the main path launches no row
    # kernel with operands on the card
    ROW_MAIN_M["inject_rows_mapped"] = max(
        m for m in PINNED_INJECT_M if rowk.pinned_form("inject_rows", m) == "mapped")
    for name in ("inject_rows", "inject_rows_mapped", "inject_rows_copy", "gather_rows",
                 "gather_rows_mapped", "row_bump"):
        base = name.replace("_mapped", "").replace("_copy", "")
        key = f"{base}_{ROW_MAIN_FORM[name]}" if base != "row_bump" else name
        n = (bump_launches if name == "row_bump"
             else eng_launches[key] + pipe_launches[key] + persist_launches[key]
             + host_launches[key] + atlas_launches.get(key, 0)
             + wire_launches.get(key, 0) + overload_launches.get(key, 0)
             + fault_launches.get(key, 0))
        check(n > 0, f"{name} was never launched on its main path")
        r = next(r for r in row_recs if r["kernel"] == base
                 and r["m"] == ROW_MAIN_M.get(name, r["m"])
                 and r["form"] == ROW_MAIN_FORM[name])
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[base], replaces=REPLACES[base],
            launches=n, max_abs_err=row_errs[base], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            library_device_ms=r["library_device_ms"], call_ms=r["call_ms"],
            shape=f"m={r['m']}, {r['form']}"))
    # the probe as the device-directory engine runs it (eviction on, W = 8192)
    # and the sweep; probe_assign (eviction off) runs on no engine's path and
    # is timed in phase 8a only
    for name in ("probe_assign_evict", "refresh_vacancies"):
        n = devdir_launches[name]
        check(n > 0, f"{name} was never launched on the device directory's path")
        r = next(r for r in devdir_recs if r["kernel"] == name and r["W"] in (None, WINDOW))
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=n, max_abs_err=devdir_errs[name], ms=r["ms"],
            ms_source=r.get("ms_source", "torch.profiler" if r["ms"] is not None else None),
            plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            library_device_ms=None, call_ms=r["call_ms"], cold_ms=r.get("cold_ms"),
            floor_ms=r.get("floor_ms"), grid=r.get("grid"), threads=r.get("threads"),
            shape=f"C={r['C']}" + (f", W={r['W']}" if r["W"] else "")))
    # the sharded kernels at the sharded engine's main shapes: the decide at
    # W = 8192 an owner (K = 32, W = 64 for the scan), the gather and the
    # inject at m = 64 an owner
    for name in SHARDED_KERNELS:
        n = shard_launches[name] + mesh_launches.get(name, 0)
        check(n > 0, f"{name} was never launched on the sharded engine's path")
        scan = "_scan_" in name
        r = next(r for r in shard_recs if r["kernel"] == name and (
            r.get("m") == 64 if "m" in r else
            (r["width"], r["scan_k"]) == ((64, 32) if scan else (WINDOW, 0))))
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=n, max_abs_err=shard_errs[name],
            ms=r["ms"], ms_source=r["ms_source"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            library_device_ms=r.get("library_device_ms"), call_ms=r["call_ms"],
            loop_ms=r.get("loop_ms"), loop_call_ms=r.get("loop_call_ms"),
            floor_ms=r.get("floor_ms"),
            shape=(f"R=1, S={SHARDS}, C={SHARD_ROWS}, "
                   + (f"m={r['m']}" if "m" in r else
                      ("K=32, W=64" if scan else f"W={WINDOW}")) + " an owner")))
    # the cross-card all-reduce as the mesh engine's GLOBAL sync runs it:
    # eight entries on the card (one launch), L = 4G (the masked response
    # columns); the library is the one-card sum, torch.stack(xs).sum(0) and
    # eight copies
    n = mesh_launches["ring_all_reduce_mesh"]
    check(n > 0, "ring_all_reduce_mesh was never launched on the mesh engine's path")
    r = next(r for r in mesh_recs if (r["n"], r["L"]) == (SHARDS, 4 * GLOBAL_KEYS))
    kernels.append(dict(
        name="ring_all_reduce_mesh", route="cuda", source=SOURCES["ring_all_reduce_mesh"],
        replaces=REPLACES["ring_all_reduce_mesh"], launches=n, max_abs_err=mesh_err,
        ms=r["ms"] if r["ms"] is not None else r["gated_ms"],
        ms_source=("torch.profiler, a launch (one an all-reduce on one card)"
                   if r["ms"] is not None else
                   "cuda events, an all-reduce queued behind a busy stream (the profiler "
                   "recorded none)"),
        gated_ms=r["gated_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r.get("one_card_library_ms"),
        library_device_ms=r.get("one_card_library_device_ms"),
        library="torch.stack(xs).sum(0) and a copy an output (two calls and n copies)",
        call_ms=r["call_ms"], allreduce_ms=r["allreduce_ms"],
        nvlink_bound_ms=r["nvlink_bound_ms"],
        launches_per_allreduce=r["launches_per_allreduce"],
        host_wrapper_us=r["host_wrapper_us"], host_entry_us=r["host_entry_us"],
        shape=f"n={SHARDS} entries on {r['cards']} card(s), L={r['L']}"))
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    tlog(f"total {results['total_s']:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
