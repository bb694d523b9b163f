"""The `owner` system: one owner of the port on one card, as the daemon's
build_backend makes it on a one-card host (Engine on the native key
directory), serving pulls through its peer link's owner path
(PeerLinkService._handle_batch: runs of MAX_BATCH_SIZE, the columnar C prep
straight to the decide kernels, the leftover items through the
request-object path after their run).

No socket carries the pulls: the service is started with no worker thread,
and each pull is written into the service's own pull buffers, as the
transport's pls_next_batch fills them, and handed to _handle_batch from the
benchmark's one thread. The owner's Instance is reduced to what that path
calls: columnar_backend() and apply_owner_batch_direct(), which ends, as
the Instance's does, in the engine's get_rate_limits.

The engine's columnar entry points (submit_columnar / complete_columnar,
launch_columnar_windows / collect_columnar_windows) are wrapped from
outside to pass the pull's clock (the service reads the wall clock
itself), so that every decision of a pull is made at one recorded clock;
in a traced run they also mark spans for the profiler. The owner stub
counts the leftover items. The wrappers count the items handed to them,
and a pull whose items did not all reach them stops the run: a service
that came to use another entry point would decide at its own clock, and
the check would judge it against the wrong one.
"""

from __future__ import annotations

import ctypes

import numpy as np

from portbench import trace


class System:
    def __init__(self, cfg: dict, fleet, rows0: np.ndarray, device, traced: bool):
        from gubernator_tpu_torch.models.engine import Engine
        from gubernator_tpu_torch.service.peerlink import (
            METHOD_GET_PEER_RATE_LIMITS,
            PeerLinkService,
        )

        self.clock = 0
        self.leftover_items = 0
        self.columnar_items = 0
        self._span = trace.spans(traced)
        eng = Engine(capacity=int(cfg["capacity"]),
                     min_width=int(cfg["min_width"]),
                     max_width=int(cfg["max_width"]), device=device)
        self.engine = eng
        blob, off = fleet.joined()
        restored = eng.load_snapshot_slabs([(blob, off, rows0)])
        del blob, off
        if restored != fleet.n or eng.key_count() != fleet.n:
            raise RuntimeError(f"restored {restored} rows, directory holds "
                               f"{eng.key_count()} keys, want {fleet.n}")
        eng.warmup()
        self._wrap(eng)
        self.service = PeerLinkService(_Owner(self), port=0, workers=0,
                                       wire_v2=False)
        b = self.service._mk_pull_bufs()
        n = len(b["hits"])
        width = fleet.key_rows.shape[1]
        b["key_off"][:] = np.arange(n + 1, dtype=np.int32) * width
        b["name_len"][:] = fleet.name_len
        b["method"][:] = METHOD_GET_PEER_RATE_LIMITS
        self.b = b

    def _wrap(self, eng) -> None:
        submit, complete = eng.submit_columnar, eng.complete_columnar
        launch, collect = eng.launch_columnar_windows, eng.collect_columnar_windows
        span = self._span

        def submit_columnar(*args, now_ms=None):
            self.columnar_items += int(args[0])
            with span("portbench.submit"):
                return submit(*args, now_ms=self.clock)

        def complete_columnar(*args):
            with span("portbench.complete"):
                return complete(*args)

        def launch_columnar_windows(windows, slow_mask, now_ms=None,
                                    staging=None):
            self.columnar_items += sum(int(w[0]) for w in windows)
            with span("portbench.submit"):
                return launch(windows, slow_mask, now_ms=self.clock,
                              staging=staging)

        def collect_columnar_windows(handle, outs):
            with span("portbench.complete"):
                return collect(handle, outs)

        eng.submit_columnar = submit_columnar
        eng.complete_columnar = complete_columnar
        eng.launch_columnar_windows = launch_columnar_windows
        eng.collect_columnar_windows = collect_columnar_windows

    def leftovers(self, requests):
        self.leftover_items += len(requests)
        with self._span("portbench.leftover"):
            return self.engine.get_rate_limits(requests, now_ms=self.clock)

    def fill(self, pool, start: int, stop: int) -> int:
        """Write pool items start..stop into the pull buffers, as the
        transport writes a pull; returns its item count."""
        b = self.b
        got = stop - start
        keys = pool.keys[start:stop]
        ctypes.memmove(b["keys"], keys.ctypes.data, keys.nbytes)
        b["hits"][:got] = pool.hits[start:stop]
        b["limit"][:got] = pool.limit[start:stop]
        b["duration"][:got] = pool.duration[start:stop]
        b["algorithm"][:got] = pool.algorithm[start:stop]
        b["behavior"][:got] = pool.behavior[start:stop]
        return got

    def serve(self, got: int) -> None:
        before = self.columnar_items
        self.service._handle_batch(got, self.b)
        reached = self.columnar_items - before
        if reached != got:
            raise RuntimeError(
                f"{reached} of a pull's {got} items reached the wrapped "
                "columnar entry points of the engine: the owner path now "
                "decides through another one, at a clock the benchmark "
                "does not record (portbench/systems/owner.py)")

    def stage_ns(self) -> dict:
        return dict(self.engine.stats.stage_ns)

    def close(self) -> None:
        self.service.close()
        self.engine.close()
        self.engine = None


class _Owner:
    """The Instance surface that the owner path calls."""

    def __init__(self, system: System):
        self._system = system

    def columnar_backend(self):
        return self._system.engine

    def apply_owner_batch_direct(self, requests, now_ms=None,
                                 from_peer_rpc=False):
        return self._system.leftovers(requests)
