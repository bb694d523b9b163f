"""Row-access probe: random 512-byte row read-modify-writes on the card.

    python3 -m gubernator_tpu_torch.bench_rows

The counterpart of the JAX package's scripts/bench_pallas_rows.py main():
an int32[CAP, 128] table (5.12 GB at CAP = 10M) takes +1 on every element
of BATCH distinct random rows per call, in place, through the row_bump
kernel (csrc/rows.cu, via ops/rows.py). Four slot sets are drawn as the
original draws them (np.random.RandomState(5), replace=False); one warm
call, one timed call to size the loop, then a loop of about TARGET_S
seconds. Prints one JSON line: variant, rows_per_s, iters and the card's
name. Runs on the card unless the caller of run() asks for the CPU.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from gubernator_tpu_torch.ops.rows import BUMP_ROW, row_bump
from gubernator_tpu_torch.utils.platform import resolve_device

CAP = 10_000_000
BATCH = 8_192
TARGET_S = 3.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device=None, cap: int = CAP, batch: int = BATCH,
        target_s: float = TARGET_S) -> dict:
    """Run the probe and return its JSON record."""
    dev = resolve_device(device)
    rng = np.random.RandomState(5)
    table = torch.zeros((cap, BUMP_ROW), dtype=torch.int32, device=dev)
    slot_sets = [torch.from_numpy(rng.choice(cap, batch, replace=False)
                                  .astype(np.int32)).to(dev) for _ in range(4)]
    out = row_bump(table, slot_sets[0])
    _ = int(out[0])
    t0 = time.perf_counter()
    out = row_bump(table, slot_sets[1])
    _ = int(out[0])
    per_call = max(time.perf_counter() - t0, 1e-6)
    iters = max(4, min(400, int(target_s / per_call)))
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        out = row_bump(table, slot_sets[i % 4])
    _ = int(out[0])
    el = time.perf_counter() - t0
    return {
        "variant": "cuda_row_bump" if dev.type == "cuda" else "plain_row_bump",
        "rows_per_s": iters * batch / el,
        "iters": iters,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main() -> None:
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
