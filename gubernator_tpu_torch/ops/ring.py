"""Ring all-reduce-sum over S shards: plain PyTorch version and CUDA kernel.

The counterpart of the JAX package's ops/ring.py, whose Pallas kernel
(`_ring_kernel`) sums one int64 vector per device around a 1-D ring of
chips in N-1 rotate-and-accumulate hops. Here the S shards of the GLOBAL
sync (parallel/global_sync.py) are S rows of one tensor on one device,
int64[S, L], and every output row is the sum of all rows:

- ring_all_reduce_plain() does the same S-1 hops with torch.roll;
- csrc/ring.cu does them in registers, one column per thread in blocks of
  64, through the shared launch path (ops/_launch.py).

ring_all_reduce() takes a tensor on either device: on the CPU it runs the
plain version, on CUDA it launches the kernel, or raises. The cross-card
form (peer-mapped buffers over NVLink, or NCCL) is not in this module.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import torch

from gubernator_tpu_torch.ops import _launch

I64 = torch.int64

# Launches of the CUDA kernel: the wrapper adds one where it launches.
launch_counts: Dict[str, int] = {"ring_all_reduce": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def ring_all_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """int64[S, L] -> int64[S, L], every row the (wrapping) sum of all rows,
    built as the Pallas kernel builds it: S-1 hops, each shard adding the
    value its left-hand neighbour forwarded on the previous hop."""
    acc = x.clone()
    comm = x
    for _ in range(x.shape[0] - 1):
        comm = torch.roll(comm, 1, 0)  # shard s receives from shard s-1
        acc += comm
    return acc


_kernels: Optional[SimpleNamespace] = None


def _load() -> SimpleNamespace:
    global _kernels
    if _kernels is None:
        V, I = _launch.VOID_P, _launch.INT
        k = _launch.load("ring", {"ring_all_reduce_launch": (I, V, V, I, I, V)})
        k.max_shards = k.lib.ring_max_shards()
        _kernels = k
    return _kernels


def ring_all_reduce_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/ring.cu on x's card. Raises
    on a tensor it does not take (not int64[S, L], not contiguous, S past
    the kernel's largest ring) or a refused launch."""
    index = _launch.cuda_index(x, "ring_all_reduce_cuda")
    _launch.check(x, "x", I64, (None, None), index)
    S, L = x.shape
    k = _kernels or _load()
    if S > k.max_shards:
        raise ValueError(f"the ring kernel takes at most {k.max_shards} shards, got {S}")
    out = torch.empty_like(x)
    if S == 0 or L == 0:
        return out
    _launch.raise_on(k.ring_all_reduce_launch(index, x.data_ptr(), out.data_ptr(), S, L,
                                              k.stream(index)), "ring")
    launch_counts["ring_all_reduce"] += 1
    return out


def ring_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The CPU takes the plain version; CUDA takes the kernel, or raises."""
    if x.is_cpu:
        return ring_all_reduce_plain(x)
    return ring_all_reduce_cuda(x)
