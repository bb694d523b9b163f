"""Ring all-reduce-sum over S shards: plain PyTorch version and CUDA kernel.

The counterpart of the JAX package's ops/ring.py, whose Pallas kernel
(`_ring_kernel`) sums one int64 vector per device around a 1-D ring of
chips in N-1 rotate-and-accumulate hops. Here the S shards of the GLOBAL
sync (parallel/global_sync.py) are S rows of one tensor on one device,
int64[S, L], and every output row is the sum of all rows:

- ring_all_reduce_plain() does the same S-1 hops with torch.roll;
- csrc/ring.cu does them in registers, one thread per column.

ring_all_reduce() takes a tensor on either device: on the CPU it runs the
plain version, on CUDA it launches the kernel, or raises. The cross-card
form (peer-mapped buffers over NVLink, or NCCL) is not in this module.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

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


_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from gubernator_tpu_torch.ops import _build

        lib = _build.load("ring")
        lib.ring_all_reduce_launch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.ring_all_reduce_launch.restype = ctypes.c_int
        lib.ring_max_shards.argtypes = []
        lib.ring_max_shards.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def ring_all_reduce_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/ring.cu on x's card. Raises on a tensor it does not take
    (not int64[S, L], not contiguous, S past the kernel's largest ring) or
    a refused launch."""
    if x.device.type != "cuda":
        raise ValueError(f"ring_all_reduce_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int64 or x.dim() != 2:
        raise ValueError(f"x must be int64[S, L], got {x.dtype}{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    S, L = x.shape
    lib = _lib()
    if S > lib.ring_max_shards():
        raise ValueError(f"the ring kernel takes at most "
                         f"{lib.ring_max_shards()} shards, got {S}")
    out = torch.empty_like(x)
    if S == 0 or L == 0:
        return out
    dev = x.device
    err = lib.ring_all_reduce_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        x.data_ptr(), out.data_ptr(), S, L,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring kernel launch failed: CUDA error {err}")
    launch_counts["ring_all_reduce"] += 1
    return out


def ring_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The CPU takes the plain version; CUDA takes the kernel, or raises."""
    if x.device.type == "cpu":
        return ring_all_reduce_plain(x)
    return ring_all_reduce_cuda(x)
