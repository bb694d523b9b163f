"""The launch path shared by the CUDA wrappers of ops/ring.py and ops/rows.py.

Their kernels run in about 1.3 µs on the card, so a wrapper call is mostly
host work: checks, the library, an output, the stream, the ctypes call.
This module keeps each of those to attribute reads and one foreign call:

- load() builds and loads a csrc/ library once, sets the argtypes of its
  entry points and returns them as attributes of one namespace, with the
  stream lookup beside them; nothing is looked up again per call;
- cuda_index() and check() raise ValueError on a tensor the kernel does not
  take (wrong device, dtype, shape or contiguity), through one test of
  attributes that builds no torch.device; an operand in host memory is
  checked for page-locking by CUDA at the launch (the entry point's
  cudaHostGetDevicePointer fails on other memory), and require_pinned()
  then names the operand at fault;
- the namespace's stream(index) is the current stream's cudaStream_t,
  read without building a torch.cuda.Stream object;
- raise_on() turns the error an entry point returns (cudaGetLastError()
  after its launch) into a RuntimeError.

Nothing here imports or touches CUDA until a wrapper's first launch: the
module imports on machines with no card and no nvcc. No lock is taken per
call; a library loads under ops/_build.py's lock.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Dict, Optional, Sequence

import torch

from gubernator_tpu_torch.ops import _build

VOID_P = ctypes.c_void_p
INT = ctypes.c_int
LONGLONG = ctypes.c_longlong
HOST = -1  # check(..., index=HOST): host memory (page-locked, for a kernel)


def load(name: str, signatures: Dict[str, Sequence]) -> SimpleNamespace:
    """Build and load csrc/<name>.cu, give each entry point of `signatures`
    ({symbol: argtypes}) its argtypes and an int return (a CUDA error
    code), and return them as attributes of a namespace, with `stream`:
    stream(index) is the raw handle of card `index`'s current stream.

    That is torch._C._cuda_getCurrentRawStream, which is private to
    PyTorch (the code its compiler generates calls it): it returns the
    cudaStream_t as an int without building the torch.cuda.Stream that
    torch.cuda.current_stream(device).cuda_stream builds on every call.
    Checked on torch 2.11.0+cu128, where chip_smoke.py holds the two equal,
    inside a side-stream context too. A CPU build of torch lacks it, so it
    is looked up here, at the first launch, and not at import."""
    lib = _build.load(name)
    fns = {}
    for symbol, argtypes in signatures.items():
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = INT
        fns[symbol] = fn
    return SimpleNamespace(lib=lib, stream=torch._C._cuda_getCurrentRawStream, **fns)


def cuda_index(t: torch.Tensor, what: str) -> int:
    """The index of the card `t` lies on; ValueError when it is not on one."""
    if not t.is_cuda:
        raise ValueError(f"{what} needs CUDA tensors, got {t.device}")
    return t.get_device()


def check(t: torch.Tensor, what: str, dtype: torch.dtype,
          dims: Sequence[Optional[int]], index: int) -> None:
    """Raise ValueError unless `t` is a contiguous `dtype` tensor with one
    dimension per entry of `dims` (one or two entries: an int the size must
    equal, or None for any size) on card `index`, or, for index HOST, in
    host memory. One expression over t.shape, read once: Tensor.size(i)
    costs about three times as much as a tuple index."""
    shape = t.shape
    if ((not t.is_cuda if index == HOST else t.get_device() == index)
            and t.dtype is dtype and len(shape) == len(dims) and t.is_contiguous()
            and (dims[0] is None or shape[0] == dims[0])
            and (len(dims) == 1 or dims[1] is None or shape[1] == dims[1])):
        return
    _refuse(t, what, dtype, dims, index)


def _refuse(t: torch.Tensor, what: str, dtype: torch.dtype, dims, index: int) -> None:
    """The ValueError for the first condition of check() that `t` fails."""
    if index == HOST and t.is_cuda:
        raise ValueError(f"{what} must be in host memory, got a tensor on {t.device}")
    if index != HOST and t.get_device() != index:
        raise ValueError(f"{what} is on {t.device}, expected cuda:{index}")
    if t.dtype is not dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    want = ", ".join("n" if d is None else str(d) for d in dims)
    raise ValueError(f"{what} must be [{want}], got {tuple(t.shape)}")


def require_pinned(t: torch.Tensor, what: str) -> None:
    """Raise ValueError unless `t` lies in page-locked host memory
    (pin_memory=True), the only host memory a kernel can address."""
    if t.is_cuda or not t.is_pinned():
        raise ValueError(f"{what} must be page-locked host memory (pin_memory=True), "
                         f"got a tensor on {t.device} that is not")


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
