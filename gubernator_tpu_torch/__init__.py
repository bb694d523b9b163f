"""gubernator_tpu_torch — the PyTorch/CUDA port of gubernator_tpu.

The JAX package (gubernator_tpu/) is the reference; this package does the
same work in PyTorch for one NVIDIA H100. Its layout mirrors the JAX
package's, so each module's counterpart sits at the same relative path.
Device kernels are hand-written CUDA C++ (csrc/), built with nvcc at first
use and bound through ctypes (ops/_build.py); each keeps a plain PyTorch
version beside it, which is what runs when the tensors lie on the CPU.

The port imports torch and numpy and never JAX, nor anything of the JAX
package: what it needs from there it keeps as its own copy (types.py,
utils/). Entry points run on the CUDA card unless the caller passes
device="cpu".
"""

from gubernator_tpu_torch.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
    RateLimitResp,
    Status,
    hash_key,
)

__version__ = "0.1.0"

__all__ = [
    "Algorithm",
    "Behavior",
    "RateLimitReq",
    "RateLimitResp",
    "Status",
    "hash_key",
    "__version__",
]
