"""Device resolution for the port's entry points.

Every entry point (Engine, make_table, make_global_sync, ...) runs on the
CUDA card unless its caller asks for the CPU. Without a card and without
that request it raises: the port never carries on silently on the CPU,
where the plain PyTorch versions of its kernels would stand in for them.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the CUDA card; "cpu" (or any explicit device) is taken
    as given. Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
