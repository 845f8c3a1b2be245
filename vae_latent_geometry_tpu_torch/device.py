"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` unless the caller names another device.

    A CUDA request on a machine without a usable GPU raises: the port never
    falls back to the CPU silently (a CPU run of the production workload is
    orders of magnitude slower, and its numbers are not device numbers)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU explicitly")
    return dev
