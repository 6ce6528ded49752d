"""Device resolution shared by every entry point of the package."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    There is no silent fallback: with no CUDA device and no explicit
    `device`, this raises instead of running on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")


def host_values(t: torch.Tensor) -> list:
    """`t.tolist()`: a step's one read of device values on the host. A meta
    tensor (the dry run, `launch.dryrun`: shapes only) holds no values and
    reads as zeros of its shape, so the step runs on with the shapes it
    would have; a CPU or CUDA tensor never takes that path."""
    if t.is_meta:
        return torch.zeros(t.shape, dtype=t.dtype).tolist()
    return t.tolist()
