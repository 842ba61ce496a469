"""The device the port's entry points use when the caller names none."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The card: ``torch.device("cuda")``. An entry point that is handed no
    tensor and no ``device`` builds its tensors here, so on a machine without
    CUDA it raises; pass ``device="cpu"`` (or CPU tensors) to run on the CPU."""
    return torch.device("cuda")
