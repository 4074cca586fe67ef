"""Device selection for the port.

The caller names the device; nothing here probes for a card and falls
back.  `resolve_device("cuda")` on a machine without a usable CUDA device
raises, so a run that asked for the card never runs quietly on the CPU.
"""

from __future__ import annotations

import torch

from .errors import ConfigError


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device for `device`; raises when it is a CUDA device and
    no card is present."""
    try:
        dev = torch.device(device)
    except RuntimeError as exc:
        raise ConfigError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'") from exc
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available (pass device='cpu' to run on the CPU)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ConfigError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
