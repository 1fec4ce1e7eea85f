"""Where the port's entry points put their tensors.

Every entry point that builds tensors takes ``device="cuda"``: the port
runs on the card unless the caller asks for the CPU (``device="cpu"``, as
the tests do).  Without a CUDA device a call that did not ask for the CPU
raises instead of carrying on there.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a torch.device (None means the card); raises if it
    names CUDA and no CUDA device is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card unless "
            "the caller passes device='cpu'")
    return dev
