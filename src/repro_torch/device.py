"""Device resolution for the port's entry points.

Everything runs on ``cuda`` unless the caller asks for ``cpu``. A missing
GPU is an error, never a silent CPU run. On the card the f32 numerics of
the reference are kept: TF32 is switched off for matmuls and cuDNN
convolutions (cuDNN defaults to TF32), and cuDNN is held to deterministic
algorithms so that the round-fused loop and the host loop give bitwise
equal results.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' "
                "(CLI: --device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
