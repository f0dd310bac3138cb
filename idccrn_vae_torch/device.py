"""Device selection for the port's entry points.

The entry points (`NsvaeEncoder`, `VaeDecoder`, `Enhancer`) run on the
card unless the caller asks for another device. With no CUDA device the
default raises instead of drifting to the CPU, so a CPU run is always
one the caller asked for.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "idccrn_vae_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
