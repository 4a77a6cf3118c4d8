"""Device resolution shared by every entry point of the port, and the
card's published peak rates, which every bound and roofline of the port
(`chip_smoke.py`, `launch/dryrun.py`) reads."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

# NVIDIA H100 SXM 80GB HBM3 at its 700 W limit, the data sheet's dense
# rates: tensor-core bf16, CUDA-core fp32 and fp64; HBM3; NVLink 4 per
# direction. A card set below 700 W runs below these under load.
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "float64": 34e12}
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 450e9


class NoCudaDevice(RuntimeError):
    """An entry point was asked to run on the card and there is none."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no CUDA device and no explicit request this raises, so
    a run never carries on on the CPU by accident."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDevice(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """`ModelConfig.dtype` string -> torch dtype."""
    try:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None
