"""Device resolution, the shared-memory budget and the SM count of the
card.

Counterpart of wespeaker_tpu/ops/tpu_info.py: there the fused Pallas
kernels sized their tiles against a VMEM budget read from the TPU; here
the CUDA kernels size theirs against the shared memory one block may opt
into, read from the card's properties.
"""

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None means the card. Raises when CUDA is asked for and absent: an
    entry point never drops to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def smem_budget_bytes(device: DeviceLike = None) -> int:
    """Dynamic shared memory one block may opt into on `device` (232,448
    bytes on an H100). Only meaningful for a CUDA device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"no shared-memory budget on {dev}")
    props = torch.cuda.get_device_properties(dev)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    if optin is None:
        raise RuntimeError("this torch build does not report "
                           "shared_memory_per_block_optin")
    return int(optin)


H100_SMS = 132  # an H100 SXM's SMs, where no card can be asked


def sm_count(device: DeviceLike = None) -> int:
    """The card's SMs, as the CUDA launchers read them at run time
    (csrc/common.cuh::sm_count), or H100_SMS where CUDA is absent, so that
    the CPU mirrors of the launch plans follow the card they model."""
    if not torch.cuda.is_available():
        return H100_SMS
    dev = resolve_device(device)
    if dev.type != "cuda":
        return H100_SMS
    return int(torch.cuda.get_device_properties(dev).multi_processor_count)
