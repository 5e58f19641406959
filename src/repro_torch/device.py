"""Device selection and the float32 precision contract.

TF32 keeps about three decimal digits, and the reference's float32
tolerances are 3e-5, so both TF32 switches are off for every matmul and
convolution the port runs (PyTorch's default leaves cuDNN's on).

Every entry point takes ``device=None``, which means the CUDA card. Without
one it raises instead of carrying on on the CPU: the CPU is used only when a
caller asks for it (``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device", "device_name"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises RuntimeError without a card); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, ``"cpu"`` otherwise."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
