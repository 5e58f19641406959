"""PyTorch and CUDA port of the ``repro`` package (DecAvg over network
topologies), for one NVIDIA H100.

The module layout mirrors ``repro``'s, so each module's counterpart is found
at the same path. Importing the package sets the float32 precision flags
(see ``repro_torch.device``). The port imports neither ``jax`` nor anything
of ``repro``: the numpy-only modules it needs are copies.
"""

from repro_torch import device as _device  # noqa: F401  (sets precision flags)
