"""Public wrappers around the port's kernels, as ``repro.kernels.ops`` is for
the Pallas ones. The port's wrappers take unpadded tensors: the kernels mask
ragged edges themselves."""

from __future__ import annotations

from repro_torch.kernels.ell_sum import ell_sum
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gossip_mix import gossip_mix
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.kernels.sparse_gossip import gossip_mix_sparse, gossip_mix_sparse_blocked

__all__ = [
    "ell_sum", "flash_attention", "gossip_mix", "gossip_mix_sparse", "gossip_mix_sparse_blocked",
    "selective_scan",
]
