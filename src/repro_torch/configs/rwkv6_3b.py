"""rwkv6-3b ("Finch") — attention-free, data-dependent decay. [arXiv:2404.05892]

§Arch-applicability: DecAvg applies unchanged (gossip averages the full
param pytree); the WKV recurrent *state* is per-sequence and never gossiped.
long_500k runs natively (O(1) state per layer).
"""

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.rwkv import RWKVSpec

CONFIG = ArchConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    source="[arXiv:2404.05892]",
    num_layers=32,
    d_model=2560,
    num_heads=40,  # d_model / head_dim(64)
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    pattern=(LayerSpec("rwkv", "rwkv"),),
    rwkv=RWKVSpec(head_dim=64),
    num_nodes_single_pod=16,
    num_nodes_multi_pod=32,
)
