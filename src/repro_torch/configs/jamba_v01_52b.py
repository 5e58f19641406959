"""jamba-v0.1-52b — hybrid Mamba+attention 7:1 with MoE every other layer.
[arXiv:2403.19887]

Pattern period = 8 layers (the Jamba block): one attention layer per period
(position 4, mirroring the paper's placement), Mamba elsewhere; MoE replaces
the dense FFN on every odd layer (16 experts, top-2).
"""

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.mamba import MambaSpec
from repro_torch.models.moe import MoESpec

_P = tuple(
    LayerSpec(
        mixer="attn" if i == 4 else "mamba",
        ffn="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = ArchConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    source="[arXiv:2403.19887]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    pattern=_P,
    moe=MoESpec(num_experts=16, top_k=2, d_ff=14336),
    mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
    optimizer="sgd",
    num_nodes_single_pod=2,
    num_nodes_multi_pod=4,
)
