"""arctic-480b — 128-expert top-2 MoE with a parallel dense residual FFN.
[hf:Snowflake/snowflake-arctic-base]

At 482 B params a single replica needs bf16 optimizer state to fit a pod
(DESIGN §4): single-pod hosts 1 node (gossip degenerates to local training),
multi-pod hosts 2 (one per pod — the cross-silo configuration).
"""

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.moe import MoESpec

CONFIG = ArchConfig(
    arch_id="arctic-480b",
    family="moe",
    source="[hf:Snowflake/snowflake-arctic-base]",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    pattern=(LayerSpec("attn", "moe"),),
    moe=MoESpec(
        num_experts=128, top_k=2, d_ff=4864, dense_residual=True, dense_d_ff=4864
    ),
    optimizer="sgd",
    num_nodes_single_pod=1,
    num_nodes_multi_pod=2,
    opt_dtype="bfloat16",
)
