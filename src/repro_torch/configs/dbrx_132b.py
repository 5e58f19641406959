"""dbrx-132b — fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]"""

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.moe import MoESpec

CONFIG = ArchConfig(
    arch_id="dbrx-132b",
    family="moe",
    source="[hf:databricks/dbrx-base]",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    pattern=(LayerSpec("attn", "moe"),),
    moe=MoESpec(num_experts=16, top_k=4, d_ff=10752),
    optimizer="sgd",
    opt_dtype="bfloat16",
    num_nodes_single_pod=2,
    num_nodes_multi_pod=4,
)
