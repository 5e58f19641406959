"""mistral-large-123b — dense GQA. [hf:mistralai/Mistral-Large-Instruct-2407]"""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    arch_id="mistral-large-123b",
    family="dense",
    source="[hf:mistralai/Mistral-Large-Instruct-2407]",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    pattern=(LayerSpec("attn", "dense"),),
    # 123 B params: two full replicas (nodes) per 256-chip pod at most.
    optimizer="sgd",
    opt_dtype="bfloat16",
    num_nodes_single_pod=2,
    num_nodes_multi_pod=4,
)
