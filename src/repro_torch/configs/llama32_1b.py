"""llama3.2-1b — small llama3 dense GQA. [hf:meta-llama/Llama-3.2-1B]"""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    arch_id="llama3.2-1b",
    family="dense",
    source="[hf:meta-llama/Llama-3.2-1B]",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    pattern=(LayerSpec("attn", "dense"),),
    num_nodes_single_pod=16,
    num_nodes_multi_pod=32,
)
