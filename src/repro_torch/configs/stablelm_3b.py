"""stablelm-3b — dense, MHA (kv == heads). [hf:stabilityai/stablelm-2-1_6b]"""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    arch_id="stablelm-3b",
    family="dense",
    source="[hf:stabilityai/stablelm-2-1_6b]",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    pattern=(LayerSpec("attn", "dense"),),
    num_nodes_single_pod=16,
    num_nodes_multi_pod=32,
)
