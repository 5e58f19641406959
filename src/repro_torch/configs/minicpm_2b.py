"""minicpm-2b — llama-like dense MHA, trained with the WSD schedule.
[arXiv:2404.06395]"""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    arch_id="minicpm-2b",
    family="dense",
    source="[arXiv:2404.06395]",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    pattern=(LayerSpec("attn", "dense"),),
    num_nodes_single_pod=16,
    num_nodes_multi_pod=32,
)

LR_SCHEDULE = "wsd"
