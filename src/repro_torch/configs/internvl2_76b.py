"""internvl2-76b — VLM backbone: InternLM2-style 80L GQA decoder.
[arXiv:2404.16821]

The InternViT-6B vision tower + MLP projector is a STUB (models/frontends.py):
the LM consumes projected patch embeddings as a continuous prefix
(``vlm_prefix_frac`` of the sequence) ahead of the text tokens.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    arch_id="internvl2-76b",
    family="vlm",
    source="[arXiv:2404.16821]",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=1_000_000.0,
    pattern=(LayerSpec("attn", "dense"),),
    vlm_prefix_frac=0.25,
    optimizer="sgd",
    opt_dtype="bfloat16",
    num_nodes_single_pod=2,
    num_nodes_multi_pod=4,
)
