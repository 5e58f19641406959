"""whisper-base — encoder-decoder audio backbone. [arXiv:2212.04356]

The mel+conv frontend is a STUB (models/frontends.py): the encoder consumes
precomputed frame embeddings. LayerNorm + GELU FFN per the Whisper paper.
Decoder context is 448 tokens; the decode_32k / long_500k shapes are
architecturally synthetic for this model (see DESIGN.md §4) but are lowered
with a ring-buffer cache for completeness.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    arch_id="whisper-base",
    family="audio",
    source="[arXiv:2212.04356]",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    norm="ln",
    ffn_act="gelu",
    pattern=(LayerSpec("attn", "dense"),),
    enc_dec=True,
    enc_layers=6,
    max_target_len=448,
    num_nodes_single_pod=16,
    num_nodes_multi_pod=32,
)
