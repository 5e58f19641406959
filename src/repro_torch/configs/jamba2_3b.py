"""AI21-Jamba2-3B: Jamba's hybrid block at 3 B parameters, a dense SwiGLU FFN
on every layer. [https://huggingface.co/ai21labs/AI21-Jamba2-3B/blob/main/config.json]

Published: 28 layers of width 2560; Mamba-1 mixers (``mamba_d_state`` 16,
``d_conv`` 4, ``expand`` 2, ``dt_rank`` 160, conv bias, no projection bias)
with RMSNorms on dt, B and C inside the mixer (arXiv:2403.19887, section
6.4); one attention layer in every 14 (``attn_layer_offset`` 7,
``attn_layer_period`` 14) with 20 query heads and one KV head of width 128,
no positional encoding; a dense FFN of 8192 on every layer
(``num_experts`` 1); a tied 65,536-row vocabulary; ``rms_norm_eps`` 1e-6.

The config holds one period, 14 of the 28 layers (13 Mamba layers and the
attention layer at index 7): the deployment it stands for runs each member
as a two-stage pipeline, one period a card, and a card holds stage 1 of
every member of its cohort. ``PUBLISHED_LAYERS`` is the full depth. The
public config names no optimizer: SGD with momentum, as the port's
jamba-v0.1 trains.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.mamba import MambaSpec

PUBLISHED_LAYERS = 28
ATTN_OFFSET, ATTN_PERIOD = 7, 14

_P = tuple(LayerSpec(mixer="attn" if i == ATTN_OFFSET else "mamba", ffn="dense")
           for i in range(ATTN_PERIOD))

CONFIG = ArchConfig(
    arch_id="jamba2-3b",
    family="hybrid",
    source="[https://huggingface.co/ai21labs/AI21-Jamba2-3B/blob/main/config.json]",
    num_layers=ATTN_PERIOD,
    d_model=2560,
    num_heads=20,
    num_kv_heads=1,
    head_dim=128,
    d_ff=8192,
    vocab_size=65536,
    pattern=_P,
    mamba=MambaSpec(d_state=16, d_conv=4, expand=2, dt_rank=160, inner_norms=True),
    optimizer="sgd",
    num_nodes_single_pod=3,
    num_nodes_multi_pod=3,
    use_rope=False,
    tie_embeddings=True,
    norm_eps=1e-6,
)
