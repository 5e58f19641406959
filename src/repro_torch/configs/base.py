"""Architecture configuration, mirrored field for field from the reference's
``repro/configs/base.py``.

``ArchConfig`` is what model init, forward, prefill, decode and the serving
engine read. ``pattern`` is one period of layers; the stack is the pattern
tiled ``num_groups`` times, and the parameters of each layer of the period
carry a leading group axis (the reference scans over it; the port loops).

One file per assigned architecture lives beside this module, each with its
source in ``source``; ``get`` resolves an arch id or alias to its config.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Literal

import torch

from repro_torch.models.mamba import MambaSpec
from repro_torch.models.moe import MoESpec
from repro_torch.models.rwkv import RWKVSpec

__all__ = ["ArchConfig", "LayerSpec", "ASSIGNED_ARCHS", "EXTRA_ARCHS", "get", "all_arch_ids"]

Mixer = Literal["attn", "mamba", "rwkv"]
Ffn = Literal["dense", "moe", "rwkv", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    ffn: Ffn = "dense"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    source: str

    num_layers: int = 12
    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 2048
    vocab_size: int = 32000
    rope_theta: float = 10000.0
    norm: Literal["rms", "ln"] = "rms"
    ffn_act: Literal["swiglu", "gelu"] = "swiglu"

    # Layer pattern (one period; tiled). Default: uniform attn+dense.
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)

    moe: MoESpec | None = None
    mamba: MambaSpec | None = None
    rwkv: RWKVSpec | None = None

    # Sliding-window width of the long-context variant; full attention
    # unless ``always_window`` is set.
    sliding_window: int = 4096
    always_window: bool = False

    # Encoder-decoder (whisper): encoder layers share d_model/heads/d_ff.
    enc_dec: bool = False
    enc_layers: int = 0
    max_target_len: int = 448

    # Modality frontends: continuous prefix embeddings (vlm).
    vlm_prefix_frac: float = 0.0

    # Distribution / dtype policy.
    num_nodes_single_pod: int = 16
    num_nodes_multi_pod: int = 32
    param_dtype: str = "bfloat16"
    opt_dtype: str = "float32"
    optimizer: str = "adamw"

    smoke_batch: int = 2
    smoke_seq: int = 32

    # The port's own fields (the reference has none of them), each off by
    # default, so every config above builds the reference's tree and bits:
    # RoPE in self-attention (Jamba uses no positional encoding), logits as
    # ``x @ embed.T`` with no ``lm_head`` leaf, and the eps of every RMSNorm.
    use_rope: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.period == 0, (
            f"{self.arch_id}: num_layers {self.num_layers} not divisible by "
            f"pattern period {self.period}"
        )
        return self.num_layers // self.period

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 periods, d_model<=256, <=4 experts, f32
        params."""
        d_model = min(self.d_model, 256)
        hd = 32
        heads = max(2, min(self.num_heads, d_model // hd))
        kv = heads if self.num_kv_heads == self.num_heads else max(1, heads // 2)
        if self.num_kv_heads == 1:
            kv = 1  # multi-query attention stays multi-query
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff=min(self.moe.d_ff, 448),
                dense_d_ff=min(self.moe.dense_d_ff, 448) if self.moe.dense_d_ff else 0,
            )
        rwkv = None
        if self.rwkv is not None:
            rwkv = dataclasses.replace(self.rwkv, head_dim=hd, decay_lora=16, chunk=8)
        mamba = None
        if self.mamba is not None:
            mamba = dataclasses.replace(self.mamba, d_state=8, chunk=8, dt_rank=0)
        return dataclasses.replace(
            self,
            arch_id=self.arch_id + "-reduced",
            num_layers=min(2 * self.period, self.num_layers),
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            enc_layers=min(self.enc_layers, 2),
            moe=moe,
            rwkv=rwkv,
            mamba=mamba,
            sliding_window=16,
            param_dtype="float32",
            num_nodes_single_pod=4,
            num_nodes_multi_pod=4,
        )


ASSIGNED_ARCHS = (
    "stablelm_3b",
    "mistral_large_123b",
    "jamba_v01_52b",
    "dbrx_132b",
    "arctic_480b",
    "llama32_1b",
    "minicpm_2b",
    "rwkv6_3b",
    "whisper_base",
    "internvl2_76b",
)

_ALIASES = {name.replace("_", "-"): name for name in ASSIGNED_ARCHS} | {
    "stablelm-3b": "stablelm_3b",
    "mistral-large-123b": "mistral_large_123b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "dbrx-132b": "dbrx_132b",
    "arctic-480b": "arctic_480b",
    "llama3.2-1b": "llama32_1b",
    "minicpm-2b": "minicpm_2b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-base": "whisper_base",
    "internvl2-76b": "internvl2_76b",
    "paper-mlp": "paper_mlp",
    "jamba2-3b": "jamba2_3b",
}

# Configurations of the port beyond the reference's zoo (``all_arch_ids``
# stays the reference's list): each resolves through ``get``.
EXTRA_ARCHS = ("jamba2_3b",)


def get(arch_id: str) -> Any:
    """The config of ``arch_id`` (module name or alias; ``paper-mlp`` gives
    the paper MLP's own dataclass, as in the reference)."""
    mod_name = _ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", ""))
    if mod_name not in ASSIGNED_ARCHS + EXTRA_ARCHS + ("paper_mlp",):
        raise ValueError(f"unknown arch id {arch_id!r}; known: {ASSIGNED_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_arch_ids() -> tuple[str, ...]:
    return ASSIGNED_ARCHS
