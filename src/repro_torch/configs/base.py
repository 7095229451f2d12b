"""Unified model configuration covering all ten assigned architectures plus
the paper's own sentence-encoder.  One frozen dataclass; families select
block patterns.  A copy of ``repro.configs.base``: ``dtype`` is a
``torch.dtype``.  The registry holds every config; ``repro_torch.models``
runs every family in train, prefill and decode mode."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

REGISTRY = {}


def register(cfg: "ModelConfig") -> "ModelConfig":
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> "ModelConfig":
    if name not in REGISTRY:
        from repro_torch import configs  # noqa: F401  (populates REGISTRY)
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    d_ff_shared: int = 0  # 0 -> no shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # mamba2 P
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "silu"  # mlp activation; "geglu" handled via act="gelu"
    gated_mlp: bool = True  # SwiGLU/GeGLU if True, plain MLP otherwise
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # SWA width (mixtral)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SsmConfig] = None
    # Heterogeneous stacks (grouped scan; DESIGN.md sec. 3):
    group_size: int = 1  # layers per scanned super-block
    cross_attn_index: Optional[int] = None  # vlm: local idx of cross-attn layer
    shared_attn_every: Optional[int] = None  # zamba2: shared attn after each group
    slstm_index: Optional[int] = None  # xlstm: local idx of sLSTM layer
    block_kind: str = "attn"  # attn | mamba | mlstm  (body of each group)
    # Encoder-decoder (whisper):
    encoder_layers: int = 0
    n_frontend_tokens: int = 0  # stub modality tokens (audio frames / img patches)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    max_seq_len: int = 8192
    # --- large-scale knobs (launch/train) ---
    remat: bool = True
    microbatch: int = 1  # gradient-accumulation steps inside train_step
    # --- perf-hillclimb knobs (EXPERIMENTS.md section Perf) ---
    attn_probs_bf16: bool = False  # cast attention probs to bf16 before PV
    attn_chunk: Optional[int] = 1024  # flash-style KV-block online softmax (None -> naive)
    # "auto" keeps the chunked/naive path; "flash" routes train-mode
    # self-attention through the flash-attention kernel
    # (kernels/flash_attention.py; its plain version on a CPU tensor), used
    # by the serving encoder stage whose bucketed shapes satisfy the kernel's
    # block-divisibility; "sdpa" forces the naive path (A/B baseline).
    attn_impl: str = "auto"  # auto | flash | sdpa
    moe_impl: str = "scatter"  # scatter (zero-flop dispatch) | einsum (GShard one-hot)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def dtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, (self.n_layers, self.group_size)
        return self.n_layers // self.group_size

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so TP over 16 always divides."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (whisper is enc-dec)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        scale = {
            "d_model": 64,
            "n_heads": max(2, min(self.n_heads, 4)),
            "n_kv_heads": max(1, min(self.n_kv_heads, 2)),
            "d_ff": 128 if self.d_ff else 0,
            "vocab_size": 512,
            "head_dim": 16 if self.head_dim else None,
            "param_dtype": "float32",
            "max_seq_len": 128,
            "remat": False,
        }
        n_groups = min(self.n_groups, 2)
        scale["n_layers"] = n_groups * self.group_size
        if self.moe:
            scale["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                d_ff_shared=128 if self.moe.d_ff_shared else 0,
            )
        if self.ssm:
            scale["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16, chunk=16)
        if self.encoder_layers:
            scale["encoder_layers"] = 2
        if self.n_frontend_tokens:
            scale["n_frontend_tokens"] = 16
        if self.sliding_window:
            scale["sliding_window"] = 32
        return self.replace(name=self.name + "-smoke", **scale)


# Shape cells assigned to every LM arch (system prompt):
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (spec)."""
    if cell.name == "long_500k" and not cfg.is_subquadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
