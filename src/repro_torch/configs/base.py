"""Config system: one frozen dataclass tree describes a model + its sharding.

A copy of ``repro/configs/base.py`` (pure Python): the port keeps its own
so that it never imports the JAX package. Keep the two in step.

Design notes:
  * Everything needed to build params, lower train/serve steps, and shard
    them lives here -- configs are hashable and printable, and the
    checkpoint manifest stores a fingerprint of them.
  * ``layer_pattern`` is the repeating unit of layer kinds; models scan over
    groups of the unit (HLO size independent of depth). If the pattern
    length equals ``num_layers`` the stack is unrolled (used by hymba whose
    3 global layers are at {first, middle, last}).
  * vocab is padded up to a multiple of ``vocab_pad_to`` so the `model` mesh
    axis always divides the embedding table; the loss masks padded ids.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Layer kinds usable in layer_pattern:
#   'attn'         full (global) attention
#   'attn_local'   sliding-window attention (window = cfg.window)
#   'mamba'        Mamba1 SSM block (attention-free)
#   'hybrid'       Hymba-style parallel attention + SSM heads (SWA)
#   'hybrid_global'same, with global attention
LAYER_KINDS = ("attn", "attn_local", "mamba", "hybrid", "hybrid_global")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model / 16)
    bcdt_norm: bool = False  # falcon-mamba's RMSNorm on B/C/dt


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder half of an encoder-decoder stack (whisper)."""

    num_layers: int
    max_frames: int  # positional table size for the (stubbed) frontend


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm'
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- optional architecture features -------------------------------
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: Optional[int] = None
    qk_norm: bool = False
    attn_bias: bool = False
    mlp: str = "swiglu"  # 'swiglu' | 'gelu'
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None  # gemma3: different base for SWA layers
    learned_pos_embed: Optional[int] = None  # whisper decoder: table size
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-5
    embed_scale_by_dim: bool = False  # gemma: embeddings *= sqrt(d_model)
    meta_tokens: int = 0  # hymba: learnable always-visible prefix (sinks)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    max_seq_len: int = 524_288
    # --- modality frontend stubs --------------------------------------
    frontend: Optional[str] = None  # 'audio' | 'vision' (input_specs provides embeddings)
    num_patches: int = 0  # vision: patch embeddings prepended to the text sequence
    # --- numerics / sharding ------------------------------------------
    dtype: str = "bfloat16"  # activation/param compute dtype
    vocab_pad_to: int = 256
    # 'heads' | 'sequence' (context parallel, KV all-gathered) | 'ring'
    # (context parallel, KV sharded + rotated -- distributed/ring_attention)
    attn_sharding: str = "heads"
    scan_layers: bool = True
    remat: bool = True

    # -------------------------------------------------------------- utils
    @property
    def padded_vocab(self) -> int:
        v, m = self.vocab_size, self.vocab_pad_to
        return (v + m - 1) // m * m

    @property
    def group_size(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_groups(self) -> int:
        return self.num_layers // self.group_size

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        rem = self.num_layers % self.group_size
        return self.layer_pattern[:rem]

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Kind of every layer, in order."""
        kinds = self.layer_pattern * self.num_groups + self.tail_pattern
        assert len(kinds) == self.num_layers
        return kinds

    def kind_window(self, kind: str) -> Optional[int]:
        if kind in ("attn_local", "hybrid"):
            return self.window
        return None

    def validate(self) -> None:
        assert all(k in LAYER_KINDS for k in self.layer_pattern), self.layer_pattern
        if any(k.startswith("attn") or k.startswith("hybrid") for k in self.layer_pattern):
            assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if any(k in ("mamba", "hybrid", "hybrid_global") for k in self.layer_pattern):
            assert self.ssm is not None, f"{self.name}: ssm config required"
        if "attn_local" in self.layer_pattern or "hybrid" in self.layer_pattern:
            assert self.window is not None, f"{self.name}: window required"
        if self.family == "moe":
            assert self.moe is not None
        if self.family == "encdec":
            assert self.encoder is not None
        assert self.padded_vocab % self.vocab_pad_to == 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the assigned input-shape cells."""

    name: str  # 'train_4k' | 'prefill_32k' | 'decode_32k' | 'long_500k'
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
