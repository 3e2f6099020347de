"""The 10 assigned architectures, exact configs from the public sources
cited in the assignment. One ``ModelConfig`` each; see registry.py for
lookup, shape applicability, and input specs.

A copy of ``repro/configs/archs.py``: same names, same published widths.

Sharding notes (DESIGN.md Section 3): archs whose q-head count does not
divide the 16-way `model` axis use attn_sharding='sequence' (context
parallelism -- the mesh-level form of the paper's sequence-dimension
parallelism); the rest shard heads.
"""

from __future__ import annotations

from repro_torch.configs.base import EncoderConfig, ModelConfig, MoEConfig, SSMConfig

WHISPER_BASE = ModelConfig(
    # [arXiv:2212.04356] enc-dec; conv/mel frontend stubbed to frame embeddings.
    name="whisper-base",
    family="encdec",
    num_layers=6,  # decoder layers; encoder below
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    mlp="gelu",
    norm="layernorm",
    attn_bias=True,
    tie_embeddings=True,  # whisper ties the decoder unembedding
    learned_pos_embed=32_768 + 8,  # stress-sized for decode_32k (real model: 448)
    encoder=EncoderConfig(num_layers=6, max_frames=32_768),
    frontend="audio",
    rope_theta=10_000.0,  # unused (learned positions); kept for uniformity
    attn_sharding="sequence",  # 8 heads < 16-way model axis
    max_seq_len=32_768,
)

GRANITE_MOE_1B = ModelConfig(
    # [hf:ibm-granite/granite-3.0-1b-a400m-base] 32 experts, top-8.
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,  # per-expert FFN width
    vocab_size=49_155,
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512),
    tie_embeddings=True,
    rope_theta=10_000.0,
    attn_sharding="heads",
    max_seq_len=32_768,
)

MIXTRAL_8X22B = ModelConfig(
    # [arXiv:2401.04088 / hf:mistralai] 8 experts top-2, sliding-window attn.
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=32_768,
    layer_pattern=("attn_local",),
    window=4_096,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=16_384),
    rope_theta=1_000_000.0,
    attn_sharding="heads",
    max_seq_len=524_288,
)

GEMMA3_1B = ModelConfig(
    # [hf:google/gemma-3-1b-pt] 5:1 local:global, 512-token window, 1kv head.
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    layer_pattern=("attn_local",) * 5 + ("attn",),
    window=512,
    qk_norm=True,
    tie_embeddings=True,
    embed_scale_by_dim=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    attn_sharding="sequence",  # 4 heads < 16
    max_seq_len=524_288,
)

QWEN3_8B = ModelConfig(
    # [hf:Qwen/Qwen3-8B] qk-norm GQA.
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12_288,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    attn_sharding="heads",
    max_seq_len=32_768,
)

DEEPSEEK_CODER_33B = ModelConfig(
    # [arXiv:2401.14196] llama-arch dense.
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19_200,
    vocab_size=32_256,
    rope_theta=100_000.0,
    attn_sharding="sequence",  # 56 heads % 16 != 0
    max_seq_len=32_768,
)

STABLELM_12B = ModelConfig(
    # [hf:stabilityai/stablelm-2-12b] per-head qk-layernorm, GQA.
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13_824,
    vocab_size=100_352,
    qk_norm=True,
    rope_theta=10_000.0,
    attn_sharding="heads",
    max_seq_len=32_768,
)

FALCON_MAMBA_7B = ModelConfig(
    # [arXiv:2410.05355] attention-free Mamba-1; B/C/dt RMS norms.
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,
    num_kv_heads=1,
    head_dim=1,
    d_ff=0,
    vocab_size=65_024,
    layer_pattern=("mamba",),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256, bcdt_norm=True),
    attn_sharding="heads",  # no attention anywhere; `model` shards d_inner
    max_seq_len=524_288,
)

INTERNVL2_76B = ModelConfig(
    # [arXiv:2404.16821] InternViT (stubbed to patch embeddings) + llama3-70B-class LM.
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    frontend="vision",
    num_patches=256,  # 448px / 14 patch, 1/4 pixel-shuffle
    rope_theta=500_000.0,
    attn_sharding="heads",
    max_seq_len=32_768,
)

# Hymba: 3 full-attention layers at {first, middle, last}; the rest SWA.
# The pattern spans all 32 layers, so the stack is unrolled (num_groups=1).
_HYMBA_PATTERN = tuple(
    "hybrid_global" if i in (0, 15, 31) else "hybrid" for i in range(32)
)

HYMBA_1_5B = ModelConfig(
    # [arXiv:2411.13676] parallel attn+SSM heads, 128 meta tokens, SWA 1024.
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    layer_pattern=_HYMBA_PATTERN,
    window=1024,
    meta_tokens=128,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=100),
    rope_theta=10_000.0,
    attn_sharding="sequence",  # 25 heads % 16 != 0
    max_seq_len=524_288,
)

ALL = [
    WHISPER_BASE,
    GRANITE_MOE_1B,
    MIXTRAL_8X22B,
    GEMMA3_1B,
    QWEN3_8B,
    DEEPSEEK_CODER_33B,
    STABLELM_12B,
    FALCON_MAMBA_7B,
    INTERNVL2_76B,
    HYMBA_1_5B,
]
