"""The 10 assigned architectures (+ the paper's own workloads live in
core/workloads.py). Exact dims from the assignment table; sources noted.
A copy of `repro/configs/all_archs.py` (see base.py)."""

from .base import (ArchConfig, MLAConfig, MoEConfig, SSMConfig, register)


@register("deepseek-v2-236b")
def deepseek_v2_236b() -> ArchConfig:
    # [arXiv:2405.04434; hf] 60L d_model=5120 128H MLA(kv_lora=512)
    # MoE: 2 shared + 160 routed top-6, expert d_ff=1536; first layer dense.
    return ArchConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=12288,  # dense-layer FFN (DeepSeek-V2 first layer)
        vocab=102400, head_dim=192,  # qk_nope 128 + rope 64
        activation="silu",
        moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                      num_shared_experts=2, first_dense_layers=1),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
    )


@register("dbrx-132b")
def dbrx_132b() -> ArchConfig:
    # [hf:databricks/dbrx-base; unverified] 40L d=6144 48H GQA kv=8
    # MoE 16 experts top-4, fine-grained, d_ff=10752.
    return ArchConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab=100352, activation="silu", norm="layernorm",
        rope_theta=500000.0,
        moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
    )


@register("whisper-small")
def whisper_small() -> ArchConfig:
    # [arXiv:2212.04356; unverified] enc-dec, 12L each, d=768, 12H,
    # d_ff=3072, vocab 51865. Conv frontend is a STUB: input_specs()
    # provides precomputed frame embeddings (batch, seq, d_model).
    return ArchConfig(
        name="whisper-small", family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=51865, activation="gelu", norm="layernorm",
        use_rope=False,  # whisper uses learned/sinusoidal positions
        encoder_decoder=True, n_encoder_layers=12,
    )


@register("yi-6b")
def yi_6b() -> ArchConfig:
    # [arXiv:2403.04652; hf] llama-arch GQA: 32L d=4096 32H kv=4 d_ff=11008
    return ArchConfig(
        name="yi-6b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab=64000, activation="silu", rope_theta=5000000.0,
    )


@register("minitron-8b")
def minitron_8b() -> ArchConfig:
    # [arXiv:2407.14679; hf] pruned nemotron: 32L d=4096 32H kv=8
    # d_ff=16384 vocab=256000, squared-ReLU like its parent.
    return ArchConfig(
        name="minitron-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=16384, vocab=256000, activation="relu2", head_dim=128,
    )


@register("granite-8b")
def granite_8b() -> ArchConfig:
    # [arXiv:2405.04324; hf] llama-arch code model: 36L d=4096 32H kv=8
    return ArchConfig(
        name="granite-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=49152, activation="silu",
    )


@register("nemotron-4-340b")
def nemotron_4_340b() -> ArchConfig:
    # [arXiv:2402.16819; unverified] 96L d=18432 96H kv=8 d_ff=73728
    # vocab=256000, squared-ReLU, no gating. Pure full attention ->
    # long_500k cell is skipped (DESIGN.md §4).
    return ArchConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
        d_ff=73728, vocab=256000, activation="relu2", head_dim=192,
    )


@register("llama-3.2-vision-90b")
def llama_32_vision_90b() -> ArchConfig:
    # [hf:meta-llama/Llama-3.2-11B-Vision; unverified] 100L d=8192 64H kv=8
    # d_ff=28672 vocab=128256; cross-attn image layers every 5th layer.
    # Vision frontend is a STUB: input_specs() provides patch embeddings.
    return ArchConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28672, vocab=128256, activation="silu", rope_theta=500000.0,
        cross_attn_every=5, n_image_tokens=1601,
    )


@register("mamba2-370m")
def mamba2_370m() -> ArchConfig:
    # [arXiv:2405.21060; unverified] SSD: 48L d=1024 attn-free,
    # ssm_state=128, vocab=50280.
    return ArchConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280, activation="silu", use_rope=False,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2,
                      conv_kernel=4, chunk_size=256),
    )


@register("hymba-1.5b")
def hymba_1_5b() -> ArchConfig:
    # [arXiv:2411.13676; hf] 32L d=1600 25H kv=5, d_ff=5504, vocab=32001,
    # ssm_state=16; parallel attn+mamba heads; SWA everywhere except
    # 3 global-attention layers (first/middle/last).
    return ArchConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab=32001, activation="silu", head_dim=64,
        hybrid_parallel_heads=True,
        sliding_window=1024, global_attn_layers=(0, 15, 31),
        ssm=SSMConfig(d_state=16, head_dim=64, expand=2,
                      conv_kernel=4, chunk_size=256),
    )


ALL_ARCHS = [
    "deepseek-v2-236b", "dbrx-132b", "whisper-small", "yi-6b",
    "minitron-8b", "granite-8b", "nemotron-4-340b",
    "llama-3.2-vision-90b", "mamba2-370m", "hymba-1.5b",
]
