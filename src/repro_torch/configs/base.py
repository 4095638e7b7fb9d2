"""Architecture + shape configuration system.

Every assigned architecture is a frozen `ArchConfig`; every workload shape a
`ShapeConfig`. `REGISTRY` maps --arch ids to config constructors, and
`reduced(cfg)` derives the CPU-smoke-test variant (same family, tiny dims).

A copy of `repro/configs/base.py`: the PyTorch port keeps its own so that
`import repro_torch` never loads the JAX package. Keep the two in step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # first N layers use a dense FFN instead of MoE (DeepSeek-V2 uses 1)
    first_dense_layers: int = 0
    # tokens per routing group (GShard-style grouped dispatch: keeps the
    # one-hot dispatch tensor at O(N * E * cap_per_group) instead of
    # O(N * E * cap_global) — mandatory at 1M-token batches)
    group_size: int = 128
    # "onehot": GShard einsum dispatch (reference); "sort": argsort +
    # scatter/gather dispatch — same math, O(N·K·D) traffic instead of
    # O(N·E·cap·D) (the §Perf optimization for many-expert models)
    dispatch: str = "onehot"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block parameters."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    activation: str = "silu"         # silu(glu) | gelu | relu2
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (hymba): parallel attn + ssm heads per layer
    hybrid_parallel_heads: bool = False
    sliding_window: Optional[int] = None
    global_attn_layers: tuple[int, ...] = ()
    # encoder-decoder (whisper): encoder frontend is a stub (frame embeddings)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # vlm (llama-3.2-vision): cross-attention to image tokens every Nth layer
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    # full attention (no sub-quadratic path) — long_500k is skipped if True
    # (SSM / hybrid / sliding-window archs override)
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic token mixing available (SSM / hybrid / SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def n_params_dense_estimate(self) -> float:
        """Rough parameter count (for 6ND MODEL_FLOPS bookkeeping)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.mla:
            m = self.mla
            attn = (d * m.q_lora_rank + m.q_lora_rank * self.n_heads *
                    (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        if self.moe:
            ffn = (self.moe.num_experts + self.moe.num_shared_experts) * \
                  3 * d * self.moe.d_ff_expert
        else:
            mult = 3 if self.activation in ("silu", "geglu") else 2
            ffn = mult * d * self.d_ff
        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            ffn = 0
            attn = d * (2 * di + 2 * s.n_groups * s.d_state +
                        s.n_heads(d)) + di * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = L * (attn + ffn) + emb
        if self.encoder_decoder:
            total += self.n_encoder_layers * (attn + ffn)
        return float(total)

    def active_params_estimate(self) -> float:
        """Active (per-token) params — differs from total only for MoE."""
        if not self.moe:
            return self.n_params_dense_estimate
        d, L = self.d_model, self.n_layers
        dense = self.n_params_dense_estimate
        all_experts = (self.moe.num_experts + self.moe.num_shared_experts) * \
                      3 * d * self.moe.d_ff_expert
        active = (self.moe.top_k + self.moe.num_shared_experts) * \
                 3 * d * self.moe.d_ff_expert
        return dense - L * all_experts + L * active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "long_decode")
SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}

REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        REGISTRY[name] = fn
        return fn
    return deco


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        # import config modules lazily so `register` decorators run
        from . import all_archs  # noqa: F401
        if name not in REGISTRY:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]()


def list_archs() -> list[str]:
    from . import all_archs  # noqa: F401
    return sorted(REGISTRY)


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """Shape cells for an arch, honoring the assignment's skip rules:
    long_500k only for sub-quadratic archs (SSM / hybrid / SWA)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        shapes.append("long_500k")
    return shapes


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        activation=cfg.activation,
        norm=cfg.norm,
        use_rope=cfg.use_rope,
        tie_embeddings=cfg.tie_embeddings,
    )
    if cfg.moe:
        kw["moe"] = MoEConfig(
            num_experts=4, top_k=2, d_ff_expert=32,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
        )
    if cfg.mla:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.ssm:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2,
                              conv_kernel=4, chunk_size=32)
    kw["hybrid_parallel_heads"] = cfg.hybrid_parallel_heads
    if cfg.sliding_window:
        kw["sliding_window"] = 32
    kw["global_attn_layers"] = tuple(i for i in cfg.global_attn_layers if i < 2)
    if cfg.encoder_decoder:
        kw["encoder_decoder"] = True
        kw["n_encoder_layers"] = 2
    if cfg.cross_attn_every:
        kw["cross_attn_every"] = 2
        kw["n_image_tokens"] = 16
    return ArchConfig(**kw)
