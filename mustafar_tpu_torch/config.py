"""Configuration for models, pruning policies and the inference engine.

The port keeps its own copy of the JAX package's config (``mustafar_tpu/
config.py``): it imports nothing of that package.  Only what the served path
reads is carried over: the Llama geometry, the pruning policies, the cache
modes and the engine settings of the compressed cache.  Fields of the JAX
config that select paths the port does not have yet (MoE, chunked prefill,
sharding axes) are left out until those paths land.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class PruneMethod(enum.Enum):
    """Pruning strategy (K/V cache, token-wise or channel-wise, magnitude or
    output-aware).  The port serves ``KT_MAG_VT_MAG`` and ``DENSE``; the
    other members exist so configs read the same as the JAX package's."""

    DENSE = "dense"
    KT_MAG_VT_MAG = "kt_mag_vt_mag"
    KT_MAG_VC_MAG = "kt_mag_vc_mag"
    KT_MAG_VT_OPA = "kt_mag_vt_opa"
    KT_OPA_VT_MAG = "kt_opa_vt_mag"
    KT_MAG_VC_OPA = "kt_mag_vc_opa"
    THINK = "think"
    THINV = "thinv"

    @property
    def k_policy(self) -> str:
        return {
            PruneMethod.DENSE: "none",
            PruneMethod.KT_MAG_VT_MAG: "token_mag",
            PruneMethod.KT_MAG_VC_MAG: "token_mag",
            PruneMethod.KT_MAG_VT_OPA: "token_mag",
            PruneMethod.KT_OPA_VT_MAG: "token_opa",
            PruneMethod.KT_MAG_VC_OPA: "token_mag",
            PruneMethod.THINK: "think",
            PruneMethod.THINV: "think",
        }[self]

    @property
    def v_policy(self) -> str:
        return {
            PruneMethod.DENSE: "none",
            PruneMethod.KT_MAG_VT_MAG: "token_mag",
            PruneMethod.KT_MAG_VC_MAG: "channel_mag",
            PruneMethod.KT_MAG_VT_OPA: "token_opa",
            PruneMethod.KT_OPA_VT_MAG: "token_mag",
            PruneMethod.KT_MAG_VC_OPA: "channel_opa",
            PruneMethod.THINK: "none",
            PruneMethod.THINV: "thinv",
        }[self]


class CacheMode(enum.Enum):
    """How the KV cache is stored: DENSE (no pruning), MASKED (dense with
    pruned entries zeroed) or COMPRESSED (packed pool + dense window)."""

    DENSE = "dense"
    MASKED = "masked"
    COMPRESSED = "compressed"


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    method: PruneMethod = PruneMethod.KT_MAG_VT_MAG
    k_sparsity: float = 0.5
    v_sparsity: float = 0.5
    residual_length: int = 32      # most recent tokens kept dense
    exact_keep: Optional[int] = None

    def kept_per_row(self, dim: int, sparsity: float) -> int:
        """Survivors per pruned row: the threshold is the
        ``int(sparsity*dim)``-th smallest |x| and elements at or above it are
        kept, so ``dim - int(sparsity*dim) + 1`` survive (exact top-k with
        that count).  ``exact_keep`` overrides the rule."""
        if self.exact_keep is not None:
            return self.exact_keep
        k = max(1, int(sparsity * dim))
        return dim - k + 1 if sparsity > 0 else dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Llama architecture hyperparameters."""

    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    max_position_embeddings: int = 4096
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


LLAMA3_8B = ModelConfig(
    name="llama-3-8b", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=8192,
)

TINY_LLAMA = ModelConfig(
    name="tiny-llama", vocab_size=512, hidden_size=128, intermediate_size=256,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
    rope_theta=10000.0, max_position_embeddings=1024,
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine settings: cache mode, cache sizing and codec."""

    model: ModelConfig = TINY_LLAMA
    prune: PruneConfig = PruneConfig()
    cache_mode: CacheMode = CacheMode.MASKED
    max_seq_len: int = 1024
    chunk_size: int = 256
    prefill_bucket: int = 256
    codec: str = "bitmap"

    def __post_init__(self):
        assert self.codec in ("bitmap", "bitmap-q8", "q8", "q8q4", "q4q4"), self.codec
        if self.cache_mode == CacheMode.COMPRESSED:
            if self.codec != "bitmap":
                assert self.chunk_size % 4 == 0, self.chunk_size
            assert self.chunk_size % 32 == 0, (
                f"chunk_size must be a multiple of 32 (got {self.chunk_size})")
            assert self.max_seq_len >= self.chunk_size + self.prune.residual_length, (
                f"max_seq_len {self.max_seq_len} leaves no room for one "
                f"compressed chunk ({self.chunk_size}) plus the residual "
                f"window ({self.prune.residual_length})")
        assert self.max_seq_len > 0 and self.prefill_bucket > 0
