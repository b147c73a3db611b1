"""Configuration for models, pruning policies and the inference engine.

The port keeps its own copy of the JAX package's config (``mustafar_tpu/
config.py``): it imports nothing of that package.  Only what the served path
reads is carried over: the Llama geometry, the pruning policies, the cache
modes, and the engine settings of the compressed cache, continuous batching
and chunked prefill, and the named architectures (``MODEL_REGISTRY``).
Fields of the JAX config that select paths the port does not have yet (MoE,
sharding axes) are left out until those paths land.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class PruneMethod(enum.Enum):
    """Pruning strategy (K/V cache, token-wise or channel-wise, magnitude or
    output-aware).  The masked cache serves all eight; the compressed cache
    the per-token ones (``KT_MAG_VT_MAG``, ``KT_OPA_VT_MAG``,
    ``KT_MAG_VT_OPA``), as in the JAX package."""

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
    group_size: int = 32           # channel-prune / Opa accumulation group
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
    """Llama / Mistral architecture hyperparameters.  ``sliding_window``
    (Mistral): a query at position p attends keys k with p - window < k <=
    p.  ``dtype`` names the checkpoint's parameter type, as the JAX
    package's config records it; the caller picks the type it runs in."""

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
    dtype: str = "bfloat16"

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


LLAMA2_7B = ModelConfig(
    name="llama-2-7b", vocab_size=32000, hidden_size=4096, intermediate_size=11008,
    num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
    rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=4096,
)

LLAMA3_8B = ModelConfig(
    name="llama-3-8b", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=8192,
)

MISTRAL_7B = ModelConfig(
    name="mistral-7b", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    rms_norm_eps=1e-5, rope_theta=1000000.0, max_position_embeddings=32768,
    sliding_window=None,  # v0.2 removed the sliding window; v0.1 used 4096
)

MISTRAL_7B_SWA = dataclasses.replace(MISTRAL_7B, name="mistral-7b-swa", sliding_window=4096)

TINY_LLAMA = ModelConfig(
    name="tiny-llama", vocab_size=512, hidden_size=128, intermediate_size=256,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
    rope_theta=10000.0, max_position_embeddings=1024,
)

MODEL_REGISTRY = {
    m.name: m for m in [LLAMA2_7B, LLAMA3_8B, MISTRAL_7B, MISTRAL_7B_SWA, TINY_LLAMA]
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine settings: cache mode, cache sizing, batching and codec.

    ``batch_size`` is the number of slots of the continuous-batching engine.
    ``chunked_prefill`` (compressed cache only) streams a prompt through the
    stack one chunk-sized segment at a time, attending to the packed past:
    activation memory O(chunk) instead of O(prompt), and prefill attention
    then sees the pruned past.  ``codec`` is the compressed cache's chunk
    storage: "bitmap" (a bitmap plus the packed bf16 non-zeros), "bitmap-q8"
    (the same bitmap, the non-zeros as int8 codes with per-channel scales:
    the capacity codec, 112 int16 rows a chunk and kv head at sparsity 0.7
    against bitmap's 192) or a quant codec, pruned chunks quantized dense:
    "q8" (int8 K and V), "q8q4" (int8 K, int4 V) or "q4q4" (int4 K and
    V)."""

    model: ModelConfig = TINY_LLAMA
    prune: PruneConfig = PruneConfig()
    cache_mode: CacheMode = CacheMode.MASKED
    max_seq_len: int = 1024
    chunk_size: int = 256
    prefill_bucket: int = 256
    batch_size: int = 1
    chunked_prefill: bool = False
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
        if self.chunked_prefill:
            assert self.cache_mode == CacheMode.COMPRESSED, (
                "chunked_prefill requires the compressed cache")
            assert self.prefill_bucket % self.chunk_size == 0, (
                f"chunked prefill segments are chunk-sized: prefill_bucket "
                f"{self.prefill_bucket} must be a multiple of chunk_size "
                f"{self.chunk_size}")
