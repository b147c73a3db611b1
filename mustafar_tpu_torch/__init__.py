"""mustafar_tpu_torch: the PyTorch / CUDA port of ``mustafar_tpu``.

It serves the JAX package's main paths on an NVIDIA H100: a Llama model
with weight-only int8 (W8) or int4 (W4) weights, the compressed KV cache
with the bitmap codec (the default: a bitmap plus the packed bf16
non-zeros, ``ops/sparse_format.py``) or the quant codecs q8, q8q4 and q4q4
(``ops/quant_format.py``), or the dense baseline cache; the greedy
generator with monolithic or chunked prefill, and the continuous-batching
engine (``runtime/scheduler.py``).  The hand-written kernels on those
paths are, per codec family, the flash-decode kernels for a uniform batch
(``csrc/q_decode.cu``, ``csrc/sp_decode.cu``) and for per-slot counts
(``csrc/q_decode_ps.cu``, the second entry of ``csrc/sp_decode.cu``) and
the chunked-prefill segment kernels (``csrc/q_segment.cu``,
``csrc/sp_segment.cu``); the quant codecs' prune + quantize + pack
(``csrc/prune_quant_pack.cu``, ``prune_quant_pack`` and, K and V in one
launch, ``prune_quant_pack_kv``); the W4 decode matmul
(``csrc/w4_matmul.cu``) and the dense cache's flash-decode
(``csrc/dense_decode.cu``, with the cache's ``use_pallas``).

The engine's slot bookkeeping runs in a native C++ core
(``native/scheduler.cpp``, built with g++ at first use).  The LongBench and
accuracy harness (``harness/``) and the command line (``python -m
mustafar_tpu_torch predict|eval|synth-ckpt|accuracy``, ``cli.py``) run the
port's engine on trained or synthetic checkpoints.

The port imports ``torch``, never ``jax``, and nothing of ``mustafar_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"`` (the
command line: ``MUSTAFAR_CPU=1``); with no card they raise.  Importing the
package builds nothing.
"""

__version__ = "0.1.0"

from mustafar_tpu_torch.config import (  # noqa: F401
    CacheMode,
    EngineConfig,
    ModelConfig,
    PruneConfig,
    PruneMethod,
)
from mustafar_tpu_torch.device import resolve_device  # noqa: F401
from mustafar_tpu_torch.ops.kernels.pack_kernel import (  # noqa: F401
    prune_quant_pack,
    prune_quant_pack_kv,
)
