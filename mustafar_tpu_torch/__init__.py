"""mustafar_tpu_torch: the PyTorch / CUDA port of ``mustafar_tpu``.

It serves the JAX package's main paths on an NVIDIA H100: a Llama model
with weight-only int8 weights, the compressed KV cache with the q8q4 codec
(or the dense baseline cache), the greedy generator with monolithic or
chunked prefill, and the continuous-batching engine
(``runtime/scheduler.py``).  The hand-written kernels on those paths are
the q8q4 flash-decode kernels (``csrc/q_decode.cu``, uniform batch;
``csrc/q_decode_ps.cu``, per-slot counts) and the chunked-prefill segment
kernel (``csrc/q_segment.cu``).

The port imports ``torch``, never ``jax``, and nothing of ``mustafar_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card they raise.  Importing the package builds nothing.
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
