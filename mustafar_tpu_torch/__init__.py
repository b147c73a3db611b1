"""mustafar_tpu_torch: the PyTorch / CUDA port of ``mustafar_tpu``.

It serves the JAX package's main path on an NVIDIA H100: a Llama model with
weight-only int8 weights, monolithic prefill, the compressed KV cache with
the q8q4 codec (or the dense baseline cache) and the greedy generator.  The
one hand-written kernel on that path is the q8q4 flash-decode kernel in
``csrc/q_decode.cu``.

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
