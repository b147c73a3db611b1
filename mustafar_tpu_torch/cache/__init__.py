from mustafar_tpu_torch.cache.compressed import CompressedKVCache  # noqa: F401
from mustafar_tpu_torch.cache.dense import DenseKVCache  # noqa: F401
from mustafar_tpu_torch.config import CacheMode


def make_cache(engine_cfg, device=None):
    """Cache impl for ``engine_cfg.cache_mode`` on ``device`` (default cuda)."""
    if engine_cfg.cache_mode == CacheMode.DENSE:
        return DenseKVCache(engine_cfg, device=device)
    if engine_cfg.cache_mode == CacheMode.COMPRESSED:
        return CompressedKVCache(engine_cfg, device=device)
    raise NotImplementedError(
        f"cache mode {engine_cfg.cache_mode}: the masked cache is ROADMAP "
        "Queue A item 12")
