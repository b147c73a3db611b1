"""Tensor, data and expert parallelism on ``torch.distributed`` (port of
``mustafar_tpu/parallel/sharding.py`` and ``distributed.py``)."""
