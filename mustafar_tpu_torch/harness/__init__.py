"""The LongBench / accuracy harness of the port (``mustafar_tpu/harness/``'s counterpart)."""
