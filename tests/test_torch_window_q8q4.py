"""Port parity, Mistral's sliding window through the compressed cache at
q8q4, q4q4 and the Opa method KT_MAG_VT_OPA (q8q4: kernel 1 with the window
and its window probabilities): the checks of ``test_torch_window_codecs.py``
(its module note), in a file of their own so that each file stays short on
one test worker.
"""

import pytest

from tests.test_torch_window_codecs import check_compressed


@pytest.mark.parametrize("codec,method", [
    ("q8q4", "KT_MAG_VT_MAG"), ("q4q4", "KT_MAG_VT_MAG"), ("q8q4", "KT_MAG_VT_OPA")])
def test_generator_compressed_matches_jax(codec, method):
    check_compressed(codec, method)
