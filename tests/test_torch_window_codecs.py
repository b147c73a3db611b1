"""Port parity, Mistral's sliding window through the compressed cache: the
``Generator`` at the bitmap codecs and q8 (here) and at q8q4, q4q4 and the
Opa method KT_MAG_VT_OPA (``test_torch_window_q8q4.py``), against the JAX
package's (its kernels in Pallas interpret mode), on the windowed model of
``test_torch_window_generate.py``: banded prefill of a 600-token prompt,
decode steps whose window leaves chunk 0 wholly and chunk 1 partly below
it (kernels 1 and 6 with ``window``), and one compaction.

Greedy picks are held as ``test_torch_generate.py`` holds the compressed
cache's: the kernels round q, the window and p to bf16, so last-bit
differences of the f32 activations can move a logit by a few 1e-4.  At
every step, fed the JAX stream, the port's pick is JAX's token or ties with
it within ``TIE_TOL``; the free-running streams agree up to the first such
near-tie (on these seeds q8q4 has one, at its last step: a margin of 3.3e-4
between the two best logits; every other stream agrees in full).
"""

import numpy as np
import pytest

from tests.test_torch_generate import TIE_TOL, _teacher_forced_logits
from tests.test_torch_window_generate import _prompt, run_generators


@pytest.mark.parametrize("codec", ["bitmap", "bitmap-q8", "q8"])
def test_generator_compressed_matches_jax(codec):
    check_compressed(codec, "KT_MAG_VT_MAG")


def check_compressed(codec, method):
    """The Generator's tokens at ``codec`` under ``method``, port against
    JAX (module note), and the cache's chunk counts after the compaction."""
    want, got, tgen = run_generators("COMPRESSED", codec, method)
    cache = tgen.last_cache
    # 2 prompt chunks, then the compaction after decode step 200
    assert cache["nc_host"] == 3 and (cache["n_chunks"] == 3).all()
    if method == "KT_MAG_VT_OPA":
        assert (cache["v_score"][..., :10, :] > 0).all()
    logits, compacted_after, _ = _teacher_forced_logits(tgen, _prompt(), want)
    assert compacted_after == [200]
    at_jax = np.take_along_axis(logits, want[..., None], -1)[..., 0]
    gap = logits.max(-1) - at_jax                    # 0 where the picks agree
    tol = TIE_TOL["COMPRESSED"]
    assert (gap <= tol).all(), (
        f"port and JAX disagree beyond the tie tolerance at steps "
        f"{np.argwhere(gap > tol).tolist()}")
    picked = logits.argmax(-1)
    for row in range(2):
        ties = np.flatnonzero(picked[row] != want[row])
        parted = np.flatnonzero(got[row] != want[row])
        first_tie = ties[0] if len(ties) else want.shape[1]
        first_part = parted[0] if len(parted) else want.shape[1]
        assert first_part >= first_tie, (
            f"row {row}: streams part at step {first_part} with no near-tie "
            f"before step {first_tie}")
