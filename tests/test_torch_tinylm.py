"""Port parity, the accuracy harness on the trained ``ckpt/tiny-acc`` (f32).

(a) ``score_nll`` on two rows of 320 held-out tokens, prefill 256: 64
    teacher-forced decode steps that cross one compaction (at step 33,
    where the window of 288 tokens is full), in the modes ``dense``,
    ``masked``, ``compressed`` (bitmap), ``compressed-q8q4`` and
    ``compressed-q8q4+chunked`` at sparsity 0.7, the JAX package's
    ``score_nll`` (its on-device loop, kernels through its plain path as its
    own tests run it) against the port's host loop: NLL within 1e-3
    absolute, the logits buffer within 1e-2 of its range (slot for slot,
    the JAX loop's zero first slot and clamped last one included), and
    ``kl_vs`` against dense within 1e-3.
(b) ``run_accuracy`` with 2 passkey rows of 400 bytes, ``nll_tokens=320``,
    mode ``compressed-q8q4`` at 0.7, both packages writing their grids:
    ``passkey_acc`` equal, ``nll`` and ``kl_vs_dense`` within 1e-3, each
    variant's ``passkey.jsonl`` equal, or its rows parted only after a
    near-tie (the port teacher-forced on JAX's tokens picks them within
    1e-2 of its best logit).
"""

import json
import os

import numpy as np
import pytest
import torch

from mustafar_tpu.harness import tinylm as jtiny
from mustafar_tpu_torch.harness import tinylm as ttiny
from mustafar_tpu_torch.models import llama as tl
from mustafar_tpu_torch.weights import load_ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "ckpt", "tiny-acc")
MODES = ["dense", "masked", "compressed", "compressed-q8q4", "compressed-q8q4+chunked"]
TIE_TOL = 1e-2

pytestmark = pytest.mark.skipif(not os.path.exists(os.path.join(CKPT, "params.npz")),
                                reason="ckpt/tiny-acc is not in this checkout")


@pytest.fixture(scope="module")
def ckpt():
    jcfg, jp = jtiny.load_ckpt(CKPT)
    tcfg, tp = load_ckpt(CKPT, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def tokens():
    corpus = "".join(open(os.path.join(os.path.dirname(np.__file__), name),
                          encoding="utf-8").read()
                     for name in ("__init__.py", "_globals.py", "version.py"))
    rng = np.random.RandomState(0)
    return np.stack([np.asarray([jtiny.BOS_ID] + list(jtiny._filler(corpus, rng, 400)
                                                      .encode("utf-8"))[:319], np.int32)
                     for _ in range(2)])


@pytest.fixture(scope="module")
def scores(ckpt, tokens):
    """Each mode's (NLL, logits) from both packages, and the port's
    compactions (the pool count at each)."""
    from mustafar_tpu_torch.cache.compressed import CompressedKVCache
    jcfg, jp, tcfg, tp = ckpt
    compact, seen = CompressedKVCache.compact, []

    def counted(self, state):
        seen.append(state["nc_host"])
        return compact(self, state)

    out = {}
    CompressedKVCache.compact = counted
    try:
        for mode in MODES:
            seen.clear()
            port = ttiny.score_nll(ttiny._engine(tcfg, mode, 0.7, 1024), tp, tokens,
                                   device="cpu")
            out[mode] = (jtiny.score_nll(jtiny._engine(jcfg, mode, 0.7, 1024), jp, tokens),
                         port, list(seen))
    finally:
        CompressedKVCache.compact = compact
    return out


@pytest.mark.parametrize("mode", MODES)
def test_score_nll_matches_jax(scores, mode):
    (jnll, jlogits), (nll, logits), compactions = scores[mode]
    jlogits = np.asarray(jlogits)
    assert logits.shape == jlogits.shape == (2, 64, ttiny.VOCAB)
    assert abs(nll - jnll) <= 1e-3, (nll, jnll)
    err = np.abs(logits.numpy() - jlogits).max()
    assert err <= 1e-2 * (jlogits.max() - jlogits.min()), err
    assert not logits[:, 0].any()                 # the JAX loop's zero first slot
    # one compaction, before step 33, with the pool still empty
    assert compactions == ([0] if mode.startswith("compressed") else [])
    if mode != "dense":
        jkl = jtiny.kl_vs(scores["dense"][0][1], jlogits)
        kl = ttiny.kl_vs(scores["dense"][1][1], logits)
        assert abs(kl - jkl) <= 1e-3, (kl, jkl)


def _teacher_forced_gap(gen, prompt_ids, stream):
    """The port's largest logit minus its logit at each of ``stream``'s
    tokens, fed ``stream`` after the prompt (as ``Generator.generate``)."""
    impl, cfg = gen.cache_impl, gen.cfg
    T = prompt_ids.shape[1]
    toks = torch.zeros((1, gen._bucket(T)), dtype=torch.int64)
    toks[:, :T] = torch.from_numpy(prompt_ids)
    cache = impl.init(1, gen.dtype)
    gaps = []
    with torch.inference_mode():
        logits, cache = tl.prefill(cfg, gen.params, toks, cache, impl, T, last_only=True)
        for i, t in enumerate(stream):
            row = logits[0, 0]
            gaps.append(float(row.max() - row[t]))
            logits, cache = tl.decode_step(cfg, gen.params, torch.tensor([[t]]), cache, impl,
                                           T + i)
            if hasattr(impl, "compact") and impl.window_full(cache, T + i + 1):
                impl.compact(cache)
    return np.asarray(gaps)


def _check_parted(gen, prompt_ids, jax_pred, port_pred):
    """Two passkey predictions that differ part only after a near-tie: the
    port, fed JAX's bytes up to the first differing one (or JAX's EOS where
    its prediction ends first), picks each within TIE_TOL of its best."""
    js, ts = list(jax_pred.encode("utf-8")), list(port_pred.encode("utf-8"))
    k = next((i for i, (a, b) in enumerate(zip(js, ts)) if a != b), min(len(js), len(ts)))
    stream = js[:k + 1] if k < len(js) else js + [ttiny.EOS_ID]
    gaps = _teacher_forced_gap(gen, prompt_ids, stream)
    assert gaps.max() <= TIE_TOL, (jax_pred, port_pred, gaps)


def test_run_accuracy_matches_jax(tmp_path):
    from mustafar_tpu_torch.harness.configs import DATASET2PROMPT
    from mustafar_tpu_torch.harness.longbench import truncate_middle
    from mustafar_tpu_torch.runtime.generate import Generator

    kw = dict(n_rows=2, ctx_bytes=400, sparsities=(0.7,), modes=("compressed-q8q4",),
              nll_tokens=320, log=lambda *a: None)
    want = jtiny.run_accuracy(CKPT, str(tmp_path / "jax"), **kw)
    got = ttiny.run_accuracy(CKPT, str(tmp_path / "port"), device="cpu", **kw)
    assert sorted(got) == sorted(want) == ["compressed-q8q4@0.7", "dense"]
    for name in want:
        assert got[name]["passkey_acc"] == want[name]["passkey_acc"]
        assert abs(got[name]["nll"] - want[name]["nll"]) <= 1e-3
        if name != "dense":
            assert abs(got[name]["kl_vs_dense"] - want[name]["kl_vs_dense"]) <= 1e-3
    assert json.load(open(tmp_path / "port" / "result.json")) == got
    # the rows run_accuracy made (its corpus and generator seeds)
    corpus = ttiny.load_corpus(seed=1235)
    rng = np.random.RandomState(1234)
    rows = [ttiny.make_passkey_row(corpus, rng, 400) for _ in range(2)]
    max_seq = ((400 + len(ttiny.PASSKEY_QUESTION) + 256) // 256 + 1) * 256 + 256
    tok = ttiny.ByteTokenizer()
    _, tp = load_ckpt(CKPT, device="cpu")
    for name in want:
        preds = [[json.loads(line) for line in open(tmp_path / pkg / name / "passkey.jsonl")]
                 for pkg in ("jax", "port")]
        assert len(preds[0]) == len(preds[1]) == 2
        mode = "dense" if name == "dense" else name.split("@")[0]
        gen = Generator(ttiny._engine(ttiny.TINY_ACC, mode, 0.7, max_seq), tp,
                        dtype=torch.float32, device="cpu")
        for row, jrow, trow in zip(rows, *preds):
            assert jrow["answers"] == trow["answers"] == row["answers"]
            if jrow != trow:
                prompt = truncate_middle(tok, DATASET2PROMPT["passkey"].format(
                    context=row["context"], input=""), max_seq - 64)
                _check_parted(gen, tok(prompt, return_tensors="np").input_ids,
                              jrow["pred"], trow["pred"])
