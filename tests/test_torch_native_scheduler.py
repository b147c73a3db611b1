"""Port parity, the native slot core of the continuous-batching engine.

(a) The port's ``NativeSlotScheduler`` (its own copy of ``scheduler.cpp``,
    built with g++ into ``mustafar_tpu_torch/_build/``) against the JAX
    package's on the same op sequences: the cases of
    ``tests/test_native_scheduler.py`` and seeded random sequences of
    submit (refused ones too), fill, commit (inactive and out-of-range
    slots too) and the queries; every return and ``stats()`` equal.
    The port's ``PySlotScheduler`` (the rule kept for a host without g++)
    against the JAX package's core on the same sequences.
(b) The submit fault: a request with no new tokens, an empty prompt or
    more than ``max_seq_len`` tokens raises ValueError in the JAX engine
    and in the port's (with the core and, the library's loader made to
    find none, with the Python rule), the uid stays spent in each, and the
    next request gets the same uid in all.
(c) The port's engine with the core and with the Python rule gives the
    same tokens, and the JAX engine's (its native core, kernels in Pallas
    interpret mode) up to a near-tie, on a tiny mixed stream that crosses a
    compaction, retires a request and reuses its slot.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu import native as jnative
from mustafar_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch import native as tnative
from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine as TEngine

from test_torch_scheduler import MIXES, _Forced, _check_streams, _engine, _params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def libs():
    if jnative.load_scheduler_lib() is None or tnative.load_scheduler_lib() is None:
        pytest.skip("no g++ toolchain")
    return jnative, tnative


def _apply(sched, op):
    kind, *args = op
    if kind == "submit":
        return sched.submit(*args)
    if kind == "fill":
        return sched.fill()
    if kind == "commit":
        return sched.commit(*args)
    return getattr(sched, kind) if kind.startswith("num_") else getattr(sched, kind)()


# tests/test_native_scheduler.py's cases as op sequences (slots, max_seq_len, ops)
CASES = {
    "admission_and_fill": (2, 128, [
        ("submit", 1, 10, 5), ("submit", 2, 20, 5), ("submit", 3, 30, 5), ("fill",),
        ("num_active",), ("num_queued",), ("positions",)]),
    "reject_oversized": (2, 128, [("submit", 9, 120, 20), ("stats",)]),
    "commit_retire_and_reuse": (2, 128, [
        ("submit", 1, 10, 2), ("submit", 2, 10, 5), ("submit", 3, 10, 5), ("fill",),
        ("commit", 0, False), ("commit", 0, False), ("num_active",), ("fill",),
        ("commit", 1, True), ("stats",)]),
    "commit_errors": (2, 128, [("commit", 0, False), ("commit", 7, False)]),
}


def _random_ops(seed, n=400):
    rs = np.random.RandomState(seed)
    slots, max_seq = int(rs.randint(1, 9)), int(rs.randint(16, 300))
    ops, uid = [], 0
    for _ in range(n):
        r = rs.rand()
        if r < 0.35:
            uid += 1
            ops.append(("submit", uid, int(rs.randint(-2, max_seq)),
                        int(rs.randint(-2, max_seq // 2))))
        elif r < 0.5:
            ops.append(("fill",))
        elif r < 0.9:
            ops.append(("commit", int(rs.randint(-1, slots + 2)), bool(rs.rand() < 0.1)))
        else:
            ops.append((["num_active", "num_queued", "positions", "active_mask",
                         "stats"][rs.randint(5)],))
    ops.append(("stats",))
    return slots, max_seq, ops


def _ops(case):
    return CASES[case] if case in CASES else _random_ops(int(case[6:]))


@pytest.mark.parametrize("case", list(CASES) + [f"random{s}" for s in range(6)])
def test_core_matches_jax(libs, case):
    jn, tn = libs
    slots, max_seq, ops = _ops(case)
    js, ts = jn.NativeSlotScheduler(slots, max_seq), tn.NativeSlotScheduler(slots, max_seq)
    for op in ops:
        assert _apply(ts, op) == _apply(js, op), op
    assert ts.stats() == js.stats()
    if case.startswith("random"):        # the sequences reach every branch
        s = ts.stats()
        assert s["admitted"] and s["finished"] and s["rejected"]


@pytest.mark.parametrize("case", list(CASES) + [f"random{s}" for s in range(6)])
def test_python_rule_matches_core(libs, case):
    jn, tn = libs
    slots, max_seq, ops = _ops(case)
    js, ps = jn.NativeSlotScheduler(slots, max_seq), tn.PySlotScheduler(slots, max_seq)
    for op in ops:
        assert _apply(ps, op) == _apply(js, op), op
    assert ps.stats() == js.stats()


def test_slot_scheduler_falls_back_without_the_library(libs, monkeypatch):
    assert isinstance(tnative.slot_scheduler(2, 128), tnative.NativeSlotScheduler)
    monkeypatch.setattr(tnative, "load_scheduler_lib", lambda: None)
    assert isinstance(tnative.slot_scheduler(2, 128), tnative.PySlotScheduler)
    with pytest.raises(ValueError):
        tnative.PySlotScheduler(0, 128)


def _engine_without_core(monkeypatch, *args, **kw):
    """The port's engine as on a host where the core cannot be built."""
    with monkeypatch.context() as m:
        m.setattr(tnative, "load_scheduler_lib", lambda: None)
        cb = TEngine(*args, **kw)
    assert isinstance(cb.core, tnative.PySlotScheduler)
    return cb


def test_core_builds_into_the_port(libs):
    path = tnative.library_path()
    assert path.parent.name == "_build" and path.parent.parent.name == "mustafar_tpu_torch"
    assert path.exists() and path.name.startswith("_scheduler_")
    with pytest.raises(ValueError):
        tnative.NativeSlotScheduler(0, 128)


REFUSED = {"zero_new": (50, 0), "empty_prompt": (0, 8), "oversized": (1000, 100)}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_request_spends_its_uid(libs, case, monkeypatch):
    jeng, teng = _engine(jc, "COMPRESSED", max_seq=1024), _engine(tc, "COMPRESSED", max_seq=1024)
    jp, tp = _params(jeng, 0)
    n, m = REFUSED[case]
    rs = np.random.RandomState(1)
    engines = [JEngine(jeng, jp, dtype=jnp.float32),
               TEngine(teng, tp, dtype=torch.float32, device="cpu"),
               _engine_without_core(monkeypatch, teng, tp, dtype=torch.float32, device="cpu")]
    assert engines[0].native is not None
    assert isinstance(engines[1].core, tnative.NativeSlotScheduler)
    uids = []
    for cb in engines:
        first = cb.submit(rs.randint(0, 512, size=100), 4)
        with pytest.raises(ValueError):
            cb.submit(np.zeros(n, np.int64), m)
        uids.append((first, cb.submit(rs.randint(0, 512, size=100), 4)))
    assert uids == [(1, 3)] * 3
    assert [cb.core.num_queued for cb in engines[1:]] == [2, 2]
    assert engines[1].core.stats() == engines[2].core.stats() == engines[0].native.stats() == {
        "admitted": 0, "finished": 0, "rejected": 1}


def test_engine_tokens_native_python_and_jax(libs, monkeypatch):
    """The compaction mix (280 + 30 crosses r + C = 288 while decoding; 530
    packs a chunk at prefill) with a third request that waits for a slot,
    chunked prefill with interleaved admission, q8q4 at 0.5."""
    jeng, teng = _engine(jc, "COMPRESSED"), _engine(tc, "COMPRESSED")
    jp, tp = _params(jeng, 3)
    rs = np.random.RandomState(3)
    reqs = [(rs.randint(0, 512, size=n), m) for n, m in MIXES["compaction"]]
    jcb = JEngine(jeng, jp, dtype=jnp.float32)
    assert jcb.native is not None
    jcb.impl.use_pallas = jcb.prefill_impl.use_pallas = True
    juids = [jcb.submit(p, m) for p, m in reqs]
    want = jcb.run()
    runs = {}
    for native in (True, False):
        cb = (TEngine(teng, tp, dtype=torch.float32, device="cpu") if native else
              _engine_without_core(monkeypatch, teng, tp, dtype=torch.float32, device="cpu"))
        assert isinstance(cb.core, tnative.NativeSlotScheduler) == native
        assert [cb.submit(p, m) for p, m in reqs] == juids
        runs[native] = (cb, cb.run())
    (ncb, native_out), (pcb, python_out) = runs[True], runs[False]
    assert sorted(native_out) == sorted(python_out) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(native_out[uid], python_out[uid])
    assert ncb.core.stats() == pcb.core.stats() == jcb.native.stats() == {
        "admitted": 3, "finished": 3, "rejected": 0}
    assert ncb.core.num_active == 0 and ncb.core.num_queued == 0
    forced = _Forced(teng, tp, dtype=torch.float32, device="cpu", streams=want)
    assert isinstance(forced.core, tnative.NativeSlotScheduler)
    for p, m in reqs:
        forced.submit(p, m)
    assert forced.run().keys() == want.keys()
    _check_streams(want, native_out, forced.logits, 1e-2)
