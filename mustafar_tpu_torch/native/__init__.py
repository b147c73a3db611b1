"""The native slot core of the continuous-batching engine (``scheduler.cpp``),
bound with ctypes: the port's copy of the JAX package's ``native`` module.

Nothing is built at import.  The first ``load_scheduler_lib`` compiles
``scheduler.cpp`` with ``g++`` into ``mustafar_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name that carries the hash of the source, so an
unchanged source loads at once and a changed one rebuilds.  Without a
toolchain it returns None, and ``slot_scheduler`` hands the engine
``PySlotScheduler``: the same rule in Python, with the same returns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from collections import deque
from pathlib import Path

SOURCE = Path(__file__).resolve().with_name("scheduler.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def library_path() -> Path:
    """The library's name: ``_scheduler_<hash of the source>.so``."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"_scheduler_{tag}.so"


def _build() -> Path | None:
    """Compile the source unless its hashed library exists; None if g++
    is missing or fails.  The library is written under a temporary name and
    renamed, so processes building at once never load a partial file."""
    out = library_path()
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def load_scheduler_lib():
    """Load (building if needed) the native core; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.msched_create.restype = ctypes.c_void_p
        lib.msched_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
        lib.msched_destroy.argtypes = [ctypes.c_void_p]
        lib.msched_submit.restype = ctypes.c_int32
        lib.msched_submit.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                      ctypes.c_int32, ctypes.c_int32]
        lib.msched_fill.restype = ctypes.c_int32
        lib.msched_fill.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_uint64),
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.c_int32]
        lib.msched_commit.restype = ctypes.c_int32
        lib.msched_commit.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
        lib.msched_num_active.restype = ctypes.c_int32
        lib.msched_num_active.argtypes = [ctypes.c_void_p]
        lib.msched_num_queued.restype = ctypes.c_int32
        lib.msched_num_queued.argtypes = [ctypes.c_void_p]
        for fn in ("msched_active_mask", "msched_positions"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.msched_uids.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.msched_stats.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_uint64)] * 3
        _LIB = lib
        return _LIB


class NativeSlotScheduler:
    """Thin OO wrapper over the C core (see scheduler.cpp)."""

    def __init__(self, num_slots: int, max_seq_len: int):
        self.lib = load_scheduler_lib()
        if self.lib is None:
            raise RuntimeError("native scheduler unavailable (no g++?)")
        self.h = self.lib.msched_create(num_slots, max_seq_len)
        if not self.h:
            raise ValueError("bad scheduler params")
        self.num_slots = num_slots

    def __del__(self):
        if getattr(self, "h", None) and self.lib is not None:
            self.lib.msched_destroy(self.h)
            self.h = None

    def submit(self, uid: int, prompt_len: int, max_new: int) -> bool:
        """Queue a request; False if the core refuses it (no prompt, no new
        tokens, or more than ``max_seq_len`` tokens in all)."""
        return self.lib.msched_submit(self.h, uid, prompt_len, max_new) == 0

    def fill(self):
        """Admit queued requests -> list of (slot, uid, prompt_len, max_new)."""
        cap = self.num_slots
        slots = (ctypes.c_int32 * cap)()
        uids = (ctypes.c_uint64 * cap)()
        plens = (ctypes.c_int32 * cap)()
        mnews = (ctypes.c_int32 * cap)()
        n = self.lib.msched_fill(self.h, slots, uids, plens, mnews, cap)
        return [(slots[i], uids[i], plens[i], mnews[i]) for i in range(n)]

    def commit(self, slot: int, is_eos: bool) -> int:
        """1 if the slot retired, 0 if it stays active, -1 if it was not
        active (or out of range)."""
        return self.lib.msched_commit(self.h, slot, int(is_eos))

    @property
    def num_active(self) -> int:
        return self.lib.msched_num_active(self.h)

    @property
    def num_queued(self) -> int:
        return self.lib.msched_num_queued(self.h)

    def positions(self):
        out = (ctypes.c_int32 * self.num_slots)()
        self.lib.msched_positions(self.h, out)
        return list(out)

    def active_mask(self):
        out = (ctypes.c_int32 * self.num_slots)()
        self.lib.msched_active_mask(self.h, out)
        return [bool(x) for x in out]

    def stats(self):
        a, f, r = (ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64())
        self.lib.msched_stats(self.h, ctypes.byref(a), ctypes.byref(f), ctypes.byref(r))
        return {"admitted": a.value, "finished": f.value, "rejected": r.value}


class PySlotScheduler:
    """The core's rule in Python, for a host without g++: the same returns
    and ``stats()`` as ``NativeSlotScheduler`` for every call sequence."""

    def __init__(self, num_slots: int, max_seq_len: int):
        if num_slots <= 0 or max_seq_len <= 0:
            raise ValueError("bad scheduler params")
        self.num_slots, self.max_seq_len = num_slots, max_seq_len
        self.queue: deque = deque()            # (uid, prompt_len, max_new)
        self.active = [False] * num_slots
        self.pos = [0] * num_slots
        self.budget = [0] * num_slots
        self._stats = {"admitted": 0, "finished": 0, "rejected": 0}

    def submit(self, uid: int, prompt_len: int, max_new: int) -> bool:
        if prompt_len <= 0 or max_new <= 0 or prompt_len + max_new > self.max_seq_len:
            self._stats["rejected"] += 1
            return False
        self.queue.append((uid, prompt_len, max_new))
        return True

    def fill(self):
        out = []
        for i in range(self.num_slots):
            if not self.queue:
                break
            if self.active[i]:
                continue
            uid, prompt_len, max_new = self.queue.popleft()
            self.active[i], self.pos[i], self.budget[i] = True, prompt_len, max_new
            self._stats["admitted"] += 1
            out.append((i, uid, prompt_len, max_new))
        return out

    def commit(self, slot: int, is_eos: bool) -> int:
        if not 0 <= slot < self.num_slots or not self.active[slot]:
            return -1
        self.pos[slot] += 1
        self.budget[slot] -= 1
        if is_eos or self.budget[slot] <= 0 or self.pos[slot] >= self.max_seq_len:
            self.active[slot], self.pos[slot] = False, 0
            self._stats["finished"] += 1
            return 1
        return 0

    @property
    def num_active(self) -> int:
        return sum(self.active)

    @property
    def num_queued(self) -> int:
        return len(self.queue)

    def positions(self):
        return list(self.pos)

    def active_mask(self):
        return list(self.active)

    def stats(self):
        return dict(self._stats)


def slot_scheduler(num_slots: int, max_seq_len: int):
    """The native core where it builds, ``PySlotScheduler`` otherwise."""
    if load_scheduler_lib() is None:
        return PySlotScheduler(num_slots, max_seq_len)
    return NativeSlotScheduler(num_slots, max_seq_len)
