"""The compiled decode and chunked prefill: one decode step, or one
chunked-prefill segment of the whole model, from static input buffers to
its logits, captured once as a CUDA graph and replayed, the port's
counterpart of the JAX package's jitted decode (the ``Generator``'s
``lax.while_loop``, the engine's jitted ``step``) and of its jitted segment
program (``runtime/generate.py`` ``StaticSegment``).

``StepGraph(fn, device, graph)`` holds a callable ``fn`` of no arguments
that reads its inputs from static buffers (a token buffer, a device
position, the cache state: tensors that outlive the StepGraph's use and are
only ever written in place) and returns the step's logits.  Every value the
step needs lives on the device, so nothing in ``fn`` reads the host or
sizes a launch from a count.  ``run()``:
  * with ``graph`` (the card): the first call runs ``fn`` eagerly on the
    StepGraph's own stream, which does that step's real work, builds every
    kernel it launches and allocates each kernel wrapper's scratch for that
    stream; then it captures ``fn`` on the same stream into a CUDA graph
    (its intermediates in the graph's private memory pool).  Every later
    call replays the graph on the current stream and returns its static
    logits, which the next replay overwrites.  A capture that fails raises.
    The per-stream scratch, workspaces and merge counters the captured
    launches use are held by the StepGraph, so no later call replaces them
    while the graph lives.
  * without (the CPU, which has no graphs): every call runs ``fn`` again,
    the same callable on the same buffers after their in-place updates, as
    a replay would.  The CPU tests hold this program against the eager loop
    and the JAX package.
Launch counts: the kernel wrappers count their launches in Python, which a
replay does not run.  A capture's counts are taken back out of the
wrappers' ``launches`` (a capture launches nothing) and kept as the graph's
``captured``; each replay adds them to ``REPLAYED``.  So the launches a
run made of wrapper f are ``f.launches + REPLAYED[f.__name__]``
(``launches``): the eager ones, plus captured launches x replays.
"""

from __future__ import annotations

import collections
import gc
import time

import torch

REPLAYED: collections.Counter = collections.Counter()


def kernel_wrappers() -> dict:
    """The counted kernel wrappers of the serving paths, by name."""
    from mustafar_tpu_torch.ops.kernels import dense_decode as dd
    from mustafar_tpu_torch.ops.kernels import pack_kernel as pk
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    from mustafar_tpu_torch.ops.kernels import sparse_attention as ska
    from mustafar_tpu_torch.ops.kernels import w4_matmul as w4
    return {fn.__name__: fn for fn in (
        qa.fused_q_decode_attention, qa.fused_q_decode_attention_ps,
        qa.fused_q_segment_attention, ska.fused_sparse_decode_attention,
        ska.fused_sparse_decode_attention_ps, ska.fused_sparse_segment_attention,
        w4.w4_matmul, dd.flash_decode_attention, pk.prune_quant_pack,
        pk.prune_quant_pack_kv)}


def launches() -> dict:
    """Each wrapper's launches: its eager count plus what graph replays
    launched (module note)."""
    return {name: fn.launches + REPLAYED[name] for name, fn in kernel_wrappers().items()}


def _stream_buffers(device, stream) -> list:
    """The kernel wrappers' per-stream buffers for (device, stream): the
    split scratch and merge counters, the W4 workspace."""
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    from mustafar_tpu_torch.ops.kernels import w4_matmul as w4
    key = (device.index or 0, stream.cuda_stream)
    return [buf for table in (qa._SCRATCH, qa._COUNTERS, w4._WORKSPACE)
            if (buf := table.get(key)) is not None]


class StepGraph:
    """A step (a decode step, or a chunked-prefill segment) from static
    buffers to its logits, captured and replayed on the card, rerun on the
    CPU (module note).  ``replays`` counts the calls after the first
    (replays of the graph, or reruns).  After a capture, ``capture_s`` is
    its host time (the capture and the graph's instantiation) and
    ``capture_bytes`` what the card's memory pool reserved for it (the
    graph's intermediates)."""

    def __init__(self, fn, device, graph: bool):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = graph
        self.replays = 0
        self.captured: dict = {}
        self._graph = None
        self._out = None
        self._held = []
        self._stream = torch.cuda.Stream(self.device) if graph else None
        self.capture_s = None
        self.capture_bytes = None

    def run(self) -> torch.Tensor:
        if not self.graph:
            if self._out is not None:
                self.replays += 1
            self._out = self.fn()
            return self._out
        if self._graph is None:
            return self._capture()
        self._graph.replay()
        self.replays += 1
        REPLAYED.update(self.captured)
        return self._out

    def _capture(self) -> torch.Tensor:
        wrappers = kernel_wrappers()
        cur = torch.cuda.current_stream(self.device)
        s = self._stream
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            out = self.fn()                       # this step, eagerly
        before = {name: fn.launches for name, fn in wrappers.items()}
        # what the capture itself starts with (it collects and empties the
        # cache too), so that the pool it reserves is the difference
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            self._out = self.fn()
        self.capture_s = time.perf_counter() - t
        self.capture_bytes = torch.cuda.memory_reserved(self.device) - reserved
        for name, fn in wrappers.items():
            if fn.launches != before[name]:
                self.captured[name] = fn.launches - before[name]
                fn.launches = before[name]
        self._held = _stream_buffers(self.device, s)
        cur.wait_stream(s)
        out.record_stream(cur)
        self._graph = graph
        return out
