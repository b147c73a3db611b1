"""Point-to-point transfers between ranks: the ring's K/V hops, the SP
prefill's cache handoff and the pipeline's activations.

``post`` starts every send and receive of one exchange at once and returns
a ``Transfer`` whose ``wait`` finishes them.  Over nccl (one card a rank)
that is one ``batch_isend_irecv`` of the device tensors.  gloo moves no
CUDA tensor point to point, so over gloo (the CPU, or ranks that share one
card) the sends are staged through the host: copied off the device,
posted as ``isend`` / ``irecv`` pairs (a ring whose ranks each send and
receive cannot deadlock, since nothing waits before everything is
posted), and the receives copied back on ``wait``.  The backend is the
group's, which the caller chose.  A group's first exchange over nccl
is preceded by a barrier of the whole group, so its communicator is made
with every rank present (a pipeline's later stages post their first
exchange ticks after the first stage).  Tensors travel as their bytes
(``uint8`` views), so every dtype goes over either backend.  A transfer
that fails to post or to finish raises.

A ``clock`` dict ({"s": float, "n": int}) times the exchanges: each is
bracketed by device synchronizes, from its post to its wait (the overlap
with compute in between is then lost), and its seconds and count added.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


_NCCL_READY: set = set()     # groups whose nccl communicator is made


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


class Transfer:
    """An exchange in flight; ``wait`` returns once every receive landed."""

    def __init__(self, works, landings, clock, device, t0, keep=()):
        self._works, self._landings, self._keep = works, landings, keep
        self._clock, self._device, self._t0 = clock, device, t0

    def wait(self):
        for w in self._works:
            w.wait()
        for dest, buf in self._landings:
            dest.copy_(buf.view(dest.dtype).view(dest.shape))
        if self._clock is not None:
            _sync(self._device)
            self._clock["s"] += time.perf_counter() - self._t0
            self._clock["n"] += 1


def post(sends, recvs, group, clock: dict | None = None) -> Transfer:
    """Start ``sends`` [(peer, tensor)] and ``recvs`` [(peer, dest)] with
    the peers given as ranks of ``group``; every dest is written on
    ``wait``.  A peer may appear on both sides (a ring of two)."""
    tensors = [t for _, t in sends] + [d for _, d in recvs]
    device = tensors[0].device
    t0 = None
    if clock is not None:
        _sync(device)
        t0 = time.perf_counter()
    group = group if group is not None else dist.group.WORLD
    glob = lambda r: dist.get_global_rank(group, r)   # noqa: E731
    landings = []
    if dist.get_backend(group) == "nccl":
        if id(group) not in _NCCL_READY:
            dist.barrier(group=group)
            _NCCL_READY.add(id(group))
        keep = [_bytes(t) for _, t in sends]
        ops = [dist.P2POp(dist.isend, b, glob(p), group) for (p, _), b in zip(sends, keep)]
        for p, dest in recvs:
            buf = torch.empty(dest.numel() * dest.element_size(), dtype=torch.uint8,
                              device=dest.device)
            ops.append(dist.P2POp(dist.irecv, buf, glob(p), group))
            landings.append((dest, buf))
        return Transfer(dist.batch_isend_irecv(ops), landings, clock, device, t0, keep)
    staged = [(p, _bytes(t).cpu()) for p, t in sends]
    works = []
    for p, dest in recvs:
        buf = torch.empty(dest.numel() * dest.element_size(), dtype=torch.uint8)
        works.append(dist.irecv(buf, glob(p), group))
        landings.append((dest, buf))
    works += [dist.isend(buf, glob(p), group) for p, buf in staged]
    return Transfer(works, landings, clock, device, t0, staged)
