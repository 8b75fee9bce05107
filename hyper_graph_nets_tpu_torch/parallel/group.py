"""A group of ranks in one process: the port's counterpart of a device mesh
(the JAX package's ``parallel/sharding.make_mesh``, axes ``('data',
'graph')``).

``RankGroup(n)`` has one axis, ``graph``, of n ranks (the halo forward's);
``RankGroup(data, graph)`` has two: rank ``r = d * graph + g`` sits at
``(d, g)``, the row-major order of JAX's ``devices.reshape(data, graph)``.
Collectives run along one axis (``graph`` unless told otherwise): each
sub-group of ranks that share the other coordinate combines on its own, in
rank order.  Ring kernels ring along ``graph``, each rank's neighbours
keeping its ``data`` coordinate (the JAX package's ``_mesh_neighbors``).

The JAX package drives every device of its mesh from one process
(``shard_map``).  Here each rank has its own ``torch.device`` and its own
CUDA stream, and :meth:`RankGroup.run` runs one function per rank, each in
its own thread under the rank's device and stream, so every rank runs the
same network code in lockstep, taking turns.  A collective
(:meth:`exchange`, :meth:`all_reduce_plain`) is a rendezvous of every rank
of the group: every rank hands in its tensor, the last runs the combine for
all of them (the hand-written ring kernels launch there: one C call
launches every rank's kernel, each on its rank's card and stream, with no
host synchronization between them), and each rank gets its own result back.

On the card, rank r sits on ``cuda:(r % device_count)``: on a node with n
cards every rank has its own card (peer access is turned on between them,
and the ring kernels write across NVLink); with one card the n ranks share
it, and a ring's "remote" writes land in the same memory.  ``device="cpu"``
puts every rank on the CPU, where the kernels' plain versions run (the
tests).  Without a card and without ``device="cpu"`` it raises.

A pod (``parallel.multihost.make_pod_group``) is a rank group in each of
several processes joined by a ``torch.distributed`` process group: the
``data`` axis continues across the processes (process p holds global data
rows ``p * data .. (p + 1) * data - 1``), the ``graph`` axis stays inside
each one, as the JAX package keeps ``graph`` on each host's own chips.  An
all-reduce along ``data`` first combines the process's own ranks in rank
order, then the processes' results through the host: CPU tensors gathered
over the process group and combined in process order, so that every
process holds the same bits.  Collectives along ``graph`` and the ring
kernels never leave the process.

The ring kernels need state that outlives a call: each rank's comm slots and
flags (allocated once per ring kind and kept, never reset: each
call passes the next epoch) and a page-locked error word their bounded
spins write before they trap; :meth:`check` synchronizes every rank and
raises on it.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from hyper_graph_nets_tpu_torch.runtime import resolve_device

# flag rows (8 int64 words each: READY, CREDIT and the two barrier words of
# csrc/ring_common.cuh) of a rank and ring kind: one per K6 sub-ring (at
# most the card's SMs) or K7 band
RING_FLAG_ROWS = 256
MAX_BANDS = 64
WAIT_KINDS = {1: "barrier", 2: "credit", 3: "ready", 4: "band completion"}
AXES = ("data", "graph")


def _axis(axis: str) -> str:
    if axis not in AXES:
        raise ValueError(f"axis must be one of {AXES}, got {axis!r}")
    return axis


class _Aborted(RuntimeError):
    """A rank stopped because another rank failed."""


class RankGroup:
    """``n`` ranks on one ``graph`` axis, or ``n x graph`` ranks on the axes
    ``(data, graph)``; each rank has a device and (on the card) a stream.

    ``devices``: one device per rank (default ``cuda:(r % device_count)``);
    ``device="cpu"``: every rank on the CPU.
    """

    def __init__(
        self,
        n: int,
        graph: Optional[int] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
        device: Optional[Union[str, torch.device]] = None,
        process_group=None,
    ):
        data, graph = (1, n) if graph is None else (n, graph)
        if data < 1 or graph < 1:
            raise ValueError(f"a rank group needs at least one rank on each axis, got {data} x {graph}")
        self.shape = {"data": data, "graph": graph}
        n = data * graph
        if device is not None and devices is not None:
            raise ValueError("pass devices or device, not both")
        if devices is None:
            base = resolve_device(device)
            if base.type == "cpu":
                devices = [base] * n
            else:
                count = torch.cuda.device_count()
                devices = [torch.device("cuda", r % count) for r in range(n)]
        devices = [resolve_device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} ranks")
        kinds = {d.type for d in devices}
        if len(kinds) != 1:
            raise ValueError(f"a rank group lies on one kind of device, got {devices}")
        self.n = n
        self.devices: List[torch.device] = [
            torch.device(d.type, d.index if d.index is not None else torch.cuda.current_device())
            if d.type == "cuda" else d
            for d in devices
        ]
        self.is_cuda = self.devices[0].type == "cuda"
        self.streams = [torch.cuda.Stream(d) for d in self.devices] if self.is_cuda else [None] * n
        self.epoch = 0
        # the pod's processes (1 and 0 outside a pod)
        self.process_group = process_group
        self.processes, self.process = 1, 0
        if process_group is not None:
            import torch.distributed as dist

            self.processes = dist.get_world_size(process_group)
            self.process = dist.get_rank(process_group)
        self._local = threading.local()
        self._cv = threading.Condition()
        self._turn, self._failed = 0, False
        self._box: List[object] = [None] * n
        self._result: List[object] = [None] * n
        self._ring: Dict[str, list] = {}
        self._err = None
        if self.is_cuda and len(set(self.devices)) > 1:
            self._enable_peer_access()

    # -- layout -------------------------------------------------------------
    def device(self, rank: int) -> torch.device:
        return self.devices[rank]

    def stream(self, rank: int):
        return self.streams[rank]

    def coords(self, rank: int) -> Tuple[int, int]:
        """``(data, graph)`` coordinates of ``rank``."""
        return divmod(rank, self.shape["graph"])

    def rank_at(self, data: int, graph: int) -> int:
        return data * self.shape["graph"] + graph

    @property
    def data_size(self) -> int:
        """The ``data`` axis over every process of the pod."""
        return self.processes * self.shape["data"]

    def axis_index(self, rank: int, axis: str = "graph") -> int:
        """The rank's coordinate on ``axis`` (JAX's ``axis_index``)."""
        return self.coords(rank)[AXES.index(_axis(axis))]

    def subgroups(self, axis: str = "graph") -> List[List[int]]:
        """The ranks that collectives along ``axis`` combine: one list per
        value of the other coordinate, each in order along ``axis``."""
        D, G = self.shape["data"], self.shape["graph"]
        if _axis(axis) == "graph":
            return [[self.rank_at(d, g) for g in range(G)] for d in range(D)]
        return [[self.rank_at(d, g) for d in range(D)] for g in range(G)]

    def left(self, rank: int) -> int:
        """The ring neighbour before ``rank`` along ``graph``, its ``data``
        coordinate fixed (the JAX package's ``_mesh_neighbors``)."""
        d, g = self.coords(rank)
        return self.rank_at(d, (g - 1) % self.shape["graph"])

    def right(self, rank: int) -> int:
        d, g = self.coords(rank)
        return self.rank_at(d, (g + 1) % self.shape["graph"])

    def ranks_on_device(self, rank: int) -> int:
        return sum(d == self.devices[rank] for d in self.devices)

    def ctas_per_rank(self, rank: int) -> int:
        """CTAs one rank's ring kernel may use so that every rank's fit on
        its card at once: SMs / (ranks on that card)."""
        sms = torch.cuda.get_device_properties(self.devices[rank]).multi_processor_count
        return max(1, sms // self.ranks_on_device(rank))

    def layout(self) -> str:
        return ", ".join(f"rank {r}: {d}" for r, d in enumerate(self.devices))

    # -- running ------------------------------------------------------------
    def rank(self) -> int:
        """The calling thread's rank (inside :meth:`run`)."""
        r = getattr(self._local, "rank", None)
        if r is None:
            raise RuntimeError("not inside RankGroup.run")
        return r

    def context(self, rank: int):
        """The rank's device and stream as the current ones."""
        if not self.is_cuda:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.devices[rank]))
        stack.enter_context(torch.cuda.stream(self.streams[rank]))
        return stack

    def _sanitized(self):
        """Under PyTorch's CUDA sanitizer (``TORCH_CUDA_SANITIZER=1``), its
        dispatch mode in this thread too: the mode is per thread, and a
        rank's thread would otherwise run its operations unseen.  The module
        is looked up, never imported: importing it turns on PyTorch's GPU
        trace callbacks for the whole process (every allocation, event and
        sync then calls into Python)."""
        sanitizer = sys.modules.get("torch.cuda._sanitizer")
        if not self.is_cuda or sanitizer is None or not sanitizer.cuda_sanitizer.enabled:
            return contextlib.nullcontext()
        return sanitizer.cuda_sanitizer.dispatch

    def run(self, fn: Callable[[int], object]) -> list:
        """``[fn(0), ..., fn(n-1)]``, each rank in its own thread under its
        device and stream.

        The threads take turns: one runs at a time, from one collective to
        the next, in rank order (rank 0 up to its first collective, then rank
        1, ...; the last rank runs the combine and hands the turn back to
        rank 0).  Python runs one thread at a time anyway, and threads that
        ran at once would only contend for the interpreter; taking turns
        keeps the host's launch path as fast as one rank's, and the order of
        every rank's work the same from call to call.  The ranks' streams
        first wait for the caller's current streams, and the caller's
        current streams wait for the ranks' at the end, so tensors pass in
        and out in stream order.  The first error of any rank is raised."""
        if self.is_cuda:
            for r, d in enumerate(self.devices):
                self.streams[r].wait_stream(torch.cuda.current_stream(d))
        results: List[object] = [None] * self.n
        errors: List[BaseException] = []
        self._turn, self._failed = 0, False

        def body(r):
            self._local.rank = r
            try:
                self._wait_turn(r)
                with self.context(r), self._sanitized():
                    results[r] = fn(r)
            except BaseException as exc:  # re-raised below, in the caller's thread
                errors.append(exc)
                with self._cv:
                    self._failed = True
                    self._cv.notify_all()
            finally:
                self._local.rank = None
            self._pass_turn(r)

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise next((e for e in errors if not isinstance(e, _Aborted)), errors[0])
        if self.is_cuda:
            for r, d in enumerate(self.devices):
                torch.cuda.current_stream(d).wait_stream(self.streams[r])
        return results

    def _wait_turn(self, r: int) -> None:
        with self._cv:
            self._cv.wait_for(lambda: self._turn == r or self._failed)
            if self._failed:
                raise _Aborted("another rank failed")

    def _pass_turn(self, r: int) -> None:
        with self._cv:
            self._turn = (r + 1) % self.n
            self._cv.notify_all()

    def _rendezvous(self, value, combine: Callable[[list], list]):
        """Hand in ``value``; the last rank combines everyone's; take this
        rank's result when the turn comes back."""
        r = self.rank()
        self._box[r] = value
        if r == self.n - 1:
            self._result = combine(list(self._box))
        self._pass_turn(r)
        self._wait_turn(r)
        return self._result[r]

    # -- collectives ----------------------------------------------------------
    def exchange(self, value, combine: Callable[[list], list]):
        """This rank's entry of ``combine([value_0, ..., value_{n-1}])``,
        which returns one result per rank (a ring kernel's wrapper)."""
        return self._rendezvous(value, combine)

    def all_reduce_plain(self, x: torch.Tensor, op: str, axis: str = "graph") -> torch.Tensor:
        """Sum, max or min over the ranks' tensors along ``axis``, in rank
        order, the same result for every rank of a sub-group: the
        counterpart of XLA's ``psum``/``pmax``/``pmin`` (plain PyTorch, as
        the JAX package left them to XLA)."""
        return self._rendezvous(x, lambda xs: self.reduce_plain(xs, op, axis))

    def reduce_plain(self, xs: Sequence[torch.Tensor], op: str, axis: str = "graph") -> list:
        """:meth:`all_reduce_plain` on the list of every rank's tensor (each
        ready on its rank's stream); one result per rank, on its device.
        Along ``data`` in a pod, the processes' results are combined next
        (:meth:`fold_processes`; no gradient flows through that step)."""
        groups = self.subgroups(axis)
        folded = [self._fold([xs[r] for r in ranks], op, ranks) for ranks in groups]
        if axis == "data" and self.processes > 1:
            total = self.fold_processes(torch.stack([self._to_host(f[0], ranks[0])
                                                     for f, ranks in zip(folded, groups)]), op)
            folded = [[self._to_rank(total[i], r) for r in ranks] for i, ranks in enumerate(groups)]
        outs: List[object] = [None] * self.n
        for ranks, results in zip(groups, folded):
            for r, out in zip(ranks, results):
                outs[r] = out
        return outs

    def fold_processes(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum, max or min of a CPU tensor over the pod's processes: each
        process's ``x`` gathered over the process group and folded in
        process order, the same bits in every process (``x`` itself
        outside a pod)."""
        if self.processes == 1:
            return x
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(self.processes)]
        dist.all_gather(parts, x.contiguous(), group=self.process_group)
        fold = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[op]
        acc = parts[0]
        for part in parts[1:]:
            acc = fold(acc, part)
        return acc

    def _to_host(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        """``x`` (ready on ``rank``'s stream) on the CPU."""
        if not self.is_cuda:
            return x.detach()
        with torch.cuda.device(self.devices[rank]), torch.cuda.stream(self.streams[rank]):
            return x.detach().cpu()

    def _to_rank(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        if not self.is_cuda:
            return x
        with torch.cuda.device(self.devices[rank]), torch.cuda.stream(self.streams[rank]):
            return x.to(self.devices[rank])

    def _fold(self, xs: Sequence[torch.Tensor], op: str, ranks: Sequence[int]) -> list:
        fold = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[op]
        if not self.is_cuda:
            acc = xs[0]
            for x in xs[1:]:
                acc = fold(acc, x)
            return [acc] * len(ranks)
        s0, d0 = self.streams[ranks[0]], self.devices[ranks[0]]
        with torch.cuda.device(d0), torch.cuda.stream(s0):
            for r in ranks[1:]:
                s0.wait_stream(self.streams[r])
            acc = xs[0]
            for x in xs[1:]:
                acc = fold(acc, x.to(d0))
        outs = []
        for i, r in enumerate(ranks):
            d, s = self.devices[r], self.streams[r]
            with torch.cuda.device(d), torch.cuda.stream(s):
                s.wait_stream(s0)
                if i:
                    acc.record_stream(s)
                outs.append(acc if d == d0 else acc.to(d))
        return outs

    # -- ring kernel state ----------------------------------------------------
    def next_epoch(self, count: int = 1) -> int:
        """The first of ``count`` new epochs (a batched K7 call rings once
        per batch row, each pass with an epoch of its own)."""
        self.epoch += count
        return self.epoch - count + 1

    def ring_state(self, kind: str, floats: int, counters: int = MAX_BANDS) -> list:
        """Per rank ``(slots [2 * floats] float32, flags [RING_FLAG_ROWS, 8]
        int64, counters [>= counters] int32)`` of ring kind ``kind`` (each
        kind its own), allocated once and kept; slots and counters grow
        (after a synchronization of every rank, before any launch) when a
        call outgrows them.  Counters are zero between calls (each K7 band
        ring resets its own)."""
        state = self._ring.get(kind)
        if state is not None and state[0][0].numel() >= 2 * floats and state[0][2].numel() >= counters:
            return state
        self.synchronize()
        if state is None:
            flags = [torch.zeros(RING_FLAG_ROWS, 8, dtype=torch.int64, device=d) for d in self.devices]
        else:
            flags = [s[1] for s in state]
        size = max(counters, MAX_BANDS, 0 if state is None else state[0][2].numel())
        slots = [torch.zeros(2 * floats, dtype=torch.float32, device=d) for d in self.devices]
        counts = [torch.zeros(size, dtype=torch.int32, device=d) for d in self.devices]
        self.synchronize()
        self._ring[kind] = list(zip(slots, flags, counts))
        return self._ring[kind]

    def error_word(self):
        """The host-mapped int32 [4] the ring kernels' spins write before
        they trap: (what timed out, rank, step, sub-ring or band)."""
        if self._err is None:
            self._err = torch.zeros(4, dtype=torch.int32).pin_memory()
        return self._err

    def synchronize(self) -> None:
        if self.is_cuda:
            for d in sorted(set(self.devices), key=lambda d: d.index):
                torch.cuda.synchronize(d)

    def check(self) -> None:
        """Synchronize every rank; raise if a ring kernel's spin timed out
        (the kernel trapped) or the card reported a fault."""
        fault = None
        try:
            self.synchronize()
        except RuntimeError as exc:
            fault = exc
        if self._err is not None and int(self._err[0]) != 0:
            kind, rank, step, sub = (int(v) for v in self._err)
            raise RuntimeError(
                f"ring kernel: rank {rank} waited past its time limit for its "
                f"neighbour's {WAIT_KINDS.get(kind, kind)} (step {step}, sub-ring or band {sub}); "
                "were the ranks' launches serialized?"
            ) from fault
        if fault is not None:
            raise fault

    def _enable_peer_access(self) -> None:
        from hyper_graph_nets_tpu_torch.ops.ring import enable_peer_access

        for a in set(self.devices):
            for b in set(self.devices):
                if a != b:
                    enable_peer_access(a, b)
