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

A pod (``parallel.multihost.make_pod_group``) is one ``(data, graph)``
layout over several processes joined by a ``torch.distributed`` process
group, as JAX's ``make_pod_mesh`` lays its mesh over hosts: global rank
``p * per_process + i`` is process p's i-th rank, the ranks numbered
row-major over ``(data, graph)``, so a ``data`` row or a ``graph`` column
may span processes; each process builds the group of its own ranks
(``ranks``, their local indices 0 .. n-1), and ``shape`` is the whole
pod's.  A collective whose sub-group spans processes gathers the
sub-group's entries over a process group of exactly those processes
(:meth:`gather`: an all-gather, then the same fold in global rank order in
every process), so every process holds the bits the in-process group of
the same shape would; each keeps its own ranks' results.  Over ``nccl`` the
gathers run on the process's first card (rank 0's device and stream), over
``gloo`` through CPU tensors; the backend is the process group's (NCCL
takes one card per process: two processes on one card keep ``gloo``).  A
sharded node's backward sums the other processes' cotangents the same way
(:meth:`cotangents`), inside the autograd engine; every such node of a
step takes a token from the one made before it (:meth:`chain`), so the
engine reaches them in one order in every process.  The ring kernels (K6,
K7) stay inside a process: on a ``graph`` row that spans processes they
raise (:meth:`check_ring`).

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


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the process group carries it: its bytes (``gloo`` takes no
    bfloat16 or int16), viewed back by the receiver."""
    return x.contiguous().view(torch.uint8)


def _timeout(process_group):
    """The process group's time limit, for the sub-groups made from it
    (None, the backend's default, where the backend does not say)."""
    try:
        import torch.distributed as dist

        kind = "cuda" if dist.get_backend(process_group) == "nccl" else "cpu"
        return process_group._get_backend(torch.device(kind)).options._timeout
    except (AttributeError, RuntimeError):
        return None


class _Aborted(RuntimeError):
    """A rank stopped because another rank failed."""


class RankGroup:
    """``n`` ranks on one ``graph`` axis, or ``n x graph`` ranks on the axes
    ``(data, graph)``; each rank has a device and (on the card) a stream.

    ``devices``: one device per rank (default ``cuda:(r % device_count)``);
    ``device="cpu"``: every rank on the CPU.

    In a pod (see the module's docstring) the shape is the pod's,
    ``ranks`` this process's global ranks (ascending; ``devices`` one per
    each), ``per_process`` the ranks each process numbers (its local
    devices, the idle ones included: rank ``q`` belongs to process ``q //
    per_process``) and ``process_group`` the processes' group.
    """

    def __init__(
        self,
        n: int,
        graph: Optional[int] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
        device: Optional[Union[str, torch.device]] = None,
        process_group=None,
        ranks: Optional[Sequence[int]] = None,
        per_process: Optional[int] = None,
    ):
        data, graph = (1, n) if graph is None else (n, graph)
        if data < 1 or graph < 1:
            raise ValueError(f"a rank group needs at least one rank on each axis, got {data} x {graph}")
        self.shape = {"data": data, "graph": graph}
        self.ranks: List[int] = list(range(data * graph) if ranks is None else ranks)
        self.per_process = per_process or data * graph
        if not self.ranks or any(not 0 <= q < data * graph for q in self.ranks) or self.ranks != sorted(set(self.ranks)):
            raise ValueError(f"ranks {self.ranks} are not ascending ranks of a {data} x {graph} group")
        if len({q // self.per_process for q in self.ranks}) != 1:
            raise ValueError(f"ranks {self.ranks} lie in more than one process of {self.per_process} ranks")
        self._index = {q: i for i, q in enumerate(self.ranks)}
        n = len(self.ranks)
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
        # the pod's processes (1 and 0 outside a pod): this one holds ranks
        # process * per_process ..; the process groups of the sub-groups
        # that span processes, by their processes
        self.process_group = process_group
        self.process = self.ranks[0] // self.per_process
        self.processes = -(-data * graph // self.per_process)
        self._pgs: Dict[Tuple[int, ...], object] = {}
        self._nccl = False
        if process_group is not None:
            self._join(process_group)
        self._token = None
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
        """``(data, graph)`` coordinates of (local) ``rank``."""
        return divmod(self.ranks[rank], self.shape["graph"])

    def rank_at(self, data: int, graph: int) -> int:
        """The local index of the rank at ``(data, graph)`` (this process's)."""
        q = data * self.shape["graph"] + graph
        if q not in self._index:
            raise ValueError(f"rank ({data}, {graph}) lies in process {q // self.per_process}, not {self.process}")
        return self._index[q]

    @property
    def data_size(self) -> int:
        """The ``data`` axis over every process of the pod."""
        return self.shape["data"]

    @property
    def data_rows(self) -> List[int]:
        """The ``data`` rows this process holds ranks of, ascending."""
        return sorted({self.coords(r)[0] for r in range(self.n)})

    @property
    def idle(self) -> List[int]:
        """This process's global ranks past the pod's ``data x graph``
        (JAX's devices past ``devices[:data * graph]``): they sit out."""
        first = self.process * self.per_process
        return [q for q in range(first, first + self.per_process) if q >= self.shape["data"] * self.shape["graph"]]

    def axis_index(self, rank: int, axis: str = "graph") -> int:
        """The rank's coordinate on ``axis`` (JAX's ``axis_index``)."""
        return self.coords(rank)[AXES.index(_axis(axis))]

    def subgroups(self, axis: str = "graph") -> List[List[int]]:
        """The ranks that collectives along ``axis`` combine: one list of this
        process's ranks per value of the other coordinate, each in order
        along ``axis`` (in a pod a list may be part of a sub-group that
        spans processes: :meth:`crosses`)."""
        keyed: Dict[int, List[int]] = {}
        for r in range(self.n):
            d, g = self.coords(r)
            keyed.setdefault(g if _axis(axis) == "data" else d, []).append(r)
        return [keyed[k] for k in sorted(keyed)]

    def members(self, rank: int, axis: str = "graph") -> List[int]:
        """The global ranks of (local) ``rank``'s sub-group along ``axis``, in
        order."""
        return self._members(self.ranks[rank], axis)

    def _members(self, q: int, axis: str) -> List[int]:
        D, G = self.shape["data"], self.shape["graph"]
        d, g = divmod(q, G)
        return [d * G + k for k in range(G)] if _axis(axis) == "graph" else [k * G + g for k in range(D)]

    def _processes(self, members: Sequence[int]) -> Tuple[int, ...]:
        return tuple(sorted({q // self.per_process for q in members}))

    def crosses(self, rank: int, axis: str = "graph") -> bool:
        """Whether (local) ``rank``'s sub-group along ``axis`` spans processes."""
        return len(self._processes(self.members(rank, axis))) > 1

    def check_ring(self, what: str) -> None:
        """Raise where a ``graph`` row of this process spans processes: the
        ring kernels (K6, K7) write into their neighbours' slots, which
        another process's memory would need CUDA IPC handles for (ROADMAP
        entry 7.4c)."""
        if any(self.crosses(ranks[0], "graph") for ranks in self.subgroups("graph")):
            raise NotImplementedError(
                f"{what} on a graph row that spans processes is not ported (ROADMAP entry 7.4c: K6 and K7 "
                "across processes); lay the pod out with graph_per_host at most a process's ranks")

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
        self._turn, self._failed, self._token = 0, False, None

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
        which returns one result per rank (a ring kernel's wrapper).  In a
        pod the combine sees this process's ranks; it reaches the other
        processes' through :meth:`gather`."""
        return self._rendezvous(value, combine)

    def all_reduce_plain(self, x: torch.Tensor, op: str, axis: str = "graph") -> torch.Tensor:
        """Sum, max or min over the ranks' tensors along ``axis``, in rank
        order, the same result for every rank of a sub-group: the
        counterpart of XLA's ``psum``/``pmax``/``pmin`` (plain PyTorch, as
        the JAX package left them to XLA)."""
        return self._rendezvous(x, lambda xs: self.reduce_plain(xs, op, axis))

    def reduce_plain(self, xs: Sequence[torch.Tensor], op: str, axis: str = "graph") -> list:
        """:meth:`all_reduce_plain` on the list of every rank's tensor (each
        ready on its rank's stream); one result per rank, on its device.  A
        sub-group that spans processes gathers the other processes' members
        first (:meth:`gather`) and folds on rank 0's device and stream (no
        gradient flows through the gather)."""
        outs: List[object] = [None] * self.n
        for ranks in self.subgroups(axis):
            parts = [xs[r] for r in ranks]
            if self.crosses(ranks[0], axis):
                with torch.no_grad(), self.lead(ranks):
                    parts = self.gather(parts, ranks[0], axis)
                results = self._fold(parts, op, ranks, lead=0)
            else:
                results = self._fold(parts, op, ranks)
            for r, out in zip(ranks, results):
                outs[r] = out
        return outs

    def lead(self, ranks: Sequence[int]):
        """Rank 0's device and stream as the current ones, the stream after
        every stream of ``ranks``: where a sub-group's cross-process gather
        runs."""
        if not self.is_cuda:
            return contextlib.nullcontext()
        for r in ranks:
            self.streams[0].wait_stream(self.streams[r])
        return self.context(0)

    def gather(self, parts: Sequence[torch.Tensor], rank: int, axis: str = "graph") -> List[torch.Tensor]:
        """Every member's tensor of (local) ``rank``'s sub-group along
        ``axis``, in global rank order: ``parts`` are this process's members'
        (in order; one shape and dtype, ready on the current stream), the
        other processes' come over the process group of the sub-group's
        processes (an all-gather of each process's members, padded to the
        most any holds; over ``nccl`` on rank 0's card, over ``gloo`` through
        CPU tensors) onto rank 0's device, on the current stream.
        ``parts`` itself where the sub-group lies in this process."""
        members = self.members(rank, axis)
        procs = self._processes(members)
        if len(procs) == 1:
            return list(parts)
        held = {p: sum(q // self.per_process == p for q in members) for p in procs}
        x = torch.stack([t.to(self.devices[0]) for t in parts])
        k = max(held.values())
        if k > len(parts):
            x = torch.cat([x, x.new_zeros((k - len(parts),) + tuple(x.shape[1:]))])
        out: List[torch.Tensor] = []
        for p, got in zip(procs, self._all_gather(x, procs)):
            out += list(parts) if p == self.process else list(got[: held[p]].unbind(0))
        return out

    def _all_gather(self, x: torch.Tensor, procs: Tuple[int, ...]) -> List[torch.Tensor]:
        """Each of ``procs``' ``x`` (this process's is ``x``), in process
        order, on rank 0's device: over ``nccl`` on the card, over ``gloo``
        through CPU tensors."""
        import torch.distributed as dist

        wire = _wire(x)
        if not self._nccl:
            wire = wire.cpu()
        bufs = [torch.empty_like(wire) for _ in procs]
        dist.all_gather(bufs, wire.contiguous(), group=self._pgs[procs])
        return [b.to(self.devices[0]).view(x.dtype) for b in bufs]

    def sum_processes(self, x: torch.Tensor, rank: int, axis: str = "graph") -> torch.Tensor:
        """``x``, this process's part of a sum over (local) ``rank``'s
        sub-group along ``axis``, added to the other processes' parts of
        it, in process order, on ``x``'s device (``x`` where the sub-group
        lies in this process)."""
        procs = self._processes(self.members(rank, axis))
        if len(procs) == 1:
            return x
        acc = None
        for got in self._all_gather(x.to(self.devices[0]), procs):
            acc = got if acc is None else acc + got
        return acc.to(x.device)

    def cotangents(self, parts: Sequence[torch.Tensor], rank: int) -> List[torch.Tensor]:
        """A sharded node's backward: every member's aggregate cotangent of
        (local) ``rank``'s ``graph`` row, in global rank order
        (:meth:`gather` on the current stream)."""
        return self.gather(parts, rank, "graph")

    def token(self) -> torch.Tensor:
        """The token a sharded node whose row spans processes takes: the
        previous such node's (:meth:`chain`) in this call of :meth:`run`, or
        a fresh one.  Each node returns a new token, so the autograd engine
        runs every such node's backward (and its cross-process gather) after
        the next one's: one order in every process."""
        return torch.zeros(()) if self._token is None else self._token

    def chain(self, token: torch.Tensor) -> None:
        self._token = token

    def gather_processes(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every process's ``x`` (one shape and dtype in each; on rank 0's
        device, ready on the current stream), in process order, on rank 0's
        device; ``[x]`` outside a pod."""
        if self.processes == 1:
            return [x]
        return self._all_gather(x, tuple(range(self.processes)))

    def _join(self, process_group) -> None:
        """This process's place in the pod's process group, and a process
        group (its backend and time limit) for every set of processes that
        a sub-group spans, made in one order in every process."""
        import torch.distributed as dist

        self.processes = dist.get_world_size(process_group)
        if dist.get_rank(process_group) != self.process:
            raise ValueError(f"process {dist.get_rank(process_group)} given ranks {self.ranks} of process "
                             f"{self.process}")
        D, G = self.shape["data"], self.shape["graph"]
        if D * G > self.processes * self.per_process:
            raise ValueError(f"a {D} x {G} pod needs more than {self.processes} processes of {self.per_process} ranks")
        backend = dist.get_backend(process_group)
        self._nccl = backend == "nccl"
        spans = {self._processes(self._members(q, axis)) for axis in AXES for q in range(D * G)}
        self._pgs[tuple(range(self.processes))] = process_group
        for procs in sorted(p for p in spans if len(p) > 1):
            if len(procs) < self.processes:
                self._pgs[procs] = dist.new_group([dist.get_global_rank(process_group, p) for p in procs],
                                                  timeout=_timeout(process_group), backend=backend)

    def _fold(self, xs: Sequence[torch.Tensor], op: str, ranks: Sequence[int], lead: Optional[int] = None) -> list:
        """``xs`` folded in order with ``op`` on rank ``lead``'s device and
        stream (``ranks[0]``'s by default), after every stream of ``ranks``;
        the result for each of ``ranks`` on its device and stream."""
        fold = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[op]
        if not self.is_cuda:
            acc = xs[0]
            for x in xs[1:]:
                acc = fold(acc, x)
            return [acc] * len(ranks)
        lead = ranks[0] if lead is None else lead
        s0, d0 = self.streams[lead], self.devices[lead]
        with torch.cuda.device(d0), torch.cuda.stream(s0):
            for r in ranks:
                if r != lead:
                    s0.wait_stream(self.streams[r])
            acc = xs[0].to(d0)
            for x in xs[1:]:
                acc = fold(acc, x.to(d0))
        outs = []
        for r in ranks:
            d, s = self.devices[r], self.streams[r]
            with torch.cuda.device(d), torch.cuda.stream(s):
                if r != lead:
                    s.wait_stream(s0)
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
