"""Device resolution (the caller names the device, nothing is picked for
it), timing on the card, and the capture of one render iteration or one
train step as a CUDA graph."""
from __future__ import annotations

import ctypes
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import profiling

DEVICES = ("cuda", "cpu")


def resolve_device(name: str) -> torch.device:
    """`"cuda"` or `"cpu"` -> torch.device. Raises when CUDA is asked for and
    absent: a render that asked for the card never quietly runs elsewhere."""
    if name not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    return torch.device(name)


_COUNTERS = {}  # (device index, stream) -> a persistent kernel's counter


def stream_counter(device: torch.device, stream: int) -> torch.Tensor:
    """4 bytes of scratch for a persistent kernel's work counter, one per
    device and stream (K1 and K2 share it: their C entry points zero it on
    the stream before each launch, and a stream runs one launch at a
    time). Under a capture that zeroing is a memset node of the graph; the
    capture stream's counter is made before the capture (`capture_graph`),
    so it lives outside the graph's pool. Every graph captured on a device
    uses that one counter, so graphs replay one after another on one
    stream, never concurrently."""
    key = (device.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.empty((1,), dtype=torch.int32, device=device)
    return _COUNTERS[key]


_CAPTURE_STREAMS = {}  # device index -> the side stream captures run on


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream on which `capture_graph` captures for `device`."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return _CAPTURE_STREAMS[idx]


class CapturedGraph:
    """One captured CUDA graph with what its capture measured.

    `launches` holds, for each kernel counter passed to `capture_graph`,
    the launches the capture recorded: the wrappers count a launch when
    they enqueue it, which under a capture happens once, while every
    `replay()` runs them again without a wrapper call: `launches` is what
    a replay is expected to launch, and the kernels' device tallies
    (`utils.launches.device_launches`) count what ran.
    `capture_s` and `instantiate_s` are host seconds, `pool_bytes` the
    device memory the graph's private pool holds, `nodes` and
    `kernel_nodes` the graph's nodes and kernel nodes as the CUDA runtime
    counts them (`graph_node_counts`). `name` names its replay span
    (`<name>.replay`) and node counter (`<name>.graph_nodes`)."""

    def __init__(self, graph, launches: Dict[str, int], capture_s: float,
                 instantiate_s: float, pool_bytes: int, name: str = "graph",
                 nodes: int = 0, kernel_nodes: int = 0):
        self.graph = graph
        self.launches = launches
        self.capture_s = capture_s
        self.instantiate_s = instantiate_s
        self.pool_bytes = pool_bytes
        self.name = name
        self.nodes = nodes
        self.kernel_nodes = kernel_nodes
        self.replays = 0
        self._span = name + ".replay"

    def replay(self) -> None:
        """Launch the graph on the current stream (the span
        `<name>.replay`: the host's `graph.replay()`, torch's generator
        prologue and `cudaGraphLaunch`)."""
        with profiling.span(self._span):
            self.graph.replay()
        self.replays += 1


_GRAPH_API = None
KERNEL_NODE = 0   # cudaGraphNodeTypeKernel


def _graph_api():
    """(cudaGraphGetNodes, cudaGraphNodeGetType) of the CUDA runtime that
    torch loaded, found by its soname."""
    global _GRAPH_API
    if _GRAPH_API is None:
        rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
        get, typ = rt.cudaGraphGetNodes, rt.cudaGraphNodeGetType
        get.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.POINTER(ctypes.c_size_t)]
        typ.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        _GRAPH_API = (get, typ)
    return _GRAPH_API


def graph_node_counts(graph) -> Tuple[int, int]:
    """(nodes, kernel nodes) of a captured `torch.cuda.CUDAGraph` made with
    `keep_graph=True`, from the CUDA runtime (`cudaGraphGetNodes`,
    `cudaGraphNodeGetType` on `raw_cuda_graph()`)."""
    get, typ = _graph_api()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = get(raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if err == 0:
        err = get(raw, nodes, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"counting a graph's nodes failed: error {err}")
    kind, kernels = ctypes.c_int(-1), 0
    for i in range(n.value):
        err = typ(nodes[i], ctypes.byref(kind))
        if err != 0:
            raise RuntimeError(f"reading a graph node's type failed: "
                               f"error {err}")
        kernels += kind.value == KERNEL_NODE
    return n.value, kernels


def _pool_bytes(pool) -> int:
    """Bytes of the segments the caching allocator holds for `pool`."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def capture_graph(fn: Callable[[], None], device: torch.device,
                  generators: Sequence[torch.Generator] = (),
                  counters: Optional[Callable[[], Dict[str, int]]] = None,
                  pool=None, name: str = "graph") -> CapturedGraph:
    """Capture `fn()` as a CUDA graph on `device`'s side stream.

    `fn` must already have run once eagerly with the same shapes (that run
    builds the lazy tables, the kernels' libraries and their launch plans),
    and it must make no host round trip: a sync, a host-to-device copy or
    a value read on the host makes the capture fail, and the error is
    raised here. Every generator that `fn` draws from is registered with
    the graph, so each replay reads the generator's seed and offset as
    they stand at the replay (reseed with `manual_seed` before it).
    `counters()` returns the kernel wrappers' launch counters; their
    increase during the capture is the graph's `launches`. The kernels'
    scratch (`stream_counter`) and launch tally (`utils.launches`) are
    made before the capture, outside the graph's pool. The graph keeps
    its private memory pool, which is released with it; with `pool` (an
    earlier graph's `graph.pool()`) it allocates from that one instead,
    which is sound where neither graph leaves a live tensor in the pool
    and the two never replay at once. After the timed capture and
    instantiation the graph's nodes are counted (`graph_node_counts`) and
    kept as the counter `<name>.graph_nodes`; `name` also names the
    replay's span.

    A train step's backward is captured too: autograd runs it on its own
    device thread, on the stream each forward op ran on (here the side
    stream), and the capture takes every launch on that stream whichever
    thread makes it; the gradients it allocates come from the graph's
    pool and die inside the step."""
    from .launches import device_tally
    stream = capture_stream(device)
    stream_counter(device, stream.cuda_stream)
    device_tally(device)
    # keep_graph: instantiate apart from the capture, to time each
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for gen in generators:
        graph.register_generator_state(gen)
    before = dict(counters()) if counters is not None else {}
    torch.cuda.synchronize(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    t0 = time.perf_counter()
    with torch.cuda.device(device), torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture was already invalidated by fn's error
            raise
        graph.capture_end()
    t1 = time.perf_counter()
    graph.instantiate()
    torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    after = dict(counters()) if counters is not None else {}
    launches = {k: after[k] - before.get(k, 0) for k in after}
    nodes, kernel_nodes = graph_node_counts(graph)
    profiling.set_counter(name + ".graph_nodes", nodes)
    profiling.set_counter(name + ".kernel_nodes", kernel_nodes)
    return CapturedGraph(graph, launches, t1 - t0, t2 - t1,
                         _pool_bytes(graph.pool()), name, nodes, kernel_nodes)


def synchronize(device: torch.device) -> None:
    """Wait for queued work on `device` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ~5 ms of a 2 GHz clock: longer than the host takes to enqueue 20 calls
# of a ctypes-bound wrapper
HOLD_CYCLES = 10_000_000


def time_ms(fn, iters: int, warm: int = 1) -> float:
    """Mean device ms per call of `fn` over `iters` calls after `warm`
    untimed ones, by CUDA events on the current stream (needs a card).

    The stream is held busy (`torch.cuda._sleep`) while the host enqueues
    the timed calls, so a call whose kernel is shorter than its host side
    (a ctypes launch takes tens of us) is timed by its kernels, not by its
    launch. A loop of eager ops that outlasts the hold is still timed at
    the host's pace."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


FLUSH_BYTES = 128 << 20  # more than the 50 MB L2 of an H100


def time_cold_ms(fn, reps: int, flush_bytes: int = FLUSH_BYTES) -> list:
    """Device ms of each of `reps` calls of `fn`, each made after writing a
    `flush_bytes` buffer (so that what the call reads comes from device
    memory, not L2), with CUDA events around the call alone. The stream is
    held while the host enqueues, as in `time_ms`."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for rep in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES // 10)
        flush.fill_(rep)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]
