"""The port's counterparts of the JAX package's TPU probes under ``tools/``
(``python -m video2music_tpu_torch.tools.<name>`` on the card): their
kernels are csrc/probes.cu."""

from __future__ import annotations

import math

L2_BYTES = 50 * 1024 ** 2  # the H100's L2 (cudaDeviceProp.l2CacheSize)
SMS = 132  # the H100 SXM's streaming multiprocessors


def sm_count(device) -> int:
    """The card's streaming multiprocessors (SMS off the card)."""
    import torch
    if device.type != "cuda":
        return SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def l2_bytes(device) -> int:
    """The card's L2 in bytes (L2_BYTES where torch does not say)."""
    import torch
    props = torch.cuda.get_device_properties(device)
    return getattr(props, "L2_cache_size", L2_BYTES) or L2_BYTES


def cold_copies(call_bytes: int, l2_bytes: int = L2_BYTES) -> int:
    """Copies of a call's inputs that a cold timing rotates over: one pass
    over them reads at least twice the L2, so no copy is still in the L2
    when its turn comes again; at least 2."""
    return max(2, math.ceil(2 * l2_bytes / max(1, call_bytes)))


def require_cuda(what: str):
    """The card's torch device; raises SystemExit without one (a probe
    measures the card and has no CPU result to give)."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{what}: torch.cuda.is_available() is False; this "
                         "probe needs an NVIDIA GPU")
    return torch.device("cuda")


def graph_us(fn, iters: int = 100, reps: int = 5) -> float:
    """Device microseconds per call of fn with the caches warm: ``iters``
    calls on the same inputs captured into one CUDA graph, replayed
    ``reps`` times between CUDA events after a warm-up, so the host's
    launch overhead is excluded."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (reps * iters)


def cold_us(fns, reps: int = 5) -> float:
    """Device microseconds per call with the caches cold: one call of each
    of ``fns`` (the same function on the copies of its inputs that
    :func:`cold_copies` counts) captured in turn into one CUDA graph,
    replayed ``reps`` times between CUDA events after a warm-up."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (reps * len(fns))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]
