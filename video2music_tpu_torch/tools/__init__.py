"""The port's counterparts of the JAX package's TPU probes under ``tools/``
(``python -m video2music_tpu_torch.tools.<name>`` on the card): their
kernels are csrc/probes.cu."""

from __future__ import annotations


def require_cuda(what: str):
    """The card's torch device; raises SystemExit without one (a probe
    measures the card and has no CPU result to give)."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{what}: torch.cuda.is_available() is False; this "
                         "probe needs an NVIDIA GPU")
    return torch.device("cuda")


def graph_us(fn, iters: int = 100, reps: int = 5) -> float:
    """Device microseconds per call of fn: ``iters`` calls captured into
    one CUDA graph, replayed ``reps`` times between CUDA events after a
    warm-up, so the host's launch overhead is excluded."""
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


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]
