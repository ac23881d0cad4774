"""Start a world of W ranks on one machine: W fresh Python processes, each
running ``package.module:function(payload)`` with ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and a ``file://`` rendezvous (``V2M_INIT_METHOD``) set, so
``parallel.create_mesh`` joins the world there. The ranks start with
``python -m video2music_tpu_torch.parallel.launch``: they import the
function's module and the port, nothing of the caller's.

A rank's return value (anything ``torch.save`` takes) comes back through
a file in the work directory; a rank that fails stops the others and the
call raises.

    results = spawn("mypkg.mod:fn", 4, payload, workdir=tmp)
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
from typing import Any, List, Optional

import torch

from .mesh import INIT_METHOD_ENV


def _paths(workdir: str):
    return (os.path.join(workdir, "payload.pt"),
            os.path.join(workdir, "rendezvous"))


def _result_path(workdir: str, rank: int) -> str:
    return os.path.join(workdir, f"result_{rank}.pt")


def start(fn: str, world_size: int, payload: Any = None, *, workdir: str,
          threads: Optional[int] = None, env: Optional[dict] = None):
    """Start the ranks; returns their processes (see :func:`join`)."""
    os.makedirs(workdir, exist_ok=True)
    payload_path, rdv = _paths(workdir)
    torch.save(payload, payload_path)
    if os.path.exists(rdv):
        os.remove(rdv)
    procs = []
    for rank in range(world_size):
        e = dict(os.environ if env is None else env)
        e.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                 LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size))
        e[INIT_METHOD_ENV] = "file://" + os.path.abspath(rdv)
        if threads:
            e["V2M_RANK_THREADS"] = str(threads)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "video2music_tpu_torch.parallel.launch",
             workdir, fn], env=e))
    return procs


def join(procs, workdir: str, timeout: Optional[float] = None) -> List[Any]:
    """Wait for the ranks of :func:`start`; stop them all if one fails or
    the timeout passes. Returns each rank's result."""
    t_end = None if timeout is None else time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0]} exited with code "
                                   f"{procs[bad[0]].returncode}")
            if t_end is not None and time.time() > t_end:
                raise RuntimeError(f"the world did not finish in {timeout} s")
            time.sleep(0.05)
        bad = [i for i, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"rank {bad[0]} exited with code "
                               f"{procs[bad[0]].returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for rank in range(len(procs)):
        path = _result_path(workdir, rank)
        out.append(torch.load(path, weights_only=False)
                   if os.path.exists(path) else None)
    return out


def spawn(fn: str, world_size: int, payload: Any = None, *, workdir: str,
          timeout: Optional[float] = None, threads: Optional[int] = None,
          env: Optional[dict] = None) -> List[Any]:
    """Run ``fn(payload)`` on every rank of a new world of ``world_size``
    processes; returns the ranks' results in rank order."""
    return join(start(fn, world_size, payload, workdir=workdir,
                      threads=threads, env=env), workdir, timeout)


def _main(workdir: str, fn: str) -> None:
    threads = os.environ.get("V2M_RANK_THREADS")
    if threads:
        torch.set_num_threads(int(threads))
    module, name = fn.split(":")
    target = getattr(importlib.import_module(module), name)
    payload = torch.load(_paths(workdir)[0], weights_only=False)
    result = target(payload)
    if result is not None:
        rank = int(os.environ["RANK"])
        tmp = _result_path(workdir, rank) + ".tmp"
        torch.save(result, tmp)
        os.replace(tmp, _result_path(workdir, rank))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(*sys.argv[1:3])
