"""What bounds the batched decode attention: its core timed alone on the card
(counterpart of tools/kv_traffic_probe.py, row 13 of the kernel table;
kernels csrc/probes.cu).

    python -m video2music_tpu_torch.tools.kv_traffic_probe [-B 32] [-S 300]
        [-D 512] [-H 8] [-pos P]

Four modes over B clips' (S, D) K and V slabs (csrc/probes.cu, one
launch a call each):

  bf16    per clip and head, softmax over the cache rows 0..pos of
          q . k / sqrt(hd) in f32, then P . V (bf16 slabs): each warp
          issues the K and V loads of its next rows before any arithmetic
          and folds them in with an online softmax (a head's rows over a
          thread-block cluster where the (clip, head) pairs are few);
  int8    the same over int8 slabs with per-row f32 scales folded into the
          logits (k) and the probabilities (v): half the cache bytes;
  floor   a kernel that reads every slab byte and reduces it (per group of
          8 clips the column sums of K and V, plus q): the cache-traffic
          floor, one launch, the same bits every run;
  noattn  q * 1.0001: the launch and the q / out traffic alone.

Prints one JSON line: each mode's microseconds per call warm (the same
slabs every call: they stay in the 50 MB L2) and cold (``cold_<mode>``:
calls rotating over enough copies that one pass reads twice the L2), the
slab bytes, each attention mode's bound at 3.35 TB/s, the floor's read
rate warm and cold, and the time of ``F.scaled_dot_product_attention``
for the bf16 core (q (B, H, 1, hd) against the first pos + 1 rows), the
library call for the same function, warm and cold, with the card's name
and power limit. The row-6 widths are B=16 and 64 (``-B``). Each function
dispatches by device: CPU tensors take the plain versions below (the
tests hold them to the JAX probe), CUDA tensors the kernels, whose limits
:func:`attend_fault` and :func:`floor_fault` state.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import kernels
from . import (L2_BYTES, card, cold_copies, cold_us, graph_us, l2_bytes,
               require_cuda, sm_count)

HBM_BYTES_PER_S = 3.35e12
FLOOR_BLOCK = 8  # clips a floor group sums over (the JAX probe's BLOCK_B)
MAX_CLUSTER = 8          # blocks a head's rows split over (csrc/probes.cu)
ATTEND_MIN_ROWS = 16     # a cluster doubles only while its blocks keep 2x
FLOOR_SMALL_BYTES = 24 * 2 ** 20  # the floor's plan: slabs up to this


def attend_plain(q, k, v, pos: int, H: int, k_scale=None, v_scale=None):
    """The decode-attention core in plain PyTorch. q (B, D); k, v (B, S, D)
    (int8 with ``k_scale`` / ``v_scale`` (B, S) f32 row scales); rows
    0..pos. Per (clip, head): logits q . k * hd**-0.5 (* k_scale) in f32,
    softmax, probabilities (* v_scale) times V in f32; out (B, D) bf16."""
    B, S, D = k.shape
    hd, n = D // H, pos + 1
    qh = q.float().view(B, H, hd)
    kh = k[:, :n].float().view(B, n, H, hd)
    logits = torch.einsum("bhd,bshd->bhs", qh, kh) * hd ** -0.5
    if k_scale is not None:
        logits = logits * k_scale[:, None, :n].float()
    p = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, None, :n].float()
    out = torch.einsum("bhs,bshd->bhd", p, v[:, :n].float().view(B, n, H, hd))
    return out.reshape(B, D).to(torch.bfloat16)


def floor_plain(q, k, v, block: int = FLOOR_BLOCK):
    """The floor in plain PyTorch: for each group of ``block`` clips, the
    f32 column sums of its K rows plus those of its V rows, plus each
    clip's q; out (B, D) bf16."""
    B, S, D = k.shape
    ks = k.float().view(B // block, block * S, D).sum(1)
    vs = v.float().view(B // block, block * S, D).sum(1)
    sums = (ks + vs).repeat_interleave(block, dim=0)
    return (sums + q.float()).to(torch.bfloat16)


def noattn_plain(q):
    """q * 1.0001 in f32, rounded to bf16."""
    return (q.float() * 1.0001).to(torch.bfloat16)


def attend_fault(B: int, S: int, D: int, H: int, pos: int, int8: bool):
    """Why the core's kernel cannot take this shape, or None: D a multiple
    of H, the head size hd = D / H a multiple of 8 (bf16) or 16 (int8:
    16-byte row pieces) and at most 128 (a row group's lanes), and
    0 <= pos < S."""
    if B < 1 or H < 1 or D < 1 or D % H:
        return f"H={H} heads do not divide D={D}"
    hd, unit = D // H, 16 if int8 else 8
    if hd % unit or hd > 128:
        return (f"head size {hd}: the {'int8' if int8 else 'bf16'} core "
                f"takes multiples of {unit} up to 128")
    if not 0 <= pos < S:
        return f"pos {pos} outside the cache's {S} rows"
    return None


def attend_plan(B: int, H: int, rows: int, sms: int = 132) -> tuple:
    """(cluster, per): each (clip, head)'s ``rows`` split over a
    thread-block cluster of ``cluster`` blocks of ``per`` rows, doubled
    (up to MAX_CLUSTER) while the (clip, head) pairs times it stay within
    half the card's SMs and each block would keep ATTEND_MIN_ROWS rows
    twice over: on an H100 a cluster cost more than it gave once every SM
    had a (clip, head) (PERF.md, PR 19). A block's warps stream their
    shares of its rows, so ``per`` has no limit."""
    cluster = 1
    while (cluster < MAX_CLUSTER and 2 * B * H * cluster <= sms
           and rows >= 2 * ATTEND_MIN_ROWS * cluster):
        cluster *= 2
    return cluster, -(-rows // cluster)


def floor_fault(B: int, S: int, D: int, block: int):
    """Why the floor's kernel cannot take this shape, or None: B clips in
    whole groups of ``block``, S >= 1, D a multiple of 8 (16-byte loads)."""
    if block < 1 or B < block or B % block:
        return f"B={B} is no positive multiple of block={block}"
    if S < 1 or D < 8 or D % 8:
        return f"S={S}, D={D}: the floor takes S >= 1 and D a multiple of 8"
    return None


def floor_plan(B: int, S: int, D: int, block: int, sms: int = 132) -> tuple:
    """(width, slices, chunks): the floor's grid. Each group's (block S, D)
    slabs are cut into ``slices`` column slices of ``width`` and ``chunks``
    contiguous row ranges (no more than the rows); one range a slice needs
    no partials and no ticket. Up to FLOOR_SMALL_BYTES of slabs, slices of
    32 columns and about one block an SM; above, slices of 64 and about two
    blocks an SM (the ranges rounded to the nearest count): the faster
    plans of a sweep on an H100 (PERF.md, PR 19)."""
    small = 2 * B * S * D * 2 <= FLOOR_SMALL_BYTES
    width = min(D, 32 if small else 64)
    slices = -(-D // width)
    tiles = (B // block) * slices
    blocks = (1 if small else 2) * sms
    chunks = max(1, min(block * S, (2 * blocks + tiles) // (2 * tiles)))
    return width, slices, chunks


_floor_ws = {}  # (device, groups, slices, chunks, width) -> (ws, tickets)


def floor_workspace(device, groups: int, slices: int, chunks: int,
                    width: int):
    """The floor's partial rows (f32, no initial value) and its tickets
    (int32 zeros, made once: every call leaves them zero), kept for the
    next call on the same plan. Calls on one stream only."""
    key = (device, groups, slices, chunks, width)
    if key not in _floor_ws:
        import torch
        _floor_ws[key] = (
            torch.empty(groups * slices * chunks * width, device=device,
                        dtype=torch.float32),
            torch.zeros(groups * slices, device=device, dtype=torch.int32))
    return _floor_ws[key]


def attend(q, k, v, pos: int, H: int, k_scale=None, v_scale=None):
    """The core (:func:`attend_plain`) on the card: bf16 or int8 slabs."""
    what = "kv_traffic_probe.attend"
    if kernels.use_plain(q, what):
        return attend_plain(q, k, v, pos, H, k_scale, v_scale)
    B, S, D = k.shape
    quant = k.dtype == torch.int8
    kernels.require(q.shape == (B, D) and q.dtype == torch.bfloat16
                    and v.shape == k.shape and v.dtype == k.dtype
                    and k.dtype in (torch.bfloat16, torch.int8), what,
                    "q (B, D) bf16, k and v (B, S, D) bf16 or int8")
    fault = attend_fault(B, S, D, H, pos, quant)
    kernels.require(fault is None, what, str(fault))
    if quant:
        kernels.require(k_scale is not None and v_scale is not None
                        and k_scale.shape == (B, S)
                        and v_scale.shape == (B, S), what,
                        "int8 slabs need (B, S) row scales")
        kernels.require_like({"v_scale": v_scale}, k_scale, what)
    tensors = [t for t in (q, k, v, k_scale, v_scale) if t is not None]
    kernels.require(all(t.is_cuda and t.is_contiguous() for t in tensors)
                    and all(t.data_ptr() % 16 == 0 for t in (k, v)),
                    what, "contiguous CUDA tensors, k and v 16-byte aligned")
    cluster, per = attend_plan(B, H, pos + 1, sm_count(q.device))
    out = torch.empty_like(q)
    status = kernels.library().v2m_kv_probe_attend(
        2 if quant else 1, kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
        kernels.ptr(k_scale if quant else None),
        kernels.ptr(v_scale if quant else None), kernels.ptr(out), B, S, D, H,
        pos, cluster, per, kernels.stream_of(q))
    kernels.check(status, what)
    attend.launches += 1
    return out


def floor(q, k, v, block: int = FLOOR_BLOCK):
    """The floor (:func:`floor_plain`) on the card."""
    what = "kv_traffic_probe.floor"
    if kernels.use_plain(q, what):
        return floor_plain(q, k, v, block)
    B, S, D = k.shape
    kernels.require(q.shape == (B, D) and v.shape == k.shape, what,
                    "q (B, D), k and v (B, S, D)")
    fault = floor_fault(B, S, D, block)
    kernels.require(fault is None, what, str(fault))
    kernels.require_like({"k": k, "v": v}, q, what)
    kernels.require(q.dtype == torch.bfloat16 and q.is_contiguous(), what,
                    "bf16 tensors")
    width, slices, chunks = floor_plan(B, S, D, block, sm_count(q.device))
    ws, tickets = floor_workspace(q.device, B // block, slices, chunks, width)
    out = torch.empty_like(q)
    status = kernels.library().v2m_kv_probe_floor(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(out),
        kernels.ptr(ws), kernels.ptr(tickets), B, S, D, block, width, chunks,
        kernels.stream_of(q))
    kernels.check(status, what)
    floor.launches += 1
    return out


def noattn(q):
    """q * 1.0001 (:func:`noattn_plain`) on the card."""
    what = "kv_traffic_probe.noattn"
    if kernels.use_plain(q, what):
        return noattn_plain(q)
    kernels.require(q.dtype == torch.bfloat16 and q.is_contiguous(), what,
                    "a contiguous bf16 q")
    out = torch.empty_like(q)
    status = kernels.library().v2m_kv_probe_noattn(
        kernels.ptr(q), kernels.ptr(out), q.numel(), kernels.stream_of(q))
    kernels.check(status, what)
    noattn.launches += 1
    return out


attend.launches = floor.launches = noattn.launches = 0


def inputs(B: int, S: int, D: int, device, seed: int = 0):
    """The probe's slabs, made from ``seed`` on the device: q (B, D) and
    bf16 K / V (B, S, D) of N(0, 1); int8 K / V of uniform integers in
    [-127, 127] with (B, S) scales in [0.01, 0.1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    bf = dict(device=device, dtype=torch.bfloat16)
    q = torch.randn(B, D, generator=g, device=device).to(**bf)
    k = torch.randn(B, S, D, generator=g, device=device).to(**bf)
    v = torch.randn(B, S, D, generator=g, device=device).to(**bf)
    ki, vi = (torch.randint(-127, 128, (B, S, D), generator=g, device=device,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(B, S, generator=g, device=device) * 0.09 + 0.01
              for _ in range(2))
    return dict(q=q, k=k, v=v, k8=ki, v8=vi, ks=ks, vs=vs)


def slab_bytes(B: int, S: int, D: int) -> dict:
    """Cache bytes a call reads at pos = S - 1: both bf16 slabs; both int8
    slabs and their f32 scales (the JAX probe's accounting)."""
    return dict(bf16=2 * B * S * D * 2, int8=B * S * D * 2 + B * S * 2 * 4)


def modes(x: dict, pos: int, H: int) -> dict:
    """The four modes on the slabs ``x`` (:func:`inputs`): name -> (kernel
    call, plain call)."""
    q = x["q"]
    return {
        "bf16": (lambda: attend(q, x["k"], x["v"], pos, H),
                 lambda: attend_plain(q, x["k"], x["v"], pos, H)),
        "int8": (lambda: attend(q, x["k8"], x["v8"], pos, H, x["ks"], x["vs"]),
                 lambda: attend_plain(q, x["k8"], x["v8"], pos, H, x["ks"],
                                      x["vs"])),
        "floor": (lambda: floor(q, x["k"], x["v"]),
                  lambda: floor_plain(q, x["k"], x["v"])),
        "noattn": (lambda: noattn(q), lambda: noattn_plain(q)),
    }


# the inputs of each mode (keys of :func:`inputs`)
MODE_INPUTS = {"bf16": ("q", "k", "v"), "int8": ("q", "k8", "v8", "ks", "vs"),
               "floor": ("q", "k", "v"), "noattn": ("q",)}


def input_bytes(x: dict, mode: str) -> int:
    """Bytes of the inputs one call of ``mode`` reads."""
    return sum(x[n].numel() * x[n].element_size() for n in MODE_INPUTS[mode])


def cold_calls(x: dict, mode: str, pos: int, H: int,
               l2_bytes: int = L2_BYTES) -> list:
    """The kernel of ``mode`` on :func:`cold_copies` copies of its inputs,
    one call a copy, for :func:`cold_us`."""
    calls = []
    for _ in range(cold_copies(input_bytes(x, mode), l2_bytes)):
        copy = {n: x[n].clone() for n in MODE_INPUTS[mode]}
        calls.append(modes(copy, pos, H)[mode][0])
    return calls


def sdpa_call(x: dict, pos: int, H: int):
    """F.scaled_dot_product_attention on the bf16 core's inputs: q (B, H, 1,
    hd) against the first pos + 1 rows (the (B, H, rows, hd) copies made
    here, outside the call)."""
    q = x["q"]
    B, D = q.shape
    hd, n = D // H, pos + 1
    qs = q.view(B, H, 1, hd)
    kh, vh = (t[:, :n].view(B, n, H, hd).transpose(1, 2).contiguous()
              for t in (x["k"], x["v"]))
    return lambda: torch.nn.functional.scaled_dot_product_attention(qs, kh,
                                                                    vh)


def cold_sdpa_us(x: dict, pos: int, H: int, l2: int) -> float:
    """SDPA's time with the caches cold: each call on its own copies of
    the first pos + 1 rows."""
    B, S, D = x["k"].shape
    n = cold_copies(2 * B * (pos + 1) * D * 2, l2)
    return cold_us([sdpa_call(x, pos, H) for _ in range(n)])


def probe(B: int = 32, S: int = 300, D: int = 512, H: int = 8, pos=None,
          iters: int = 100) -> dict:
    """Every mode on the card, held to its plain version and timed warm
    and cold, with the slab bytes, the bounds, the floor's read rates and
    SDPA's time; returns the JSON object."""
    dev = require_cuda("kv_traffic_probe")
    pos = S - 1 if pos is None else pos
    x = inputs(B, S, D, dev)
    l2 = l2_bytes(dev)
    out = dict(B=B, S=S, D=D, H=H, pos=pos)
    for name, (kernel, plain) in modes(x, pos, H).items():
        got, want = kernel().float(), plain().float()
        err = (got - want).abs().max().item()
        rel = err / max(want.abs().max().item(), 1e-30)
        if rel > 2e-2:  # bf16 outputs of f32 sums in another order
            raise SystemExit(f"kv_traffic_probe {name}: max error {err:.3e} "
                             f"({rel:.3e} of the largest value) against the "
                             "plain version")
        out[name] = round(graph_us(kernel, iters), 3)
        out[f"cold_{name}"] = round(cold_us(cold_calls(x, name, pos, H, l2)),
                                    3)
        out[f"max_abs_err_{name}"] = err
    out["sdpa_bf16"] = round(graph_us(sdpa_call(x, pos, H), iters), 3)
    out["cold_sdpa_bf16"] = round(cold_sdpa_us(x, pos, H, l2), 3)
    sb = slab_bytes(B, S, D)
    out["slab_bytes_bf16"], out["slab_bytes_int8"] = sb["bf16"], sb["int8"]
    out["floor_TB_s"] = round(sb["bf16"] / out["floor"] / 1e6, 3)
    out["cold_floor_TB_s"] = round(sb["bf16"] / out["cold_floor"] / 1e6, 3)
    out["bound_us_bf16"] = round(sb["bf16"] / HBM_BYTES_PER_S * 1e6, 3)
    out["bound_us_int8"] = round(sb["int8"] / HBM_BYTES_PER_S * 1e6, 3)
    out["card"] = card()
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-B", type=int, default=32, help="clips (row 6: 16, 64)")
    p.add_argument("-S", type=int, default=300)
    p.add_argument("-D", type=int, default=512)
    p.add_argument("-H", type=int, default=8)
    p.add_argument("-pos", type=int, default=None, help="default S - 1")
    a = p.parse_args(argv)
    print(json.dumps(probe(a.B, a.S, a.D, a.H, a.pos)), flush=True)


if __name__ == "__main__":
    main()
