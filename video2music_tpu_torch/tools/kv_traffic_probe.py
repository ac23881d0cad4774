"""What bounds the batched decode attention: its core timed alone on the card
(counterpart of tools/kv_traffic_probe.py, row 13 of the kernel table;
kernels csrc/probes.cu).

    python -m video2music_tpu_torch.tools.kv_traffic_probe [-B 32] [-S 300]
        [-D 512] [-H 8] [-pos P]

Four modes over B clips' (S, D) K and V slabs, each timed by CUDA-graph
replay of many launches:

  bf16    per clip and head, softmax over the cache rows 0..pos of
          q . k / sqrt(hd) in f32, then P . V (bf16 slabs);
  int8    the same over int8 slabs with per-row f32 scales folded into the
          logits (k) and the probabilities (v): half the cache bytes;
  floor   a kernel that reads every slab byte and reduces it (per block of
          8 clips the column sums of K and V, plus q): the cache-traffic
          floor;
  noattn  q * 1.0001: the launch and the q / out traffic alone.

Prints one JSON line: each mode's microseconds per call, the slab bytes,
each attention mode's bound at 3.35 TB/s, and the time of
``F.scaled_dot_product_attention`` for the bf16 core (q (B, H, 1, hd)
against the first pos + 1 rows), the library call for the same function,
with the card's name and power limit. The row-6 widths are B=16 and 64
(``-B``). Each function dispatches by device: CPU tensors take the plain
versions below (the tests hold them to the JAX probe), CUDA tensors the
kernels.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import kernels
from . import card, graph_us, require_cuda

HBM_BYTES_PER_S = 3.35e12
FLOOR_BLOCK = 8  # clips a floor group sums over (the JAX probe's BLOCK_B)


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
    kernels.require(0 <= pos < S and D % H == 0, what, "bad pos or heads")
    if quant:
        kernels.require(k_scale is not None and v_scale is not None
                        and k_scale.shape == (B, S)
                        and v_scale.shape == (B, S), what,
                        "int8 slabs need (B, S) row scales")
        kernels.require_like({"v_scale": v_scale}, k_scale, what)
    tensors = [t for t in (q, k, v, k_scale, v_scale) if t is not None]
    kernels.require(all(t.is_cuda and t.is_contiguous() for t in tensors),
                    what, "contiguous CUDA tensors")
    out = torch.empty_like(q)
    status = kernels.library().v2m_kv_probe_attend(
        2 if quant else 1, kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
        kernels.ptr(k_scale if quant else None),
        kernels.ptr(v_scale if quant else None), kernels.ptr(out), B, S, D, H,
        pos, kernels.stream_of(q))
    kernels.check(status, what)
    attend.launches += 1
    return out


def floor(q, k, v, block: int = FLOOR_BLOCK):
    """The floor (:func:`floor_plain`) on the card."""
    what = "kv_traffic_probe.floor"
    if kernels.use_plain(q, what):
        return floor_plain(q, k, v, block)
    B, S, D = k.shape
    kernels.require(q.shape == (B, D) and v.shape == k.shape and B % block == 0,
                    what, "q (B, D), k and v (B, S, D), B a multiple of block")
    kernels.require_like({"k": k, "v": v}, q, what)
    kernels.require(q.dtype == torch.bfloat16 and q.is_contiguous(), what,
                    "bf16 tensors")
    sums = torch.zeros(B // block, D, device=q.device, dtype=torch.float32)
    out = torch.empty_like(q)
    status = kernels.library().v2m_kv_probe_floor(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(sums),
        kernels.ptr(out), B, S, D, block, kernels.stream_of(q))
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


def probe(B: int = 32, S: int = 300, D: int = 512, H: int = 8, pos=None,
          iters: int = 100) -> dict:
    """Every mode on the card, held to its plain version and timed, with
    the slab bytes, the bounds and SDPA's time; returns the JSON object."""
    dev = require_cuda("kv_traffic_probe")
    pos = S - 1 if pos is None else pos
    x = inputs(B, S, D, dev)
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
        out[f"max_abs_err_{name}"] = err
    out["sdpa_bf16"] = round(graph_us(sdpa_call(x, pos, H), iters), 3)
    sb = slab_bytes(B, S, D)
    out["slab_bytes_bf16"], out["slab_bytes_int8"] = sb["bf16"], sb["int8"]
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
