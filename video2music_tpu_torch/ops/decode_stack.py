"""Whole-run B=1 decode steps of AMT 2.2: one cooperative kernel,
csrc/decode_stack.cu, behind three wrappers.

Counterparts (ops/pallas_decode_stack.py):
  * decoder_segments, pack_decoder_segments, pack_monolith -> the same
    names here;
  * decode_segment_step (one run of same-kind layers, caches (n, S, D)),
    decode_monolith_step (the whole step: embed, every layer, final norm
    and head, caches (L, S, D)) and decode_flat_monolith_step (any run of
    layers with per-layer caches, the embed and the head optional) -> the
    same names here, each with a ``.launches`` counter.

The three TPU kernels compute one function and differ in how the TPU
addresses the weights (stacks in VMEM, a grid over layers, separate
operands). On Hopper one address per layer costs what one per stack costs,
so the packs hold per-layer views of the model's parameters (no stacked
copies) and every wrapper launches the same kernel over a per-layer pointer
table. The caches keep the JAX steps' layouts.

Each wrapper takes the plain version on a CPU tensor and launches the
kernel on a CUDA tensor (``kernels.use_plain``); shapes are checked on
both. The self caches are written in place at row ``pos``. A step closure
passes ``plans``, a dict it keeps across calls: the kernel's argument
struct, workspace and grid are built at the first call and reused while
the caches are the same tensors, so a call sets only pos, the input and
the output (decode/fused.py).

int8 weights are not taken here, as in the JAX package: int8 decode runs
the per-layer step (ops/decode_layer.py).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import kernels
from .decode_layer import (decode_layer_plain, decode_shape_fault,
                           embed_plain, head_plain, log_route,
                           logging_routes, pack_decoder_layers, pack_ends,
                           workspace_size)

_LAYER_KEYS = ("wqkv", "bqkv", "wo", "bo", "cwq", "cbq", "cwo", "cbo",
               "norm_scale", "norm_bias", "w1g", "b1g", "w2", "b2")
_DEEP_KEYS = ("gate_w", "gate_b", "ew1g", "eb1g", "ew2", "eb2")
_EMBED_KEYS = ("emb_root", "emb_attr", "lc_w", "lc_krow", "lc_b")
_HEAD_KEYS = ("dn_scale", "dn_bias", "wout", "bout")


# ---------------------------------------------------------------------------
# segments and packing
# ---------------------------------------------------------------------------

def decoder_segments(cfg) -> List[Dict]:
    """Runs of consecutive same-ffn-kind decoder layers:
    [{"kind": "swiglu"|"moe", "start": i, "layers": [i..j]}, ...]."""
    segs = []
    for i, spec in enumerate(cfg.decoder_layers):
        if segs and segs[-1]["kind"] == spec.ffn:
            segs[-1]["layers"].append(i)
        else:
            segs.append({"kind": spec.ffn, "start": i, "layers": [i]})
    return segs


def pack_decoder_segments(model) -> List[Dict]:
    """One dict per segment: its "kind", "start" and "layers", the
    :func:`pack_decoder_layers` dicts of its layers (views, not stacks)."""
    per_layer = pack_decoder_layers(model)
    return [dict(kind=seg["kind"], start=seg["start"],
                 layers=[per_layer[i] for i in seg["layers"]])
            for seg in decoder_segments(model.cfg)]


def pack_monolith(model) -> Dict:
    """The embed / head keys of :func:`pack_ends` plus "layers", every
    layer's :func:`pack_decoder_layers` dict."""
    return dict(pack_ends(model), layers=pack_decoder_layers(model))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def decode_flat_monolith_plain(token_root, token_attr, key, pos: int, layers,
                               head, caches, *, n_heads: int, k_top: int = 2,
                               rope=None, embed: bool = True,
                               fold_head: bool = True, x=None):
    """Plain version of :func:`decode_flat_monolith_step`: the embed of
    ops/decode_layer.py's ends (emb rows summed in f32), each layer's plain
    step, the folded head."""
    if embed:
        x = embed_plain(token_root, token_attr, key, head, caches[0][0].dtype)
    for layer, (kc, vc, kx, vx) in zip(layers, caches):
        x = decode_layer_plain(x, pos, layer, kc, vc, kx, vx, n_heads=n_heads,
                               k_top=k_top, rope=rope)
    return head_plain(x, head) if fold_head else x


def _stacked(k_cache, v_cache, k_cross, v_cross):
    return [(k_cache[i], v_cache[i], k_cross[i], v_cross[i])
            for i in range(k_cache.shape[0])]


def decode_segment_plain(x, pos: int, seg, k_cache, v_cache, k_cross,
                         v_cross, *, n_heads: int, k_top: int = 2, rope=None):
    """Plain version of :func:`decode_segment_step`."""
    return decode_flat_monolith_plain(
        None, None, None, pos, seg["layers"], None,
        _stacked(k_cache, v_cache, k_cross, v_cross), n_heads=n_heads,
        k_top=k_top, rope=rope, embed=False, fold_head=False, x=x)


def decode_monolith_plain(token_root, token_attr, key, pos: int, packed,
                          k_cache, v_cache, k_cross, v_cross, *,
                          n_heads: int, k_top: int = 2, rope=None,
                          embed: bool = True, fold_head: bool = True, x=None):
    """Plain version of :func:`decode_monolith_step`."""
    return decode_flat_monolith_plain(
        token_root, token_attr, key, pos, packed["layers"], packed,
        _stacked(k_cache, v_cache, k_cross, v_cross), n_heads=n_heads,
        k_top=k_top, rope=rope, embed=embed, fold_head=fold_head, x=x)


# ---------------------------------------------------------------------------
# the kernel's launch
# ---------------------------------------------------------------------------

def attention_floats(D: int, n_heads: int) -> int:
    """f32 scratch of the kernel's split attention (csrc/decode_stack.cu
    V2MStack.attn): for the self and the cross attention, each head's up
    to kernels.MAX_STACK_SPLITS splits of (o[head_dim], m, l, 2 pad)."""
    return 2 * n_heads * kernels.MAX_STACK_SPLITS * (D // n_heads + 4)


def _check_run(what: str, layers, caches, head, *, n_heads: int, k_top: int,
               embed: bool, fold_head: bool, x) -> None:
    """Shapes every path must agree on (checked before the dispatch)."""
    n = len(layers)
    kernels.require(1 <= n <= kernels.MAX_STACK_LAYERS, what,
                    f"{n} layers; the kernel takes 1 to "
                    f"{kernels.MAX_STACK_LAYERS}")
    kernels.require(len(caches) == n, what,
                    f"{len(caches)} cache sets for {n} layers")
    S, D = caches[0][0].shape
    Sm = caches[0][2].shape[0]
    F = layers[0]["w2"].shape[-1]
    kernels.require(n_heads > 0 and D % n_heads == 0, what,
                    f"bad head split D={D} H={n_heads}")
    for i, (layer, (kc, vc, kx, vx)) in enumerate(zip(layers, caches)):
        kernels.require(kc.shape == (S, D) and vc.shape == (S, D), what,
                        f"layer {i}: self caches must be (S, D) = ({S}, {D})")
        kernels.require(kx.shape == (Sm, D) and vx.shape == (Sm, D), what,
                        f"layer {i}: cross K/V must be (Sm, D) = ({Sm}, {D})")
        kernels.require(layer["wqkv"].shape == (3 * D, D)
                        and layer["w2"].shape == (D, F), what,
                        f"layer {i}: weights do not match D={D}, F={F}")
        kernels.require("wqkv_s" not in layer, what,
                        "int8 weights run through decode_layer_step")
        if "gate_w" in layer:
            E = layer["gate_w"].shape[0]
            kernels.require(1 <= k_top <= E, what,
                            f"k_top={k_top} must be in [1, E={E}]")
    if not embed:
        kernels.require(x is not None and tuple(x.shape) in ((1, D), (D,)),
                        what, f"x must be (1, D) = (1, {D}) without the "
                        "embed prologue")
    if embed or fold_head:
        kernels.require(head is not None, what, "the embed / head weights "
                        "are missing")


class _Run:
    """One run's launch: the argument struct with every pointer that does
    not move (weights, caches, rope tables, workspace), the grid and the
    shared memory, built once. :meth:`launch` sets pos, the input and the
    output and launches."""

    def __init__(self, what, layers, caches, head, *, n_heads, k_top, rope,
                 embed, fold_head):
        kc0 = caches[0][0]
        S, D = kc0.shape
        dev, dt = kc0.device, kc0.dtype
        self.what, self.embed, self.fold_head = what, embed, fold_head
        self.code = kernels.dtype_code(kc0, what)
        hd = D // n_heads
        F = layers[0]["w2"].shape[-1]
        deep = [l for l in layers if "gate_w" in l]
        E = deep[0]["gate_w"].shape[0] if deep else 0
        fault = decode_shape_fault(D, n_heads, (F,))
        kernels.require(fault is None, what, fault)
        kernels.require(all(l["w2"].shape[-1] == F for l in layers)
                        and all(l["gate_w"].shape[0] == E for l in deep),
                        what, "every layer needs the same d_ff and experts")
        tensors = {}
        for i, (layer, cache) in enumerate(zip(layers, caches)):
            tensors.update({f"{k}[{i}]": v for k, v in layer.items()})
            tensors.update({f"{k}[{i}]": v for k, v in zip(
                ("k_cache", "v_cache", "k_cross", "v_cross"), cache)})
        keys = (_EMBED_KEYS if embed else ()) + (_HEAD_KEYS if fold_head
                                                 else ())
        tensors.update({k: head[k] for k in keys})
        kernels.require_like(tensors, kc0, what)
        a = self.args = kernels.StackArgs()
        P = lambda t: kernels.ptr(t).value
        self.keep = [layers, caches, head]  # what the struct points into
        for i, (layer, (kc, vc, kx, vx)) in enumerate(zip(layers, caches)):
            t = a.layers[i]
            for name in _LAYER_KEYS + (_DEEP_KEYS if "gate_w" in layer
                                       else ()):
                setattr(t, name, P(layer[name]))
            t.k_cache, t.v_cache, t.k_cross, t.v_cross = (
                P(kc), P(vc), P(kx), P(vx))
        for name in keys:
            setattr(a, name, P(head[name]))
        if rope is not None:
            cos, sin = (t.to(device=dev, dtype=torch.float32).contiguous()
                        for t in rope)
            kernels.require(cos.shape[1] == hd // 2 and cos.shape[0] >= S,
                            what, "rope tables must be (>=S, head_dim/2)")
            a.rope_cos, a.rope_sin = P(cos), P(sin)
            self.keep.append((cos, sin))
        # the f32 workspace, the attention splits' triples, the arrival
        # counters (zero between launches: the kernel zeroes them at its
        # end) and each layer's expert ids
        self.work = torch.empty(workspace_size(D, F, k_top), device=dev,
                                dtype=torch.float32)
        self.attn = torch.empty(attention_floats(D, n_heads), device=dev,
                                dtype=torch.float32)
        self.sync = torch.zeros(2 * n_heads + 6, device=dev,
                                dtype=torch.int32)
        self.sel = torch.empty(len(layers) * k_top, device=dev,
                               dtype=torch.int32)
        self.moe_layers = [i for i, l in enumerate(layers) if "gate_w" in l]
        a.work, a.attn, a.sync, a.sel = (P(self.work), P(self.attn),
                                         P(self.sync), P(self.sel))
        Sm = caches[0][2].shape[0]
        self.n_out = head["wout"].shape[0] if fold_head else D
        a.D, a.H, a.F, a.E, a.k_top = D, n_heads, F, E, k_top
        a.S, a.Sm, a.n_out, a.n_layers = S, Sm, self.n_out, len(layers)
        self.S, self.D, self.dev, self.dt, self.k_top = S, D, dev, dt, k_top
        # the splits of a head's attention: one a kernels.STACK_TILE_ROWS
        # rows of the longer cache, at most kernels.MAX_STACK_SPLITS, fewer
        # where their triples would not fit the shared memory (the grid
        # call lowers the count)
        splits = ctypes.c_int(min(kernels.MAX_STACK_SPLITS,
                                  -(-max(S, Sm) // kernels.STACK_TILE_ROWS)))
        lib = kernels.library()
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        status = lib.v2m_decode_stack_grid(self.code, D, n_heads, F, E,
                                           k_top, ctypes.byref(splits),
                                           ctypes.byref(smem),
                                           ctypes.byref(blocks))
        kernels.check(status, what)
        a.max_splits, a.smem, a.grid = splits.value, smem.value, blocks.value
        self.lib = lib
        self.tensors = ()  # the caller's cache tensors (_new_run)

    def probe(self, pos: int, x=None, tokens=None) -> Dict[str, float]:
        """One launch of the kernel's probe instance (csrc/decode_stack.cu
        Probe): microseconds of each phase kind summed over the run's
        layers (from the previous boundary to the last block finishing
        it), of the embed and the head, and of the grid barriers' waits
        (from the last block's arrival to block 0's release); and, under
        "marks_block0" / "marks_last", block 0's and the last block's
        stamps at the points mark() numbers inside layer 1, in us from
        block 0's first (None where that block did not pass). Not counted
        as a launch of the wrapper."""
        n = kernels.STACK_PROBE_SLOTS
        marks = 1 + 2 * n + (n + 1) // 2
        buf = torch.zeros(marks + 64, device=self.dev, dtype=torch.int64)
        self.args.probe = buf.data_ptr()
        try:
            self.launch(pos, x=x, tokens=tokens)
        finally:
            self.args.probe = None
        t = buf.cpu().tolist()
        kinds = kernels.STACK_PROBE_KINDS
        slots = [(name, i * len(kinds) + k)
                 for i in range(self.args.n_layers)
                 for k, name in enumerate(kinds)]
        embed_slot = len(kinds) * kernels.MAX_STACK_LAYERS
        if self.embed:
            slots.insert(0, ("embed", embed_slot))
        slots.append(("head" if self.fold_head else "output", embed_slot + 1))
        out = {name: 0.0 for name, _ in slots}
        out["barrier_wait"] = 0.0
        prev = t[0]
        for name, s in slots:
            done, left = t[1 + 2 * s], t[2 + 2 * s]
            out[name] += (done - prev) / 1e3
            if left:
                out["barrier_wait"] += (left - done) / 1e3
            prev = left or done
        out["total"] = (prev - t[0]) / 1e3
        m0 = t[marks]
        out["marks_block0"] = [(v - m0) / 1e3 if v else None
                               for v in t[marks:marks + 32]]
        out["marks_last"] = [(v - m0) / 1e3 if v else None
                             for v in t[marks + 32:marks + 64]]
        return out

    def launch(self, pos: int, x=None, tokens=None) -> torch.Tensor:
        what, a = self.what, self.args
        kernels.require(0 <= pos < self.S, what,
                        f"pos {pos} outside cache of {self.S}")
        a.pos = pos
        if self.embed:
            root, attr, key = tokens
            root, attr = (t.reshape(-1)[:1].to(device=self.dev,
                                                dtype=torch.int32)
                          for t in (root, attr))
            key = key.reshape(-1)[:1].to(device=self.dev, dtype=torch.float32)
            a.token_root, a.token_attr = root.data_ptr(), attr.data_ptr()
            a.key = key.data_ptr()
        else:
            kernels.require(x.dtype == self.dt and x.device == self.dev
                            and x.is_contiguous() and x.numel() == self.D,
                            what, f"x must be a contiguous (1, {self.D}) "
                            f"{self.dt} tensor on {self.dev}")
            a.x = x.data_ptr()
        out = torch.empty(1, self.n_out, device=self.dev, dtype=self.dt)
        if self.fold_head:
            a.logits = out.data_ptr()
        else:
            a.y = out.data_ptr()
        status = self.lib.v2m_decode_stack(self.code, ctypes.byref(a),
                                           kernels.stream_of(out))
        kernels.check(status, what)
        if logging_routes():  # the run's sel is rewritten at every launch
            k = self.k_top
            for i in self.moe_layers:
                log_route(self.sel[i * k:(i + 1) * k].clone().view(1, k))
        return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b address the same elements: the same tensor, or views with
    one start, shape and strides (a step's chunk of stacked caches makes a
    new view each call)."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype
                      and a.device == b.device)


def _cached_run(plans: Optional[dict], tensors: Tuple) -> Optional[_Run]:
    """The caller's run when it was built for these very cache tensors."""
    run = plans.get("run") if plans is not None else None
    if (run is None or len(run.tensors) != len(tensors)
            or not all(_same(a, b) for a, b in zip(run.tensors, tensors))):
        return None
    return run


def _new_run(plans: Optional[dict], tensors: Tuple, what, layers, caches,
             head, **kw) -> _Run:
    run = _Run(what, layers, caches, head, **kw)
    run.tensors = tensors
    if plans is not None:
        plans["run"] = run
    return run


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def decode_flat_monolith_step(token_root, token_attr, key, pos: int,
                              layers: Sequence[Dict], head: Optional[Dict],
                              caches: Sequence[Tuple], *, n_heads: int,
                              k_top: int = 2, rope=None, embed: bool = True,
                              fold_head: bool = True, x=None,
                              plans: Optional[dict] = None):
    """A run of decoder layers at B=1 as one kernel launch.

    Args:
      token_root, token_attr, key: (1,) ids and key on the device (with
        ``embed``).
      pos: position of the current token (a host int).
      layers: :func:`pack_decoder_layers` dicts, one per layer of the run.
      head: :func:`pack_ends` (or :func:`pack_monolith`) keys, for the
        embed prologue and the final-LayerNorm + head epilogue.
      caches: per layer (k_cache, v_cache, k_cross, v_cross): (S, D) self
        caches written in place at row pos, (Sm, D) primed cross K/V.
      embed: fold the chord embedding + Linear_chord in; otherwise pass
        ``x`` (1, D) in the compute dtype.
      fold_head: fold the final LayerNorm + chord head in.
      plans: a dict the caller keeps across calls (see the module doc).
    Returns:
      logits (1, n_out) with ``fold_head``, else the run's output y (1, D).
    """
    what = "decode_flat_monolith_step"
    tensors = tuple(t for c in caches for t in c)
    run = _cached_run(plans, tensors)
    if run is None:
        _check_run(what, layers, caches, head, n_heads=n_heads, k_top=k_top,
                   embed=embed, fold_head=fold_head, x=x)
        if kernels.use_plain(caches[0][0], what):
            return decode_flat_monolith_plain(
                token_root, token_attr, key, pos, layers, head, caches,
                n_heads=n_heads, k_top=k_top, rope=rope, embed=embed,
                fold_head=fold_head, x=x)
        run = _new_run(plans, tensors, what, layers, caches, head,
                       n_heads=n_heads, k_top=k_top, rope=rope, embed=embed,
                       fold_head=fold_head)
    out = run.launch(pos, x=x, tokens=(token_root, token_attr, key))
    decode_flat_monolith_step.launches += 1
    return out


decode_flat_monolith_step.launches = 0


def decode_segment_step(x, pos: int, seg: Dict, k_cache, v_cache, k_cross,
                        v_cross, *, n_heads: int, k_top: int = 2, rope=None,
                        resident: bool = True,
                        plans: Optional[dict] = None):
    """One segment (a run of same-kind layers) for one decode step.

    Args:
      x: (1, D) activation entering the segment, in the compute dtype.
      seg: one :func:`pack_decoder_segments` dict.
      k_cache, v_cache: (n, S, D) stacked self caches, written in place.
      k_cross, v_cross: (n, Sm, D) stacked primed memory K/V.
      resident: the TPU kernel's choice between weights resident in VMEM
        and one layer's block per grid cell; one kernel serves both here.
    Returns:
      y (1, D) after the whole segment.
    """
    del resident
    what = "decode_segment_step"
    tensors = (k_cache, v_cache, k_cross, v_cross)
    run = _cached_run(plans, tensors)
    if run is None:
        caches = _stacked(*tensors)
        _check_run(what, seg["layers"], caches, None, n_heads=n_heads,
                   k_top=k_top, embed=False, fold_head=False, x=x)
        if kernels.use_plain(k_cache, what):
            return decode_segment_plain(x, pos, seg, k_cache, v_cache,
                                        k_cross, v_cross, n_heads=n_heads,
                                        k_top=k_top, rope=rope)
        run = _new_run(plans, tensors, what, seg["layers"], caches, None,
                       n_heads=n_heads, k_top=k_top, rope=rope, embed=False,
                       fold_head=False)
    out = run.launch(pos, x=x)
    decode_segment_step.launches += 1
    return out


decode_segment_step.launches = 0


def decode_monolith_step(token_root, token_attr, key, pos: int, packed: Dict,
                         k_cache, v_cache, k_cross, v_cross, *,
                         n_heads: int, k_top: int = 2, rope=None,
                         embed: bool = True, fold_head: bool = True, x=None,
                         plans: Optional[dict] = None):
    """One whole decode step (embed, every layer, final norm, head) as one
    kernel launch.

    Args:
      token_root, token_attr, key: (1,) ids and key on the device.
      packed: :func:`pack_monolith` of the model, or of a run of its
        layers (its "layers" one per cache row).
      k_cache, v_cache: (L, S, D) stacked self caches, written in place.
      k_cross, v_cross: (L, Sm, D) stacked primed memory K/V.
      embed, fold_head, x: as :func:`decode_flat_monolith_step` takes them,
        for a step cut into runs of at most ``kernels.MAX_STACK_LAYERS``
        layers (decode/fused.py); the whole step folds both ends.
    Returns:
      logits (1, n_out) in the compute dtype, or y (1, D) without the head.
    """
    what = "decode_monolith_step"
    tensors = (k_cache, v_cache, k_cross, v_cross)
    run = _cached_run(plans, tensors)
    if run is None:
        caches = _stacked(*tensors)
        _check_run(what, packed["layers"], caches, packed, n_heads=n_heads,
                   k_top=k_top, embed=embed, fold_head=fold_head, x=x)
        if kernels.use_plain(k_cache, what):
            return decode_monolith_plain(token_root, token_attr, key, pos,
                                         packed, k_cache, v_cache, k_cross,
                                         v_cross, n_heads=n_heads,
                                         k_top=k_top, rope=rope, embed=embed,
                                         fold_head=fold_head, x=x)
        run = _new_run(plans, tensors, what, packed["layers"], caches,
                       packed, n_heads=n_heads, k_top=k_top, rope=rope,
                       embed=embed, fold_head=fold_head)
    out = run.launch(pos, x=x, tokens=(token_root, token_attr, key))
    decode_monolith_step.launches += 1
    return out


decode_monolith_step.launches = 0
