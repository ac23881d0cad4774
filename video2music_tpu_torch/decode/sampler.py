"""KV-cached, constraint-aware chord sampler (counterpart of
decode/sampler.py:generate_chords), at B=1 and for a batch of clips.

Sampling semantics kept from the JAX sampler:
  * probs = softmax(logits / temperature)[:CHORD_END], sampled
    unnormalised (CHORD_END itself can never be emitted);
  * max_conseq_N == 0 bans the "N" chord (id 0);
  * if the last ``max_conseq_chord`` tokens are equal, that chord is banned
    for the next step;
  * a clip's primer tokens are kept while pos + 1 is inside its primer
    (a torch.where on the device);
  * a sample is argmax(log(probs) + gumbel), which is how
    jax.random.categorical samples; the noise comes from a torch.Generator,
    drawn for all T - 1 steps and B clips at once.
The token, its root/attr ids and the sequence advance on the device: the
loop never reads a device value back, and gen_seq is fetched by the caller.
The first step runs outside the loop, as in the JAX sampler.

The step backend is routed as the JAX sampler routes it
(decode/sampler.py:292-436; ``fused_backend``), every backend in
decode/fused.py:
  * the V2 family at B=1: "auto" / "ends" the ends-folded per-layer
    kernels (``split=False``: the whole step in one cooperative-kernel
    launch), "on" / "layer" one decode-layer kernel per layer, "stack" one
    launch per run of same-kind layers, "monolith" the whole step in one
    launch; ``quantize="int8"`` takes the "layer" backend with int8 weights
    whatever ``fused`` says, except "off";
  * the V2 family at B>1: "auto" / "ends" the batched step with the embed
    and head folded, every other value but "off" the batched step with
    them as plain glue; ``kv_quant="int8"`` keeps its caches as int8 rows
    with row scales; ``quantize="int8"`` decodes on the plain step with
    fake-quantized weights (and warns unless ``fused="auto"``);
  * the variant wirings (``fused_variant_eligible``: the base AMT, V1.x,
    2.0 and V3): the variant kernels at B=1 (with int8
    weights for ``quantize="int8"``) and the batched variant pair at B>1;
    "ends", "stack" and "monolith" raise ValueError; ``quantize="int8"``
    at B>1 or with "off" decodes on the plain step with fake-quantized
    weights (and warns at B>1 unless ``fused="auto"``); ``kv_quant`` at
    B>1 warns and keeps full-precision caches;
  * a wiring no kernel covers (KAN 2.3, grouped-query attention, odd head
    dims): the plain step whatever ``fused`` says, as in the JAX sampler;
    ``quantize="int8"`` raises ValueError;
  * "off": the model's plain ``decode_step``, the counterpart of the XLA
    step path.
A wiring with the frozen chord table reads the current chord ids too
(``step_logits(..., token=)``); separated root / attr heads raise
NotImplementedError, as in the JAX sampler.
``kv_quant`` is None or "int8", excludes ``quantize`` (ValueError), and is
ignored at B=1 and with "off", as in the JAX sampler.
"auto" means the kernels on a CUDA tensor and their plain versions on a
CPU tensor (the wrappers dispatch by device); the JAX sampler's TPU checks
(``_use_pallas``, the Mosaic tiling checks) have no counterpart here. Cache
segmentation
(``GenerateConfig.cache_segments``) is not ported: the JAX sampler is
bit-exact with one segment, and the kernels read only rows <= pos.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import torch

from ..core import constants as C
from ..core.vocab import chord_to_root_attr_tables

from ..ops.decode_layer import (fake_quantize_decoder_params,
                                fused_decode_eligible)
from ..ops.decode_variant import fused_variant_eligible
from .fused import (init_fused_batch_caches,
                    init_fused_batch_variant_caches, init_fused_caches,
                    init_fused_monolith_caches, init_fused_stack_caches,
                    init_fused_variant_caches, make_fused_batch_step,
                    make_fused_batch_variant_step, make_fused_ends_step,
                    make_fused_monolith_step, make_fused_stack_step,
                    make_fused_step, make_fused_variant_step)

FUSED = ("auto", "ends", "on", "layer", "stack", "monolith", "off")


def _init_plain_caches(model, cross):
    return model.init_cache(cross)


def _make_plain_step(model):
    """The model's plain decode_step as a step_logits closure."""
    def step_logits(cache, token_root, token_attr, key, pos: int,
                    token=None):
        return model.decode_step(None if token is None else token[:, None],
                                 token_root[:, None], token_attr[:, None],
                                 key, pos, cache)
    return step_logits


def _fake_quant_backend(B: int, fused: str):
    """The plain step on fake-quantized weights: int8 decode where no int8
    kernel runs (B>1, "off"); warns at B>1 unless fused="auto"."""
    if B > 1 and fused != "auto":
        warnings.warn(
            f"fused={fused!r} with quantize='int8' at B={B}: int8 weights "
            "are a B=1 fused feature; decoding on the plain step with "
            "fake-quantized weights", stacklevel=4)
    return _init_plain_caches, lambda model: _make_plain_step(
        fake_quantize_decoder_params(model))


def fused_backend(cfg, B: int, fused: str = "auto", quantize=None,
                  split: bool = True, kv_quant=None):
    """(init_caches(model, cross), make_step(model)) of the step that
    decodes ``cfg`` at batch ``B`` for the sampler's ``fused``,
    ``quantize`` and ``kv_quant`` arguments (see the module docstring)."""
    if fused not in FUSED:
        raise ValueError(f"fused must be one of {FUSED}, got {fused!r}")
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    if kv_quant not in (None, "int8"):
        raise ValueError(f"kv_quant must be None or 'int8', got {kv_quant!r}")
    if kv_quant is not None and quantize is not None:
        raise ValueError(
            "kv_quant and quantize are mutually exclusive (int8 weights are "
            "a B=1 feature, int8 KV caches a B>1 feature)")
    if fused_decode_eligible(cfg):
        if quantize is not None and (B > 1 or fused == "off"):
            return _fake_quant_backend(B, fused)
        if fused == "off":
            return _init_plain_caches, _make_plain_step
        if B > 1:
            ends = fused in ("auto", "ends")
            return (lambda model, cross: init_fused_batch_caches(
                model, cross, kv_quant=kv_quant),
                lambda model: make_fused_batch_step(
                    model, ends=ends, kv_quant=kv_quant))
        if quantize is not None:
            return init_fused_caches, lambda model: make_fused_step(
                model, quantize=quantize)
        if fused in ("auto", "ends"):
            return init_fused_caches, lambda model: make_fused_ends_step(
                model, split=split)
        if fused == "stack":
            return init_fused_stack_caches, make_fused_stack_step
        if fused == "monolith":
            return init_fused_monolith_caches, make_fused_monolith_step
        return init_fused_caches, make_fused_step
    if fused_variant_eligible(cfg):
        if fused in ("ends", "stack", "monolith"):
            raise ValueError(
                f"fused={fused!r} requires the V2-family decoder wiring "
                "(ops/decode_layer.fused_decode_eligible); this config "
                "routes through the per-layer variant kernels: use "
                "fused='on' or 'auto'")
        if kv_quant is not None and B > 1 and fused != "off":
            warnings.warn(
                "kv_quant='int8' covers the V2-family batched kernels "
                "(ops/decode_batch.py); this variant config decodes with "
                "full-precision KV caches", stacklevel=3)
        if quantize is not None and (B > 1 or fused == "off"):
            return _fake_quant_backend(B, fused)
        if fused == "off":
            return _init_plain_caches, _make_plain_step
        if B == 1:
            return init_fused_variant_caches, lambda model: \
                make_fused_variant_step(model, quantize=quantize)
        return init_fused_batch_variant_caches, make_fused_batch_variant_step
    # no kernel covers the wiring (KAN experts, grouped-query attention,
    # odd head dims): the plain step, as the JAX sampler's XLA path
    if quantize is not None:
        raise ValueError(
            "quantize='int8' covers the fused-decode-eligible configs "
            "(V2-family or variant decoder wirings); got an ineligible "
            "config")
    return _init_plain_caches, _make_plain_step


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    target_seq_length: int = 300
    temperature: float = 1.0
    max_conseq_N: int = 0
    max_conseq_chord: int = 2


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """-log(-log(u)), u uniform in [tiny, 1) (jax.random.gumbel's form)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def _sample_next(logits, gen_seq, pos: int, gcfg: GenerateConfig,
                 temperature, noise):
    """Token for position pos+1 from the logits at pos: (B,) int64.
    ``temperature`` is a float or a (B, 1) tensor."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    probs = probs[..., :C.CHORD_END].clone()
    if gcfg.max_conseq_N == 0:
        probs[..., 0] = 0.0
    m = gcfg.max_conseq_chord
    if pos + 1 >= m:
        pre = gen_seq[:, pos]
        same = torch.ones_like(pre, dtype=torch.bool)
        for k in range(1, m):
            same &= gen_seq[:, pos - k] == pre
        ban = (torch.arange(C.CHORD_END, device=probs.device)[None, :]
               == pre[:, None]).float()
        probs = torch.where(same[:, None], probs * (1.0 - ban), probs)
    return torch.argmax(torch.log(probs) + noise, dim=-1)


def _timer(device):
    """Stage clock: CUDA events on the card, the host clock on the CPU.
    Returns mark() and elapsed_ms(a, b), read once after a synchronise."""
    if device.type == "cuda":
        def mark():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return mark, lambda a, b: a.elapsed_time(b)
    return time.perf_counter, lambda a, b: (b - a) * 1e3


def generate_chords(model, *, semantic, key, scene_offset, motion, emotion,
                    primer, primer_root, primer_attr, num_primer,
                    generator: torch.Generator = None,
                    gcfg: GenerateConfig = GenerateConfig(),
                    temperature=None, fused: str = "auto", quantize=None,
                    split: bool = True, kv_quant=None, _gumbel=None):
    """Generate a (B, target_seq_length) chord-id sequence.

    Args:
      model: a port VideoMusicTransformer, on the device and in the dtype
        to compute in.
      semantic/scene_offset/motion/emotion: (B, Lv, ...) video features.
      key: (B, 1) or (B,) key conditioning (0 major, 1 minor).
      primer, primer_root, primer_attr: (B, P) ids; the first num_primer
        (>= 1) are kept.
      num_primer: an int for every clip, or a (B,) / (B, 1) tensor of
        per-clip primer lengths.
      generator: the torch.Generator of the sampling noise (on the model's
        device).
      temperature: sampling temperature, a float or a (B,) / (B, 1) tensor
        of per-clip values (default gcfg.temperature).
      fused: the step backend, one of FUSED (the module docstring).
      quantize: None or "int8" (weight-only int8 decode: the int8 kernels
        at B=1, fake-quantized weights on the plain step elsewhere).
      split: with the "ends" backend at B=1, False runs the whole step as
        one cooperative-kernel launch (make_fused_ends_step(split=False)).
      kv_quant: None or "int8": int8 KV caches with row scales on the
        batched V2 step (the module docstring).
      _gumbel: test seam — (T-1, B, CHORD_END) noise used instead of the
        generator's.
    Returns:
      dict of gen_seq / gen_seq_root / gen_seq_attr (B, T) int32 tensors on
      the device, and ``timings_ms``: encode / prime / decode stage times.
    """
    if model.cfg.separated:
        raise NotImplementedError(
            "generate_chords needs the 159-way chord head; separated "
            "(root/attr) models have no generate path in the reference "
            "either (its generate slices the chord softmax, "
            "video_music_transformer.py:1070-1073)")
    B = semantic.shape[0]
    init_caches, make_step = fused_backend(model.cfg, B, fused, quantize,
                                           split, kv_quant)
    device = semantic.device
    T = gcfg.target_seq_length
    if temperature is None:
        temperature = gcfg.temperature
    if torch.is_tensor(temperature):
        temperature = temperature.to(device=device, dtype=torch.float32)
        temperature = temperature.reshape(-1, 1).expand(B, 1)
    root_tab, attr_tab = (torch.from_numpy(t).to(device)
                          for t in chord_to_root_attr_tables())
    P = primer.shape[1]
    num_primer = torch.as_tensor(num_primer, device=device,
                                 dtype=torch.int32).reshape(-1, 1).expand(B, 1)
    in_primer = torch.arange(P, device=device)[None, :] < num_primer

    def padded(ids, pad):
        out = torch.full((B, T), pad, dtype=torch.int32, device=device)
        n = min(P, T)
        out[:, :n] = torch.where(in_primer[:, :n],
                                 ids[:, :n].to(device=device,
                                               dtype=torch.int32), pad)
        return out

    gen_seq = padded(primer, C.CHORD_PAD)
    gen_root = padded(primer_root, C.CHORD_ROOT_PAD)
    gen_attr = padded(primer_attr, C.CHORD_ATTR_PAD)
    if _gumbel is None:
        noise = gumbel_noise((T - 1, B, C.CHORD_END), generator, device)
    else:
        noise = _gumbel.to(device=device, dtype=torch.float32)
    key = key.reshape(-1).to(device=device, dtype=torch.float32)
    key = key.expand(B).contiguous()

    mark, elapsed = _timer(device)
    t0 = mark()
    with torch.no_grad():
        memory = model.encode(semantic, scene_offset, motion, emotion)
        t1 = mark()
        cross = model.prime(memory)
        caches = init_caches(model, cross)
        step_logits = make_step(model)
        t2 = mark()

        def step(pos: int):
            root = gen_root[:, pos].contiguous()
            attr = gen_attr[:, pos].contiguous()
            # the chord ids, for a wiring with the frozen chord table
            tok = ({"token": gen_seq[:, pos].contiguous()}
                   if model.cfg.chord_embed else {})
            logits = step_logits(caches, root, attr, key, pos, **tok)
            nxt = _sample_next(logits, gen_seq, pos, gcfg, temperature,
                               noise[pos])
            keep = pos + 1 < num_primer[:, 0]  # the primer token stays
            gen_seq[:, pos + 1] = torch.where(keep, gen_seq[:, pos + 1],
                                              nxt.to(torch.int32))
            gen_root[:, pos + 1] = torch.where(keep, gen_root[:, pos + 1],
                                               root_tab[nxt])
            gen_attr[:, pos + 1] = torch.where(keep, gen_attr[:, pos + 1],
                                               attr_tab[nxt])

        step(0)
        for pos in range(1, T - 1):
            step(pos)
        t3 = mark()
    if device.type == "cuda":
        t3.synchronize()
    timings = dict(encode=elapsed(t0, t1), prime=elapsed(t1, t2),
                   decode=elapsed(t2, t3))
    return {"gen_seq": gen_seq, "gen_seq_root": gen_root,
            "gen_seq_attr": gen_attr, "timings_ms": timings}
