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
The first step runs outside the loop, as in the JAX sampler. The steps are
routed as the JAX sampler routes them (decode/sampler.py:298-371): the V2
family through the fused ends step at B=1 and the batched fused step at
B>1, the variant wirings (V3) through the variant kernels at B=1 and the
batched variant pair at B>1 (decode/fused.py); any other wiring raises
NotImplementedError. Cache segmentation
(``GenerateConfig.cache_segments``) is not ported: the JAX sampler is
bit-exact with one segment, and the kernels read only rows <= pos.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..core import constants as C
from ..core.vocab import chord_to_root_attr_tables

from ..ops.attention import not_ported
from ..ops.decode_layer import fused_decode_eligible
from ..ops.decode_variant import fused_variant_eligible
from .fused import (init_fused_batch_caches,
                    init_fused_batch_variant_caches, init_fused_caches,
                    init_fused_variant_caches, make_fused_batch_step,
                    make_fused_batch_variant_step, make_fused_ends_step,
                    make_fused_variant_step)


def fused_backend(cfg, B: int):
    """(init_caches, make_step) of the fused step that decodes ``cfg`` at
    batch ``B``."""
    if fused_decode_eligible(cfg):
        return ((init_fused_caches, make_fused_ends_step) if B == 1 else
                (init_fused_batch_caches, make_fused_batch_step))
    if fused_variant_eligible(cfg):
        return ((init_fused_variant_caches, make_fused_variant_step)
                if B == 1 else (init_fused_batch_variant_caches,
                                make_fused_batch_variant_step))
    raise not_ported(f"decoding the AMT {cfg.version!r} wiring",
                     "Queue 1 item 12")


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
                    temperature=None, _gumbel=None):
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
      _gumbel: test seam — (T-1, B, CHORD_END) noise used instead of the
        generator's.
    Returns:
      dict of gen_seq / gen_seq_root / gen_seq_attr (B, T) int32 tensors on
      the device, and ``timings_ms``: encode / prime / decode stage times.
    """
    B = semantic.shape[0]
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
        init_caches, make_step = fused_backend(model.cfg, B)
        caches = init_caches(model, cross)
        step_logits = make_step(model)
        t2 = mark()

        def step(pos: int):
            root = gen_root[:, pos].contiguous()
            attr = gen_attr[:, pos].contiguous()
            logits = step_logits(caches, root, attr, key, pos)
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
