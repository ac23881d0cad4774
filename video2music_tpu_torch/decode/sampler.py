"""KV-cached, constraint-aware chord sampler at B=1 (counterpart of
decode/sampler.py:generate_chords).

Sampling semantics kept from the JAX sampler:
  * probs = softmax(logits / temperature)[:CHORD_END], sampled
    unnormalised (CHORD_END itself can never be emitted);
  * max_conseq_N == 0 bans the "N" chord (id 0);
  * if the last ``max_conseq_chord`` tokens are equal, that chord is banned
    for the next step;
  * primer tokens are kept while pos + 1 is inside the primer;
  * a sample is argmax(log(probs) + gumbel), which is how
    jax.random.categorical samples; the noise comes from a torch.Generator,
    drawn for all T - 1 steps at once.
The token, its root/attr ids and the sequence advance on the device: the
loop never reads a device value back, and gen_seq is fetched by the caller.
The first step runs outside the loop, as in the JAX sampler. B>1
(generate_batch) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from video2music_tpu.core import constants as C
from video2music_tpu.core.vocab import chord_to_root_attr_tables

from ..ops.attention import not_ported
from .fused import init_fused_caches, make_fused_ends_step


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
                 temperature: float, noise):
    """Token for position pos+1 from the logits at pos: (B,) int64."""
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
                    primer, primer_root, primer_attr, num_primer: int,
                    generator: torch.Generator = None,
                    gcfg: GenerateConfig = GenerateConfig(),
                    temperature: float = None, _gumbel=None):
    """Generate a (1, target_seq_length) chord-id sequence.

    Args:
      model: a port VideoMusicTransformer, on the device and in the dtype
        to compute in.
      semantic/scene_offset/motion/emotion: (1, Lv, ...) video features.
      key: (1, 1) key conditioning (0 major, 1 minor).
      primer, primer_root, primer_attr: (1, P) ids; the first num_primer
        (>= 1) are kept.
      generator: the torch.Generator of the sampling noise (on the model's
        device).
      temperature: sampling temperature (default gcfg.temperature).
      _gumbel: test seam — (T-1, 1, CHORD_END) noise used instead of the
        generator's.
    Returns:
      dict of gen_seq / gen_seq_root / gen_seq_attr (1, T) int32 tensors on
      the device, and ``timings_ms``: encode / prime / decode stage times.
    """
    B = semantic.shape[0]
    if B != 1:
        raise not_ported("decoding several clips at once (generate_batch)",
                         "Queue 1, pipeline: generate_batch")
    device = semantic.device
    T = gcfg.target_seq_length
    if temperature is None:
        temperature = gcfg.temperature
    root_tab, attr_tab = (torch.from_numpy(t).to(device)
                          for t in chord_to_root_attr_tables())
    P = primer.shape[1]

    def padded(ids, pad):
        out = torch.full((B, T), pad, dtype=torch.int32, device=device)
        n = min(P, num_primer)
        out[:, :n] = ids[:, :n].to(device=device, dtype=torch.int32)
        return out

    gen_seq = padded(primer, C.CHORD_PAD)
    gen_root = padded(primer_root, C.CHORD_ROOT_PAD)
    gen_attr = padded(primer_attr, C.CHORD_ATTR_PAD)
    if _gumbel is None:
        noise = gumbel_noise((T - 1, B, C.CHORD_END), generator, device)
    else:
        noise = _gumbel.to(device=device, dtype=torch.float32)
    key = key.reshape(-1)[:1].to(device=device, dtype=torch.float32)

    mark, elapsed = _timer(device)
    t0 = mark()
    with torch.no_grad():
        memory = model.encode(semantic, scene_offset, motion, emotion)
        t1 = mark()
        caches = init_fused_caches(model, model.prime(memory))
        step_logits = make_fused_ends_step(model)
        t2 = mark()

        def step(pos: int):
            logits = step_logits(caches, gen_root[:, pos], gen_attr[:, pos],
                                 key, pos)
            if pos + 1 < num_primer:
                return  # the primer token at pos+1 stays
            nxt = _sample_next(logits, gen_seq, pos, gcfg, temperature,
                               noise[pos])
            gen_seq[:, pos + 1] = nxt.to(torch.int32)
            gen_root[:, pos + 1] = root_tab[nxt]
            gen_attr[:, pos + 1] = attr_tab[nxt]

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
