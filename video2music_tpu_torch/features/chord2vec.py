"""Chord embedding tables for the ``chord_embed`` model variants.

The reference loads a frozen 512-d gensim Word2Vec table trained over the
chord corpus in ChordEmbedding.ipynb (``word2vec_filled.bin``,
vector_size=512; load site reference:
``model/video_music_transformer.py:47-50``). Neither the binary nor the
corpus ships with the repo, so this module provides two first-party
replacements:

  * :func:`deterministic_chord_table` — a music-theory-informed table,
    generated from code (no binary asset): each chord id maps to features
    (circle-of-fifths + chromatic root coordinates, quality one-hot, the
    chord-tone pitch-class set from the ezchord voicer) projected to the
    target dim by a seeded Gaussian. Deterministic across runs/platforms,
    and musically structured: chords sharing tones/roots are closer than
    unrelated ones. This is the default frozen table for ``chord_embed``
    models (wired in models/amt.py).
  * :func:`train_skipgram` — a small numpy skip-gram/negative-sampling
    trainer (the same objective gensim's Word2Vec optimizes) for users who
    have a chord ``.lab`` corpus and want a data-driven table;
    :func:`corpus_from_labs` turns .lab files into id sentences.
"""

from __future__ import annotations

import functools
import pickle
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from ..core import constants as C
from ..core.vocab import QUALITIES, chord_symbol
from ..midi.ezchord import Chord


@functools.lru_cache(maxsize=None)
def chord_feature_matrix() -> np.ndarray:
    """(CHORD_SIZE, 31) float32: [cof sin/cos, chromatic sin/cos,
    quality one-hot(13), pitch-class set(12), is_N/is_END/is_PAD would be
    degenerate rows -> encoded as zeros plus the id-specific flags]."""
    n_q = len(QUALITIES)
    F = 4 + n_q + 12 + 2
    out = np.zeros((C.CHORD_SIZE, F), np.float32)
    for cid in range(C.CHORD_SIZE):
        if cid in (C.CHORD_END, C.CHORD_PAD):
            out[cid, -1] = 1.0 if cid == C.CHORD_PAD else -1.0
            continue
        sym = chord_symbol(cid)
        if sym == "N":
            out[cid, -2] = 1.0
            continue
        root_txt = sym.split(":")[0]
        quality = sym.split(":")[1] if ":" in sym else "maj"
        from ..core.vocab import ROOTS
        pc = ROOTS.index(root_txt)
        cof = (pc * 7) % 12
        out[cid, 0] = np.sin(2 * np.pi * cof / 12)
        out[cid, 1] = np.cos(2 * np.pi * cof / 12)
        out[cid, 2] = np.sin(2 * np.pi * pc / 12)
        out[cid, 3] = np.cos(2 * np.pi * pc / 12)
        out[cid, 4 + QUALITIES.index(quality)] = 1.0
        # chord tones from the same voicer the renderer uses
        for note in Chord(sym.replace(":", "")).getMIDI("c", 4):
            out[cid, 4 + n_q + (note % 12)] = 1.0
    return out


def deterministic_chord_table(dim: int = 512, seed: int = 0) -> np.ndarray:
    """(CHORD_SIZE, dim) float32 frozen chord embedding: standardized
    music-theory features through a seeded Gaussian projection."""
    feats = chord_feature_matrix().copy()
    mu = feats.mean(axis=0, keepdims=True)
    sd = feats.std(axis=0, keepdims=True)
    feats = (feats - mu) / np.maximum(sd, 1e-6)
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((feats.shape[1], dim)).astype(np.float32)
    table = feats @ proj / np.sqrt(feats.shape[1])
    return table.astype(np.float32)


class _Stub:
    """Inert stand-in for gensim classes during restricted unpickling:
    accepts any constructor args and absorbs state into ``__dict__``."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


def _stub_callable(*_a, **_k):
    return _Stub()


class _GensimUnpickler(pickle.Unpickler):
    """Restricted unpickler for gensim ``Word2Vec.save()`` files.

    Only numpy array reconstruction, a few stdlib builtins, and inert
    stubs for the gensim classes are allowed — anything else (the usual
    pickle code-execution vector) raises. This lets the framework read the
    reference's shipped ``word2vec_filled.bin``
    (``model/video_music_transformer.py:20,47-50``) without gensim — and
    without trusting the pickle."""

    _ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"),   # numpy 1.x writers
        ("numpy._core.multiarray", "_reconstruct"),  # numpy 2.x writers
        ("_codecs", "encode"),  # protocol<=2 array buffers (latin-1 str)
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("collections", "defaultdict"),
        ("builtins", "int"),
        ("builtins", "dict"),
        ("builtins", "list"),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        if module.startswith("gensim"):
            return _stub_callable if name[:1].islower() else _Stub
        if module.startswith("numpy.random"):
            # RandomState/bit-generator reconstruction — state baggage the
            # table does not need; swallow it
            return _stub_callable
        if (module, name) == ("builtins", "hash"):
            return _stub_callable  # gensim's hashfxn attribute
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} from a word2vec file")


def load_gensim_word2vec(path: str) -> Tuple[np.ndarray, List[str]]:
    """Read a gensim ``Word2Vec.save()`` pickle WITHOUT gensim.

    Returns ``(vectors, index_to_key)``: the (vocab, dim) float32 vector
    table and the key for each row. Works for models saved with arrays
    inline (gensim keeps arrays in the pickle below its 10 MB sep_limit —
    the reference's 836 KB ``word2vec_filled.bin`` qualifies)."""
    with open(path, "rb") as f:
        obj = _GensimUnpickler(f).load()
    wv = obj.__dict__["wv"].__dict__
    vectors = np.asarray(wv["vectors"], np.float32)
    keys = [str(k) for k in wv["index_to_key"]]
    if len(keys) != vectors.shape[0]:
        raise ValueError(
            f"word2vec file {path!r}: {len(keys)} keys vs "
            f"{vectors.shape[0]} vectors")
    return vectors, keys


def align_chord_table(vectors: np.ndarray, keys: Sequence[str], *,
                      positional: bool = True) -> np.ndarray:
    """(CHORD_SIZE, dim) chord-id-indexed table from raw word2vec rows.

    The reference's shipped ``word2vec_filled.bin`` stores 203 vectors in
    gensim FREQUENCY order (keys "C", "G", "F", "D", "G:7", ... — 157 of
    them are exactly our chord vocabulary; the rest are 9th/11th/13th
    chords and "X", outside the 159-id vocab), yet the reference indexes
    ``wv.vectors`` POSITIONALLY with chord ids
    (``Embedding.from_pretrained(wv.vectors)`` then
    ``self.chord_embedding_model(x)``,
    ``model/video_music_transformer.py:50,153``) — so chord id 2 (C:dim)
    reads the embedding trained for "F". Quirk: the reference trained its
    chord_embed models end-to-end against this misaligned-but-frozen
    table, so ``positional=True`` (the default, weight-comparable parity)
    reproduces it. ``positional=False`` aligns rows by chord SYMBOL
    (zero rows for END/PAD and any absent id) — the corrected table.
    """
    out = np.zeros((C.CHORD_SIZE, vectors.shape[1]), np.float32)
    if positional:
        n = min(C.CHORD_SIZE, vectors.shape[0])
        out[:n] = vectors[:n]
        return out
    from ..core.vocab import chord_dict

    cd = chord_dict()
    for row, key in zip(vectors, keys):
        cid = cd.get(key)
        if cid is None and key.isdigit() and int(key) < C.CHORD_SIZE:
            cid = int(key)
        if cid is not None:
            out[cid] = row
    return out


_ASSET_PATH = __file__.rsplit("features", 1)[0] + "assets/chord_word2vec.npz"


@functools.lru_cache(maxsize=None)
def _load_asset() -> Tuple[np.ndarray, Tuple[str, ...]]:
    data = np.load(_ASSET_PATH, allow_pickle=False)
    return np.asarray(data["vectors"], np.float32), tuple(
        str(k) for k in data["keys"])


def word2vec_chord_table(dim: int = 512, *,
                         positional: bool = True) -> np.ndarray:
    """The reference's trained 512-d chord table (converted from its
    shipped ``word2vec_filled.bin`` into ``assets/chord_word2vec.npz`` by
    ``tools/import_word2vec.py``), id-aligned per
    :func:`align_chord_table`. Raises if ``dim`` mismatches the artifact
    (the reference trained vector_size=512)."""
    vectors, keys = _load_asset()
    if vectors.shape[1] != dim:
        raise ValueError(
            f"trained chord table is {vectors.shape[1]}-d, requested {dim}; "
            "use chord_table='deterministic' for other dims")
    return align_chord_table(vectors, keys, positional=positional)


def corpus_from_labs(lab_texts: Iterable[str]) -> List[List[int]]:
    """Chord ``.lab`` file contents -> sentences of chord ids (one sentence
    per file), the corpus format ChordEmbedding.ipynb trains on."""
    from ..core.vocab import chord_dict

    cd = chord_dict()
    sentences = []
    for text in lab_texts:
        sent = []
        for line in text.splitlines():
            parts = line.strip().split(" ")
            if len(parts) < 2 or not parts[0].isdigit():
                continue
            cid = cd.get(parts[1])
            if cid is not None:
                sent.append(cid)
        if sent:
            sentences.append(sent)
    return sentences


def train_skipgram(sentences: Sequence[Sequence[int]], *, dim: int = 512,
                   vocab_size: int = C.CHORD_SIZE, window: int = 5,
                   negatives: int = 5, lr: float = 0.025, epochs: int = 5,
                   seed: int = 0) -> np.ndarray:
    """Skip-gram with negative sampling (gensim Word2Vec sg=1 objective),
    plain numpy. Returns the (vocab_size, dim) input-vector table; ids that
    never occur keep their random init."""
    rng = np.random.default_rng(seed)
    w_in = (rng.standard_normal((vocab_size, dim)) / np.sqrt(dim)).astype(
        np.float32)
    w_out = np.zeros((vocab_size, dim), np.float32)

    counts = np.zeros(vocab_size, np.float64)
    for sent in sentences:
        for t in sent:
            counts[t] += 1
    probs = counts ** 0.75
    total = probs.sum()
    if total == 0:
        return w_in
    probs = probs / total

    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-np.clip(x, -30, 30)))

    for _ in range(epochs):
        for sent in sentences:
            n = len(sent)
            for i, center in enumerate(sent):
                w = 1 + int(rng.integers(window))
                for j in range(max(0, i - w), min(n, i + w + 1)):
                    if j == i:
                        continue
                    ctx = sent[j]
                    targets = [ctx] + list(
                        rng.choice(vocab_size, negatives, p=probs))
                    labels = [1.0] + [0.0] * negatives
                    v = w_in[center]
                    grad_v = np.zeros_like(v)
                    for t, label in zip(targets, labels):
                        u = w_out[t]
                        g = (sigmoid(v @ u) - label) * lr
                        grad_v += g * u
                        w_out[t] = u - g * v
                    w_in[center] = v - grad_v
    return w_in
