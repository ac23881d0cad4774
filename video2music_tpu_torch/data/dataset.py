"""MuVi-Sync (vevo) dataset pipeline: feature files -> fixed-shape batches.

Re-implements ``VevoDataset`` / ``create_vevo_datasets`` (reference:
``dataset/vevo_dataset.py:58-651``) as a pure-numpy pipeline. Differences by
design, not behavior:

  * samples are materialized lazily behind a bounded LRU cache instead of
    the reference's eager load of the entire split at startup
    (reference: vevo_dataset.py:187-191) — startup is O(1); the default
    capacity (1024) holds every MuVi-Sync split (748 ids total) so
    steady-state matches the eager load, while huge custom datasets stay
    memory-bounded via ``cache_size``;
  * batches come out as dense numpy dicts ready for one host->device
    transfer, instead of per-tensor ``.to(device)`` copies
    (reference: run_model_vevo.py:31-45).

Sample-dict keys, shapes and padding match the reference exactly
(vevo_dataset.py:534-554). The mixup augmentation reproduces the reference's
``a*l + b*(l-1)`` combination — note ``(l-1)`` is NEGATIVE for l in (0.2,
0.8); this is the reference's live behavior and is reproduced verbatim
(vevo_dataset.py:193-224, flagged in SURVEY.md §7).
"""

from __future__ import annotations

import os
import random
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..core import constants as C
from ..core.vocab import KEY_DIC, emotion_chord_targets
from . import parsers as P

# Float feature keys the reference's mixup actually exercises. The reference
# also linearly mixes the integer chord-token ids and omits "tgt"/"key" from
# augmented samples entirely (vevo_dataset.py:200-221) — that path crashes in
# torch too (float ids into nn.Embedding; KeyError at collate), i.e. the
# augmentation is only live for the regression model, whose inputs are all
# below. We keep token-id keys from sample ``a`` so augmented samples remain
# well-formed for both models (documented deviation; dead-path crash fix).
_MIX_KEYS = (
    "semantic", "key_val", "scene_offset", "motion", "emotion",
    "tgt_emotion", "tgt_emotion_prob", "note_density", "loudness",
    "instrument",
)


def make_sample(*, chord_lab, chord_lab_no_norm, emotion_lab, motion_src,
                scene_offset_lab, loudness_lab, note_density_lab,
                instrument_csv, semantic_npy,
                max_seq_chord: int = C.MAX_SEQ_CHORD,
                max_seq_video: int = C.MAX_SEQ_VIDEO,
                motion_type: int = 0) -> Dict[str, np.ndarray]:
    """One sample from feature sources (paths or line lists), mirroring
    createSample (reference: vevo_dataset.py:241-554)."""
    native_ok = isinstance(chord_lab, (str, os.PathLike))
    if native_ok:
        from . import native as N
        parsed = N.parse_chord_lab(str(chord_lab), max_seq_chord)
    else:
        parsed = None
    if parsed is not None:
        chord, root, attr, key_int, last_time = parsed
        key = np.asarray([float(key_int)], np.float32)
    else:
        chord, root, attr, key_str, last_time = P.parse_chord_lab(
            chord_lab, max_seq_chord)
        key = np.asarray([0.0 if "major" in key_str else 1.0], np.float32)
    original_key = P.parse_chord_lab_key(chord_lab_no_norm)
    key_val = np.asarray([KEY_DIC.get(original_key, 0)], np.float32)

    x = chord[: max_seq_chord - 1]
    tgt = chord[1:max_seq_chord].copy()
    x_root = root[: max_seq_chord - 1]
    tgt_root = root[1:max_seq_chord].copy()
    x_attr = attr[: max_seq_chord - 1]
    tgt_attr = attr[1:max_seq_chord].copy()
    if last_time < max_seq_chord - 1:
        # END token right after the final chord (reference: :325-328). The
        # bound is max_seq-1 (tgt has length 299): a clip whose lab reaches
        # second 299 gets no END — matching the reference when a t>=300
        # line triggers its break, and fixing its dead-path IndexError when
        # the lab ends at exactly t=299.
        tgt[last_time] = C.CHORD_END
        tgt_root[last_time] = C.CHORD_ROOT_END
        tgt_attr[last_time] = C.CHORD_ATTR_END

    def _scalar(src, pad, offset=0.0):
        if isinstance(src, (str, os.PathLike)):
            from . import native as N
            got = N.parse_scalar_lab(str(src), max_seq_video, pad, offset)
            if got is not None:
                return got
        return P.parse_scalar_lab(src, max_seq_video, pad=pad, offset=offset)

    scene_offset = _scalar(scene_offset_lab, C.SCENE_OFFSET_PAD, 1.0)
    if motion_type == 0 and isinstance(motion_src, (str, os.PathLike)):
        motion = _scalar(motion_src, C.MOTION_PAD)
    else:
        motion = P.load_motion(motion_src, max_seq_video, motion_type)
    note_density = _scalar(note_density_lab, C.NOTE_DENSITY_PAD)
    loudness = _scalar(loudness_lab, C.LOUDNESS_PAD)
    if isinstance(emotion_lab, (str, os.PathLike)):
        from . import native as N
        emotion = N.parse_emotion_lab(str(emotion_lab), max_seq_video)
        if emotion is None:
            emotion = P.parse_emotion_lab(emotion_lab, max_seq_video)
    else:
        emotion = P.parse_emotion_lab(emotion_lab, max_seq_video)
    if isinstance(instrument_csv, (str, os.PathLike)):
        from . import native as N
        instrument = N.parse_instrument_csv(str(instrument_csv),
                                            max_seq_video)
        if instrument is None:
            instrument = P.parse_instrument_csv(instrument_csv,
                                                max_seq_video)
    else:
        instrument = P.parse_instrument_csv(instrument_csv, max_seq_video)
    semantic = (P.load_semantic_npy(semantic_npy, max_seq_video)
                if isinstance(semantic_npy, (str, os.PathLike))
                else np.asarray(semantic_npy, np.float32))

    # emotion -> allowed-chord 159-d rows, chord PAD/END override
    # (reference: vevo_dataset.py:461-509)
    rows = emotion_chord_targets()
    emo_argmax = np.argmax(emotion, axis=1)
    row_idx = np.where(chord == C.CHORD_PAD, 7,
                       np.where(chord == C.CHORD_END, 6, emo_argmax))
    mapped = rows[row_idx]
    max_prob = np.take_along_axis(emotion, emo_argmax[:, None], axis=1)[:, 0]

    return {
        "x": x, "tgt": tgt, "chord": chord,
        "x_root": x_root, "tgt_root": tgt_root, "chord_root": root,
        "x_attr": x_attr, "tgt_attr": tgt_attr, "chord_attr": attr,
        "semantic": semantic, "key": key, "key_val": key_val,
        "scene_offset": scene_offset, "motion": motion, "emotion": emotion,
        "tgt_emotion": mapped[1:], "tgt_emotion_prob": max_prob[1:],
        "note_density": note_density, "loudness": loudness,
        "instrument": instrument,
    }


def mixup_samples(a: Dict, b: Dict, l: float) -> Dict:
    """The reference's augmentation combine ``a*l + b*(l-1)``
    (reference: vevo_dataset.py:200-221). Reproduced verbatim for the float
    feature keys, including the negative ``(l-1)`` second weight (flagged in
    SURVEY.md §7); token-id and "key"/"tgt" entries are taken from ``a``
    (see the _MIX_KEYS comment for why)."""
    out = dict(a)
    for k in _MIX_KEYS:
        out[k] = a[k] * l + b[k] * (l - 1)
    return out


class VevoDataset:
    """Lazy split of the vevo dataset; indexable like the reference's."""

    def __init__(self, dataset_root: str = "./dataset", split: str = "train",
                 split_ver: str = "v1", vis_models: str = "2d/clip_l14p",
                 emo_model: str = "6c_l14p", motion_type: int = 0,
                 max_seq_chord: int = C.MAX_SEQ_CHORD,
                 max_seq_video: int = C.MAX_SEQ_VIDEO,
                 augmentation: bool = False, aug_seed: int = 0,
                 cache_size: int = 1024):
        self.root = dataset_root
        self.motion_type = motion_type
        self.max_seq_chord = max_seq_chord
        self.max_seq_video = max_seq_video
        vm = vis_models.split(" ")[0].split("/")
        motion_dir = {0: "origin", 1: "option1", 2: "option2"}[motion_type]
        motion_ext = ".lab" if motion_type == 0 else ".npy"
        self._paths = []
        split_file = os.path.join(dataset_root, "vevo_meta", "split",
                                  split_ver, split + ".txt")
        with open(split_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        for fid in ids:
            p = dict(
                chord_lab=os.path.join(dataset_root, "vevo_chord",
                                       "lab_v2_norm", "origin", fid + ".lab"),
                chord_lab_no_norm=os.path.join(dataset_root, "vevo_chord",
                                               "lab_v2", "origin",
                                               fid + ".lab"),
                emotion_lab=os.path.join(dataset_root, "vevo_emotion",
                                         emo_model, "origin", fid + ".lab"),
                motion_src=os.path.join(dataset_root, "vevo_motion",
                                        motion_dir, fid + motion_ext),
                scene_offset_lab=os.path.join(dataset_root,
                                              "vevo_scene_offset", "origin",
                                              fid + ".lab"),
                loudness_lab=os.path.join(dataset_root, "vevo_loudness",
                                          "origin", fid + ".lab"),
                note_density_lab=os.path.join(dataset_root,
                                              "vevo_note_density", "origin",
                                              fid + ".lab"),
                instrument_csv=os.path.join(dataset_root, "vevo_instrument",
                                            "thresholding", fid + ".csv"),
                semantic_npy=os.path.join(dataset_root, "vevo_semantic",
                                          "origin", vm[0], vm[1],
                                          fid + ".npy"),
            )
            if all(os.path.exists(v) for v in p.values()):
                self._paths.append((fid, p))
        self._cache: "OrderedDict[int, Dict]" = OrderedDict()
        self._cache_size = max(1, int(cache_size))
        self._aug: List[tuple] = []
        if augmentation and len(self._paths) >= 2:
            # 2x mixup pairs, as in the reference (vevo_dataset.py:195-223)
            rng = random.Random(aug_seed)
            for _ in range(2 * len(self._paths)):
                i, j = rng.sample(range(len(self._paths)), 2)
                self._aug.append((i, j, rng.uniform(0.2, 0.8)))

    def __len__(self):
        return len(self._paths) + len(self._aug)

    @property
    def ids(self):
        return [fid for fid, _ in self._paths]

    def _base(self, idx: int) -> Dict:
        if idx in self._cache:
            self._cache.move_to_end(idx)
            return self._cache[idx]
        _, p = self._paths[idx]
        sample = make_sample(
            max_seq_chord=self.max_seq_chord,
            max_seq_video=self.max_seq_video,
            motion_type=self.motion_type, **p)
        self._cache[idx] = sample
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return sample

    def __getitem__(self, idx: int) -> Dict:
        n = len(self._paths)
        if idx < n:
            return self._base(idx)
        i, j, l = self._aug[idx - n]
        return mixup_samples(self._base(i), self._base(j), l)


def create_vevo_datasets(dataset_root: str = "./dataset", split_ver="v1",
                         vis_models="2d/clip_l14p", emo_model="6c_l14p",
                         motion_type=0, max_seq_chord=C.MAX_SEQ_CHORD,
                         max_seq_video=C.MAX_SEQ_VIDEO, augmentation=False):
    """(train, val, test) — augmentation applies to train only
    (reference: vevo_dataset.py:634-651)."""
    mk = lambda split, aug: VevoDataset(
        dataset_root=dataset_root, split=split, split_ver=split_ver,
        vis_models=vis_models, emo_model=emo_model, motion_type=motion_type,
        max_seq_chord=max_seq_chord, max_seq_video=max_seq_video,
        augmentation=aug)
    return mk("train", augmentation), mk("val", False), mk("test", False)


def batches(dataset, batch_size: int, *, shuffle: bool = True, seed: int = 0,
            drop_last: bool = False):
    """Yield stacked numpy batch dicts (one host->device copy per batch)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        samples = [dataset[int(i)] for i in idx]
        yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
