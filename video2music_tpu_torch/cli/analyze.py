"""CLI: dataset analysis utilities
(``python -m video2music_tpu.cli.analyze <kind> ...``).

Rebuilds the reference's analysis scripts:
  * ``chord_weight`` — chord-frequency histogram over all splits and the
    inverse-frequency weight vector (reference: ``script/chord_weight.py``);
  * ``emotion_chord`` — (dominant emotion, chord quality) co-occurrence
    counts over the dataset (reference: ``script/emotion_chord.py``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..core import constants as C
from ..core.vocab import QUALITIES, chord_to_root_attr_tables
from ..data import create_vevo_datasets


def cmd_chord_weight(args):
    train_ds, val_ds, test_ds = create_vevo_datasets(
        dataset_root=args.dataset_dir)
    counts = np.ones(C.CHORD_SIZE, np.int64)  # +1 smoothing as in reference
    for ds in (train_ds, val_ds, test_ds):
        for i in range(len(ds)):
            ids, cnt = np.unique(np.asarray(ds[i]["chord"], np.int64),
                                 return_counts=True)
            counts[ids] += cnt
    weights = 1.0 / counts
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, "chord_count.npy"), counts)
    np.save(os.path.join(args.out_dir, "chord_weight.npy"), weights)
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(14, 4))
        ax.bar(range(C.CHORD_SIZE), counts)
        ax.set_yscale("log")
        ax.set_xlabel("chord id")
        ax.set_ylabel("count")
        fig.savefig(os.path.join(args.out_dir, "chord_count.png"),
                    bbox_inches="tight", dpi=100)
    print("top-10 chords:", np.argsort(-counts)[:10].tolist())


def cmd_emotion_chord(args):
    train_ds, val_ds, test_ds = create_vevo_datasets(
        dataset_root=args.dataset_dir)
    _, attr_tab = chord_to_root_attr_tables()
    co = np.zeros((C.N_EMOTIONS, 14), np.int64)  # quality 0..13
    for ds in (train_ds, val_ds, test_ds):
        for i in range(len(ds)):
            s = ds[i]
            chord = np.asarray(s["chord"], np.int64)
            emo = np.asarray(s["emotion"])
            valid = chord < C.CHORD_END
            eid = np.argmax(emo[: len(chord)], axis=1)
            qual = attr_tab[chord[valid]]
            np.add.at(co, (eid[valid], qual), 1)
    os.makedirs(args.out_dir, exist_ok=True)
    out = {
        "emotions": list(C.EMOTION_CLASSES),
        "qualities": ["N"] + list(QUALITIES),
        "counts": co.tolist(),
    }
    with open(os.path.join(args.out_dir, "emotion_chord.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({e: int(co[i].sum())
                      for i, e in enumerate(C.EMOTION_CLASSES)}, indent=2))


def main(argv=None):
    p = argparse.ArgumentParser(description="Dataset analysis")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("chord_weight")
    s.add_argument("-dataset_dir", default="./dataset")
    s.add_argument("-out_dir", default="./analysis")
    s.add_argument("-plot", action="store_true")
    s.set_defaults(fn=cmd_chord_weight)
    s = sub.add_parser("emotion_chord")
    s.add_argument("-dataset_dir", default="./dataset")
    s.add_argument("-out_dir", default="./analysis")
    s.set_defaults(fn=cmd_emotion_chord)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
