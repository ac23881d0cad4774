"""CLI: dataset-primed chord generation for a test id
(``python -m video2music_tpu_torch.cli.generate``).

Rebuild of the reference's ``generate.py``: loads a test sample's
precomputed features, primes with its first chords (or a user primer),
decodes a chord sequence, runs the regression model, and renders
``output.lab`` + ``output.mid`` (+ flac/mp4 when fluidsynth/ffmpeg exist).
The JAX package's CLI on the port's ``Video2music``, plus ``-device``
(``cuda`` unless given; without CUDA it raises).
"""

from __future__ import annotations

import argparse
import os

from ..core import constants as C
from ..data import create_vevo_datasets
from ..pipeline.api import Video2music
from ..train.step import resolve_device
from .train_amt import add_device_flag


def main(argv=None):
    p = argparse.ArgumentParser(description="Dataset-primed generation")
    p.add_argument("-dataset_dir", default="./dataset")
    p.add_argument("-test_id", default=None,
                   help="video id from the test split (default: first)")
    p.add_argument("-primer", default="")
    p.add_argument("-key", default=None)
    p.add_argument("-temperature", type=float, default=1.0)
    p.add_argument("-music_gen_version", default="2.2")
    p.add_argument("-regModel", default="bimamba+")
    p.add_argument("-motion_type", type=int, default=0)
    p.add_argument("-amt_weights", default=None)
    p.add_argument("-reg_weights", default=None)
    p.add_argument("-output_dir", default="./output")
    p.add_argument("-num_prime_chord", type=int, default=30)
    p.add_argument("-input_video", default=None,
                   help="optional video file to mux the audio onto, with "
                        "Prime/Generated Chords captions burned in "
                        "(reference generate.py:694-709)")
    p.add_argument("-seed", type=int, default=0)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    _, _, test_ds = create_vevo_datasets(dataset_root=args.dataset_dir,
                                         motion_type=args.motion_type)
    if not len(test_ds):
        raise SystemExit(f"no complete samples under {args.dataset_dir}")
    ids = test_ds.ids
    idx = ids.index(args.test_id) if args.test_id else 0
    sample = test_ds[idx]

    v2m = Video2music(music_gen_version=args.music_gen_version,
                      reg_model=args.regModel,
                      motion_type=args.motion_type,
                      amt_checkpoint=args.amt_weights,
                      reg_checkpoint=args.reg_weights, device=device)
    feats = {
        "semantic": sample["semantic"],
        "emotion": sample["emotion"],
        "scene_offset": sample["scene_offset"],
        "motion": sample["motion"],
    }
    primer = args.primer
    if not primer:
        # prime with the sample's first chords (reference: generate.py:286-342)
        from ..core.vocab import chord_inv_dict
        inv = chord_inv_dict()
        n = min(args.num_prime_chord, int(
            (sample["chord"] != C.CHORD_PAD).sum()))
        primer = " ".join(
            inv[int(c)].replace(":min", "m").replace(":", "")
            for c in sample["chord"][:n] if int(c) < C.CHORD_END)
    overlays = None
    if args.input_video:
        from ..pipeline.video_io import chord_caption_overlays
        n_sec = int(feats["semantic"].shape[0])
        overlays = chord_caption_overlays(args.num_prime_chord, n_sec)
    result = v2m.generate(video=args.input_video, primer=primer,
                          key=args.key, temperature=args.temperature,
                          features=feats, output_dir=args.output_dir,
                          caption_overlays=overlays, seed=args.seed)
    lab_path = os.path.join(args.output_dir, "output.lab")
    with open(lab_path, "w", encoding="utf-8") as f:
        for i, sym in enumerate(result.chords):
            f.write(f"{i} {sym}\n")
    print("chords:", " ".join(result.chords[:16]), "...")
    print("wrote", lab_path, "and", result.midi_path)
    return result


if __name__ == "__main__":
    main()
