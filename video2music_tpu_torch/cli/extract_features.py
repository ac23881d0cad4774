"""CLI: dataset feature extraction
(``python -m video2music_tpu_torch.cli.extract_features <kind> ...``).

One entry point covering the reference's per-feature scripts
(reference: ``script/semantic_feature.py``, ``emotion_feature.py``,
``motion_feature.py``, ``scene_feature.py``, ``scene_offset_feature.py``,
``loudness_feature.py``, ``note_density_feature.py``,
``thresholding_instrument.py``, ``video2jpg.py``). Each subcommand reads
videos/audio/midi under the dataset root and writes the same .lab/.npy/.csv
layouts the data pipeline consumes. CLIP/MaxViT subcommands batch ALL frames
of a video into one forward on ``-device`` (``cuda`` unless given; without
CUDA it raises), float32, their attention through the port's flash
attention kernel (the reference runs one frame per forward). Their weight
file is the JAX CLI's (a pickled dict of numpy arrays: ``np.save`` of the
flax params, or an ``.npz`` holding ``params``), bridged by
``weights.clip_from_jax`` / ``maxvit_from_jax``, or a ``torch.save``d
state dict of the port's ``CLIP`` / ``MaxViT`` (what cli/convert_clip.py
and cli/convert_maxvit.py write from the published weights).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .train_amt import add_device_flag


def _videos_in(d):
    return sorted(f for f in os.listdir(d)
                  if f.rsplit(".", 1)[-1].lower() in ("mp4", "mkv", "webm",
                                                      "avi", "mov"))


def load_state(path, bridge):
    """A state dict of the port's model from ``path``: the JAX CLI's
    pickled numpy params (``.npy``; ``.npz`` holding ``params``) through
    ``bridge`` (weights.clip_from_jax / maxvit_from_jax), or a
    ``torch.save``d state dict."""
    import torch

    if path.endswith((".npy", ".npz")):
        arr = np.load(path, allow_pickle=True)
        return bridge((arr["params"] if path.endswith(".npz") else arr).item())
    return torch.load(path, map_location="cpu", weights_only=True)


def _extractor(cls, cfg, state, device):
    """``cls(cfg)`` built on ``device`` (float32) with ``state``, in eval
    mode."""
    import torch

    with torch.device(device):
        model = cls(cfg)
    model.load_state_dict(state)
    return model.eval()


def _clip_pixels(frames, device):
    """1 fps RGB frames -> CLIP-normalized pixels on ``device``: the
    reference's bicubic resize and crop on the host (features.clip
    ``preprocess_frames``), the normalization on the device."""
    import torch
    from ..features.clip import (clip_vit_l14_336_config, normalize_pixels,
                                 resize_crop_frames)

    size = clip_vit_l14_336_config().vision.image_size
    return normalize_pixels(torch.from_numpy(
        resize_crop_frames(frames, size)).to(device))


def _clip(args):
    from .. import weights
    from ..features.clip import CLIP, clip_vit_l14_336_config
    from ..train.step import resolve_device

    device = resolve_device(args.device)
    model = _extractor(CLIP, clip_vit_l14_336_config(),
                       load_state(args.clip_params, weights.clip_from_jax),
                       device)
    return model, device


def cmd_semantic(args):
    import torch
    from ..pipeline.video_io import read_frames

    model, device = _clip(args)
    os.makedirs(args.out_dir, exist_ok=True)
    for fname in _videos_in(args.video_dir):
        vid = os.path.splitext(fname)[0]
        frames, _, _, _ = read_frames(os.path.join(args.video_dir, fname))
        with torch.no_grad():
            feats = model.encode_image(_clip_pixels(frames, device)) \
                .cpu().numpy()
        np.save(os.path.join(args.out_dir, vid + ".npy"), feats)
        print(vid, feats.shape)


def cmd_emotion(args):
    import torch
    from ..pipeline.video_io import read_frames

    model, device = _clip(args)
    text_embeds = torch.as_tensor(np.load(args.text_embeds), device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    header = ("time exciting_prob fearful_prob tense_prob sad_prob "
              "relaxing_prob neutral_prob")
    for fname in _videos_in(args.video_dir):
        vid = os.path.splitext(fname)[0]
        frames, _, _, _ = read_frames(os.path.join(args.video_dir, fname))
        with torch.no_grad():
            probs = model.emotion_probs(_clip_pixels(frames, device),
                                        text_embeds).cpu().numpy()
        with open(os.path.join(args.out_dir, vid + ".lab"), "w") as f:
            f.write(header + "\n")
            for i, row in enumerate(probs):
                f.write(f"{i} " + " ".join(format(p, ".4f")
                                           for p in row) + "\n")
        print(vid, probs.shape)


def cmd_scene(args):
    import cv2
    from ..features import scene as S
    from ..pipeline.video_io import read_frames

    os.makedirs(args.out_dir, exist_ok=True)
    offset_dir = args.offset_dir or args.out_dir
    os.makedirs(offset_dir, exist_ok=True)
    for fname in _videos_in(args.video_dir):
        vid = os.path.splitext(fname)[0]
        _, frames_all, fps, _ = read_frames(
            os.path.join(args.video_dir, fname))
        rgb = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2RGB)
                        for f in frames_all])
        cuts = S.detect_cuts(rgb)
        spans = S.scenes_from_cuts(cuts, len(frames_all), fps)
        n_sec = int(np.ceil(len(frames_all) / fps))
        ids = S.scene_ids_per_second(spans, n_sec)
        with open(os.path.join(args.out_dir, vid + ".lab"), "w") as f:
            for i, sid in enumerate(ids):
                f.write(f"{i} {sid}\n")
        offs = S.scene_offsets(ids)
        with open(os.path.join(offset_dir, vid + ".lab"), "w") as f:
            for i, o in enumerate(offs):
                f.write(f"{i} {o}\n")
        print(vid, len(spans), "scenes")


def cmd_motion(args):
    from ..features.maxvit import scalar_motion
    from ..pipeline.video_io import read_frames, second_boundary_pairs

    if args.motion_type != 0:
        import torch
        from .. import weights
        from ..features.maxvit import (MaxViT, maxvit_t_config,
                                       motion_diff_frames,
                                       normalize_diff_pixels,
                                       resize_crop_diff_frames)
        from ..train.step import resolve_device
        device = resolve_device(args.device)
        cfg = maxvit_t_config()
        model = _extractor(MaxViT, cfg, load_state(
            args.maxvit_params, weights.maxvit_from_jax), device)
    os.makedirs(args.out_dir, exist_ok=True)
    for fname in _videos_in(args.video_dir):
        vid = os.path.splitext(fname)[0]
        _, frames_all, fps, _ = read_frames(
            os.path.join(args.video_dir, fname))
        pairs = second_boundary_pairs(frames_all, fps)
        if args.motion_type == 0:
            vals = scalar_motion(pairs)
            with open(os.path.join(args.out_dir, vid + ".lab"), "w") as f:
                for i, v in enumerate(vals):
                    f.write(f"{i} {v:.4f}\n")
        else:
            # the reference's resize and crop on the host (features.maxvit
            # preprocess_diff_frames), the normalization on the device
            u8 = resize_crop_diff_frames(motion_diff_frames(pairs),
                                         cfg.image_size)
            with torch.no_grad():
                feats = model(normalize_diff_pixels(
                    torch.from_numpy(u8).to(device))).cpu().numpy()
            np.save(os.path.join(args.out_dir, vid + ".npy"), feats)
        print(vid)


def cmd_loudness(args):
    from ..features.audio import (load_wav_mono, loudness_per_second,
                                  write_lab)

    os.makedirs(args.out_dir, exist_ok=True)
    for fname in sorted(os.listdir(args.wav_dir)):
        if not fname.endswith(".wav"):
            continue
        vid = os.path.splitext(fname)[0]
        samples = load_wav_mono(os.path.join(args.wav_dir, fname))
        write_lab(os.path.join(args.out_dir, vid + ".lab"),
                  loudness_per_second(samples))
        print(vid)


def cmd_note_density(args):
    from ..features.audio import note_density_per_second, write_lab

    os.makedirs(args.out_dir, exist_ok=True)
    for fname in sorted(os.listdir(args.midi_dir)):
        if not fname.endswith((".mid", ".midi")):
            continue
        vid = os.path.splitext(fname)[0]
        write_lab(os.path.join(args.out_dir, vid + ".lab"),
                  note_density_per_second(os.path.join(args.midi_dir,
                                                       fname)))
        print(vid)


def cmd_threshold_instrument(args):
    """Tag probabilities csv -> binary csv at threshold 0.1
    (reference: script/thresholding_instrument.py:20-29)."""
    import csv as csvmod

    os.makedirs(args.out_dir, exist_ok=True)
    for fname in sorted(os.listdir(args.prob_dir)):
        if not fname.endswith(".csv"):
            continue
        with open(os.path.join(args.prob_dir, fname)) as f:
            rows = list(csvmod.reader(f))
        header, data = rows[0], np.asarray(rows[1:], np.float32)
        binary = (data >= args.threshold).astype(int)
        with open(os.path.join(args.out_dir, fname), "w", newline="") as f:
            w = csvmod.writer(f)
            w.writerow(header)
            w.writerows(binary.tolist())
        print(fname)


def build_parser():
    p = argparse.ArgumentParser(description="Feature extraction")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("semantic")
    s.add_argument("-video_dir", required=True)
    s.add_argument("-out_dir", required=True)
    s.add_argument("-clip_params", required=True)
    add_device_flag(s)
    s.set_defaults(fn=cmd_semantic)

    s = sub.add_parser("emotion")
    s.add_argument("-video_dir", required=True)
    s.add_argument("-out_dir", required=True)
    s.add_argument("-clip_params", required=True)
    s.add_argument("-text_embeds", required=True)
    add_device_flag(s)
    s.set_defaults(fn=cmd_emotion)

    s = sub.add_parser("scene")
    s.add_argument("-video_dir", required=True)
    s.add_argument("-out_dir", required=True)
    s.add_argument("-offset_dir", default=None)
    s.set_defaults(fn=cmd_scene)

    s = sub.add_parser("motion")
    s.add_argument("-video_dir", required=True)
    s.add_argument("-out_dir", required=True)
    s.add_argument("-motion_type", type=int, default=0)
    s.add_argument("-maxvit_params", default=None)
    add_device_flag(s)
    s.set_defaults(fn=cmd_motion)

    s = sub.add_parser("loudness")
    s.add_argument("-wav_dir", required=True)
    s.add_argument("-out_dir", required=True)
    s.set_defaults(fn=cmd_loudness)

    s = sub.add_parser("note_density")
    s.add_argument("-midi_dir", required=True)
    s.add_argument("-out_dir", required=True)
    s.set_defaults(fn=cmd_note_density)

    s = sub.add_parser("threshold_instrument")
    s.add_argument("-prob_dir", required=True)
    s.add_argument("-out_dir", required=True)
    s.add_argument("-threshold", type=float, default=0.1)
    s.set_defaults(fn=cmd_threshold_instrument)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
