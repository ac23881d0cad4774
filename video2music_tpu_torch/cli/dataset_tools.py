"""Dataset acquisition / preparation CLIs.

Rebuilds the reference's host-side dataset tooling:
  * ``download-videos`` — fetch the MuVi-Sync source videos by YouTube id
    (reference: ``script/download_video.py:1-23`` + ``function.py:26-54``,
    which uses pytube's highest-resolution stream). Here the download
    shells out to whichever of ``yt-dlp`` / ``youtube-dl`` is installed
    (neither ships in this image — capability-gated like
    ffmpeg/fluidsynth).
  * ``video2jpg`` — 1-fps JPEG frame extraction per video (reference:
    ``script/video2jpg.py:1-27``), reproducing its exact ffmpeg select
    filter (first frame + one frame per elapsed second, highest JPEG
    quality).

Usage:
    python -m video2music_tpu.cli.dataset_tools download-videos \\
        -idlist ./dataset/vevo_meta/idlist.txt -out ./dataset/video
    python -m video2music_tpu.cli.dataset_tools video2jpg \\
        -input_dir ./dataset/vevo -output_dir ./dataset/vevo_frame
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
from typing import List, Optional, Tuple


def read_id_list(idlist_path: str) -> List[Tuple[str, str]]:
    """idlist.txt rows "<index> <youtube_id>" -> [(index, youtube_id)]
    (reference: function.py:56-68)."""
    out = []
    with open(idlist_path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) >= 2:
                out.append((parts[0], parts[1]))
    return out


def _downloader() -> Optional[List[str]]:
    """Best available YouTube downloader command prefix, or None."""
    if shutil.which("yt-dlp"):
        # highest-resolution progressive mp4, like pytube's
        # get_highest_resolution()
        return ["yt-dlp", "-f", "best[ext=mp4]/best", "-o"]
    if shutil.which("youtube-dl"):
        return ["youtube-dl", "-f", "best[ext=mp4]/best", "-o"]
    return None


def download_videos(idlist_path: str, out_dir: str,
                    log=print) -> List[str]:
    """Download every listed video that is not already present. Returns
    the ids that could not be fetched (missing tool counts all)."""
    os.makedirs(out_dir, exist_ok=True)
    dl = _downloader()
    failed = []
    for index, vid in read_id_list(idlist_path):
        path = os.path.join(out_dir, f"{index}.mp4")
        if os.path.exists(path):
            continue
        if dl is None:
            failed.append(index)
            continue
        url = f"https://www.youtube.com/watch?v={vid}"
        try:
            subprocess.run(dl + [path, url], check=True,
                           capture_output=True)
            log(f"downloaded {url} -> {path}")
        except subprocess.CalledProcessError:
            log(f"FAILED {url}")
            failed.append(index)
    if dl is None:
        log("no yt-dlp/youtube-dl on PATH — nothing downloaded")
    return failed


# the reference's exact 1-fps select filter (script/video2jpg.py:23)
SELECT_1FPS = ("select=bitor(gte(t-prev_selected_t\\,1)\\,"
               "isnan(prev_selected_t))")


def video_to_jpgs(input_path: str, output_dir: str) -> None:
    """One video -> ``<stem>_%03d.jpg`` frames at 1 fps, max JPEG quality
    (reference: script/video2jpg.py:14-25)."""
    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(input_path))[0]
    out_pattern = os.path.join(output_dir, f"{stem}_%03d.jpg")
    cmd = ["ffmpeg", "-y", "-i", input_path, "-vf", SELECT_1FPS,
           "-vsync", "0", "-qmin", "1", "-q:v", "1", out_pattern]
    subprocess.run(cmd, check=True, capture_output=True)


def video_dir_to_jpgs(input_dir: str, output_dir: str, log=print) -> None:
    os.makedirs(output_dir, exist_ok=True)
    for filename in sorted(os.listdir(input_dir)):
        if not filename.endswith(".mp4"):
            continue
        stem = filename[:-4]
        video_to_jpgs(os.path.join(input_dir, filename),
                      os.path.join(output_dir, stem))
        log(f"extracted frames for {stem}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("download-videos")
    d.add_argument("-idlist", default="./dataset/vevo_meta/idlist.txt")
    d.add_argument("-out", default="./dataset/video")
    j = sub.add_parser("video2jpg")
    j.add_argument("-input_dir", default="./dataset/vevo")
    j.add_argument("-output_dir", default="./dataset/vevo_frame")
    args = p.parse_args(argv)
    if args.cmd == "download-videos":
        failed = download_videos(args.idlist, args.out)
        if failed:
            print(f"{len(failed)} ids not downloaded: {failed[:10]}...")
    else:
        if not shutil.which("ffmpeg"):
            raise SystemExit("ffmpeg not on PATH")
        video_dir_to_jpgs(args.input_dir, args.output_dir)


if __name__ == "__main__":
    main()
