"""The port's batched serving path against the JAX pipeline (CPU, f32):
``Video2music.generate_batch`` at B=3 with bridged weights, mixed primers,
keys and temperatures and the JAX sampling noise handed in must give the
same chords and byte-identical MIDI, stems and inst.csv for every clip.
Also: the generate_batch contract (n_real, on_decoded, defer_render, the
empty batch), the port's DynamicBatcher (with a raw-video request, through
a tiny seeded CLIP), and no kernel launch on the CPU."""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from video2music_tpu.core import constants as C
from video2music_tpu.pipeline import Video2music as JaxVideo2music
from video2music_tpu_torch.features import clip as pclip
from video2music_tpu_torch.ops import decode_batch as port_batch
from video2music_tpu_torch.ops import decode_layer as port_decode
from video2music_tpu_torch.ops.flash_attention import flash_attention
from video2music_tpu_torch.ops.scan import selective_scan
from video2music_tpu_torch.pipeline import Video2music
from video2music_tpu_torch.pipeline.serving import DynamicBatcher
from video2music_tpu_torch.weights import (amt_from_jax, init_weights_,
                                           regression_from_jax)

torch.set_num_threads(1)
KW = dict(music_gen_version="2.2", reg_model="bimamba+", motion_type=0,
          amt_overrides=dict(n_layers=3, num_heads=2, d_model=16, d_ff=32),
          reg_overrides=dict(n_layers=1, d_model=8, d_hidden=16))
T = 300


def _features(n_sec, seed):
    r = np.random.default_rng(seed)
    return {"semantic": r.standard_normal((n_sec, 768)).astype(np.float32),
            "emotion": r.uniform(size=(n_sec, 6)).astype(np.float32),
            "scene_offset": np.arange(n_sec, dtype=np.float32),
            "motion": r.standard_normal((n_sec,)).astype(np.float32)}


def _jax_gumbel(seed, n):
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T - 1):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (n, C.CHORD_END))))
    return torch.from_numpy(np.stack(out))


def _tiny_clip():
    """A 56 px CLIP with the product's 768-d projection, seeded."""
    cfg = pclip.CLIPConfig(
        vision=pclip.CLIPVisionConfig(hidden_size=16, layers=1, heads=2,
                                      image_size=56),
        text=pclip.CLIPTextConfig(hidden_size=16, layers=1, heads=2,
                                  vocab_size=40, context_length=9))
    gen = torch.Generator().manual_seed(1)
    text = torch.randn(6, 768, generator=gen).numpy()
    return dict(clip_cfg=cfg, emotion_text_embeds=text,
                extractor_dtype="float32", clip_params=init_weights_(
                    pclip.CLIP(cfg), gen).state_dict())


@pytest.fixture(scope="module")
def pair():
    jv = JaxVideo2music(**KW)
    pv = Video2music(device="cpu", **_tiny_clip(), **KW)
    pv.load_state_dicts(
        amt_from_jax(jax.device_get(jv.variables["params"])),
        regression_from_jax(jax.device_get(jv.reg_variables["params"])))
    return jv, pv


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _requests():
    return [dict(features=_features(24, 5), primer="C Am", key="C major"),
            dict(features=_features(10, 6), primer=""),
            dict(features=_features(40, 7), primer="G Em C D",
                 key="A minor")]


def test_generate_batch_matches_jax_pipeline(pair, tmp_path):
    jv, pv = pair
    kw = dict(temperature=[0.9, 1.0, 1.1], seed=3, compute_dtype="float32")
    want = jv.generate_batch(_requests(), output_dir=str(tmp_path / "jax"),
                             **kw)
    got = pv.generate_batch(_requests(), output_dir=str(tmp_path / "port"),
                            _gumbel=_jax_gumbel(3, 3), **kw)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.chord_ids, w.chord_ids,
                                      err_msg=f"clip {i}")
        assert g.chords == w.chords and g.key == w.key
        assert g.densities == w.densities and g.velocities == w.velocities
        np.testing.assert_array_equal(g.instruments, w.instruments)
    jax_files = _files(tmp_path / "jax")
    port_files = _files(tmp_path / "port")
    for i in range(3):
        assert f"clip_{i:03d}/output.mid" in port_files
        assert f"clip_{i:03d}/inst.csv" in port_files
    assert sorted(port_files) == sorted(jax_files)
    for name, data in jax_files.items():
        assert port_files[name] == data, f"{name} differs"
    assert set(pv.last_timings) >= {"encode", "prime", "decode",
                                    "regression", "postprocess", "total"}


def test_generate_batch_contract(pair, tmp_path):
    """n_real: the pad clone decodes but is neither rendered nor returned;
    on_decoded fires per real clip after the fetch and before any render;
    defer_render returns the render closure; an empty batch gives []."""
    _, pv = pair
    reqs = _requests()[:2] + [dict(_requests()[1],
                                   output_dir=str(tmp_path / "_pad"))]
    seen = []

    def on_decoded(i, payload):
        seen.append(i)
        assert not os.path.exists(tmp_path / f"clip_{i:03d}")
        assert len(payload["chord_ids"]) == len(payload["chords"])

    render = pv.generate_batch(reqs, output_dir=str(tmp_path), n_real=2,
                               temperature=1.0, compute_dtype="float32",
                               on_decoded=on_decoded, defer_render=True)
    assert seen == [0, 1] and callable(render)
    assert not os.path.exists(tmp_path / "clip_000")
    results = render()
    assert len(results) == 2
    assert [len(r.chord_ids) for r in results] == [24, 10]
    assert os.path.exists(tmp_path / "clip_000" / "output.mid")
    assert not os.path.exists(tmp_path / "_pad")
    assert pv.generate_batch([], defer_render=True)() == []
    assert pv.generate_batch([]) == []
    with pytest.raises(ValueError, match="temperature"):
        pv.generate_batch(reqs, temperature=[1.0, 0.5])


def test_dynamic_batcher_over_port(pair, tmp_path):
    """Five concurrent requests with mixed temperatures through the port's
    DynamicBatcher (the JAX package's batching policy, loaded by path):
    every caller gets its clip, at least one batch is wider than 1, and a
    raw-video request (a 6 s clip written with cv2) gets its clip through
    extract_features_batch."""
    _, pv = pair
    batcher = DynamicBatcher(pv, max_batch=8, max_wait_ms=3000,
                             output_dir=str(tmp_path),
                             compute_dtype="float32")
    try:
        temps = [0.8, 0.9, 1.0, 1.1, 1.2]
        futs = [batcher.submit({"features": _features(8 + i, 20 + i)},
                               temperature=t) for i, t in enumerate(temps)]
        results = [f.result(timeout=600) for f in futs]
        for i, (res, width) in enumerate(results):
            assert res.chord_ids.shape == (8 + i,)
            assert ((res.chord_ids >= 1) & (res.chord_ids < C.CHORD_END)).all()
            assert os.path.getsize(res.midi_path) > 0 and width >= 1
        assert batcher.stats["batched_requests"] == 5
        assert batcher.stats["max_batch_size"] > 1
        path = _write_clip(str(tmp_path / "clip.mp4"))
        res, _ = batcher.submit({"video": path}).result(timeout=600)
        assert res.chord_ids.shape == (6,)
        assert ((res.chord_ids >= 1) & (res.chord_ids < C.CHORD_END)).all()
        assert os.path.getsize(res.midi_path) > 0
    finally:
        batcher.stop()
    assert not any(t.name in ("v2m-batcher", "v2m-render") and t.is_alive()
                   for t in threading.enumerate())


def _write_clip(path, seconds=6, fps=5.0, w=64, h=48):
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        pytest.skip("cv2.VideoWriter cannot encode here")
    colors = np.random.default_rng(3).integers(0, 255, (2, 3))
    for i in range(int(seconds * fps)):
        img = np.empty((h, w, 3), np.uint8)
        img[:] = colors[i * 2 // int(seconds * fps)]
        writer.write(img)
    writer.release()
    return path


def test_cpu_generate_batch_launches_no_kernel(pair, tmp_path):
    _, pv = pair
    fns = (flash_attention, port_decode.decode_layer_step,
           port_decode.decode_ends_step, selective_scan,
           port_batch.batched_layer_step, port_batch.batched_moe_ffn)
    for fn in fns:
        fn.launches = 0
    res = pv.generate_batch(_requests()[:2], output_dir=str(tmp_path),
                            compute_dtype="float32")
    assert [r.chord_ids.shape for r in res] == [(24,), (10,)]
    assert all(fn.launches == 0 for fn in fns)
