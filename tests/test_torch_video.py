"""Raw video in, on the port, against the JAX package (CPU, f32): CLIP's
vision and text towers and ``semantic_and_emotion`` and MaxViT on bridged
weights (the tiny configs of tests/test_pipeline.py: a 56 px CLIP with the
product's 768-d projection, a 2-stage MaxViT whose stage 0 has 2 x 2
windows and grids), the encoder attention's ``scale`` keyword and shared
bias, the frame helpers, ``extract_features`` on a multi-scene clip
written with cv2 (against the JAX pipeline and against one monolithic
pass), ``extract_features_batch`` against per-clip extraction,
``generate(video=...)`` token for token, a DynamicBatcher request with a
video, and the muxing call where fluidsynth and ffmpeg would run."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video2music_tpu.core import constants as C
from video2music_tpu.features import clip as jclip
from video2music_tpu.features import maxvit as jmaxvit
from video2music_tpu.pipeline import Video2music as JaxVideo2music
from video2music_tpu_torch.features import clip as pclip
from video2music_tpu_torch.features import maxvit as pmaxvit
from video2music_tpu_torch.features import scene as scene_mod
from video2music_tpu_torch.ops.flash_attention import (flash_attention,
                                                       flash_attention_plain)
from video2music_tpu_torch.pipeline import Video2music
from video2music_tpu_torch.pipeline import api as papi
from video2music_tpu_torch.pipeline import video_io
from video2music_tpu_torch.pipeline.serving import DynamicBatcher
from video2music_tpu_torch.weights import (amt_from_jax, clip_from_jax,
                                           init_weights_, maxvit_from_jax,
                                           regression_from_jax)

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5  # f32, sums taken in another order
T = 300
JCFG = jclip.CLIPConfig(
    vision=jclip.CLIPVisionConfig(hidden_size=16, layers=1, heads=2,
                                  patch_size=14, image_size=56,
                                  projection_dim=768),
    text=jclip.CLIPTextConfig(hidden_size=16, layers=2, heads=2,
                              vocab_size=40, context_length=9,
                              projection_dim=768))
PCFG = pclip.CLIPConfig(vision=pclip.CLIPVisionConfig(**vars(JCFG.vision)),
                        text=pclip.CLIPTextConfig(**vars(JCFG.text)))
JMCFG = jmaxvit.MaxViTConfig(channels=(8, 16), depths=(1, 1),
                             stem_channels=8, partition=7, head_dim=8,
                             image_size=56)
PMCFG = pmaxvit.MaxViTConfig(**vars(JMCFG))
# the pipeline's: the same, with the 512-d motion the AMT takes
JMCFG_512 = jmaxvit.MaxViTConfig(**dict(vars(JMCFG), channels=(8, 512)))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _perturb_bn(tree, rng):
    """FoldedBN scale / bias away from the identity the init gives."""
    for name, sub in tree.items():
        if not isinstance(sub, dict):
            continue
        if set(sub) == {"scale", "bias"} and not name.startswith("ln"):
            sub["scale"] = (1 + 0.2 * rng.standard_normal(
                sub["scale"].shape)).astype(np.float32)
            sub["bias"] = (0.1 * rng.standard_normal(
                sub["bias"].shape)).astype(np.float32)
        else:
            _perturb_bn(sub, rng)
    return tree


@pytest.fixture(scope="module")
def extractors():
    """JAX params of the tiny CLIP, the tiny MaxViT (and its 512-d form)
    and the emotion text embeddings, made from seeds."""
    rng = jax.random.PRNGKey(0)
    text = np.asarray(jax.random.normal(jax.random.fold_in(rng, 1),
                                        (6, 768)), np.float32)
    clip_params = jax.device_get(jax.jit(jclip.CLIP(cfg=JCFG).init)(
        rng, jnp.zeros((1, 56, 56, 3)), jnp.zeros((1, 9), jnp.int32))[
            "params"])
    mv = [_perturb_bn(jax.device_get(jax.jit(jmaxvit.MaxViT(cfg=c).init)(
        jax.random.fold_in(rng, 2), jnp.zeros((1, 56, 56, 3)))["params"]),
        np.random.default_rng(5)) for c in (JMCFG, JMCFG_512)]
    return clip_params, mv[0], text, mv[1]


def test_clip_towers_match_jax(extractors):
    clip_params, _, text, _ = extractors
    rng = np.random.default_rng(1)
    pix = rng.standard_normal((3, 56, 56, 3)).astype(np.float32)
    tok = rng.integers(0, 40, (4, 9)).astype(np.int32)
    jm = jclip.CLIP(cfg=JCFG)
    v = {"params": clip_params}
    run = lambda *a, **kw: jax.jit(lambda v, *a: jm.apply(v, *a, **kw))(
        v, *a)
    pm = pclip.CLIP(PCFG).eval()
    pm.load_state_dict(clip_from_jax(clip_params))
    tp, tt = torch.from_numpy(pix), torch.from_numpy(tok).long()
    with torch.no_grad():
        _close(pm.encode_image(tp), run(pix, method=jclip.CLIP.encode_image))
        _close(pm.encode_text(tt), run(tok, method=jclip.CLIP.encode_text))
        _close(pm(tp, tt)[0], run(pix, tok)[0])
        img, probs = pm.semantic_and_emotion(tp, torch.from_numpy(text))
        want_img, want_probs = run(pix, text,
                                   method=jclip.CLIP.semantic_and_emotion)
        _close(img, want_img)
        _close(probs, want_probs)
        _close(pm.emotion_probs(tp, torch.from_numpy(text)), want_probs)


def test_maxvit_matches_jax(extractors):
    _, mv_params, _, _ = extractors
    pix = np.random.default_rng(2).standard_normal(
        (2, 56, 56, 3)).astype(np.float32)
    want = jax.jit(jmaxvit.MaxViT(cfg=JMCFG).apply)({"params": mv_params},
                                                   pix)
    pm = pmaxvit.MaxViT(PMCFG).eval()
    pm.load_state_dict(maxvit_from_jax(mv_params))
    with torch.no_grad():
        got = pm(torch.from_numpy(pix))
    assert got.shape == (2, 16)
    _close(got, want)
    np.testing.assert_array_equal(pmaxvit._rel_position_index(7),
                                  jmaxvit._rel_position_index(7))


def test_seeded_extractors_cover_every_parameter(extractors):
    """init_weights_ sets every parameter from the generator, and the
    bridges give exactly the models' state-dict keys."""
    gen = torch.Generator().manual_seed(0)
    for model, bridged in ((pclip.CLIP(PCFG), clip_from_jax(extractors[0])),
                           (pmaxvit.MaxViT(PMCFG),
                            maxvit_from_jax(extractors[1]))):
        init_weights_(model, gen)
        assert all(torch.isfinite(p).all() and p.abs().sum() > 0
                   for n, p in model.named_parameters()
                   if not n.endswith("bias"))
        assert sorted(model.state_dict()) == sorted(bridged)


@pytest.mark.parametrize("shared", [False, True])
def test_attention_scale_and_shared_bias(shared):
    """flash_attention's ``scale`` and a (1, H, L, S) bias shared by every
    batch row: the output equals the plain form of the bias expanded to
    (B, H, L, S) at that scale, and the shared bias's gradient is the
    expanded one's summed over the batch."""
    rng = np.random.default_rng(3)
    B, H, L, D = 5, 2, 49, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, H, L, D)).astype(np.float32)) for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal(
        (1 if shared else B, H, L, L)).astype(np.float32)).requires_grad_()
    out = flash_attention(q, k, v, bias=bias, scale=16 ** -0.5)
    full = bias.detach().expand(B, H, L, L).clone().requires_grad_()
    want = flash_attention_plain(q, k, v, bias=full, scale=16 ** -0.5)
    _close(out.detach(), want.detach())
    g = torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32))
    (gb,) = torch.autograd.grad(out, bias, g)
    (gf,) = torch.autograd.grad(want, full, g)
    _close(gb, gf.sum(0, keepdim=True) if shared else gf)
    # the default scale is the head size's
    _close(flash_attention(q, k, v), flash_attention_plain(
        q, k, v, scale=D ** -0.5))


def test_frame_helpers_match_jax():
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (3, 20, 24, 3), dtype=np.uint8)
    _close(pclip.normalize_pixels(torch.from_numpy(u8)),
           jclip.normalize_pixels(u8))
    _close(pmaxvit.normalize_diff_pixels(torch.from_numpy(u8)),
           jmaxvit.normalize_diff_pixels(u8))
    pairs = [(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8),
              rng.integers(0, 256, (20, 24, 3), dtype=np.uint8))
             for _ in range(4)]
    np.testing.assert_array_equal(pmaxvit.motion_diff_frames(pairs),
                                  jmaxvit.motion_diff_frames(pairs))
    np.testing.assert_array_equal(pmaxvit.motion_diff_frames([]),
                                  jmaxvit.motion_diff_frames([]))
    np.testing.assert_array_equal(pmaxvit.scalar_motion(pairs),
                                  jmaxvit.scalar_motion(pairs))
    for backend in ("cv2", "pil"):
        np.testing.assert_array_equal(
            pclip.resize_crop_frames(u8, 16, backend=backend),
            jclip.resize_crop_frames(u8, 16, backend=backend))
        np.testing.assert_array_equal(
            pmaxvit.resize_crop_diff_frames(u8, 16, backend=backend),
            jmaxvit.resize_crop_diff_frames(u8, 16, backend=backend))
    _close(pclip.preprocess_frames(u8, 16), jclip.preprocess_frames(u8, 16))
    _close(pmaxvit.preprocess_diff_frames(u8, 16),
           jmaxvit.preprocess_diff_frames(u8, 16))


def _write_clip(path, seconds=6, fps=5.0, w=64, h=48, n_scenes=3, seed=3):
    """A small multi-scene clip (as tests/test_pipeline.py writes it)."""
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        pytest.skip("cv2.VideoWriter cannot encode here")
    n = int(seconds * fps)
    colors = np.random.default_rng(seed).integers(0, 255, (n_scenes, 3))
    for i in range(n):
        img = np.empty((h, w, 3), np.uint8)
        img[:] = colors[min(i * n_scenes // n, n_scenes - 1)]
        img[:, : (i * 7) % w] //= 2  # motion within the scene
        writer.write(img)
    writer.release()
    return path


KW = dict(music_gen_version="2.2", reg_model="bigru", motion_type=1,
          amt_overrides=dict(n_layers=1, num_heads=2, d_model=16, d_ff=32),
          reg_overrides=dict(n_layers=1, d_model=8, d_hidden=16))


@pytest.fixture(scope="module")
def pair(extractors):
    clip_params, _, text, mv_params = extractors
    ex = dict(emotion_text_embeds=text, extractor_dtype="float32")
    jv = JaxVideo2music(clip_params=clip_params, maxvit_params=mv_params,
                        clip_cfg=JCFG, maxvit_cfg=JMCFG_512, **ex, **KW)
    pv = Video2music(device="cpu", clip_params=clip_from_jax(clip_params),
                     maxvit_params=maxvit_from_jax(mv_params),
                     clip_cfg=PCFG,
                     maxvit_cfg=pmaxvit.MaxViTConfig(**vars(JMCFG_512)),
                     **ex, **KW)
    pv.load_state_dicts(
        amt_from_jax(jax.device_get(jv.variables["params"])),
        regression_from_jax(jax.device_get(jv.reg_variables["params"])))
    return jv, pv


def _same_features(got, want):
    assert sorted(got) == sorted(want)
    for k in ("semantic", "emotion", "motion"):
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k], k)
    np.testing.assert_array_equal(got["scene_offset"], want["scene_offset"])


def test_extract_features_matches_jax_and_one_pass(pair, tmp_path):
    """A 70 s clip (chunks of 30 + 30 + 10 seconds): the JAX pipeline's
    features, and the same as one pass over every frame at once."""
    jv, pv = pair
    path = _write_clip(str(tmp_path / "clip.mp4"), seconds=70)
    got = pv.extract_features(path)
    _same_features(got, jv.extract_features(path))
    assert got["semantic"].shape == (70, 768)
    assert set(pv.last_extract_timings) == {"decode+dispatch",
                                            "scene_decisions",
                                            "device_fetch"}
    # one pass: every 1 fps frame and every difference image at once
    s = video_io.stream_clip(path, 300)
    sem, emo = pv.clip_chunk(pclip.resize_crop_frames(
        s["frames_1fps"], 56, backend="cv2"))
    mot = pv.motion_chunk(pmaxvit.resize_crop_diff_frames(
        pmaxvit.motion_diff_frames(s["pairs"]), 56, backend="cv2"))
    _close(got["semantic"], sem)
    _close(got["emotion"], emo)
    _close(got["motion"], mot)
    assert got["motion"].shape[0] == len(s["pairs"]) + 1
    cuts = scene_mod.detect_cuts(scores=s["scores"])
    spans = scene_mod.scenes_from_cuts(cuts, s["n_frames_capped"], s["fps"])
    offsets = np.asarray(scene_mod.scene_offsets(
        scene_mod.scene_ids_per_second(spans, 70)), np.float32) + 1.0
    np.testing.assert_array_equal(got["scene_offset"], offsets)
    assert len(cuts) >= 2  # three scenes (and cuts inside them)


def test_extract_features_batch_equals_per_clip(pair, tmp_path):
    _, pv = pair
    paths = [_write_clip(str(tmp_path / f"c{i}.mp4"), seconds=s,
                         n_scenes=2 + i, seed=i)
             for i, s in enumerate((6, 9, 4))]
    batch = pv.extract_features_batch(paths)
    assert len(batch) == 3 and pv.extract_features_batch([]) == []
    for path, got in zip(paths, batch):
        _same_features(got, pv.extract_features(path))


def _jax_gumbel(seed):
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T - 1):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (1, C.CHORD_END))))
    return torch.from_numpy(np.stack(out))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_generate_from_video_matches_jax_pipeline(pair, tmp_path):
    jv, pv = pair
    path = _write_clip(str(tmp_path / "clip.mp4"), seconds=12, n_scenes=2)
    kw = dict(primer="C Am", key="C major", seed=3, temperature=0.9,
              compute_dtype="float32")
    want = jv.generate(path, output_dir=str(tmp_path / "jax"), **kw)
    got = pv.generate(path, output_dir=str(tmp_path / "port"),
                      _gumbel=_jax_gumbel(3), **kw)
    assert got.chord_ids.shape == (12,)
    np.testing.assert_array_equal(got.chord_ids, want.chord_ids)
    assert got.densities == want.densities
    assert got.velocities == want.velocities
    np.testing.assert_array_equal(got.instruments, want.instruments)
    jax_files = _files(tmp_path / "jax")
    assert jax_files and _files(tmp_path / "port") == jax_files
    with pytest.raises(ValueError, match="video path or precomputed"):
        pv.generate(output_dir=str(tmp_path / "none"))


def test_batcher_serves_a_video_request(pair, tmp_path):
    """A DynamicBatcher request with a ``video`` and no features goes
    through extract_features_batch and returns its clip, beside a
    features request in the same batch."""
    _, pv = pair
    path = _write_clip(str(tmp_path / "clip.mp4"), seconds=8)
    feats = pv.extract_features(path)
    batcher = DynamicBatcher(pv, max_batch=4, max_wait_ms=2000,
                             output_dir=str(tmp_path / "out"),
                             compute_dtype="float32")
    try:
        futs = [batcher.submit({"video": path}),
                batcher.submit({"features": feats})]
        results = [f.result(timeout=600)[0] for f in futs]
    finally:
        batcher.stop()
    assert not any(t.name in ("v2m-batcher", "v2m-render") and t.is_alive()
                   for t in threading.enumerate())
    for res in results:
        assert res.chord_ids.shape == (8,)
        assert ((res.chord_ids >= 1) & (res.chord_ids < C.CHORD_END)).all()
        assert os.path.getsize(res.midi_path) > 0


def test_render_is_muxed_onto_the_video(pair, tmp_path, monkeypatch):
    """Where fluidsynth and ffmpeg exist, the render goes onto the video
    with the caption overlays; the two tools are stood in for (the tests
    need neither installed), and without them nothing is muxed."""
    _, pv = pair
    calls = []
    feats = dict(semantic=np.zeros((5, 768), np.float32),
                 emotion=np.full((5, 6), 1 / 6, np.float32),
                 scene_offset=np.ones(5, np.float32),
                 motion=np.zeros((5, 512), np.float32))
    overlays = video_io.chord_caption_overlays(2, 5.0)
    res = pv.generate(video="in.mp4", features=feats, caption_overlays=overlays,
                      output_dir=str(tmp_path / "a"), compute_dtype="float32")
    assert res.audio_path is None and res.video_path is None
    monkeypatch.setattr(video_io, "has_fluidsynth", lambda: True)
    monkeypatch.setattr(video_io, "has_ffmpeg", lambda: True)
    monkeypatch.setattr(video_io, "midi_to_audio",
                        lambda m, a, sf=None: calls.append(("audio", m, a)))
    monkeypatch.setattr(video_io, "mux_audio_onto_video",
                        lambda v, a, o, overlays=None: calls.append(
                            ("mux", v, a, o, overlays)))
    res = pv.generate(video="in.mp4", features=feats, caption_overlays=overlays,
                      output_dir=str(tmp_path / "b"), compute_dtype="float32")
    out = str(tmp_path / "b")
    assert calls == [
        ("audio", os.path.join(out, "output.mid"),
         os.path.join(out, "output.flac")),
        ("mux", "in.mp4", os.path.join(out, "output.flac"),
         os.path.join(out, "output.mp4"), overlays)]
    assert res.video_path == os.path.join(out, "output.mp4")
    assert papi.video_io is video_io
