"""The port's product slice against the JAX pipeline (CPU, f32):
``Video2music.generate(features=...)`` with bridged weights and the JAX
sampling noise handed in must give the same chords and byte-identical
MIDI, stems and inst.csv. Also: the port runs with the JAX package and
JAX blocked, CPU calls launch no kernel, the parts a later slice ported
run (port checkpoints among them; an orbax one raises ValueError), and
without CUDA the default device raises instead of falling back."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from video2music_tpu.core import constants as C
from video2music_tpu.pipeline import Video2music as JaxVideo2music
from video2music_tpu.pipeline.api import smooth_emotion as jax_smooth
from video2music_tpu_torch.features.clip import (CLIP, CLIPConfig,
                                                 CLIPTextConfig,
                                                 CLIPVisionConfig)
from video2music_tpu_torch.ops import decode_layer as port_decode
from video2music_tpu_torch.ops.flash_attention import flash_attention
from video2music_tpu_torch.ops.scan import selective_scan
from video2music_tpu_torch.pipeline import Video2music
from video2music_tpu_torch.pipeline.api import _pad_to
from video2music_tpu_torch.weights import (amt_from_jax, init_weights_,
                                           regression_from_jax)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _jax_gumbel(seed):
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T - 1):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (1, C.CHORD_END))))
    return torch.from_numpy(np.stack(out))


@pytest.fixture(scope="module")
def pair():
    jv = JaxVideo2music(**KW)
    pv = Video2music(device="cpu", **KW)
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


def test_generate_matches_jax_pipeline(pair, tmp_path):
    jv, pv = pair
    feats = _features(24, 5)
    kw = dict(primer="C Am", key="C major", features=feats, seed=3,
              temperature=0.9, compute_dtype="float32")
    want = jv.generate(output_dir=str(tmp_path / "jax"), **kw)
    got = pv.generate(output_dir=str(tmp_path / "port"),
                      _gumbel=_jax_gumbel(3), **kw)
    np.testing.assert_array_equal(got.chord_ids, want.chord_ids)
    assert got.chords == want.chords and got.key == want.key
    assert got.densities == want.densities
    assert got.velocities == want.velocities
    np.testing.assert_array_equal(got.instruments, want.instruments)
    jax_files = _files(tmp_path / "jax")
    port_files = _files(tmp_path / "port")
    assert "output.mid" in port_files and "inst.csv" in port_files
    assert any(name.startswith("stems") for name in port_files)
    assert sorted(port_files) == sorted(jax_files)
    for name, data in jax_files.items():
        assert port_files[name] == data, f"{name} differs"

    # the regression outputs behind densities / velocities / instruments
    L = T
    sem = _pad_to(feats["semantic"], L)[None]
    emo = jax_smooth(_pad_to(feats["emotion"], L))[None]
    zeros = np.zeros((1, L), np.float32)
    (ln_nd, inst), _ = jv.model_reg.apply(
        jv.reg_variables, sem, zeros, zeros, emo,
        mutable=["moe_state", "metrics"])
    np.testing.assert_allclose(pv.last_regression["ln_nd"],
                               np.asarray(ln_nd)[0], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pv.last_regression["instrument"],
                               np.asarray(inst)[0], rtol=2e-4, atol=2e-5)


def test_generate_int8_matches_jax_pipeline(pair, tmp_path):
    """quantize="int8" at B=1: the port's int8 "layer" backend against the
    JAX pipeline (on the CPU its fake-quantized XLA step), chord for chord
    and byte for byte."""
    jv, pv = pair
    feats = _features(20, 6)
    kw = dict(primer="Am F", features=feats, seed=2, temperature=1.0,
              compute_dtype="float32", quantize="int8")
    want = jv.generate(output_dir=str(tmp_path / "jax"), **kw)
    got = pv.generate(output_dir=str(tmp_path / "port"),
                      _gumbel=_jax_gumbel(2), **kw)
    np.testing.assert_array_equal(got.chord_ids, want.chord_ids)
    jax_files = _files(tmp_path / "jax")
    assert _files(tmp_path / "port") == jax_files and jax_files


def test_cpu_generate_launches_no_kernel(pair, tmp_path):
    _, pv = pair
    fns = (flash_attention, port_decode.decode_layer_step,
           port_decode.decode_ends_step, selective_scan)
    for fn in fns:
        fn.launches = 0
    res = pv.generate(features=_features(10, 1), output_dir=str(tmp_path),
                      compute_dtype="float32")
    assert res.chord_ids.shape == (10,)
    assert all(fn.launches == 0 for fn in fns)


ISOLATED_RUN = """
import sys, tempfile
BLOCKED = ("video2music_tpu", "jax", "jaxlib", "flax", "optax", "orbax")
for m in BLOCKED:
    sys.modules[m] = None
import importlib, pkgutil
import numpy as np
import torch
import chip_smoke
import video2music_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
# multi-GPU training: the mesh, collectives, shard plan, pipeline, the
# launcher and the pipelined step, run in a world of one rank
import video2music_tpu_torch.parallel.launch
import video2music_tpu_torch.parallel.worlds
from video2music_tpu_torch.parallel import create_mesh
from video2music_tpu_torch.parallel.shard import shard_train_state_
from video2music_tpu_torch.train.pp import make_amt_pp_train_step
from video2music_tpu_torch.core.config import TrainConfig, amt_config
from video2music_tpu_torch.core.vocab import emotion_chord_targets
from video2music_tpu_torch.pipeline import Video2music
from video2music_tpu_torch.pipeline.serving import DynamicBatcher
from video2music_tpu_torch.train import create_train_state, make_amt_train_step
torch.set_num_threads(1)
r = np.random.default_rng(0)
feats = {"semantic": r.standard_normal((6, 768)).astype(np.float32),
         "emotion": r.uniform(size=(6, 6)).astype(np.float32),
         "scene_offset": np.arange(6, dtype=np.float32),
         "motion": r.standard_normal((6,)).astype(np.float32)}
v2m = Video2music(device="cpu", music_gen_version="2.2", reg_model="bimamba+",
                  motion_type=0, amt_overrides=dict(n_layers=2, num_heads=2,
                  d_model=32, d_ff=64), reg_overrides=dict(n_layers=1,
                  d_model=8, d_hidden=16))
v3 = Video2music(device="cpu", music_gen_version="3.1", reg_model="bimamba+",
                 motion_type=0, amt_overrides=dict(n_layers=2, num_heads=2,
                 d_model=16, d_ff=32), reg_overrides=dict(n_layers=1,
                 d_model=8, d_hidden=16))
with tempfile.TemporaryDirectory() as tmp:
    assert v2m.generate(features=feats, output_dir=tmp).chord_ids.shape == (6,)
    assert v3.generate(features=feats, output_dir=tmp).chord_ids.shape == (6,)
    # int8 KV caches (two heads of 16): the batched step's caches are int8
    from video2music_tpu_torch.decode import sampler
    init_batch, kv_dtypes = sampler.init_fused_batch_caches, []
    def recording_init(model, cross, kv_quant=None):
        caches = init_batch(model, cross, kv_quant=kv_quant)
        kv_dtypes.append(caches["k0"].dtype)
        return caches
    sampler.init_fused_batch_caches = recording_init
    pair = v2m.generate_batch([{"features": feats}] * 2, output_dir=tmp,
                              kv_quant="int8")
    sampler.init_fused_batch_caches = init_batch
    assert [r.chord_ids.shape for r in pair] == [(6,), (6,)]
    assert kv_dtypes == [torch.int8], kv_dtypes
    batcher = DynamicBatcher(v2m, max_batch=2, max_wait_ms=10, output_dir=tmp)
    try:
        res, width = batcher.submit({"features": feats}).result(timeout=300)
    finally:
        batcher.stop()
    assert res.chord_ids.shape == (6,) and width >= 1
    # raw video in: a tiny seeded CLIP and a 512-d MaxViT, the mingru
    # regression
    import cv2
    from video2music_tpu_torch.features.clip import (
        CLIP, CLIPConfig, CLIPTextConfig, CLIPVisionConfig)
    from video2music_tpu_torch.features.maxvit import MaxViT, MaxViTConfig
    from video2music_tpu_torch.weights import init_weights_
    gen = torch.Generator().manual_seed(0)
    ccfg = CLIPConfig(vision=CLIPVisionConfig(hidden_size=16, layers=1,
                                              heads=2, image_size=56),
                      text=CLIPTextConfig(hidden_size=16, layers=1, heads=2,
                                          vocab_size=40, context_length=9))
    mcfg = MaxViTConfig(channels=(8, 512), depths=(1, 1), stem_channels=8,
                        head_dim=8, image_size=56)
    vid = Video2music(
        device="cpu", music_gen_version="2.2", reg_model="mingru",
        motion_type=1, amt_overrides=dict(n_layers=2, num_heads=2,
        d_model=16, d_ff=32), reg_overrides=dict(n_layers=1, d_model=8),
        clip_cfg=ccfg, maxvit_cfg=mcfg, extractor_dtype="float32",
        clip_params=init_weights_(CLIP(ccfg), gen).state_dict(),
        maxvit_params=init_weights_(MaxViT(mcfg), gen).state_dict(),
        emotion_text_embeds=torch.randn(6, 768, generator=gen).numpy())
    path = tmp + "/clip.mp4"
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5.0, (64, 48))
    for i in range(20):
        w.write(np.full((48, 64, 3), 40 + 150 * (i >= 10), np.uint8))
    w.release()
    assert vid.generate(path, output_dir=tmp).chord_ids.shape == (4,)
L = 8
cfg = amt_config("2.2", n_layers=2, num_heads=2, d_model=32, d_ff=64,
                 max_seq_video=L, max_seq_chord=L, total_vf_dim=8 + 1 + 1 + 6)
state = create_train_state(cfg, TrainConfig(lr=1e-3), device="cpu")
B = 2
batch = dict(x=r.integers(0, 157, (B, L)), x_root=r.integers(0, 13, (B, L)),
             x_attr=r.integers(0, 14, (B, L)), tgt=r.integers(0, 157, (B, L)),
             tgt_emotion=emotion_chord_targets()[r.integers(0, 6, (B, L))],
             semantic=r.standard_normal((B, L, 8)).astype(np.float32),
             key=np.zeros((B, 1), np.float32),
             scene_offset=np.zeros((B, L), np.float32),
             motion=r.standard_normal((B, L)).astype(np.float32),
             emotion=r.uniform(size=(B, L, 6)).astype(np.float32))
state, m = make_amt_train_step(TrainConfig(lr=1e-3))(
    state, {k: torch.as_tensor(v) for k, v in batch.items()})
assert state.step == 1 and torch.isfinite(m["loss"])
# a tp and a pipelined step on a mesh of one gloo rank
with tempfile.TemporaryDirectory() as tmp:
    mesh = create_mesh((1, 1), backend="gloo", init_method="file://" + tmp
                       + "/rdv", rank=0, world_size=1)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    for parallel in ("tp", "pp"):
        st = create_train_state(cfg, TrainConfig(lr=1e-3), device="cpu")
        shard_train_state_(st, mesh, parallel)
        step = (make_amt_pp_train_step(cfg, TrainConfig(lr=1e-3), mesh, 2)
                if parallel == "pp" else
                make_amt_train_step(TrainConfig(lr=1e-3), mesh=mesh))
        st, m = step(st, tb)
        assert st.step == 1 and torch.isfinite(m["loss"])
# a regression step (Lion) and a MusicTransformer step (RAdanW)
from video2music_tpu_torch.core.config import (MusicTransformerConfig,
                                               RegressionConfig)
from video2music_tpu_torch.train import (make_music_transformer_train_step,
                                         make_regression_train_step)
tb = {k: torch.as_tensor(v) for k, v in batch.items()}
tb.update(note_density=torch.rand(B, L), loudness=torch.rand(B, L),
          instrument=(torch.rand(B, L, 40) > 0.5).float())
for cfg, opt, make in (
        (RegressionConfig(reg_model="bimamba+", n_layers=1, d_model=8,
                          d_hidden=16, total_vf_dim=8 + 6), "lion",
         make_regression_train_step),
        (MusicTransformerConfig(n_layers=1, num_heads=2, d_model=16, d_ff=32,
                                max_seq_chord=L), "radanw",
         make_music_transformer_train_step)):
    tcfg = TrainConfig(lr=1e-3, optimizer=opt)
    st, m = make(tcfg)(create_train_state(cfg, tcfg, device="cpu"), tb)
    assert st.step == 1 and torch.isfinite(m["loss"])
# one train_amt CLI epoch on a feature tree of four 8 s clips
from video2music_tpu_torch.cli import train_amt as train_amt_cli
with tempfile.TemporaryDirectory() as tmp:
    chip_smoke.write_feature_tree(tmp + "/vevo", 4, 8, seed=1)
    train_amt_cli.main(["-dataset_dir", tmp + "/vevo", "-output_dir",
                        tmp + "/run", "-music_gen_version", "2.2",
                        "-motion_type", "1", "-epochs", "1", "-batch_size",
                        "2", "-n_layers", "2", "-num_heads", "2",
                        "-d_model", "16", "-dim_feedforward", "32",
                        "-device", "cpu"])
    import os
    assert os.path.isfile(tmp + "/run/weights/best_loss_weights")
    assert len(os.listdir(tmp + "/run/tensorboard")) == 1
loaded = [m for m in sys.modules
          if m.split(".")[0] in BLOCKED and sys.modules[m] is not None]
assert not loaded, loaded
print("isolated ok")
"""


def test_port_imports_no_jax():
    """With the JAX package and JAX itself blocked, the whole port imports
    (every module, the raw-video ones and every CLI too, and chip_smoke.py)
    and runs on the CPU: a tiny 2.2 and a tiny V3.1 ``generate``, a 2.2
    ``generate_batch(kv_quant="int8")`` at B=2 on int8 KV caches, a
    DynamicBatcher request, a ``generate(video=...)`` through seeded CLIP
    and MaxViT with the mingru regression, one train step each of an AMT, a regression and a
    MusicTransformer, and one epoch of the ``train_amt`` CLI."""
    out = subprocess.run([sys.executable, "-c", ISOLATED_RUN], cwd=ROOT,
                         check=True, timeout=600, capture_output=True,
                         text=True)
    assert "isolated ok" in out.stdout


@pytest.mark.parametrize("case", ["video", "checkpoint", "backbone",
                                  "wiring"])
def test_outside_the_slice_raises(pair, tmp_path, case):
    """The parts once outside the port now run: raw video in (a
    ``generate(video=...)`` through a tiny seeded CLIP), the RNN backbones
    (a ``bigru`` regression), port checkpoints (an orbax directory or any
    other file raises a ValueError naming the rewriter still to come,
    while a port checkpoint of the model serves its weights), and training
    through differential attention (a V3.1 training forward)."""
    _, pv = pair
    if case == "video":
        cv2 = pytest.importorskip("cv2")
        path = str(tmp_path / "clip.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5.0,
                                 (64, 48))
        for i in range(20):
            writer.write(np.full((48, 64, 3), 40 + 150 * (i >= 10),
                                 np.uint8))
        writer.release()
        cfg = CLIPConfig(vision=CLIPVisionConfig(hidden_size=16, layers=1,
                                                 heads=2, image_size=56),
                         text=CLIPTextConfig(hidden_size=16, layers=1,
                                             heads=2, vocab_size=40,
                                             context_length=9))
        gen = torch.Generator().manual_seed(0)
        v2m = Video2music(
            device="cpu", clip_cfg=cfg, extractor_dtype="float32",
            emotion_text_embeds=torch.randn(6, 768, generator=gen).numpy(),
            clip_params=init_weights_(CLIP(cfg), gen).state_dict(), **KW)
        res = v2m.generate(path, output_dir=str(tmp_path),
                           compute_dtype="float32")
        assert res.chord_ids.shape == (4,) and res.video_path is None
        return
    if case == "backbone":
        res = Video2music(device="cpu", **dict(KW, reg_model="bigru")) \
            .generate(features=_features(7, 2), output_dir=str(tmp_path),
                      compute_dtype="float32")
        assert res.chord_ids.shape == (7,)
        return
    if case == "checkpoint":
        from video2music_tpu_torch.train.checkpoint import save_checkpoint
        from video2music_tpu_torch.train.step import TrainState
        orbax_dir = tmp_path / "orbax"
        orbax_dir.mkdir()
        (tmp_path / "junk").write_bytes(b"not a checkpoint")
        for bad in (str(orbax_dir), str(tmp_path / "junk")):
            with pytest.raises(ValueError, match="orbax rewriter"):
                Video2music(device="cpu", amt_checkpoint=bad, **KW)
        path = str(tmp_path / "amt")
        save_checkpoint(path, TrainState(0, pv.model, _NoOptimizer(),
                                         torch.Generator()))
        served = Video2music(device="cpu", seed=7, amt_checkpoint=path, **KW)
        for k, v in pv.model.state_dict().items():
            assert torch.equal(served.model.state_dict()[k], v), k
        with pytest.raises(ValueError, match="VideoRegression"):
            served.load_checkpoints(reg_checkpoint=path)
        return
    # wiring: every wiring serves and trains, differential attention too
    model = Video2music(device="cpu", **dict(
        KW, music_gen_version="3.1")).model.train()
    L = 5
    ids = torch.zeros(1, L, dtype=torch.long)
    out = model(ids, ids, ids, torch.zeros(1, L, 768), torch.zeros(1, 1),
                torch.zeros(1, L), torch.zeros(1, L), torch.zeros(1, L, 6),
                deterministic=False, generator=torch.Generator())
    assert out.shape == (1, L, 159) and bool(torch.isfinite(out).all())


class _NoOptimizer:
    """The optimizer slot of a TrainState that is saved only."""

    def state_dict(self):
        return {"count": 0}


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """No silent CPU fallback: device=None means "cuda", and without CUDA
    the constructor raises instead of picking the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Video2music(**KW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Video2music(device="cuda", **KW)
