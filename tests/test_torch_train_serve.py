"""The two halves of the port joined on the CPU: the regression and
MusicTransformer epoch loops (their CSV rows and checkpoints), a
``train_amt`` / ``train_regression`` checkpoint served by
``Video2music(amt_checkpoint=..., reg_checkpoint=...)`` token for token
with the trained models, the same swap by ``load_checkpoints`` through
the DynamicBatcher while it serves, and the reference's torch state dicts
loaded through the port's copy of train/convert.py and the weight
bridges (held against the JAX model on the same converted params)."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import reference_state_dict
from tests.test_convert import _TorchReg
from tests.test_data import _write_fixture_tree
from video2music_tpu.core.config import amt_config as jax_amt_config
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu_torch.core import constants as C
from video2music_tpu_torch.core.config import (MusicTransformerConfig,
                                               RegressionConfig, TrainConfig,
                                               amt_config)
from video2music_tpu_torch.data import create_vevo_datasets
from video2music_tpu_torch.models import VideoMusicTransformer, VideoRegression
from video2music_tpu_torch.pipeline.api import Video2music
from video2music_tpu_torch.pipeline.serving import DynamicBatcher
from video2music_tpu_torch.train import (CSV_HEADER, REG_CSV_HEADER,
                                         LoopConfig, create_train_state,
                                         load_weights, restore_checkpoint,
                                         train_amt, train_music_transformer,
                                         train_regression)
from video2music_tpu_torch.train.convert import (
    convert_reference_amt, convert_reference_regression)
from video2music_tpu_torch.weights import amt_from_jax, regression_from_jax

torch.set_num_threads(1)
IDS = ["aaa", "bbb", "ccc", "ddd", "eee"]
AMT_KW = dict(n_layers=2, num_heads=2, d_model=16, d_ff=32)
REG_KW = dict(n_layers=1, d_model=8, d_hidden=16)
KW = dict(music_gen_version="2.2", reg_model="bimamba+", motion_type=0,
          amt_overrides=AMT_KW, reg_overrides=REG_KW)
TCFG = TrainConfig(optimizer="adamw", lr=1e-3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The test fixture tree with 768-d semantic features, as
    Video2music's models read them (motion_type 0: scalar motion)."""
    root = str(tmp_path_factory.mktemp("vevo768"))
    _write_fixture_tree(root, IDS)
    r = np.random.default_rng(1)
    sem = os.path.join(root, "vevo_semantic", "origin", "2d", "clip_l14p")
    for fid in IDS:
        np.save(os.path.join(sem, fid + ".npy"),
                r.standard_normal((4, 768)).astype(np.float32))
    return root


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _loop(out, **kw):
    return LoopConfig(epochs=1, batch_size=2, output_dir=out,
                      log_fn=lambda s: None, **kw)


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    """One CPU epoch of train_amt (2.2) and of train_regression
    (bimamba+) at Video2music's sequence length."""
    out = str(tmp_path_factory.mktemp("runs"))
    train_ds, val_ds, _ = create_vevo_datasets(tree)
    amt = train_amt(amt_config("2.2", total_vf_dim=768 + 1 + 1 + 6,
                               **AMT_KW), TCFG,
                    _loop(os.path.join(out, "amt")), train_ds, val_ds,
                    device="cpu")
    reg = train_regression(RegressionConfig(reg_model="bimamba+", **REG_KW),
                           TCFG, _loop(os.path.join(out, "reg")), train_ds,
                           val_ds, device="cpu")
    return dict(out=out, amt=amt, reg=reg,
                amt_ckpt=os.path.join(out, "amt", "weights",
                                      "best_loss_weights"),
                reg_ckpt=os.path.join(out, "reg", "weights",
                                      "best_rmse_weights"))


def test_train_regression_epoch_writes_results_and_best_rmse(trained, tree):
    out = os.path.join(trained["out"], "reg")
    rows = _rows(os.path.join(out, "results.csv"))
    assert rows[0] == REG_CSV_HEADER and len(rows) == 2
    assert rows[1][0] == "1" and float(rows[1][1]) == 1e-3
    assert all(np.isfinite(float(v)) for v in rows[1][2:])
    assert os.listdir(os.path.join(out, "weights")) == ["best_rmse_weights"]
    assert trained["reg"].step == 3  # 5 clips in batches of 2
    fresh = restore_checkpoint(
        trained["reg_ckpt"], create_train_state(
            RegressionConfig(reg_model="bimamba+", **REG_KW), TCFG,
            device="cpu"))
    assert fresh.step == 3 and fresh.optimizer.count == 3
    for k, v in trained["reg"].model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


def test_train_music_transformer_epoch_writes_results(tree, tmp_path):
    train_ds, val_ds, _ = create_vevo_datasets(tree, max_seq_chord=10,
                                               max_seq_video=10)
    cfg = MusicTransformerConfig(n_layers=2, num_heads=2, d_model=16,
                                 d_ff=32, max_seq_chord=10)
    state = train_music_transformer(cfg, TCFG, _loop(str(tmp_path)),
                                    train_ds, val_ds, device="cpu")
    assert state.step == 3
    rows = _rows(tmp_path / "results.csv")
    assert rows[0] == CSV_HEADER and len(rows) == 2
    # the train and emotion columns empty; eval loss twice, hits@1/3/5
    assert rows[1][:8] == ["1"] + [""] * 7 and rows[1][10] == ""
    assert rows[1][8] == rows[1][9]
    assert all(np.isfinite(float(rows[1][i])) for i in (8, 11, 12, 13))
    ckpt = str(tmp_path / "weights" / "best_loss_weights")
    sd = load_weights(ckpt, model_class="MusicTransformer")
    for k, v in state.model.state_dict().items():
        assert torch.equal(sd[k], v), k


def _features(n_sec, seed):
    r = np.random.default_rng(seed)
    return {"semantic": r.standard_normal((n_sec, 768)).astype(np.float32),
            "emotion": r.uniform(size=(n_sec, 6)).astype(np.float32),
            "scene_offset": np.arange(n_sec, dtype=np.float32),
            "motion": r.uniform(size=(n_sec,)).astype(np.float32)}


def test_checkpoints_serve_token_for_token(trained, tmp_path):
    """Video2music(amt_checkpoint=..., reg_checkpoint=...) generates the
    trained models' chords and regression outputs: the same as a
    Video2music given the trained state dicts, f32 and bf16."""
    served = Video2music(device="cpu", seed=9,
                         amt_checkpoint=trained["amt_ckpt"],
                         reg_checkpoint=trained["reg_ckpt"], **KW)
    mem = Video2music(device="cpu", **KW)
    mem.load_state_dicts(trained["amt"].model.state_dict(),
                         trained["reg"].model.state_dict())
    feats = _features(12, 3)
    for dtype in ("float32", "bfloat16"):
        a = served.generate(features=feats, compute_dtype=dtype, seed=4,
                            output_dir=str(tmp_path / f"a_{dtype}"))
        reg_a = dict(served.last_regression)
        b = mem.generate(features=feats, compute_dtype=dtype, seed=4,
                         output_dir=str(tmp_path / f"b_{dtype}"))
        np.testing.assert_array_equal(a.chord_ids, b.chord_ids)
        for k, v in mem.last_regression.items():
            np.testing.assert_array_equal(reg_a[k], v, err_msg=k)


def test_load_checkpoints_swaps_weights_behind_the_batcher(trained,
                                                           tmp_path):
    """A seeded Video2music behind the DynamicBatcher answers, then
    ``load_checkpoints`` through ``submit_control`` swaps in the trained
    weights between batches (dropping the bf16 copy): the next answer is
    the served checkpoint's, token for token."""
    served = Video2music(device="cpu", amt_checkpoint=trained["amt_ckpt"],
                         reg_checkpoint=trained["reg_ckpt"], **KW)
    want = served.generate(features=_features(10, 5),
                           output_dir=str(tmp_path / "want"))
    v2m = Video2music(device="cpu", seed=3, **KW)
    batcher = DynamicBatcher(v2m, max_batch=1, max_wait_ms=1,
                             output_dir=str(tmp_path / "serve"))
    try:
        req = {"features": _features(10, 5)}
        before, _ = batcher.submit(dict(req)).result(timeout=600)
        assert v2m._bf16 is not None
        batcher.submit_control(lambda m: m.load_checkpoints(
            trained["amt_ckpt"], trained["reg_ckpt"])).result(timeout=600)
        after, _ = batcher.submit(dict(req)).result(timeout=600)
    finally:
        batcher.stop()
    np.testing.assert_array_equal(after.chord_ids, want.chord_ids)
    assert not np.array_equal(before.chord_ids, after.chord_ids)
    for k, v in served.model.state_dict().items():
        assert torch.equal(v2m.model.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# the reference's checkpoints through train/convert.py
# ---------------------------------------------------------------------------

def test_reference_regression_state_dict_loads_through_convert():
    """The reference's bilstm regression (a random-weight torch mirror, as
    tests/test_convert.py builds it) -> convert_reference_regression ->
    weights.regression_from_jax -> the port's VideoRegression: the same
    outputs as the torch module."""
    torch.manual_seed(1)
    vf_sem, vf_emo, d = 7, 2, 8
    t = _TorchReg(vf_sem + vf_emo, d).eval()
    r = np.random.default_rng(1)
    sem = torch.from_numpy(r.standard_normal((2, 10, vf_sem)).astype(
        np.float32))
    emo = torch.from_numpy(r.standard_normal((2, 10, vf_emo)).astype(
        np.float32))
    with torch.no_grad():
        want_reg, want_cls = t(sem, emo)
    model = VideoRegression(RegressionConfig(
        reg_model="bilstm", n_layers=2, d_model=d,
        total_vf_dim=vf_sem + vf_emo, dropout=0.0)).eval()
    model.load_state_dict(regression_from_jax(
        convert_reference_regression(t.state_dict(), "bilstm")))
    with torch.no_grad():
        got_reg, got_cls = model(sem, torch.zeros(2, 10), torch.zeros(2, 10),
                                 emo)
    torch.testing.assert_close(got_reg, want_reg, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got_cls, want_cls, rtol=2e-4, atol=2e-5)


def test_reference_amt_state_dict_loads_through_convert():
    """A base-AMT state dict in the reference's names (the torch
    nn.Transformer core, the decoder's RPR tables, the embeddings and
    projections; chip_smoke.py's builder) -> convert_reference_amt ->
    weights.amt_from_jax -> the port's base AMT: the same logits as the
    JAX base AMT on the converted params."""
    D, H, FF, n, Lq, vf = 16, 2, 32, 2, 9, 15
    sd = reference_state_dict("amt", 3, d=D, ff=FF, heads=H, n=n, S=Lq,
                              vf=vf)
    params = convert_reference_amt(sd, n_layers=n)
    kw = dict(n_layers=n, num_heads=H, d_model=D, d_ff=FF, dropout=0.0,
              max_seq_chord=Lq, max_seq_video=Lq, total_vf_dim=vf)
    model = VideoMusicTransformer(amt_config(None, **kw)).eval()
    model.load_state_dict(amt_from_jax(params))
    r = np.random.default_rng(4)
    args = [r.integers(0, C.CHORD_END, (2, Lq)),
            r.integers(0, 13, (2, Lq)), r.integers(0, 14, (2, Lq)),
            r.standard_normal((2, Lq, vf - 8)).astype(np.float32),
            r.integers(0, 2, (2, 1)).astype(np.float32),
            r.integers(0, 5, (2, Lq)).astype(np.float32),
            r.standard_normal((2, Lq)).astype(np.float32),
            r.uniform(size=(2, Lq, 6)).astype(np.float32)]
    want = JaxAMT(cfg=jax_amt_config(None, **kw)).apply(
        {"params": params}, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = model(*(torch.as_tensor(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
