"""The port's AMT training slice against the JAX package on the CPU, at
tiny widths (2+2 layers, d_model 32, 2 heads, d_ff 64, L 12): losses,
the Noam schedule, the dataset and loader, the f32 train step with
dropout 0 over 3 AdamW steps (no random mask is drawn on either side, so
loss and parameters must agree to float rounding: 1e-5 relative), a bf16
mixed-precision step, the eval step, one CPU ``train_amt`` epoch and its
checkpoint, and the entry points' device contract."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_data import _write_fixture_tree
from video2music_tpu.core.config import TrainConfig as JaxTrainConfig
from video2music_tpu.core.config import amt_config as jax_amt_config
from video2music_tpu.core.vocab import emotion_chord_targets
from video2music_tpu.data import VevoDataset as JaxVevoDataset
from video2music_tpu.data import batches as jax_batches
from video2music_tpu.data.loader import PrefetchLoader as JaxPrefetchLoader
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.ops import losses as JL
from video2music_tpu.train import create_train_state as jax_create_state
from video2music_tpu.train import make_amt_eval_step as jax_eval_step
from video2music_tpu.train import make_amt_train_step as jax_train_step
from video2music_tpu.train import make_optimizer as jax_make_optimizer
from video2music_tpu.train.optim import noam_schedule as jax_noam
from video2music_tpu_torch.core import constants as C
from video2music_tpu_torch.core.config import MoEConfig, TrainConfig, amt_config
from video2music_tpu_torch.data import (PrefetchLoader, VevoDataset, batches,
                                        create_vevo_datasets)
from video2music_tpu_torch.data.loader import device_prefetch
from video2music_tpu_torch.ops import losses as PL
from video2music_tpu_torch.ops.flash_attention_dropout import (
    flash_attention_dropout_bwd, flash_attention_dropout_fwd)
from video2music_tpu_torch.ops.moe import MoELayer as SharedMoE
from video2music_tpu_torch.train import (CSV_HEADER, LoopConfig,
                                         create_train_state,
                                         make_amt_eval_step,
                                         make_amt_train_step, noam_schedule,
                                         restore_checkpoint, train_amt)
from video2music_tpu_torch.train.optim import make_optimizer
from video2music_tpu_torch.weights import amt_from_jax, load_amt_from_jax_

torch.set_num_threads(1)
L, SEM, EMO = 12, 7, 6
TINY = dict(n_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_video=L,
            max_seq_chord=L, total_vf_dim=SEM + 1 + 1 + EMO)


def _batch(seed, B=3):
    r = np.random.default_rng(seed)
    rows = emotion_chord_targets()
    tgt = r.integers(0, C.CHORD_END, (B, L))
    tgt[0, -3:] = C.CHORD_PAD
    return dict(
        x=r.integers(0, C.CHORD_END, (B, L)),
        x_root=r.integers(0, 13, (B, L)), x_attr=r.integers(0, 14, (B, L)),
        tgt=tgt, tgt_emotion=rows[r.integers(0, 6, (B, L))].astype(np.float32),
        tgt_emotion_prob=r.uniform(0.3, 1.0, (B, L)).astype(np.float32),
        semantic=r.standard_normal((B, L, SEM)).astype(np.float32),
        key=r.integers(0, 2, (B, 1)).astype(np.float32),
        scene_offset=r.integers(0, 12, (B, L)).astype(np.float32),
        motion=r.standard_normal((B, L)).astype(np.float32),
        emotion=r.uniform(size=(B, L, EMO)).astype(np.float32))


def _torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# losses and the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("auxiliary", [False, True])
def test_losses_match_jax(smoothing, auxiliary):
    r = np.random.default_rng(1)
    logits = r.standard_normal((3, L, C.CHORD_SIZE)).astype(np.float32) * 3
    tgt = r.integers(0, C.CHORD_SIZE, (3, L))
    tgt[1, :4] = C.CHORD_PAD
    emo = (r.uniform(size=(3, L, C.CHORD_SIZE)) > 0.5).astype(np.float32)
    pt, tt = torch.tensor(logits), torch.tensor(tgt)
    jt, jg = jnp.asarray(logits), jnp.asarray(tgt)
    kw = dict(vocab_size=C.CHORD_SIZE, ignore_index=C.CHORD_PAD)
    pairs = [
        (PL.combined_chord_loss(pt, tt, label_smoothing=smoothing,
                                auxiliary=auxiliary, **kw),
         JL.combined_chord_loss(jt, jg, label_smoothing=smoothing,
                                auxiliary=auxiliary, **kw)),
        (PL.cross_entropy(pt, tt, ignore_index=C.CHORD_PAD,
                          label_smoothing=smoothing),
         JL.cross_entropy(jt, jg, ignore_index=C.CHORD_PAD,
                          label_smoothing=smoothing)),
        (PL.smooth_cross_entropy(pt, tt, label_smoothing=smoothing, **kw),
         JL.smooth_cross_entropy(jt, jg, label_smoothing=smoothing, **kw)),
        (PL.topk_auxiliary_loss(pt, tt, k=3, weight=3.0, **kw),
         JL.topk_auxiliary_loss(jt, jg, k=3, weight=3.0, **kw)),
        (PL.bce_with_logits(pt, torch.tensor(emo)),
         JL.bce_with_logits(jt, jnp.asarray(emo))),
        (PL.bce(torch.sigmoid(pt), torch.tensor(emo)),
         JL.bce(jax.nn.sigmoid(jt), jnp.asarray(emo))),
        (PL.smooth_l1(pt, torch.tensor(emo)),
         JL.smooth_l1(jt, jnp.asarray(emo))),
    ]
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   err_msg=f"loss {i}")


def test_noam_schedule_matches_jax():
    got, want = noam_schedule(32, 10, 3), jax_noam(32, 10, 3)
    for count in (0, 1, 5, 7, 8, 50, 1000):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6)
    assert noam_schedule(32, 10)(0) == 0.0


# ---------------------------------------------------------------------------
# the train and eval steps against JAX
# ---------------------------------------------------------------------------

def _pair(tcfg_kw, seed=0, **cfg_kw):
    """A JAX train state and a port state holding the same weights."""
    jcfg = jax_amt_config("2.2", dropout=0.0, **TINY, **cfg_kw)
    jmodel = JaxAMT(cfg=jcfg)
    jtcfg = JaxTrainConfig(**tcfg_kw)
    tx = jax_make_optimizer(jtcfg, d_model=jcfg.d_model)
    b = _batch(seed)
    jstate = jax_create_state(jmodel, tx, jax.random.PRNGKey(seed),
                              {k: jnp.asarray(v) for k, v in b.items()})
    tcfg = TrainConfig(**tcfg_kw)
    state = create_train_state(amt_config("2.2", dropout=0.0, **TINY,
                                          **cfg_kw), tcfg, device="cpu")
    load_amt_from_jax_(state.model, jax.device_get(jstate.params))
    return (jmodel, tx, jtcfg, jstate), (tcfg, state)


def _params_close(port_model, jax_params, rtol, lr):
    """Parameters within ``rtol`` of the model's largest magnitude, but for
    at most one entry in 10^4, which must stay within 0.1 lr. An Adam step
    moves an entry by lr * g / (|g| + eps): where |g| is near eps (1e-8)
    the step follows g's last digits, which two summation orders do not
    share (the gradients themselves agree to 1e-5, see
    test_gradients_f32_match_jax)."""
    want = amt_from_jax(jax.device_get(jax_params))
    got = port_model.state_dict()
    scale = max(w.abs().max().item() for w in want.values())
    diffs = torch.cat([(got[n] - w).abs().flatten() for n, w in want.items()])
    outliers = int((diffs > rtol * scale).sum())
    assert outliers <= 1e-4 * diffs.numel(), outliers
    assert diffs.max().item() <= max(0.1 * lr, rtol * scale), diffs.max()


def test_gradients_f32_match_jax():
    """The loss and every parameter's gradient of one f32 forward and
    backward, within 1e-5 of each tensor's largest gradient."""
    from video2music_tpu.train.step import _amt_forward
    from video2music_tpu.train.step import amt_loss as jax_amt_loss
    from video2music_tpu_torch.train.step import MODEL_INPUTS, amt_loss
    (jmodel, _, jtcfg, jstate), (tcfg, state) = _pair(
        dict(optimizer="adamw", lr=1e-3))
    b = _batch(10)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(params):
        logits, _ = _amt_forward(jmodel, params, jstate.moe_state, jb,
                                 deterministic=True, rngs=None)
        return jax_amt_loss(logits, jb, jtcfg)[0]
    jloss, jgrads = jax.value_and_grad(loss_fn)(jstate.params)
    want = amt_from_jax(jax.device_get(jgrads))
    tb = _torch_batch(b)
    loss = amt_loss(state.model(*(tb[k] for k in MODEL_INPUTS)), tb, tcfg)[0]
    named = dict(state.model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    for (name, _), g in zip(named.items(), grads):
        w = want[name]
        rel = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        assert rel <= 1e-5, (name, rel)


@pytest.mark.parametrize("lr", [1e-3, None], ids=["fixed_lr", "noam"])
def test_train_step_f32_matches_jax_over_three_adamw_steps(lr):
    tkw = dict(optimizer="adamw", lr=lr, warmup_steps=100)
    (jmodel, tx, jtcfg, jstate), (tcfg, state) = _pair(tkw)
    jstep = jax.jit(jax_train_step(jmodel, tx, jtcfg))
    pstep = make_amt_train_step(tcfg)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    for i in range(3):
        b = _batch(10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, pm = pstep(state, _torch_batch(b))
        for key in ("loss", "loss_chord", "loss_emotion"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key} step {i}")
        if i == 0 and lr is None:  # Noam: lr 0 at the first update
            for k, v in state.model.state_dict().items():
                assert torch.equal(v, before[k]), k
            _params_close(state.model, jstate.params, 0.0, 0.0)
    assert state.step == int(jstate.step) == 3
    top_lr = lr or max(noam_schedule(32, 100)(c) for c in range(3))
    _params_close(state.model, jstate.params, 1e-5, top_lr)
    # the MoE layers' load metrics: every token picks k experts
    counts = pm["expert_counts"]
    assert counts.shape == (2, 6)
    assert torch.all(counts.sum(-1) == 3 * L * 2)
    assert pm["maxvio"].shape == (2,)


def test_train_step_bf16_mixed_precision_close_to_jax():
    """One bf16 step: the loss within 2e-2 relative (bf16 activations);
    the f32 master weights move by at most 2 lr (an Adam update of one
    step is +-lr per entry, and bf16 gradients may flip the sign of the
    smallest), and the update agrees in sign on >= 95% of the entries."""
    lr = 1e-3
    tkw = dict(optimizer="adamw", lr=lr, mixed_precision=True)
    (jmodel, tx, jtcfg, jstate), (tcfg, state) = _pair(tkw)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    b = _batch(20)
    jstate, jm = jax.jit(jax_train_step(jmodel, tx, jtcfg))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    state, pm = make_amt_train_step(tcfg)(state, _torch_batch(b))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=2e-2)
    want = amt_from_jax(jax.device_get(jstate.params))
    agree = total = 0
    for name, w in want.items():
        got = state.model.state_dict()[name]
        assert got.dtype == torch.float32
        assert (got - w).abs().max().item() <= 2.0 * lr * 1.01, name
        dg, dw = got - start[name], w - start[name]
        agree += int(((dg > 0) == (dw > 0)).sum())
        total += dg.numel()
    assert agree >= 0.95 * total, agree / total


def test_eval_step_matches_jax():
    tkw = dict(optimizer="adamw", lr=1e-3)
    (jmodel, _, jtcfg, jstate), (tcfg, state) = _pair(tkw, seed=3)
    b = _batch(30)
    want = jax.jit(jax_eval_step(jmodel, jtcfg))(
        jstate.params, jstate.moe_state,
        {k: jnp.asarray(v) for k, v in b.items()})
    got = make_amt_eval_step(tcfg)(state.model, _torch_batch(b))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_training_forward_with_dropout_on_cpu():
    """dropout 0.1: a train step runs the plain dropout attention (no
    launch on CPU tensors), is reproducible from the generator's seed,
    and drop_loss optimises one of the three loss terms."""
    tcfg = TrainConfig(optimizer="adamw", lr=1e-3)
    cfg = amt_config("2.2", **TINY)
    flash_attention_dropout_fwd.launches = 0
    flash_attention_dropout_bwd.launches = 0
    runs = []
    for _ in range(2):
        state = create_train_state(cfg, tcfg, device="cpu")
        state, m = make_amt_train_step(tcfg)(state, _torch_batch(_batch(4)))
        runs.append((m, state.model.state_dict()))
    assert flash_attention_dropout_fwd.launches == 0
    assert flash_attention_dropout_bwd.launches == 0
    assert torch.isfinite(runs[0][0]["loss"])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
    state = create_train_state(cfg, tcfg, device="cpu")
    _, m = make_amt_train_step(tcfg, drop_loss=True)(
        state, _torch_batch(_batch(5)))
    terms = [float(m["loss_chord"]), float(m["loss_emotion"]),
             0.4 * float(m["loss_chord"]) + 0.6 * float(m["loss_emotion"])]
    assert min(abs(float(m["loss"]) - t) for t in terms) < 1e-6


def test_moe_balancing_bias_moves_only_in_training():
    moe = SharedMoE(MoEConfig(expert="glu", shared_expert=True,
                              balancing=True), 16, 32)
    for p in moe.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x = torch.randn(2, 5, 16)
    moe(x)
    assert torch.all(moe.balance_bias == 0)
    moe(x, torch.Generator().manual_seed(0))
    counts = moe.expert_counts
    want = 0.001 * (counts.mean() - counts)
    torch.testing.assert_close(moe.balance_bias, want)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("vevo")
    _write_fixture_tree(str(root), ["aaa", "bbb", "ccc", "ddd", "eee"])
    return str(root)


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("augmentation", [False, True])
def test_dataset_and_batches_match_jax(tree, augmentation):
    kw = dict(dataset_root=tree, split="train", max_seq_chord=10,
              max_seq_video=10, augmentation=augmentation)
    got, want = VevoDataset(**kw), JaxVevoDataset(**kw)
    assert len(got) == len(want) and got.ids == want.ids
    for i in range(len(want)):
        _same_batch(got[i], want[i])
    for g, w in zip(batches(got, 3, shuffle=True, seed=2),
                    jax_batches(want, 3, shuffle=True, seed=2)):
        _same_batch(g, w)
    for g, w in zip(PrefetchLoader(got, 2, seed=1),
                    JaxPrefetchLoader(want, 2, seed=1)):
        _same_batch(g, w)


def test_device_prefetch_copies_batches_to_the_device(tree):
    ds = VevoDataset(tree, split="val", max_seq_chord=10, max_seq_video=10)
    out = list(device_prefetch(batches(ds, 2, shuffle=False), "cpu"))
    assert len(out) == 3
    assert all(isinstance(v, torch.Tensor) for v in out[0].values())
    np.testing.assert_array_equal(out[0]["semantic"].numpy(),
                                  next(batches(ds, 2, shuffle=False))[
                                      "semantic"])


# ---------------------------------------------------------------------------
# the epoch loop
# ---------------------------------------------------------------------------

def test_train_amt_cpu_epoch_writes_results_and_restores(tree, tmp_path):
    train_ds, val_ds, _ = create_vevo_datasets(tree, max_seq_chord=10,
                                               max_seq_video=10)
    cfg = amt_config("2.2", n_layers=2, num_heads=2, d_model=32, d_ff=64,
                     max_seq_video=10, max_seq_chord=10,
                     total_vf_dim=8 + 1 + 1 + 6)
    tcfg = TrainConfig(optimizer="adamw", lr=1e-3)
    out = str(tmp_path / "run")
    loop = LoopConfig(epochs=1, batch_size=2, output_dir=out,
                      log_fn=lambda s: None)
    state = train_amt(cfg, tcfg, loop, train_ds, val_ds, device="cpu")
    assert state.step == 3  # 5 clips in batches of 2
    with open(os.path.join(out, "results.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == CSV_HEADER and len(rows) == 2
    assert rows[1][0] == "1" and float(rows[1][1]) == 1e-3
    assert all(np.isfinite(float(v)) for v in rows[1][2:])
    weights = os.path.join(out, "weights")
    assert sorted(os.listdir(weights)) == ["best_loss_weights", "epoch_0001"]

    fresh = restore_checkpoint(os.path.join(weights, "epoch_0001"),
                               create_train_state(cfg, tcfg, device="cpu"))
    assert fresh.step == 3 and fresh.optimizer.count == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for a, b in zip(fresh.optimizer.mu + fresh.optimizer.nu,
                    state.optimizer.mu + state.optimizer.nu):
        assert torch.equal(a, b)
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())

    # auto_resume continues from epoch 1 and writes one more row
    loop2 = LoopConfig(epochs=2, batch_size=2, output_dir=out,
                       auto_resume=True, log_fn=lambda s: None)
    resumed = train_amt(cfg, tcfg, loop2, train_ds, val_ds, device="cpu")
    assert resumed.step == 6
    with open(os.path.join(out, "results.csv")) as f:
        assert [r[0] for r in csv.reader(f)][1:] == ["1", "2"]


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------

def test_train_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                                 tree):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = amt_config("2.2", **TINY)
    tcfg = TrainConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(cfg, tcfg)
    ds = VevoDataset(tree, split="train", max_seq_chord=10, max_seq_video=10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_amt(cfg, tcfg, LoopConfig(output_dir=str(tree) + "_x"), ds, ds)


@pytest.mark.parametrize("case", ["optimizer", "capacity", "mesh", "profile",
                                  "drop_token", "topk_schedule"])
def test_outside_the_training_slice_raises(case, tree, tmp_path):
    """Meshes are outside the port's training (the multi-GPU slice,
    ROADMAP.md Queue 1 item 13) and raise. The other cases raised until
    they were ported and are now held to the JAX package: Lion against
    optax, the capacity dispatch against the JAX MoE layer, a train step
    with drop_token_rate (finite, and moved by the token drop), a 2.2
    wiring under the top-k scheduler routing every token to JAX's k, and
    the step profiler, which traces steps 1..2 of the first epoch once
    (one Chrome trace file, the JAX loop's log line)."""
    cfg = amt_config("2.2", **TINY)
    tcfg = TrainConfig(optimizer="adamw", lr=1e-3)
    ds = VevoDataset(tree, split="train", max_seq_chord=10, max_seq_video=10)
    loop = LoopConfig(output_dir=str(tmp_path))
    if case == "mesh":
        with pytest.raises(NotImplementedError,
                           match="not ported.*multi-GPU slice"):
            train_amt(cfg, tcfg, loop, ds, ds, device="cpu", mesh=object())
        return
    if case == "profile":
        import json
        logs, prof = [], tmp_path / "prof"
        cfg = amt_config("2.2", **dict(TINY, total_vf_dim=8 + 1 + 1 + 6))
        train_amt(cfg, tcfg, LoopConfig(output_dir=str(tmp_path / "o"),
                                        epochs=2, batch_size=1,
                                        profile_steps=2,
                                        profile_dir=str(prof),
                                        log_fn=logs.append), ds, ds,
                  device="cpu")
        assert os.listdir(prof) == ["trace_steps_1-2.json"]
        with open(prof / "trace_steps_1-2.json") as f:
            assert json.load(f)["traceEvents"]
        assert [m for m in logs if m.startswith("profiled")] == [
            f"profiled steps 1..2 -> {prof} "
            "(TensorBoard profile plugin / xprof)"]
        return
    if case == "optimizer":
        import optax
        r = np.random.default_rng(0)
        p0 = r.standard_normal((4, 5)).astype(np.float32)
        tx = jax_make_optimizer(JaxTrainConfig(optimizer="lion", lr=1e-3), 32)
        jp, js = jnp.asarray(p0), None
        js = tx.init(jp)
        tp = torch.tensor(p0)
        opt = make_optimizer(TrainConfig(optimizer="lion", lr=1e-3), [tp], 32)
        for _ in range(3):
            g = r.standard_normal((4, 5)).astype(np.float32)
            u, js = tx.update(jnp.asarray(g), js, jp)
            jp = optax.apply_updates(jp, u)
            opt.step([torch.tensor(g)])
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
        return
    if case == "capacity":
        from video2music_tpu.core.config import MoEConfig as JaxMoEConfig
        from video2music_tpu.ops.moe import MoELayer as JaxMoE
        from video2music_tpu_torch.weights import _put_moe
        kw = dict(expert="glu", shared_expert=True, dispatch="capacity")
        jm = JaxMoE(cfg=JaxMoEConfig(**kw), d_model=16, d_ff=32,
                    dropout_rate=0.0)
        x = np.random.default_rng(1).standard_normal((2, 5, 16)).astype(
            np.float32)
        v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
        sd = {}
        _put_moe(sd, "m", jax.device_get(v["params"]))
        pm = SharedMoE(MoEConfig(**kw), 16, 32)
        pm.load_state_dict({k[2:]: t for k, t in sd.items()})
        want, _ = jm.apply(v, jnp.asarray(x), mutable=["moe_state",
                                                       "metrics"])
        np.testing.assert_allclose(pm(torch.tensor(x)).detach().numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-6)
        return
    kw = {"drop_token_rate": 0.5} if case == "drop_token" else {}
    state = create_train_state(amt_config("2.2", **TINY, **kw), tcfg,
                               device="cpu")
    if case == "topk_schedule":
        for layer in state.model.decoder_layers:
            if isinstance(layer.ffn, SharedMoE):
                layer.ffn.cfg = MoEConfig(expert="glu", shared_expert=True,
                                          topk_schedule=True)
                layer.ffn.steps["sched_step"] = 0
                layer.ffn.register_buffer("sched_step",
                                          torch.zeros((), dtype=torch.int32))
    b = _torch_batch(_batch(6))
    _, m = make_amt_train_step(tcfg)(state, b)
    assert torch.isfinite(m["loss"])
    if case == "topk_schedule":  # k = max(2, 6 - 1 // 32): every expert
        assert torch.equal(m["expert_counts"][-1],
                           torch.full((6,), 3.0 * L))
        assert m["expert_counts"][0].sum() == 3 * L * 2  # the encoder's
    else:  # the same step without the token drop moves another way
        plain = create_train_state(amt_config("2.2", **TINY), tcfg,
                                   device="cpu")
        _, m0 = make_amt_train_step(tcfg)(plain, b)
        assert float(m["loss"]) != float(m0["loss"])


# ---------------------------------------------------------------------------
# the dropout attention's training forms (row 11) against Pallas
# ---------------------------------------------------------------------------

def _pallas_interp():
    from jax.experimental.pallas import tpu as pltpu
    return pltpu.InterpretParams()


def test_dropout_attention_at_2h_heads_matches_pallas():
    """Differential attention's training call: q and k at 2H heads, v
    repeated from H to 2H heads per pair, causal, rate 0.1. The output,
    the dropped probabilities (mask entry for entry), dq, dk and the
    gradient of the H-head v against the Pallas kernel in interpret
    mode at the same seed."""
    from video2music_tpu.ops.pallas_attention_dropout import (
        extract_dropped_probs as jax_extract)
    from video2music_tpu.ops.pallas_attention_dropout import \
        flash_attention_dropout as jax_fad
    from video2music_tpu_torch.ops.flash_attention_dropout import (
        extract_dropped_probs, flash_attention_dropout)
    B, H, Lq, D, rate, seed = 2, 2, 24, 16, 0.1, 77
    r = np.random.default_rng(3)
    q, k, do = (r.standard_normal((B, 2 * H, Lq, D)).astype(np.float32)
                for _ in range(3))
    vh = r.standard_normal((B, H, Lq, D)).astype(np.float32)
    interp = _pallas_interp()

    def jf(q_, k_, v_):
        return jax_fad(q_, k_, jnp.repeat(v_, 2, axis=1), causal=True,
                       dropout_rate=rate, seed=seed, interpret=interp)
    jout, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(vh))
    want = [jout, *vjp(jnp.asarray(do))]
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, vh)]
    out = flash_attention_dropout(ts[0], ts[1],
                                  ts[2].repeat_interleave(2, dim=1),
                                  causal=True, dropout_rate=rate, seed=seed)
    out.backward(torch.tensor(do))
    got = [out] + [t.grad for t in ts]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    pm = extract_dropped_probs(torch.tensor(q), torch.tensor(k), causal=True,
                               dropout_rate=rate, seed=seed)
    jm = jax_extract(jnp.asarray(q), jnp.asarray(k), causal=True,
                     dropout_rate=rate, seed=seed, interpret=interp)
    np.testing.assert_array_equal(pm.numpy() == 0, np.asarray(jm) == 0)


def test_dropout_attention_with_the_full_rpr_bias_matches_pallas():
    """The RPR training call: the full (B, H, L, L) f32 bias of
    q_scaled . Er, causal, rate 0.1. The output, the mask, dq, dk, dv,
    dbias and the gradient that reaches Er through dbias, against the
    Pallas kernel in interpret mode at the same seed."""
    from video2music_tpu.ops.pallas_attention_dropout import (
        extract_dropped_probs as jax_extract)
    from video2music_tpu.ops.pallas_attention_dropout import \
        flash_attention_dropout as jax_fad
    from video2music_tpu.ops.rpr import rpr_bias_full as jax_rpr
    from video2music_tpu_torch.ops.flash_attention_dropout import (
        extract_dropped_probs, flash_attention_dropout)
    from video2music_tpu_torch.ops.rpr import rpr_bias_full
    B, H, Lq, D, rate, seed = 2, 2, 24, 16, 0.1, 5
    r = np.random.default_rng(4)
    q, k, v, do = (r.standard_normal((B, H, Lq, D)).astype(np.float32)
                   for _ in range(4))
    er = r.standard_normal((Lq + 4, D)).astype(np.float32) * D ** -0.5
    interp = _pallas_interp()

    def jf(q_, k_, v_, er_):
        bias = jax_rpr(q_ * D ** -0.5, er_)
        return jax_fad(q_, k_, v_, bias=bias, causal=True,
                       dropout_rate=rate, seed=seed, interpret=interp), bias
    (jout, jbias), vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v, er)))
    jgrads = vjp((jnp.asarray(do), jnp.zeros_like(jbias)))
    # dbias: the kernel's gradient with respect to the bias itself
    _, bvjp = jax.vjp(lambda b_: jax_fad(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=b_, causal=True,
        dropout_rate=rate, seed=seed, interpret=interp), jbias)
    (jdbias,) = bvjp(jnp.asarray(do))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v, er)]
    bias = rpr_bias_full(ts[0] * D ** -0.5, ts[3])
    bias.retain_grad()
    out = flash_attention_dropout(ts[0], ts[1], ts[2], bias=bias, causal=True,
                                  dropout_rate=rate, seed=seed)
    out.backward(torch.tensor(do))
    np.testing.assert_allclose(bias.detach().numpy(), np.asarray(jbias),
                               rtol=1e-5, atol=1e-6, err_msg="bias")
    got = [out] + [t.grad for t in ts] + [bias.grad]
    want = [jout, *jgrads, jdbias]
    for name, g, w in zip(("out", "dq", "dk", "dv", "dEr", "dbias"), got,
                          want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    pm = extract_dropped_probs(torch.tensor(q), torch.tensor(k),
                               bias=bias.detach(), causal=True,
                               dropout_rate=rate, seed=seed)
    jm = jax_extract(jnp.asarray(q), jnp.asarray(k), bias=jbias, causal=True,
                     dropout_rate=rate, seed=seed, interpret=interp)
    np.testing.assert_array_equal(pm.numpy() == 0, np.asarray(jm) == 0)


@pytest.mark.parametrize("version", ["3.1", None])
def test_training_attention_runs_the_dropout_kernel_in_its_form(version,
                                                                monkeypatch):
    """A training forward with dropout calls the dropout attention at the
    heads the layer attends with: 2H for V3.1's differential layers (v
    repeated per pair), H with the full (B, H, L, L) RPR bias for the base
    AMT's decoder self-attention; the loss is finite."""
    from video2music_tpu_torch.ops import attention
    calls = []
    real = attention.flash_attention_dropout

    def spy(q, k, v, *, bias=None, **kw):
        calls.append((q.shape[1], v.shape[1],
                      None if bias is None else tuple(bias.shape)))
        return real(q, k, v, bias=bias, **kw)
    monkeypatch.setattr(attention, "flash_attention_dropout", spy)
    cfg = amt_config(version, dropout=0.1, **TINY)
    state = create_train_state(cfg, TrainConfig(optimizer="adamw", lr=1e-3),
                               device="cpu")
    _, m = make_amt_train_step(TrainConfig(optimizer="adamw", lr=1e-3))(
        state, _torch_batch(_batch(8)))
    assert torch.isfinite(m["loss"])
    H = TINY["num_heads"]
    assert len(calls) == 6  # 2 encoder + 2 x 2 decoder attentions
    if version == "3.1":
        assert all(c[:2] == (2 * H, 2 * H) and c[2] is None for c in calls)
    else:
        rpr = [c for c in calls if c[2] is not None]
        assert len(rpr) == 2 and all(c[2] == (3, H, L, L) for c in rpr)
