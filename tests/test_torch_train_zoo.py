"""Training every model family the port serves, against the JAX package on
the CPU (tiny widths: 2 + 2 layers, d_model 32, L 12; f32, dropout 0):
the six optimizers against optax, three train steps of V3.1, 2.1 under
the top-k scheduler, the base AMT (RPR), separated root / attr heads, the
MusicTransformer and five regression backbones, each within 1e-5 of the
JAX step (losses per step, parameters after the third); the eval steps'
metrics; the MoE layer's capacity dispatch and temperature schedule;
``drop_token_rate``, held where it does not depend on the random stream;
and, on the port alone, one step of every AMT wiring (with the 159-way
head and separated heads, GQA forms of V2 / V3), of the fourteen
regression backbones and of the MusicTransformer under each optimizer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import EMO, L, SEM, TINY, _batch, _torch_batch
from video2music_tpu.core.config import MoEConfig as JaxMoEConfig
from video2music_tpu.core.config import MusicTransformerConfig as JaxMTConfig
from video2music_tpu.core.config import RegressionConfig as JaxRegConfig
from video2music_tpu.core.config import TrainConfig as JaxTrainConfig
from video2music_tpu.core.config import amt_config as jax_amt_config
from video2music_tpu.core.vocab import chord_to_root_attr_tables
from video2music_tpu.models import MusicTransformer as JaxMT
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.models import VideoRegression as JaxRegression
from video2music_tpu.ops.moe import MoELayer as JaxMoE
from video2music_tpu.train import metrics as JM
from video2music_tpu.train import step as JS
from video2music_tpu.train.optim import make_optimizer as jax_make_optimizer
from video2music_tpu_torch.core import constants as C
from video2music_tpu_torch.core.config import (MoEConfig,
                                               MusicTransformerConfig,
                                               RegressionConfig, TrainConfig,
                                               amt_config)
from video2music_tpu_torch.ops.moe import MoELayer
from video2music_tpu_torch.train import metrics as PM
from video2music_tpu_torch.train import (create_train_state,
                                         make_amt_eval_step,
                                         make_amt_train_step,
                                         make_music_transformer_eval_step,
                                         make_music_transformer_train_step,
                                         make_optimizer,
                                         make_regression_eval_step,
                                         make_regression_train_step)
from video2music_tpu_torch.weights import (_put_moe, amt_from_jax,
                                           amt_moe_state_to_jax,
                                           load_amt_from_jax_,
                                           music_transformer_from_jax,
                                           regression_from_jax)

torch.set_num_threads(1)
REL = 1e-5
OPTIMIZERS = ("adam", "adamw", "radam", "radamw", "radanw", "lion")


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lr", [1e-3, None], ids=["fixed_lr", "noam"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name, lr):
    """Ten updates on random f32 tensors and gradients (RAdam's rectified
    branch starts at the sixth): the parameters within 1e-6 of optax's and
    the moments' count."""
    import optax
    r = np.random.default_rng(0)
    shapes = [(5, 7), (3,), (4, 4, 2)]
    p0 = [r.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jax_make_optimizer(JaxTrainConfig(optimizer=name, lr=lr,
                                           warmup_steps=3), 32)
    jp = [jnp.asarray(x) for x in p0]
    js = tx.init(jp)
    tp = [torch.tensor(x) for x in p0]
    opt = make_optimizer(TrainConfig(optimizer=name, lr=lr, warmup_steps=3),
                         tp, 32)
    for _ in range(10):
        g = [r.standard_normal(s).astype(np.float32) for s in shapes]
        u, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, u)
        opt.step([torch.tensor(x) for x in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    assert opt.count == 10
    state = opt.state_dict()
    fresh = make_optimizer(TrainConfig(optimizer=name, lr=lr), tp, 32)
    fresh.load_state_dict(state)
    assert fresh.count == 10 and all(
        torch.equal(a, b) for m in type(opt).MOMENTS
        for a, b in zip(getattr(fresh, m), getattr(opt, m)))


# ---------------------------------------------------------------------------
# train steps against JAX
# ---------------------------------------------------------------------------

def _params_close(got, want, lr, lion=False):
    """Every entry within 1e-5 of the model's largest weight, but for the
    entries whose gradient is float noise, where an Adam-type step divides
    by |g| + eps and a Lion step takes sign(g): the key-projection biases
    (softmax is invariant to them), each within 6 lr after three steps,
    and among the rest at most 1e-4 of the entries (1e-3 under Lion), each
    within 0.1 lr (2.2 lr under Lion)."""
    scale = max(w.abs().max().item() for w in want.values())
    diffs, noise = [], []
    for n, w in want.items():
        d = (got[n].float() - w).abs()
        if n.endswith("in_proj.bias"):  # q | k | v rows, D each
            D = d.shape[0] // 3
            noise.append(d[D:2 * D])
            d = torch.cat([d[:D], d[2 * D:]])
        diffs.append(d.flatten())
    diffs = torch.cat(diffs)
    if noise:
        assert torch.cat(noise).max().item() <= 6 * lr
    outliers = int((diffs > REL * scale).sum())
    assert outliers <= (1e-3 if lion else 1e-4) * diffs.numel(), outliers
    assert diffs.max().item() <= max((2.2 if lion else 0.1) * lr,
                                     REL * scale), diffs.max()


def _with_root_attr(b):
    """The separated heads' targets (tgt_root, tgt_attr) of b["tgt"]."""
    root, attr = chord_to_root_attr_tables()
    return dict(b, tgt_root=root[b["tgt"]], tgt_attr=attr[b["tgt"]])


def _topk_every_step(cfg):
    """The top-k scheduler stepping k down at every call (the configs'
    topk_update_step 32 would keep k at E for 31 steps)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, topk_update_step=1))


AMT_CASES = {
    # wiring: (version, overrides, optimizer)
    "v3.1": ("3.1", {}, "radamw"),
    "v2.1_topk": ("2.1", {}, "radanw"),
    "base_rpr": (None, {}, "radam"),
    "separated": ("2.2", dict(separated=True), "adam"),
    "v2.0_lion": ("2.0", {}, "lion"),
}


@pytest.mark.parametrize("case", list(AMT_CASES))
def test_amt_train_step_matches_jax_over_three_steps(case):
    """Three f32 train steps from the same weights and batches: the loss
    terms per step within 1e-5, the parameters after the third step as
    ``_params_close`` says, the MoE state (V3.1's balancing biases, 2.1's
    top-k step) equal to the JAX moe_state; under the scheduler every
    token routes to k = max(2, E - (step + 1)) experts, JAX's k."""
    version, over, opt = AMT_CASES[case]
    lr = 1e-3
    jcfg = jax_amt_config(version, dropout=0.0, **TINY, **over)
    pcfg = amt_config(version, dropout=0.0, **TINY, **over)
    if case == "v2.1_topk":
        jcfg, pcfg = _topk_every_step(jcfg), _topk_every_step(pcfg)
    tkw = dict(optimizer=opt, lr=lr)
    jmodel = JaxAMT(cfg=jcfg)
    jtcfg = JaxTrainConfig(**tkw)
    tx = jax_make_optimizer(jtcfg, d_model=jcfg.d_model)
    batches = [_with_root_attr(_batch(40 + i)) for i in range(3)]
    jstate = JS.create_train_state(jmodel, tx, jax.random.PRNGKey(0),
                                   _jb(batches[0]))
    tcfg = TrainConfig(**tkw)
    state = create_train_state(pcfg, tcfg, device="cpu")
    load_amt_from_jax_(state.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.moe_state))
    jstep = jax.jit(JS.make_amt_train_step(jmodel, tx, jtcfg))
    pstep = make_amt_train_step(tcfg)
    E = pcfg.moe.n_experts
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, _jb(b))
        state, pm = pstep(state, _torch_batch(b))
        for key in ("loss", "loss_chord", "loss_emotion"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       rtol=REL, err_msg=f"{key} step {i}")
        if case == "v2.1_topk":  # the deep (MoE) layers' routing
            k = max(2, E - (i + 1))
            assert torch.all(pm["expert_counts"].sum(-1) == 3 * L * k), k
    want = amt_from_jax(jax.device_get(jstate.params))
    _params_close(state.model.state_dict(), want, lr, lion=opt == "lion")
    jms = jax.device_get(jstate.moe_state)
    got_ms = amt_moe_state_to_jax(state.model)
    assert sorted(got_ms) == sorted(jms)
    for layer, st in jms.items():
        for name, v in st["ffn"].items():
            np.testing.assert_allclose(got_ms[layer]["ffn"][name],
                                       np.asarray(v), rtol=REL, atol=1e-7,
                                       err_msg=f"{layer} {name}")


@pytest.mark.parametrize("separated", [False, True])
def test_amt_eval_step_matches_jax(separated):
    """The eval step's loss terms, accuracy, hits@k and correspondence;
    separated heads through the root x attr reconstruction."""
    over = dict(separated=True) if separated else {}
    jcfg = jax_amt_config("3.1", dropout=0.0, **TINY, **over)
    jmodel = JaxAMT(cfg=jcfg)
    b = _with_root_attr(_batch(50))
    tx = jax_make_optimizer(JaxTrainConfig(), d_model=32)
    jstate = JS.create_train_state(jmodel, tx, jax.random.PRNGKey(3), _jb(b))
    want = jax.jit(JS.make_amt_eval_step(jmodel, JaxTrainConfig()))(
        jstate.params, jstate.moe_state, _jb(b))
    state = create_train_state(amt_config("3.1", dropout=0.0, **TINY, **over),
                               TrainConfig(), device="cpu")
    load_amt_from_jax_(state.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.moe_state))
    got = make_amt_eval_step(TrainConfig())(state.model, _torch_batch(b))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=REL,
                                   atol=1e-6, err_msg=k)


MT_KW = dict(n_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_chord=L,
             dropout=0.0)


def test_music_transformer_steps_match_jax():
    """Three f32 AdamW train steps of the MusicTransformer (RPR) and its
    eval step: the chord CE per step within 1e-5, the parameters after
    the third step, the eval metrics."""
    lr = 1e-3
    jmodel = JaxMT(cfg=JaxMTConfig(**MT_KW))
    jtcfg = JaxTrainConfig(optimizer="adamw", lr=lr)
    tx = jax_make_optimizer(jtcfg, d_model=32)
    batches = [_batch(60 + i) for i in range(3)]
    jstate = JS.create_train_state(jmodel, tx, jax.random.PRNGKey(1),
                                   _jb(batches[0]),
                                   init_fn=JS.music_transformer_init)
    tcfg = TrainConfig(optimizer="adamw", lr=lr)
    state = create_train_state(MusicTransformerConfig(**MT_KW), tcfg,
                               device="cpu")
    state.model.load_state_dict(music_transformer_from_jax(
        jax.device_get(jstate.params)))
    jstep = jax.jit(JS.make_music_transformer_train_step(jmodel, tx, jtcfg))
    pstep = make_music_transformer_train_step(tcfg)
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, _jb(b))
        state, pm = pstep(state, _torch_batch(b))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=REL, err_msg=f"step {i}")
    _params_close(state.model.state_dict(),
                  music_transformer_from_jax(jax.device_get(jstate.params)),
                  lr)
    b = _batch(70)
    want = jax.jit(JS.make_music_transformer_eval_step(jmodel, jtcfg))(
        jstate.params, {}, _jb(b))
    got = make_music_transformer_eval_step(tcfg)(state.model,
                                                 _torch_batch(b))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=REL,
                                   atol=1e-6, err_msg=k)


def _reg_batch(seed, B=3):
    r = np.random.default_rng(seed)
    return dict(
        semantic=r.standard_normal((B, L, SEM)).astype(np.float32),
        scene_offset=r.integers(0, 12, (B, L)).astype(np.float32),
        motion=r.standard_normal((B, L)).astype(np.float32),
        emotion=r.uniform(size=(B, L, EMO)).astype(np.float32),
        note_density=r.uniform(size=(B, L)).astype(np.float32),
        loudness=r.uniform(size=(B, L)).astype(np.float32),
        instrument=(r.uniform(size=(B, L, C.INSTRUMENT_SIZE)) > 0.7)
        .astype(np.float32))


REG_CASES = {"mamba": "adamw", "bimamba+": "radanw", "bilstm": "adam",
             "cnngru": "radamw", "mingru": "radam"}


@pytest.mark.parametrize("backbone", list(REG_CASES))
def test_regression_steps_match_jax(backbone):
    """Three f32 train steps of a regression (the loss and its SmoothL1
    and BCE terms per step within 1e-5, the parameters after the third
    step) and the eval step's loss terms and regression_eval sums."""
    lr = 1e-3
    kw = dict(reg_model=backbone, n_layers=2, d_model=16, d_hidden=32,
              total_vf_dim=SEM + EMO, dropout=0.0)
    jmodel = JaxRegression(cfg=JaxRegConfig(**kw))
    tkw = dict(optimizer=REG_CASES[backbone], lr=lr)
    jtcfg = JaxTrainConfig(**tkw)
    tx = jax_make_optimizer(jtcfg, d_model=16)
    batches = [_reg_batch(80 + i) for i in range(3)]
    jstate = JS.create_train_state(jmodel, tx, jax.random.PRNGKey(2),
                                   _jb(batches[0]),
                                   init_fn=JS.regression_init)
    tcfg = TrainConfig(**tkw)
    state = create_train_state(RegressionConfig(**kw), tcfg, device="cpu")
    state.model.load_state_dict(regression_from_jax(
        jax.device_get(jstate.params)))
    jstep = jax.jit(JS.make_regression_train_step(jmodel, tx, jtcfg))
    pstep = make_regression_train_step(tcfg)
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, _jb(b))
        state, pm = pstep(state, _torch_batch(b))
        for key in ("loss", "loss_reg", "loss_bce"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       rtol=REL, err_msg=f"{key} step {i}")
    _params_close(state.model.state_dict(),
                  regression_from_jax(jax.device_get(jstate.params)), lr)
    b = _reg_batch(90)
    want = jax.jit(JS.make_regression_eval_step(jmodel))(
        jstate.params, jstate.moe_state, _jb(b))
    got = make_regression_eval_step()(state.model, _torch_batch(b))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=REL,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_root_attr_and_regression_metrics_match_jax():
    r = np.random.default_rng(4)
    lr_, la_ = (r.standard_normal((3, L, n)).astype(np.float32) * 2
                for n in (C.CHORD_ROOT_SIZE, C.CHORD_ATTR_SIZE))
    b = _batch(5)
    tgt = b["tgt"]
    tgt[1, 0] = C.CHORD_END
    pt = [torch.tensor(x) for x in (lr_, la_)]
    jt = [jnp.asarray(x) for x in (lr_, la_)]
    np.testing.assert_allclose(
        PM.root_attr_to_chord_logits(*pt).numpy(),
        np.asarray(JM.root_attr_to_chord_logits(*jt)), rtol=1e-6, atol=1e-8)
    pairs = [(PM.compute_vevo_accuracy_root_attr(*pt, torch.tensor(tgt)),
              JM.compute_vevo_accuracy_root_attr(*jt, jnp.asarray(tgt)))]
    for k in (1, 3, 5):
        pairs.append((PM.compute_hits_k_root_attr(*pt, torch.tensor(tgt), k),
                      JM.compute_hits_k_root_attr(*jt, jnp.asarray(tgt), k)))
    pairs.append((PM.compute_vevo_correspondence_root_attr(
        *pt, torch.tensor(tgt), torch.tensor(b["tgt_emotion"]),
        torch.tensor(b["tgt_emotion_prob"])),
        JM.compute_vevo_correspondence_root_attr(
            *jt, jnp.asarray(tgt), jnp.asarray(b["tgt_emotion"]),
            jnp.asarray(b["tgt_emotion_prob"]))))
    rb = _reg_batch(6)
    pred = r.standard_normal((3, L, 2)).astype(np.float32)
    probs = r.uniform(size=(3, L, C.INSTRUMENT_SIZE)).astype(np.float32)
    probs[0, 0, :3] = (0.0, 1.0, 0.5)  # the BCE's clip
    got = PM.regression_eval(torch.tensor(pred),
                             torch.tensor(rb["note_density"]),
                             torch.tensor(rb["loudness"]),
                             torch.tensor(probs),
                             torch.tensor(rb["instrument"]))
    want = JM.regression_eval(jnp.asarray(pred),
                              jnp.asarray(rb["note_density"]),
                              jnp.asarray(rb["loudness"]),
                              jnp.asarray(probs),
                              jnp.asarray(rb["instrument"]))
    assert sorted(got) == sorted(want)
    pairs += [(got[k], want[k]) for k in sorted(want)]
    for i, (g, w) in enumerate(pairs):
        np.testing.assert_allclose(float(g), float(w), rtol=REL, atol=1e-7,
                                   err_msg=f"metric {i}")


# ---------------------------------------------------------------------------
# MoE options
# ---------------------------------------------------------------------------

def _moe_pair(kw, D=16, F=24, seed=1):
    jm = JaxMoE(cfg=JaxMoEConfig(**kw), d_model=D, d_ff=F, dropout_rate=0.0)
    x0 = jnp.zeros((2, 7, D))
    v = jm.init({"params": jax.random.PRNGKey(seed)}, x0)
    sd = {}
    _put_moe(sd, "m", jax.device_get(v["params"]))
    pm = MoELayer(MoEConfig(**kw), D, F, 0.0)
    pm.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=False)
    return jm, v, pm


def _moe_x(r, B, T, D=16):
    return r.standard_normal((B, T, D)).astype(np.float32)


@pytest.mark.parametrize("expert", ["glu", "mlp", "kan"])
def test_moe_capacity_dispatch_matches_jax(expert):
    """dispatch="capacity" at capacity factor 0.5 (most experts overflow):
    the outputs, in training and eval calls, and the dropped assignments:
    a token whose assignments were all dropped gets only the shared
    expert's share, in both."""
    kw = dict(expert=expert, shared_expert=True, dispatch="capacity",
              capacity_factor=0.5)
    jm, v, pm = _moe_pair(kw)
    r = np.random.default_rng(2)
    gen = torch.Generator().manual_seed(0)
    for training in (True, False):
        x = _moe_x(r, 2, 7)
        want, _ = jm.apply(v, jnp.asarray(x), deterministic=not training,
                           rngs={"dropout": jax.random.PRNGKey(0)},
                           mutable=["moe_state", "metrics"])
        got = pm(torch.tensor(x), gen if training else None)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    # the dropped assignments: the routed part of the output (less the
    # shared expert's) is zero exactly where JAX dropped every assignment
    shared = pm.shared(torch.tensor(x)) / pm.k
    routed = (got - shared).abs().sum(-1)
    jshared = np.asarray(want) - shared.detach().numpy()
    np.testing.assert_array_equal((routed < 1e-6).numpy(),
                                  np.abs(jshared).sum(-1) < 1e-6)
    assert bool((routed < 1e-6).any()) and bool((routed > 1e-6).any())


@pytest.mark.parametrize("shared", [True, False])
def test_moe_temperature_schedule_matches_jax(shared):
    """The routing temperature over five training calls (the JAX
    moe_state carried) and two eval calls after them: the outputs and the
    step. With a shared expert an eval call uses the next step without
    keeping it (the JAX quirk); without one eval has no temperature."""
    kw = dict(expert="glu", shared_expert=shared, temperature_schedule=True,
              temperature_step=0.05)
    jm, v, pm = _moe_pair(kw)
    r = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(0)
    params, ms = v["params"], v["moe_state"]
    for i in range(7):
        training = i < 5
        x = _moe_x(r, 2, 5)
        want, mut = jm.apply({"params": params, "moe_state": ms},
                             jnp.asarray(x), deterministic=not training,
                             rngs={"dropout": jax.random.PRNGKey(i)},
                             mutable=["moe_state", "metrics"])
        if training:
            ms = mut["moe_state"]
        got = pm(torch.tensor(x), gen if training else None)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6, err_msg=f"call {i}")
        assert pm.steps["temp_step"] == int(ms["temp_step"]) == min(i + 1, 5)


def test_moe_schedule_steps_round_trip_through_the_state_dict():
    """The schedules' host steps follow a state dict load (a checkpoint),
    and a state dict without them (a JAX param tree bridged alone) starts
    them at 0."""
    cfg = MoEConfig(expert="glu", shared_expert=True, topk_schedule=True,
                    temperature_schedule=True)
    a, b = MoELayer(cfg, 8, 16), MoELayer(cfg, 8, 16)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        a(torch.randn(1, 4, 8), gen)
    assert a.steps == {"sched_step": 3, "temp_step": 3}
    b.load_state_dict(a.state_dict())
    assert b.steps == a.steps and int(b.sched_step) == 3
    sd = {k: v for k, v in a.state_dict().items()
          if not k.endswith("_step")}
    b.load_state_dict(sd)
    assert b.steps == {"sched_step": 0, "temp_step": 0}


# ---------------------------------------------------------------------------
# drop_token_rate
# ---------------------------------------------------------------------------

def test_drop_token_rate_keeps_about_one_minus_rate_of_the_tokens():
    """Rate 0 is the plain embedding; at rate 0.3 the projected video rows
    are kept (unchanged, not rescaled) or zero, about 70% kept, drawn
    per (B, L) from the step's generator (the same seed, the same rows)."""
    from video2music_tpu_torch.models import VideoMusicTransformer
    from video2music_tpu_torch.weights import init_weights_
    b = _torch_batch(_batch(7, B=8))
    args = (b["semantic"], b["scene_offset"], b["motion"], b["emotion"])
    plain = init_weights_(VideoMusicTransformer(amt_config("2.2", **TINY)),
                          torch.Generator().manual_seed(0))
    want = plain._embed_video(*args)
    got0 = plain._embed_video(*args, torch.Generator().manual_seed(1))
    torch.testing.assert_close(got0, want, rtol=0, atol=0)
    model = init_weights_(VideoMusicTransformer(amt_config(
        "2.2", drop_token_rate=0.3, **TINY)), torch.Generator().manual_seed(0))
    got = model._embed_video(*args, torch.Generator().manual_seed(1))
    again = model._embed_video(*args, torch.Generator().manual_seed(1))
    assert torch.equal(got, again)
    kept = (got != 0).any(-1)
    torch.testing.assert_close(got[kept], want[kept], rtol=0, atol=0)
    assert bool((got[~kept] == 0).all())
    share = kept.float().mean().item()
    assert 0.55 < share < 0.85, share
    eval_out = model._embed_video(*args)
    torch.testing.assert_close(eval_out, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# every wiring, backbone and optimizer trains (the port alone)
# ---------------------------------------------------------------------------

VERSIONS = [None, "1.0", "1.1", "1.2", "1.2.3", "1.3", "1.3.3", "1.3.4",
            "2.0", "2.1", "2.2", "2.3", "3.0", "3.1", "3.2"]


@pytest.mark.parametrize("separated", [False, True], ids=["head",
                                                          "separated"])
@pytest.mark.parametrize("version", VERSIONS, ids=str)
def test_every_amt_wiring_trains(version, separated):
    """One training step (dropout 0.1, drop_loss) of every wiring
    amt_config builds, with the 159-way head and with separated heads:
    finite loss terms, the trainable parameters moved (an expert no token
    picked moves only by the weight decay, below an ulp where its weights
    are small), the same step from the same seed the same; a GQA form of
    each V2 / V3 wiring."""
    over = dict(separated=True) if separated else {}
    if version is not None and version[0] in "23" and not separated:
        over["kv_heads"] = 1
    cfg = amt_config(version, dropout=0.1, **TINY, **over)
    tcfg = TrainConfig(optimizer="adamw", lr=1e-3)
    b = _torch_batch(_with_root_attr(_batch(11)))
    runs = []
    for _ in range(2):
        state = create_train_state(cfg, tcfg, device="cpu")
        before = {k: v.clone() for k, v in state.model.named_parameters()}
        state, m = make_amt_train_step(tcfg, drop_loss=True)(state, b)
        runs.append(m)
    assert all(torch.isfinite(m[k]) for k in ("loss", "loss_chord",
                                              "loss_emotion"))
    assert float(runs[0]["loss"]) == float(runs[1]["loss"])
    trainable = [n for n, p in state.model.named_parameters()
                 if p.requires_grad]
    moved = [n for n in trainable if not torch.equal(
        state.model.get_parameter(n), before[n])]
    assert len(moved) >= 0.9 * len(trainable), sorted(
        set(trainable) - set(moved))
    assert "linear_chord.weight" in moved


@pytest.mark.parametrize("backbone", [
    "bilstm", "bigru", "lstm", "gru", "cnngru", "cnnbigru", "mamba",
    "mamba+", "moemamba", "bimamba", "bimamba+", "moe_bimamba+",
    "sharedmoe_bimamba+", "mingru"])
def test_every_regression_backbone_trains(backbone):
    """One training step (dropout 0.1) of each of the fourteen backbones:
    finite loss terms, the parameters moved; the eval step's sums."""
    cfg = RegressionConfig(reg_model=backbone, n_layers=2, d_model=16,
                           d_hidden=16, total_vf_dim=SEM + EMO)
    tcfg = TrainConfig(optimizer="radamw", lr=1e-3)
    state = create_train_state(cfg, tcfg, device="cpu")
    before = [p.clone() for p in state.model.parameters()]
    b = _torch_batch(_reg_batch(12))
    state, m = make_regression_train_step(tcfg)(state, b)
    assert all(torch.isfinite(v) for v in m.values())
    moved = sum(not torch.equal(p, q)
                for p, q in zip(state.model.parameters(), before))
    assert moved >= len(before) - 2  # MoE experts a batch never picked
    out = make_regression_eval_step()(state.model, b)
    assert out["count"] == 3 * L and torch.isfinite(out["bce_instrument"])


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_every_optimizer_trains_the_music_transformer(name):
    """Three steps of the MusicTransformer under each optimizer (Noam
    schedule): finite losses, the checkpoint of the state restoring the
    optimizer's moments and count."""
    import tempfile
    from video2music_tpu_torch.train import (restore_checkpoint,
                                             save_checkpoint)
    cfg = MusicTransformerConfig(**dict(MT_KW, dropout=0.1))
    tcfg = TrainConfig(optimizer=name, warmup_steps=2)
    state = create_train_state(cfg, tcfg, device="cpu")
    step = make_music_transformer_train_step(tcfg)
    for i in range(3):
        state, m = step(state, _torch_batch(_batch(20 + i)))
        assert torch.isfinite(m["loss"])
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp + "/ckpt", state)
        fresh = restore_checkpoint(tmp + "/ckpt",
                                   create_train_state(cfg, tcfg,
                                                      device="cpu"))
    assert fresh.step == 3 and fresh.optimizer.count == 3
    for m_name in type(state.optimizer).MOMENTS:
        for a, b in zip(getattr(fresh.optimizer, m_name),
                        getattr(state.optimizer, m_name)):
            assert torch.equal(a, b), m_name
