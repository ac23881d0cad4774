"""The port's multi-GPU training on the CPU, against the JAX package: real
multi-rank worlds over gloo (each mesh shape one spawned world, every case
of that shape in it, the results returned through files), at tiny widths
(2+2 layers, d_model 32, 4 heads, d_ff 64, 6 experts top-2, L 12, B 4).

  * the shard plan against JAX's ``param_shardings`` leaf by leaf;
  * the autograd of the collectives (f, g, the sequence gather, split and
    reduce-scatter);
  * dp x ep 2x2, tp 2x2, sp 2x2 and the inner-d_ff fallback 1x4 with 6
    experts held to the JAX single-device step over three f32 AdamW steps
    at dropout 0, a balancing config's ``balance_bias`` too (tp 1x2 and
    the pipeline: tests/test_torch_pp.py);
  * with dropout 0.1, dp, tp and sp equal the port's single-process step
    (the masks are global);
  * row 11's plain version with a shard origin against the slice of the
    whole mask and of the Pallas kernel's in interpret mode;
  * ``train_amt`` on a 2x2 dp mesh against the JAX ``train_amt`` on
    ``create_mesh((2, 2))``, its checkpoint served by ``Video2music`` and
    continued on another mesh shape, the CLI on every strategy and the
    checks that raise.

Tolerances: losses rtol 1e-4 and parameters rtol 1e-3 / atol 1e-5 (the
JAX package's tests/test_train.py), every parameter compared. An Adam
step moves an entry by lr * g / (|g| + eps), so where a gradient is near
zero its step follows g's last digits, which two summation orders do not
share: at most one entry in 10^4 may then differ by up to 2 lr a step.
"""

import csv
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_data import _write_fixture_tree
from video2music_tpu.core.config import TrainConfig as JaxTrainConfig
from video2music_tpu.core.config import amt_config as jax_amt_config
from video2music_tpu.core.vocab import emotion_chord_targets
from video2music_tpu.data import create_vevo_datasets as jax_datasets
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.ops.pallas_attention_dropout import (
    extract_dropped_probs as jax_extract)
from video2music_tpu.parallel import create_mesh as jax_create_mesh
from video2music_tpu.parallel import param_shardings
from video2music_tpu.train import create_train_state as jax_create_state
from video2music_tpu.train import make_amt_train_step as jax_train_step
from video2music_tpu.train import make_optimizer as jax_make_optimizer
from video2music_tpu.train.loop import LoopConfig as JaxLoopConfig
from video2music_tpu.train.loop import train_amt as jax_train_amt
from video2music_tpu_torch.core import constants as C
from video2music_tpu_torch.core.config import TrainConfig, amt_config
from video2music_tpu_torch.data import create_vevo_datasets
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.obs.logging import (collect_moe_metrics,
                                               reset_moe_metrics)
from video2music_tpu_torch.ops.flash_attention_dropout import (
    dropout_mask, extract_dropped_probs)
from video2music_tpu_torch.parallel import create_mesh, launch
from video2music_tpu_torch.parallel.shard import shard_plan
from video2music_tpu_torch.pipeline.api import Video2music
from video2music_tpu_torch.train import (CSV_HEADER, LoopConfig,
                                         create_train_state,
                                         make_amt_train_step, save_checkpoint,
                                         train_amt)
from video2music_tpu_torch.train.pp import make_amt_pp_train_step
from video2music_tpu_torch.train.step import MODEL_INPUTS
from video2music_tpu_torch.weights import amt_from_jax, load_amt_from_jax_

torch.set_num_threads(1)
L, SEM, EMO, B = 12, 7, 6, 4
TINY = dict(n_layers=2, num_heads=4, d_model=32, d_ff=64, max_seq_video=L,
            max_seq_chord=L, total_vf_dim=SEM + 1 + 1 + EMO)
LR = 1e-3
WORLD = "video2music_tpu_torch.parallel.worlds:run_world"
LOOP_KW = dict(n_layers=2, num_heads=2, d_model=16, d_ff=32,
               max_seq_video=10, max_seq_chord=10, total_vf_dim=776)
IDS = ["aaa", "bbb", "ccc", "ddd", "eee"]


def _batch(seed, Bn=B):
    r = np.random.default_rng(seed)
    tgt = r.integers(0, C.CHORD_END, (Bn, L))
    tgt[0, -3:] = C.CHORD_PAD
    return dict(
        x=r.integers(0, C.CHORD_END, (Bn, L)),
        x_root=r.integers(0, 13, (Bn, L)), x_attr=r.integers(0, 14, (Bn, L)),
        tgt=tgt,
        tgt_emotion=emotion_chord_targets()[r.integers(0, 6, (Bn, L))]
        .astype(np.float32),
        tgt_emotion_prob=r.uniform(0.3, 1.0, (Bn, L)).astype(np.float32),
        semantic=r.standard_normal((Bn, L, SEM)).astype(np.float32),
        key=r.integers(0, 2, (Bn, 1)).astype(np.float32),
        scene_offset=r.integers(0, 12, (Bn, L)).astype(np.float32),
        motion=r.standard_normal((Bn, L)).astype(np.float32),
        emotion=r.uniform(size=(Bn, L, EMO)).astype(np.float32))


BATCHES = [_batch(10 + i) for i in range(3)]
# (version, n_layers, overrides) of the configs held to JAX
CONFIGS = {"2.2": ("2.2", 2, {}), "base": (None, 2, {}),
           "2.2x6": ("2.2", 6, {}), "3.1": ("3.1", 2, {}),
           "2.2cap": ("2.2", 2, {}),
           "2.2x6bal": ("2.2", 6, {"balancing": True})}


def _cfgs(key, dropout=0.0, sp=False):
    version, n, kw = CONFIGS[key]
    args = dict(TINY, n_layers=n, dropout=dropout, **kw)
    cfg = amt_config(version, sequence_parallel=sp, **args)
    if key == "2.2cap":   # capacity dispatch: the port's step alone
        return None, dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="capacity", capacity_factor=1.0))
    return jax_amt_config(version, **args), cfg


@functools.lru_cache(maxsize=None)
def _jax_init(key):
    """The JAX model's initial params as a port state dict (weights for
    the worlds), and its initial train state."""
    jcfg, cfg = _cfgs(key)
    jmodel = JaxAMT(cfg=jcfg)
    tx = jax_make_optimizer(JaxTrainConfig(optimizer="adamw", lr=LR),
                            d_model=jcfg.d_model)
    jstate = jax_create_state(jmodel, tx, jax.random.PRNGKey(0),
                              {k: jnp.asarray(v)
                               for k, v in BATCHES[0].items()})
    model = VideoMusicTransformer(cfg)
    load_amt_from_jax_(model, jax.device_get(jstate.params),
                       jax.device_get(jstate.moe_state))
    return model.state_dict(), (jmodel, tx, jstate)


@functools.lru_cache(maxsize=None)
def _jax_steps(key):
    """Three f32 AdamW steps of the JAX single-device step: the losses and
    the final state as a port state dict (balance_bias included)."""
    _, (jmodel, tx, jstate) = _jax_init(key)
    step = jax.jit(jax_train_step(jmodel, tx,
                                  JaxTrainConfig(optimizer="adamw", lr=LR)))
    losses = []
    for b in BATCHES:
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, amt_from_jax(jax.device_get(jstate.params),
                                jax.device_get(jstate.moe_state))


@functools.lru_cache(maxsize=None)
def _port_steps(key, dropout):
    """The port's single-process step from its seeded init: losses and the
    final state dict."""
    _, cfg = _cfgs(key, dropout)
    state = create_train_state(cfg, TrainConfig(optimizer="adamw", lr=LR),
                               device="cpu")
    step = make_amt_train_step(TrainConfig(optimizer="adamw", lr=LR))
    losses = []
    for b in BATCHES:
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    reset_moe_metrics(state.model)
    with torch.no_grad():
        state.model(*(torch.as_tensor(BATCHES[0][k]) for k in MODEL_INPUTS),
                    count_emotions=True)
    return losses, state.model.state_dict(), collect_moe_metrics(state.model)


def _case(name, key, strategy, dropout=0.0, jax_weights=True, **kw):
    _, cfg = _cfgs(key, dropout, sp=strategy == "sp")
    return dict(name=name, cfg=cfg,
                tcfg=TrainConfig(optimizer="adamw", lr=LR),
                strategy=strategy, batches=BATCHES,
                weights=_jax_init(key)[0] if jax_weights else None, **kw)


def _close(got, want, steps=3):
    """Every parameter within rtol 1e-3 / atol 1e-5, but for at most one
    entry in 10^4 within 2 lr a step (see the module docstring). The key
    projection's bias is held to that step bound alone: it adds the same
    q . b_k to every logit of a row, which the softmax ignores, so its
    gradient is zero but for rounding and each Adam step a sign of it."""
    diffs, bounds = [], []
    for k, w in want.items():
        if not w.is_floating_point():
            assert torch.equal(got[k], w), k
            continue
        bound = 1e-5 + 1e-3 * w.abs()
        if k.endswith("in_proj.bias"):   # q | k | v, equal widths here
            n = w.numel() // 3
            bound[n:2 * n] = 2 * LR * steps
        diffs.append((got[k] - w).abs().flatten())
        bounds.append(bound.flatten())
    d, bound = torch.cat(diffs), torch.cat(bounds)
    outliers = int((d > bound).sum())
    assert outliers <= 1e-4 * d.numel(), (outliers, d.numel())
    assert d.max().item() <= 2 * LR * steps, d.max()


# ---------------------------------------------------------------------------
# the worlds: one per mesh shape, started at once, joined when read
# ---------------------------------------------------------------------------

class _World:
    def __init__(self, tmp, shape, cases):
        self.dir = str(tmp)
        self.procs = launch.start(WORLD, shape[0] * shape[1],
                                  dict(mesh=shape, cases=cases),
                                  workdir=self.dir, threads=1)
        self._out = None

    def __call__(self, rank=0):
        if self._out is None:
            self._out = launch.join(self.procs, self.dir, timeout=600)
        return self._out[rank]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The test fixture tree with 768-d semantic features, as the served
    models read them."""
    root = str(tmp_path_factory.mktemp("vevo"))
    _write_fixture_tree(root, IDS)
    r = np.random.default_rng(1)
    sem = os.path.join(root, "vevo_semantic", "origin", "2d", "clip_l14p")
    for fid in IDS:
        np.save(os.path.join(sem, fid + ".npy"),
                r.standard_normal((4, 768)).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def loop_run(tree, tmp_path_factory):
    """The JAX model of the loop comparison (2.2, 16 wide), its initial
    params written as a port checkpoint, the output dirs."""
    tmp = tmp_path_factory.mktemp("loop")
    jcfg = jax_amt_config("2.2", dropout=0.0, **LOOP_KW)
    train_ds, _, _ = jax_datasets(tree, max_seq_chord=10, max_seq_video=10)
    first = next(iter(__import__(
        "video2music_tpu.data", fromlist=["batches"]).batches(
            train_ds, 2, shuffle=False)))
    jtcfg = JaxTrainConfig(optimizer="adamw", lr=LR)
    tx = jax_make_optimizer(jtcfg, d_model=16)
    jstate = jax_create_state(JaxAMT(cfg=jcfg), tx, jax.random.PRNGKey(0),
                              first)
    tcfg = TrainConfig(optimizer="adamw", lr=LR)
    state = create_train_state(amt_config("2.2", dropout=0.0, **LOOP_KW),
                               tcfg, device="cpu")
    load_amt_from_jax_(state.model, jax.device_get(jstate.params))
    init = str(tmp / "init")
    save_checkpoint(init, state)
    return dict(init=init, out=str(tmp / "port"), cont=str(tmp / "cont"),
                jax_out=str(tmp / "jax"), cli=str(tmp / "cli"))


def _train_amt_args(tree, out, init, epochs=1):
    cfg = amt_config("2.2", dropout=0.0, **LOOP_KW)
    train_ds, val_ds, _ = create_vevo_datasets(tree, max_seq_chord=10,
                                               max_seq_video=10)
    return (cfg, TrainConfig(optimizer="adamw", lr=LR),
            LoopConfig(epochs=epochs, batch_size=2, output_dir=out,
                       continue_from=init, log_fn=print),
            train_ds, val_ds)


def _cli_argv(tree, out, parallel):
    return ["-dataset_dir", tree, "-output_dir", out, "-epochs", "1",
            "-batch_size", "4", "-n_layers", "2", "-d_model", "16",
            "-dim_feedforward", "32", "-num_heads", "2", "-mesh", "2x2",
            "-parallel", parallel, "-microbatches", "2", "-device", "cpu",
            "-no_tensorboard"] + (["-music_gen_version", "2.2"]
                                  if parallel != "pp" else [])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, tree, loop_run):
    t = tmp_path_factory.mktemp("worlds")
    cases_2x2 = [
        _case("dpep", "2.2", "dp"), _case("tp", "2.2", "tp"),
        _case("sp", "2.2", "sp"), _case("bal_dp", "3.1", "dp"),
        _case("bal_tp", "3.1", "tp"),
        _case("drop_dp", "2.2", "dp", 0.1, jax_weights=False),
        _case("drop_tp", "2.2", "tp", 0.1, jax_weights=False),
        _case("drop_sp", "2.2", "sp", 0.1, jax_weights=False,
              count_emotions=True),
        _case("cap_tp", "2.2cap", "tp", 0.1, jax_weights=False),
        dict(name="probe", probe=3),
        dict(name="train_amt", call="video2music_tpu_torch.train:train_amt",
             args=_train_amt_args(tree, loop_run["out"], loop_run["init"]),
             kwargs=dict(parallel="dp"), pass_mesh=True),
        dict(name="continue", call="video2music_tpu_torch.train:train_amt",
             args=_train_amt_args(
                 tree, loop_run["cont"],
                 os.path.join(loop_run["out"], "weights",
                              "best_loss_weights")),
             kwargs=dict(parallel="tp"), pass_mesh=(1, 4)),
    ] + [dict(name=f"cli_{p}", call="video2music_tpu_torch.cli.train_amt:main",
              args=(_cli_argv(tree, f"{loop_run['cli']}_{p}", p),))
         for p in ("dp", "tp", "sp", "pp")]
    return {"2x2": _World(t / "w2x2", (2, 2), cases_2x2),
            "1x4": _World(t / "w1x4", (1, 4), [_case("inner", "2.2", "tp")])}


# ---------------------------------------------------------------------------
# the shard plan against JAX's param_shardings
# ---------------------------------------------------------------------------

def _port_leaf(path, params):
    """(port parameter name, port dimension of each JAX leaf dimension) of
    a JAX param path, or None for a leaf the port fuses nowhere."""
    names = [getattr(k, "key", None) for k in path]
    if len(names) == 4 and names[1:3] == ["ffn", "gate"] \
            and "experts" in params[names[0]]["ffn"]:   # the MoE router
        pre = {"enc": "encoder_layers", "dec": "decoder_layers"}[
            names[0].split("_")[0]] + "." + names[0].split("_")[1]
        return (f"{pre}.ffn.gate." + ("weight" if names[3] == "kernel"
                                      else "bias"),
                {1: 0} if names[3] == "kernel" else {0: 0})
    stack = {"enc": "encoder_layers", "dec": "decoder_layers"}
    kind, _, i = names[0].partition("_")
    if kind not in stack or not i.isdigit():
        return None
    pre = f"{stack[kind]}.{i}." + ".".join(
        n for n in names[1:-2] if n not in ("experts",))
    parent, leaf = names[-2], names[-1]
    if parent in ("q_proj", "k_proj", "v_proj"):
        name = "in_proj." + ("weight" if leaf == "kernel" else "bias")
        return pre + "." + name, ({1: 0} if leaf == "kernel" else {0: 0})
    if parent == "out_proj" and leaf == "kernel":
        return pre + ".out_proj.weight", {0: 1}
    if parent in ("linear1", "gate", "Dense_0") and leaf == "kernel":
        first = "linear1" if parent == "Dense_0" else "w1g"
        return pre + f".{first}.weight", {1: 0}
    if parent in ("linear1", "gate", "Dense_0") and leaf == "bias":
        first = "linear1" if parent == "Dense_0" else "w1g"
        return pre + f".{first}.bias", {0: 0}
    if parent in ("linear2", "Dense_1") and leaf == "kernel":
        return pre + ".linear2.weight", {0: 1}
    if parent == "experts":   # (E, D, F) / (E, F) / (E, F, D) / (E, D)
        port = {"w1": "w1g", "wg": "w1g", "b1": "b1g", "bg": "b1g",
                "w2": "w2", "b2": "b2"}[leaf]
        dims = ({0: 0, 2: 1} if leaf in ("w1", "wg") else
                {0: 0, 1: 2} if leaf == "w2" else {0: 0, 1: 1})
        return f"{pre}.{port}", dims
    if parent == "shared_expert":   # (1, ...) stacks -> the SwiGLU
        port = {"w1": "w1g.weight", "wg": "w1g.weight", "b1": "w1g.bias",
                "bg": "w1g.bias", "w2": "linear2.weight",
                "b2": "linear2.bias"}[leaf]
        dims = ({2: 0} if leaf in ("w1", "wg") else {1: 1} if leaf == "w2"
                else {1: 0})
        return f"{pre}.shared.{port}", dims
    return None


# the leaves the port places differently, and why
DIFFERS = {
    # JAX's TP rule keys on the module names linear1 / linear2, and flax
    # names the base AMT's ReLU feed-forward layers Dense_0 / Dense_1, so
    # JAX replicates them; the port splits them (column / row) as Megatron
    # does for every feed-forward
    "relu": lambda name: ".ffn.linear1." in name or ".ffn.linear2." in name,
    # JAX's TP rule keys on the module name "gate", which is also the MoE
    # router's, so JAX splits the router's expert columns; the port keeps
    # the router whole (every rank routes every token to every expert)
    "router": lambda name: ".ffn.gate." in name,
    # JAX splits q / k / v columns wherever the width divides the axis,
    # cutting a differential pair or a GQA K/V head across ranks; the port
    # keeps such a module whole (each rank must hold whole heads)
    "heads": lambda name: ".in_proj." in name or ".out_proj." in name,
}


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(version, kw_items):
    jcfg = jax_amt_config(version, **dict(TINY, dropout=0.0, **dict(kw_items)))
    return jax.eval_shape(lambda: JaxAMT(cfg=jcfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        **{k: jnp.asarray(v) for k, v in _batch(0, 2).items()
           if k in ("x", "x_root", "x_attr", "semantic", "key",
                    "scene_offset", "motion", "emotion")}))["params"]


def _placements(version, kw, m, tp):
    cfg = amt_config(version, **dict(TINY, dropout=0.0, **kw))
    jparams = _jax_param_shapes(version, tuple(sorted(kw.items())))
    specs = param_shardings(jax_create_mesh((1, m)), jparams, tp=tp)
    plan = shard_plan(VideoMusicTransformer(cfg), m, "tp" if tp else "dp")
    got, want = {}, {}
    for path, sh in jax.tree_util.tree_leaves_with_path(specs):
        mapped = _port_leaf(path, jparams)
        if mapped is None:
            assert all(a is None for a in sh.spec), (path, sh.spec)
            continue
        name, dims = mapped
        axis = [d for d, a in enumerate(sh.spec) if a == "model"]
        want.setdefault(name, set()).add(dims[axis[0]] if axis else None)
        got[name] = plan[name].dim if name in plan else None
    return got, want


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("version,kw", [
    ("2.2", {}), (None, {}), ("3.1", {}), ("3.1", dict(num_heads=2)),
    ("2.2", dict(kv_heads=2))], ids=["2.2", "base", "3.1", "3.1_h2",
                                     "2.2_gqa2"])
def test_shard_plan_matches_jax_param_shardings(version, kw, m):
    """Leaf by leaf through the weight bridge's names: each port
    parameter is cut along the dimension JAX's ``param_shardings`` cuts
    its JAX leaves (fused leaves agreeing), under dp and tp, but for the
    listed differences."""
    args = dict(TINY, dropout=0.0, **kw)
    for tp in (False, True):
        got, want = _placements(version, kw, m, tp)
        for name, placed in got.items():
            jax_dims = want[name]
            if jax_dims == {placed}:
                continue
            reason = [r for r, hit in DIFFERS.items() if hit(name)]
            assert tp and reason, (name, placed, jax_dims)
            if reason == ["router"]:
                assert placed is None, name
            elif reason == ["heads"]:
                mod_kw = dict(kw)
                heads = mod_kw.get("kv_heads") or args["num_heads"]
                assert placed is None and (args["num_heads"] % m
                                           or heads % m), name
            else:  # the ReLU feed-forward: JAX keeps it whole
                assert jax_dims == {None} and placed is not None, name
        if version == "2.2" and not kw:
            E = 6   # EP where the axis divides the experts, else inner d_ff
            assert got["encoder_layers.1.ffn.w1g"] == (
                0 if E % m == 0 else 1 if tp else None)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def test_collectives_autograd(worlds):
    """f, g, the sequence gather (plain and summed), split and
    reduce-scatter over the 2x2 world's model groups (ranks 0 and 1 of
    data row 0), forward and backward, against their definitions."""
    r0, r1 = worlds["2x2"](0)["probe"], worlds["2x2"](1)["probe"]
    cat = lambda a, b: np.concatenate([a, b], axis=1)
    half = lambda a, r: np.split(a, 2, axis=1)[r]
    for rank, (me, other) in enumerate(((r0, r1), (r1, r0))):
        x, y, up, gx = me["copy_to"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_allclose(gx, up + other["copy_to"][2], rtol=1e-6)
        x, y, up, gx = me["reduce_from"]
        np.testing.assert_allclose(y, x + other["reduce_from"][0], rtol=1e-6)
        np.testing.assert_array_equal(gx, up)
        x, y, up, gx = me["gather_seq"]
        xs = (x, other["gather_seq"][0])[::1 if rank == 0 else -1]
        np.testing.assert_array_equal(y, cat(*xs))
        np.testing.assert_array_equal(gx, half(up, rank))
        x, y, up, gx = me["gather_seq_summed"]
        xs = (x, other["gather_seq_summed"][0])[::1 if rank == 0 else -1]
        np.testing.assert_array_equal(y, cat(*xs))
        np.testing.assert_allclose(
            gx, half(up + other["gather_seq_summed"][2], rank), rtol=1e-6)
        x, y, up, gx = me["split_seq"]
        np.testing.assert_array_equal(y, half(x, rank))
        ups = (up, other["split_seq"][2])[::1 if rank == 0 else -1]
        np.testing.assert_array_equal(gx, cat(*ups))
        x, y, up, gx = me["reduce_scatter_seq"]
        total = x + other["reduce_scatter_seq"][0]
        np.testing.assert_allclose(y, half(total, rank), rtol=1e-6)
        ups = (up, other["reduce_scatter_seq"][2])[::1 if rank == 0 else -1]
        np.testing.assert_array_equal(gx, cat(*ups))


# ---------------------------------------------------------------------------
# the strategies against the JAX single-device step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,case,key", [
    ("2x2", "dpep", "2.2"), ("2x2", "tp", "2.2"), ("2x2", "sp", "2.2"),
    ("2x2", "bal_dp", "3.1"), ("2x2", "bal_tp", "3.1"),
    ("1x4", "inner", "2.2")])
def test_sharded_step_matches_jax_single_device(worlds, world, case, key):
    """Three f32 AdamW steps at dropout 0 on the mesh equal three steps of
    the JAX package's ``make_amt_train_step`` on one device: the losses
    (rtol 1e-4) and every parameter, the MoE ``balance_bias`` included."""
    check_against_jax(worlds[world]()[case], key)
    if case == "inner":   # 6 experts on 4 ranks: the inner d_ff fallback
        assert worlds[world]()[case]["heads"] == [1]


def check_against_jax(got, key):
    losses, want = _jax_steps(key)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    _close(got["state"], want)
    biases = [k for k in want if k.endswith("balance_bias")]
    assert (len(biases) > 0) == (key == "3.1")
    for k in biases:
        assert want[k].abs().max() > 0, k
        np.testing.assert_allclose(got["state"][k], want[k], rtol=1e-4,
                                   atol=1e-7)


@pytest.mark.parametrize("case,key", [
    ("drop_dp", "2.2"), ("drop_tp", "2.2"), ("drop_sp", "2.2"),
    ("cap_tp", "2.2cap")])
def test_dropout_masks_are_global(worlds, case, key):
    """With dropout 0.1 (attention, feed-forward, expert and residual
    masks) the sharded step equals the port's single-process step from
    the same seed: every rank draws its slice of the unsharded masks.
    With capacity dispatch (factor 1, so assignments drop) too: the slots
    follow the global token order over the data ranks. After the sp steps
    an eval forward counting expert emotions sums its counts over
    "data" to the single-process counts."""
    got = worlds["2x2"]()[case]
    losses, want, moe = _port_steps(key, 0.1)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    _close(got["state"], want)
    if got["moe"] is not None:
        assert sorted(got["moe"]) == sorted(moe) and moe
        for layer, metrics in moe.items():
            for name, v in metrics.items():
                np.testing.assert_allclose(got["moe"][layer][name], v,
                                           rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# row 11's mask origin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b0,h0", [(0, 0), (1, 2), (2, 1)])
def test_dropout_mask_origin_is_a_slice_of_the_whole_mask(b0, h0):
    """The plain mask of a (2, 2)-head shard at origin (b0, h0, 4) is the
    slice of the whole (4, 4) grid's mask; the probabilities it drops are
    the slice of the Pallas kernel's (interpret mode) on the whole
    tensor."""
    Bw, Hw, Ls, D, rate, seed = 4, 4, 40, 16, 0.1, 5
    whole = dropout_mask(Bw, Hw, Ls, Ls, rate, seed, "cpu")
    part = dropout_mask(2, 2, Ls, Ls, rate, seed, "cpu", origin=(b0, h0, Hw))
    torch.testing.assert_close(part, whole[b0:b0 + 2, h0:h0 + 2], rtol=0,
                               atol=0)
    r = np.random.default_rng(2)
    q, k = (r.standard_normal((Bw, Hw, Ls, D)).astype(np.float32)
            for _ in range(2))
    jp = np.asarray(jax_extract(jnp.asarray(q), jnp.asarray(k), causal=True,
                                dropout_rate=rate, seed=seed,
                                interpret=pltpu.InterpretParams()))
    sl = (slice(b0, b0 + 2), slice(h0, h0 + 2))
    pp = extract_dropped_probs(torch.tensor(q[sl]), torch.tensor(k[sl]),
                               causal=True, dropout_rate=rate, seed=seed,
                               origin=(b0, h0, Hw)).numpy()
    np.testing.assert_array_equal(pp == 0, jp[sl] == 0)
    np.testing.assert_allclose(pp, jp[sl], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the loop, its checkpoints and the CLI
# ---------------------------------------------------------------------------

def test_train_amt_on_a_mesh_matches_jax_train_amt(worlds, tree, loop_run):
    """``train_amt`` on the 2x2 world (dp; experts over "model") from the
    JAX init writes the ``results.csv`` of the JAX ``train_amt`` on
    ``create_mesh((2, 2))``; 5 clips in batches of 2 run 2 full batches an
    epoch (the ragged one dropped), and the checkpoint holds the JAX
    state's weights."""
    jcfg = jax_amt_config("2.2", dropout=0.0, **LOOP_KW)
    train_ds, val_ds, _ = jax_datasets(tree, max_seq_chord=10,
                                       max_seq_video=10)
    jstate = jax_train_amt(
        JaxAMT(cfg=jcfg), JaxTrainConfig(optimizer="adamw", lr=LR),
        JaxLoopConfig(epochs=1, batch_size=2, output_dir=loop_run["jax_out"],
                      log_fn=lambda s: None),
        train_ds, val_ds, mesh=jax_create_mesh((2, 2)), parallel="dp")
    assert worlds["2x2"]()["train_amt"] == {"step": 2}
    rows = {}
    for which in ("out", "jax_out"):
        with open(os.path.join(loop_run[which], "results.csv")) as f:
            rows[which] = list(csv.reader(f))
    assert rows["out"][0] == CSV_HEADER and len(rows["out"]) == 2
    np.testing.assert_allclose(np.asarray(rows["out"][1], float),
                               np.asarray(rows["jax_out"][1], float),
                               rtol=1e-4)
    path = os.path.join(loop_run["out"], "weights", "best_loss_weights")
    saved = torch.load(path, weights_only=True)["model"]
    _close(saved, amt_from_jax(jax.device_get(jstate.params)), steps=2)
    served = Video2music(device="cpu", amt_checkpoint=path,
                         music_gen_version="2.2", reg_model="bimamba+",
                         motion_type=0,
                         amt_overrides=dict(n_layers=2, num_heads=2,
                                            d_model=16, d_ff=32),
                         reg_overrides=dict(n_layers=1, d_model=8,
                                            d_hidden=16))
    for k, v in served.model.state_dict().items():
        torch.testing.assert_close(v.float(), saved[k].float(), rtol=0,
                                   atol=0)


def test_continue_from_onto_another_mesh_shape(worlds, loop_run):
    """The 2x2 dp checkpoint restores onto a 1x4 tp mesh of the same
    ranks (whole, then cut) and trains on: its step counter carries
    over."""
    assert worlds["2x2"]()["continue"] == {"step": 4}
    with open(os.path.join(loop_run["cont"], "results.csv")) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2 and np.isfinite(float(rows[1][8]))


@pytest.mark.parametrize("parallel", ["dp", "tp", "sp", "pp"])
def test_cli_trains_on_a_mesh(worlds, loop_run, parallel):
    """``-mesh 2x2 -parallel dp|tp|sp|pp -device cpu`` (joining the
    world it runs in, as under torchrun): one epoch, one results row, the
    checkpoints."""
    worlds["2x2"]()
    out = f"{loop_run['cli']}_{parallel}"
    rows = list(csv.reader(open(os.path.join(out, "results.csv"))))
    assert rows[0] == CSV_HEADER and len(rows) == 2
    assert np.isfinite(float(rows[1][8]))
    assert sorted(os.listdir(os.path.join(out, "weights"))) == [
        "best_loss_weights", "epoch_0001"]


def test_cli_starts_its_ranks_from_a_shell(tree, tmp_path):
    """From a plain shell (no RANK in the environment) ``-mesh 1x2``
    starts its two ranks itself."""
    from video2music_tpu_torch.cli.train_amt import main
    out = str(tmp_path / "out")
    argv = _cli_argv(tree, out, "pp")
    argv[argv.index("2x2")] = "1x2"
    main(argv)
    rows = list(csv.reader(open(os.path.join(out, "results.csv"))))
    assert len(rows) == 2 and np.isfinite(float(rows[1][8]))


def test_mesh_checks_raise(tree, tmp_path):
    """The JAX loop's checks (its messages), ``-parallel`` without
    ``-mesh``, nccl with fewer GPUs than ranks, a mesh larger than the
    world, and the pp step's rejections."""
    from video2music_tpu_torch.cli.train_amt import main
    from video2music_tpu_torch.parallel import MeshSpec
    from video2music_tpu_torch.parallel.mesh import Mesh
    from video2music_tpu_torch.train.loop import _full_batches
    ds, _, _ = create_vevo_datasets(tree, max_seq_chord=10, max_seq_video=10)
    cfg = amt_config(None, dropout=0.0, **LOOP_KW)
    tcfg = TrainConfig(optimizer="adam", lr=LR)
    mesh = Mesh(MeshSpec(2, 2), 0, None, None, torch.device("cpu"), "gloo")
    loop = LoopConfig(epochs=1, batch_size=3, output_dir=str(tmp_path / "o"))
    with pytest.raises(ValueError, match="divisible"):
        train_amt(cfg, tcfg, loop, ds, ds, mesh=mesh, parallel="dp")
    with pytest.raises(ValueError, match="needs AMTConfig.sequence_parallel"):
        train_amt(cfg, tcfg, loop, ds, ds, mesh=mesh, parallel="sp")
    with pytest.raises(ValueError, match="pp needs batch_size divisible"):
        train_amt(cfg, tcfg, dataclasses_replace(loop, batch_size=6), ds, ds,
                  mesh=mesh, parallel="pp", n_microbatches=2)
    with pytest.raises(SystemExit, match="requires -mesh"):
        main(["-dataset_dir", tree, "-parallel", "tp", "-device", "cpu"])
    with pytest.raises(ValueError, match="one GPU per rank"):
        create_mesh((1, 2), backend="nccl", rank=0, world_size=2)
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        create_mesh((2, 2), backend="gloo", rank=0, world_size=2)
    msgs = []
    batches = [{"x": np.zeros((4, 3))}] * 2 + [{"x": np.zeros((2, 3))}]
    assert len(list(_full_batches(iter(batches), 4, msgs.append))) == 2
    assert len(msgs) == 1 and "ragged" in msgs[0]
    S2 = Mesh(MeshSpec(1, 2), 0, None, _Solo(2), torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="divisible"):
        make_amt_pp_train_step(amt_config("2.2", **dict(TINY, n_layers=6)),
                               tcfg, S2)
    with pytest.raises(ValueError, match="differential"):
        make_amt_pp_train_step(amt_config("3.1", **TINY), tcfg, S2)
    with pytest.raises(ValueError, match="separated"):
        make_amt_pp_train_step(amt_config(None, separated=True, **TINY),
                               tcfg, S2)


class _Solo:
    """A stand-in model group (rank 0 of ``size``) for the checks that
    raise before any collective."""

    def __init__(self, size):
        self.rank, self.size = 0, size


def dataclasses_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)
