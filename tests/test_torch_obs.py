"""The port's observability against the JAX package on the CPU, at tiny
widths: the MoE layers' expert-emotion counts of an eval forward (a 2.2
bridged by ``weights.amt_from_jax``) equal to the JAX "metrics" collection
exactly, and recorded by nothing else (a training forward, a generate);
``save_expert_emotion`` and ``MaxVioLog`` writing the JAX package's files
byte for byte, the heatmaps and confusion plots rendering; ``train_amt``'s
TensorBoard tags and steps equal to the JAX loop's, their values the
port's own ``results.csv``; the step profiler writing one trace and then
doing nothing; the ``evaluate`` CLI on the same bridged 2.2 as the JAX
CLI (a JAX checkpoint and a port checkpoint: ``eval_results.json`` to
1e-5 in f32, the confusion matrices and the expert-emotion files equal);
and the copied MIDI reader and event codec reading back what the port's
writer wrote."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_data import _write_fixture_tree
from tests.test_obs import _decode_event, _decode_tfrecords
from video2music_tpu import obs as jobs
from video2music_tpu.cli import evaluate as jeval
from video2music_tpu.core.config import TrainConfig as JaxTrainConfig
from video2music_tpu.core.config import amt_config as jax_amt_config
from video2music_tpu.data import create_vevo_datasets as jax_datasets
from video2music_tpu.data.dataset import batches as jax_batches
from video2music_tpu.midi import processor as jproc
from video2music_tpu.midi import reader as jreader
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.train import checkpoint as jckpt
from video2music_tpu.train import create_train_state as jax_create_state
from video2music_tpu.train import make_optimizer as jax_make_optimizer
from video2music_tpu.train.loop import LoopConfig as JaxLoopConfig
from video2music_tpu.train.loop import train_amt as jax_train_amt
from video2music_tpu_torch import obs
from video2music_tpu_torch.cli import evaluate as peval
from video2music_tpu_torch.core.config import TrainConfig, amt_config
from video2music_tpu_torch.data import create_vevo_datasets
from video2music_tpu_torch.midi import MIDIFile
from video2music_tpu_torch.midi import processor as pproc
from video2music_tpu_torch.midi import reader as preader
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.pipeline import Video2music
from video2music_tpu_torch.train import create_train_state, save_checkpoint
from video2music_tpu_torch.train.loop import LoopConfig, StepProfiler, train_amt
from video2music_tpu_torch.weights import amt_from_jax

torch.set_num_threads(1)
AMT_FLAGS = ["-music_gen_version", "2.2", "-n_layers", "2", "-num_heads",
             "2", "-d_model", "16", "-dim_feedforward", "32"]
B, L, SEM = 2, 12, 7
TINY = dict(n_layers=2, num_heads=2, d_model=16, d_ff=32, max_seq_video=L,
            max_seq_chord=L, total_vf_dim=SEM + 1 + 1 + 6, dropout=0.0)


def _inputs(seed):
    """AMT inputs (chords one shorter than the video, as the JAX obs test),
    PAD emotion rows at the end of clip 0 (dominant id -1)."""
    r = np.random.default_rng(seed)
    emotion = r.uniform(size=(B, L, 6)).astype(np.float32)
    emotion[0, -3:] = 0.0
    return (r.integers(0, 157, (B, L - 1)), r.integers(0, 13, (B, L - 1)),
            r.integers(0, 14, (B, L - 1)),
            r.standard_normal((B, L, SEM)).astype(np.float32),
            np.ones((B, 1), np.float32),
            r.integers(0, 5, (B, L)).astype(np.float32),
            r.standard_normal((B, L)).astype(np.float32), emotion)


@pytest.fixture(scope="module")
def counted():
    """(JAX metrics collection, port model) after one eval forward each on
    the same inputs and bridged weights, the port's counting."""
    jm = JaxAMT(cfg=jax_amt_config("2.2", **TINY))
    args = _inputs(0)
    jargs = tuple(map(jnp.asarray, args))
    variables = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, *jargs)
    _, mutated = jax.jit(lambda v, *a: jm.apply(
        v, *a, deterministic=True, mutable=["moe_state", "metrics"]))(
            variables, *jargs)
    pm = VideoMusicTransformer(amt_config("2.2", **TINY)).eval()
    pm.load_state_dict(amt_from_jax(jax.device_get(variables["params"]),
                                    variables.get("moe_state")))
    with torch.no_grad():
        pm(*map(torch.as_tensor, args), count_emotions=True)
    return jax.device_get(mutated["metrics"]), pm


def test_expert_emotion_counts_equal_jax(counted):
    jmetrics, pm = counted
    want = jobs.collect_moe_metrics(jmetrics)
    got = obs.collect_moe_metrics(pm)
    assert sorted(got) == sorted(want) == ["dec_1/ffn", "enc_1/ffn"]
    for layer, metrics in want.items():
        assert sorted(got[layer]) == sorted(metrics), layer
        for name in ("expert_emotion_counts", "expert_counts"):
            np.testing.assert_array_equal(got[layer][name], metrics[name],
                                          err_msg=f"{layer} {name}")
        np.testing.assert_allclose(got[layer]["maxvio"], metrics["maxvio"],
                                   rtol=1e-6)
        counts = got[layer]["expert_emotion_counts"]
        # top-2 over the positions a dominant emotion labels (decoder: the
        # first L - 1, the chords' length); PAD rows count nowhere
        n = 2 * L - 3 if layer.startswith("enc") else 2 * (L - 1) - 2
        assert counts.shape == (6, 6) and counts.sum() == 2 * n


def test_only_counting_eval_forwards_record_emotions(counted, tmp_path):
    """Counting eval forwards add up until reset; a training forward
    asked to count records no emotion counts, and neither does a generate
    (the encoder and the decode steps)."""
    _, pm = counted
    model = VideoMusicTransformer(pm.cfg).eval()
    model.load_state_dict(pm.state_dict())
    with torch.no_grad():
        for _ in range(2):
            model(*map(torch.as_tensor, _inputs(0)), count_emotions=True)
    for layer, v in obs.collect_moe_metrics(pm).items():
        np.testing.assert_array_equal(
            obs.collect_moe_metrics(model)[layer]["expert_emotion_counts"],
            2 * v["expert_emotion_counts"])
    obs.reset_moe_metrics(model)
    model(*map(torch.as_tensor, _inputs(1)), deterministic=False,
          generator=torch.Generator().manual_seed(0), count_emotions=True)
    got = obs.collect_moe_metrics(model)
    assert got and all("expert_emotion_counts" not in v
                       for v in got.values())
    obs.reset_moe_metrics(model)
    assert obs.collect_moe_metrics(model) == {}
    v2m = Video2music(device="cpu", music_gen_version="2.2",
                      reg_model="bimamba+", motion_type=0,
                      amt_overrides=dict(n_layers=2, num_heads=2, d_model=16,
                                         d_ff=32),
                      reg_overrides=dict(n_layers=1, d_model=8, d_hidden=16))
    r = np.random.default_rng(2)
    feats = {"semantic": r.standard_normal((8, 768)).astype(np.float32),
             "emotion": r.uniform(size=(8, 6)).astype(np.float32),
             "scene_offset": np.arange(8, dtype=np.float32),
             "motion": r.standard_normal((8,)).astype(np.float32)}
    v2m.generate(features=feats, output_dir=str(tmp_path),
                 compute_dtype="float32")
    assert obs.collect_moe_metrics(v2m.model) == {}


def test_save_expert_emotion_and_maxvio_log_write_jax_files(counted,
                                                            tmp_path):
    jmetrics, pm = counted
    paths = {}
    for tag, mod, tree in (("jax", jobs, jmetrics), ("port", obs, pm)):
        out = tmp_path / tag
        names = [os.path.basename(p)
                 for p in mod.save_expert_emotion(tree, out_dir=str(out))]
        log = mod.MaxVioLog()
        log.update(tree)
        log.update(tree)
        log.save(str(out / "maxvio.npy"))
        paths[tag] = names
    assert paths["port"] == paths["jax"] == ["experts_emotion_count0.json",
                                             "experts_emotion_count1.json"]
    for name in paths["jax"] + ["maxvio.npy"]:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    pngs = obs.plot_expert_emotion_heatmaps(pm, out_dir=str(tmp_path / "p"))
    assert len(pngs) == 2 and all(os.path.getsize(p) > 1000 for p in pngs)
    cm = np.random.default_rng(0).integers(0, 9, (14, 14))
    for p in (obs.plot_confusion_matrix(cm, out_path=str(tmp_path / "a.png")),
              obs.compare_confusion_matrices(
                  cm, cm.T, out_path=str(tmp_path / "b.png"))):
        assert os.path.getsize(p) > 1000


def test_train_amt_tensorboard_matches_jax_loop(tmp_path):
    """The port's train_amt writes the JAX loop's tags at the JAX loop's
    1-based steps; each value is the port's own results.csv entry."""
    root = str(tmp_path / "d")
    _write_fixture_tree(root, ["aaa", "bbb"])
    kw = dict(n_layers=1, num_heads=2, d_model=16, d_ff=32, max_seq_video=10,
              max_seq_chord=10, total_vf_dim=8 + 1 + 1 + 6, dropout=0.0)
    events = {}
    for tag in ("jax", "port"):
        tb = str(tmp_path / f"tb_{tag}")
        if tag == "jax":
            train_ds, val_ds, _ = jax_datasets(root, max_seq_chord=10,
                                               max_seq_video=10)
            jax_train_amt(JaxAMT(cfg=jax_amt_config(None, **kw)),
                          JaxTrainConfig(optimizer="adam", lr=1e-3),
                          JaxLoopConfig(epochs=2, batch_size=2,
                                        output_dir=str(tmp_path / "o_jax"),
                                        tensorboard_dir=tb,
                                        log_fn=lambda s: None),
                          train_ds, val_ds)
        else:
            train_ds, val_ds, _ = create_vevo_datasets(root, max_seq_chord=10,
                                                       max_seq_video=10)
            train_amt(amt_config(None, **kw),
                      TrainConfig(optimizer="adam", lr=1e-3),
                      LoopConfig(epochs=2, batch_size=2,
                                 output_dir=str(tmp_path / "o_port"),
                                 tensorboard_dir=tb, log_fn=lambda s: None),
                      train_ds, val_ds, device="cpu")
        (name,) = os.listdir(tb)
        assert name.startswith("events.out.tfevents.")
        events[tag] = [_decode_event(r) for r in
                       _decode_tfrecords(os.path.join(tb, name))]
    for tag in ("jax", "port"):
        assert events[tag][0]["file_version"] == "brain.Event:2"
    key = lambda evs: [(e["tag"], e["step"]) for e in evs[1:]]
    assert key(events["port"]) == key(events["jax"])
    assert len(events["port"]) == 9
    with open(tmp_path / "o_port" / "results.csv") as f:
        rows = list(csv.reader(f))[1:]
    for e in events["port"][1:]:
        row = rows[e["step"] - 1]
        col = {"Avg_CE_loss/eval": 8, "Avg_CE_loss_chord/eval": 9,
               "Avg_CE_loss_emotion/eval": 10, "Learn_rate/train": 1}[e["tag"]]
        assert e["value"] == np.float32(float(row[col])), e


def _save_pair(tmp_path, jax_model, first, port_cfg, bridge, init_fn=None):
    tx = jax_make_optimizer(JaxTrainConfig(), d_model=port_cfg.d_model)
    kw = {} if init_fn is None else dict(init_fn=init_fn)
    state = jax.jit(lambda rng, batch: jax_create_state(
        jax_model, tx, rng, batch, **kw))(jax.random.PRNGKey(7), first)
    jpath = str(tmp_path / "jax_ckpt")
    jckpt.save_checkpoint(jpath, state)
    pstate = create_train_state(port_cfg, TrainConfig(), device="cpu")
    params = jax.device_get(state.params)
    pstate.model.load_state_dict(
        bridge(params, jax.device_get(state.moe_state)) if init_fn is None
        else bridge(params))
    ppath = str(tmp_path / "port_ckpt")
    save_checkpoint(ppath, pstate)
    return jpath, ppath


def _results(out):
    with open(os.path.join(out, "eval_results.json")) as f:
        return json.load(f)


def test_evaluate_cli_matches_jax(tmp_path):
    """The same bridged 2.2 through both evaluate CLIs: the metrics to
    1e-5 (f32), the three confusion matrices and the per-layer
    expert-emotion JSON files equal."""
    tree = str(tmp_path / "vevo")
    _write_fixture_tree(tree, ["aaa", "bbb", "ccc"])
    _, _, test_ds = jax_datasets(tree)
    vf = 8 + 1 + 1 + 6
    kw = dict(n_layers=2, num_heads=2, d_model=16, d_ff=32, dropout=0.0,
              total_vf_dim=vf)
    first = next(jax_batches(test_ds, 3, shuffle=False))
    jpath, ppath = _save_pair(tmp_path, JaxAMT(cfg=jax_amt_config("2.2", **kw)),
                              first, amt_config("2.2", **kw), amt_from_jax)
    flags = ["-dataset_dir", tree, "-batch_size", "3", "-confusion",
             "-expert_plots"] + AMT_FLAGS
    jeval.main(flags + ["-model_weights", jpath, "-output_dir",
                        str(tmp_path / "jax")])
    peval.main(flags + ["-model_weights", ppath, "-output_dir",
                        str(tmp_path / "port"), "-device", "cpu"])
    got, want = _results(tmp_path / "port"), _results(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert "experts_emotion_count1.json" in names
    for name in names:
        if name.endswith((".npy", ".json")) and name != "eval_results.json":
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name
    cm = np.load(tmp_path / "port" / "confusion_chord.npy")
    assert cm.sum() > 0


def test_step_profiler_traces_once(tmp_path):
    logs = []
    prof = StepProfiler(2, str(tmp_path / "p"), "cpu", log_fn=logs.append)
    x = torch.ones(64, 64)
    for _ in range(2):  # a second epoch pass finds it done
        for i in range(5):
            prof.maybe_start(i)
            x = x @ x / 64
            prof.maybe_stop(i)
    assert os.listdir(tmp_path / "p") == ["trace_steps_1-2.json"]
    assert logs == [f"profiled steps 1..2 -> {tmp_path / 'p'} "
                    "(TensorBoard profile plugin / xprof)"]
    inert = StepProfiler(0, str(tmp_path / "q"), "cpu")
    inert.maybe_start(1)
    inert.maybe_stop(1)
    assert not os.path.exists(tmp_path / "q")


def test_midi_reader_and_processor_read_the_ports_midi(tmp_path):
    """A file the port's writer wrote (two tracks, tempo change, overlapping
    notes, a sustain pedal) reads back to the same notes and control
    changes through both readers, and encodes to the same events through
    both codecs; the port's decode writes the JAX decode's notes."""
    midi = MIDIFile(2)
    midi.addTempo(0, 0, 120)
    midi.addTempo(0, 4, 90)
    r = np.random.default_rng(3)
    for i in range(24):
        midi.addNote(i % 2, i % 2, int(r.integers(40, 80)), i * 0.5,
                     float(r.uniform(0.2, 2.0)), int(r.integers(20, 120)))
    midi.addControllerEvent(0, 0, 3.0, 64, 100)
    midi.addControllerEvent(0, 0, 6.0, 64, 0)
    path = str(tmp_path / "in.mid")
    with open(path, "wb") as f:
        midi.writeFile(f)
    got, want = preader.read_midi(path), jreader.read_midi(path)
    assert [vars(n) for n in got.notes] == [vars(n) for n in want.notes]
    assert [vars(c) for c in got.control_changes] == \
        [vars(c) for c in want.control_changes]
    assert got.get_end_time() == want.get_end_time()
    events = pproc.encode_midi(path)
    assert events == jproc.encode_midi(path) and len(events) > 48
    back_p = pproc.decode_midi(events, str(tmp_path / "p.mid"))
    back_j = jproc.decode_midi(events, str(tmp_path / "j.mid"))
    assert [vars(n) for n in back_p.notes] == [vars(n) for n in back_j.notes]
    assert (tmp_path / "p.mid").read_bytes() == \
        (tmp_path / "j.mid").read_bytes()
