"""The port's own copies of the JAX package's framework-free modules
(core, midi, data.native / parsers / dataset, pipeline/serving.py,
features/scene.py, pipeline/video_io.py, midi/reader.py, midi/processor.py,
features/audio.py, obs/tensorboard.py, the framework-free CLIs) equal
the originals: configs field for field for every AMT version, the
TrainConfig / RegressionConfig defaults, the vocab tables, the constants,
the MIDI helpers' output, and the serving module's source."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

import video2music_tpu.core.constants as JC
import video2music_tpu.core.vocab as JV
import video2music_tpu.midi as JM
from video2music_tpu.core import config as JCFG
import video2music_tpu_torch.core.constants as PC
import video2music_tpu_torch.core.vocab as PV
import video2music_tpu_torch.midi as PM
from video2music_tpu_torch.core import config as PCFG
from video2music_tpu_torch.data import native as PN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERSIONS = [None, "1.0", "1.1", "1.2", "1.2.3", "1.3", "1.3.3", "1.3.4",
            "2.0", "2.1", "2.2", "2.3", "3.0", "3.1", "3.2"]


@pytest.mark.parametrize("version", VERSIONS)
def test_amt_config_copy_equals_original(version):
    for kw in ({}, dict(n_layers=2, d_model=32, kv_heads=2, dropout=0.0)):
        assert dataclasses.asdict(PCFG.amt_config(version, **kw)) == \
            dataclasses.asdict(JCFG.amt_config(version, **kw))


@pytest.mark.parametrize("name", ["TrainConfig", "RegressionConfig",
                                  "MambaBackboneConfig", "MoEConfig",
                                  "AttentionConfig", "LayerSpec",
                                  "MusicTransformerConfig"])
def test_config_defaults_equal(name):
    assert dataclasses.asdict(getattr(PCFG, name)()) == dataclasses.asdict(getattr(JCFG, name)())


def test_constants_equal():
    names = lambda m: {k for k in vars(m) if k.isupper()}
    assert names(PC) == names(JC)
    for k in names(JC):
        assert getattr(PC, k) == getattr(JC, k), k


def test_vocab_tables_equal():
    assert PV.chord_dict() == JV.chord_dict()
    assert PV.chord_inv_dict() == JV.chord_inv_dict()
    assert PV.chord_root_dict() == JV.chord_root_dict()
    assert PV.chord_attr_dict() == JV.chord_attr_dict()
    assert PV.KEY_DIC == JV.KEY_DIC
    assert PV.INSTRUMENTS == JV.INSTRUMENTS
    for a, b in zip(PV.chord_to_root_attr_tables(),
                    JV.chord_to_root_attr_tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PV.emotion_chord_targets(),
                                  JV.emotion_chord_targets())
    for cid in range(PC.CHORD_END):
        assert PV.chord_symbol(cid) == JV.chord_symbol(cid)


def test_midi_copy_writes_the_same_bytes(tmp_path):
    symbols = ("C", "Am", "F", "G7", "Dm7")
    ids = [1, 1, 2, 3, 3]
    for mod, name in ((PM, "port.mid"), (JM, "jax.mid")):
        midi = mod.MIDIFile(1)
        midi.addTempo(0, 0, 120)
        chords = mod.voice([mod.Chord(s).getMIDI("c", 4) for s in symbols])
        offsets = mod.chord_offsets(ids)
        for i, chord in enumerate(chords):
            mod.add_chord(midi, chord, offsets[i],
                          mod.density_bucket(0.3 * i, i % 6), 0, i * 2.0,
                          2.0, 80, i % 6, arpeggio_chord=i % 2 == 0)
        with open(tmp_path / name, "wb") as f:
            midi.writeFile(f)
    assert (tmp_path / "port.mid").read_bytes() == \
        (tmp_path / "jax.mid").read_bytes()


def test_native_copy_builds_into_the_ports_build_dir(tmp_path):
    """The port's loader never writes the JAX package's native/ cache; its
    scalar-lab parser gives the literal expected rows. It is not held to
    the JAX package's native loader: that loader builds its library in
    place, and a test worker that loads it half-written while another
    builds it falls back for the rest of its life (ROADMAP.md, Queue 3)."""
    assert os.path.dirname(PN._SO).endswith(
        os.path.join("video2music_tpu_torch", "_build"))
    assert os.path.samefile(PN._SRC, os.path.join(ROOT, "native",
                                                  "v2m_native.cpp"))
    lab = tmp_path / "s.lab"
    lab.write_text("0 0.5\n1 0.25\n2 1.0\n")
    got = PN.parse_scalar_lab(str(lab), 5, 0.0, 1.0)
    if shutil.which("g++") is None:  # the callers parse in Python
        assert got is None
        return
    np.testing.assert_array_equal(got, np.asarray([1.5, 1.25, 2.0, 0.0, 0.0],
                                                  np.float32))


@pytest.mark.parametrize("path", [("features", "scene.py"),
                                  ("pipeline", "video_io.py"),
                                  ("midi", "reader.py"),
                                  ("midi", "processor.py"),
                                  ("features", "audio.py"),
                                  ("obs", "tensorboard.py"),
                                  ("cli", "analyze.py"),
                                  ("cli", "dataset_tools.py"),
                                  ("cli", "key_detection.py"),
                                  ("cli", "silu_approx.py")])
def test_raw_video_modules_are_copies(path):
    """Scene-cut detection and the video I/O (decode, muxing, FluidSynth),
    the MIDI reader and event codec, the audio features, the TensorBoard
    event writer and the four framework-free CLIs (analyze, dataset_tools,
    key_detection, silu_approx; sklearn, scipy and matplotlib imported
    lazily) are framework-free: the port keeps them byte for byte (their
    imports are relative already)."""
    with open(os.path.join(ROOT, "video2music_tpu", *path), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "video2music_tpu_torch", *path), "rb") as f:
        assert f.read() == want


def test_convert_module_is_a_copy():
    """The reference-checkpoint converter imports only numpy: the port
    keeps train/convert.py byte for byte; its flax-layout output reaches
    the port's models through weights.amt_from_jax / regression_from_jax
    (tests/test_torch_train_serve.py)."""
    path = ("train", "convert.py")
    with open(os.path.join(ROOT, "video2music_tpu", *path), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "video2music_tpu_torch", *path), "rb") as f:
        assert f.read() == want


def test_serving_module_is_a_copy():
    with open(os.path.join(ROOT, "video2music_tpu", "pipeline",
                           "serving.py")) as f:
        want = f.read()
    with open(os.path.join(ROOT, "video2music_tpu_torch", "pipeline",
                           "serving.py")) as f:
        assert f.read() == want


@pytest.mark.parametrize("path", [("features", "chord2vec.py"),
                                  ("assets", "chord_word2vec.npz")])
def test_chord_table_files_are_copies(path):
    """The port's chord2vec module (its imports already relative) and the
    trained chord table asset, byte for byte."""
    with open(os.path.join(ROOT, "video2music_tpu", *path), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "video2music_tpu_torch", *path), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("table", ["word2vec", "word2vec_keyed",
                                   "deterministic"])
def test_chord_tables_equal(table):
    """The tables the port's model loads for ``chord_table`` (512-d, and
    the deterministic table the JAX model takes at other dims) equal the
    JAX package's."""
    from video2music_tpu.features import chord2vec as JW
    from video2music_tpu_torch.models.amt import chord_table
    for dim in (512, 24):
        cfg = PCFG.amt_config("1.1", chord_embed=True, chord_embed_dim=dim,
                              chord_table=table)
        if table == "deterministic" or dim != 512:
            want = JW.deterministic_chord_table(dim)
        else:
            want = JW.word2vec_chord_table(
                dim, positional=table == "word2vec")
        np.testing.assert_array_equal(chord_table(cfg).numpy(), want)
