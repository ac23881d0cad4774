"""The port's command line against the JAX package's on the CPU, at tiny
widths: ``evaluate_regression`` on the same bridged weights (a JAX
checkpoint and a port checkpoint: ``eval_results.json`` to 1e-5; the AMT
``evaluate`` CLI is held in tests/test_torch_obs.py), the
``serve`` app's HTTP API (status codes, JSON keys and stream stages the
JAX app's; the port's answers its own ``generate_batch``'s), the
``extract_features`` subcommands (CLIP / MaxViT on bridged tiny weights to
the video tests' tolerance, the numpy ones to the byte), the ``generate``
CLI writing ``Video2music.generate``'s chords, the demo page, the copied
``analyze`` and ``key_detection`` CLIs giving the JAX package's results,
the training CLIs' flags, and every ``-device cuda`` raising without
CUDA."""

import functools
import http.client
import json
import os
import threading
import wave

import jax
import numpy as np
import pytest
import torch

from tests.test_data import _write_fixture_tree
from tests.test_torch_obs import _results, _save_pair
from tests.test_torch_video import (ATOL, JCFG, JMCFG, PCFG, PMCFG, RTOL,
                                    _write_clip, extractors)
from video2music_tpu.cli import evaluate_regression as jeval_reg
from video2music_tpu.cli import extract_features as jextract
from video2music_tpu.cli import serve as jserve
from video2music_tpu.cli import train_amt as jtrain_amt
from video2music_tpu.cli import train_regression as jtrain_reg
from video2music_tpu.core.config import RegressionConfig as JaxRegressionConfig
from video2music_tpu.data import create_vevo_datasets as jax_datasets
from video2music_tpu.data.dataset import batches as jax_batches
from video2music_tpu.features import clip as jclip
from video2music_tpu.features import maxvit as jmaxvit
from video2music_tpu.models import VideoRegression as JaxRegression
from video2music_tpu.pipeline import Video2music as JaxVideo2music
from video2music_tpu.train.step import regression_init
from video2music_tpu_torch.cli import demo as pdemo
from video2music_tpu_torch.cli import evaluate as peval
from video2music_tpu_torch.cli import evaluate_regression as peval_reg
from video2music_tpu_torch.cli import extract_features as pextract
from video2music_tpu_torch.cli import generate as pgenerate
from video2music_tpu_torch.cli import serve as pserve
from video2music_tpu_torch.cli import train_amt as ptrain_amt
from video2music_tpu_torch.cli import train_regression as ptrain_reg
from video2music_tpu_torch.core import constants as C
from video2music_tpu_torch.core.config import RegressionConfig
from video2music_tpu_torch.core.vocab import chord_inv_dict
from video2music_tpu_torch.data import create_vevo_datasets
from video2music_tpu_torch.features import clip as pclip
from video2music_tpu_torch.features import maxvit as pmaxvit
from video2music_tpu_torch.midi import MIDIFile
from video2music_tpu_torch.pipeline import Video2music
from video2music_tpu_torch.weights import (clip_from_jax, maxvit_from_jax,
                                           regression_from_jax)

torch.set_num_threads(1)
IDS = ["aaa", "bbb", "ccc", "ddd", "eee"]
AMT_FLAGS = ["-music_gen_version", "2.2", "-n_layers", "2", "-num_heads",
             "2", "-d_model", "16", "-dim_feedforward", "32"]
REG_FLAGS = ["-regModel", "bimamba+", "-n_layers", "1", "-d_model", "8",
             "-dim_feedforward", "16"]
KW = dict(music_gen_version="2.2", reg_model="bimamba+", motion_type=0,
          amt_overrides=dict(n_layers=2, num_heads=2, d_model=16, d_ff=32),
          reg_overrides=dict(n_layers=1, d_model=8, d_hidden=16))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The fixture tree (8-d semantic features) for evaluate_regression:
    three clips, two batches."""
    root = str(tmp_path_factory.mktemp("vevo"))
    _write_fixture_tree(root, IDS[:3])
    return root


@pytest.fixture(scope="module")
def tree768(tmp_path_factory):
    """The fixture tree with the 768-d semantic features Video2music
    reads (motion_type 0)."""
    root = str(tmp_path_factory.mktemp("vevo768"))
    _write_fixture_tree(root, IDS)
    r = np.random.default_rng(1)
    sem = os.path.join(root, "vevo_semantic", "origin", "2d", "clip_l14p")
    for fid in IDS:
        np.save(os.path.join(sem, fid + ".npy"),
                r.standard_normal((4, 768)).astype(np.float32))
    return root


# ---------------------------------------------------------------------------
# evaluate / evaluate_regression
# ---------------------------------------------------------------------------

def test_evaluate_regression_cli_matches_jax(tree, tmp_path):
    _, _, test_ds = jax_datasets(tree)
    kw = dict(reg_model="bimamba+", n_layers=1, d_model=8, d_hidden=16,
              dropout=0.0, total_vf_dim=8 + 6)
    first = next(jax_batches(test_ds, 2, shuffle=False))
    jpath, ppath = _save_pair(
        tmp_path, JaxRegression(cfg=JaxRegressionConfig(**kw)), first,
        RegressionConfig(**kw), regression_from_jax, init_fn=regression_init)
    flags = ["-dataset_dir", tree, "-batch_size", "2"] + REG_FLAGS
    jeval_reg.main(flags + ["-model_weights", jpath, "-output_dir",
                            str(tmp_path / "jax")])
    peval_reg.main(flags + ["-model_weights", ppath, "-output_dir",
                            str(tmp_path / "port"), "-device", "cpu"])
    got, want = _results(tmp_path / "port"), _results(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

RESULT_KEYS = ["audio_path", "batch_width", "chords", "key", "midi_path",
               "video_path"]
# the JAX app's answers, which the port's must give too: (status, JSON
# keys) per request, stream lines as (stage, keys)
TRANSCRIPT = [
    ("healthz", 200, ["ok", "stats"]),
    ("test_id", 200, RESULT_KEYS),
    ("features", 200, RESULT_KEYS),
    ("stream", 200, [("decoded", ["chords", "key", "stage"]),
                     ("done", sorted(RESULT_KEYS + ["stage"]))]),
    ("unknown test_id", 404, ["error"]),
    ("features missing keys", 400, ["error"]),
    ("deadline_s 0", 400, ["error"]),
    ("not JSON", 400, ["error"]),
    ("empty reload", 400, ["error"]),
    ("unknown POST path", 404, ["error"]),
    ("unknown GET path", 404, ["error"]),
    ("stopped batcher", 500, ["error"]),
]


def _features(n_sec, seed):
    r = np.random.default_rng(seed)
    return {"semantic": r.standard_normal((n_sec, 768)).tolist(),
            "emotion": r.uniform(size=(n_sec, 6)).tolist(),
            "scene_offset": list(range(n_sec)),
            "motion": r.standard_normal((n_sec,)).tolist()}


def _serve(mod, app):
    server = mod.make_server(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _call(server, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                      timeout=600)
    data = body if isinstance(body, (bytes, type(None))) else \
        json.dumps(body).encode()
    conn.request(method, path, body=data)
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    return resp.status, raw


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_serve_http_api_matches_jax_app(kind, tree768, tmp_path):
    """Each request of TRANSCRIPT through one app, one at a time
    (max_batch 1): the JAX app gives TRANSCRIPT, and so must the port's,
    whose chords are its own generate_batch's on the same request."""
    if kind == "jax":
        mod, v2m = jserve, JaxVideo2music(**KW)
        _, _, test_ds = jax_datasets(tree768)
    else:
        mod, v2m = pserve, Video2music(device="cpu", **KW)
        _, _, test_ds = create_vevo_datasets(tree768)
    app = mod.ServeApp(v2m=v2m, test_ds=test_ds, max_batch=1, max_wait_ms=1,
                       output_dir=str(tmp_path / "serve"))
    server = _serve(mod, app)
    feats = _features(6, 3)
    bodies = {
        "test_id": dict(test_id="bbb", primer="C Am", key="C major"),
        "features": dict(features=feats, temperature=0.9),
        "stream": dict(test_id="ccc", stream=True),
        "unknown test_id": dict(test_id="zzz"),
        "features missing keys": dict(features={"semantic": [[0.0]]}),
        "deadline_s 0": dict(test_id="aaa", deadline_s=0),
        "not JSON": b"{not json",
        "empty reload": {},
        "unknown POST path": {},
        "stopped batcher": dict(test_id="aaa"),
    }
    paths = {"healthz": ("GET", "/healthz"), "empty reload": ("POST",
                                                              "/reload"),
             "unknown POST path": ("POST", "/elsewhere"),
             "unknown GET path": ("GET", "/elsewhere")}
    answers = {}
    try:
        for name, status, keys in TRANSCRIPT:
            if name == "stopped batcher":
                app.stop()
            method, path = paths.get(name, ("POST", "/generate"))
            code, raw = _call(server, method, path, bodies.get(name))
            if name == "stream":
                lines = [json.loads(x) for x in raw.splitlines() if x]
                got = [(x["stage"], sorted(x)) for x in lines]
                answers[name] = lines[-1]
            else:
                got = sorted(json.loads(raw))
                answers[name] = json.loads(raw)
            assert (code, got) == (status, keys), name
    finally:
        server.shutdown()
        app.stop()
    assert answers["test_id"]["batch_width"] == 1
    if kind == "jax":
        return
    # the port app's chords are generate_batch's on the same requests
    sample = test_ds[test_ds.ids.index("bbb")]
    sfeats = {k: sample[k] for k in ("semantic", "emotion", "scene_offset",
                                     "motion")}
    for name, req, temp in (
            ("test_id", dict(features=sfeats, primer="C Am", key="C major"),
             1.0),
            ("features", dict(features={k: np.asarray(v, np.float32)
                                        for k, v in feats.items()}), 0.9)):
        (want,) = v2m.generate_batch([req], temperature=[temp],
                                     output_dir=str(tmp_path / name))
        assert answers[name]["chords"] == want.chords, name


class _HeldPipeline:
    """A stand-in pipeline whose decode waits for ``release``: drives the
    HTTP layer's load shedding and deadlines alike in both apps."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()

    def generate_batch(self, requests, *, n_real, defer_render=False, **kw):
        from types import SimpleNamespace
        self.entered.set()
        self.release.wait(60)
        res = [SimpleNamespace(chords=["C"], key="C major", midi_path=None,
                               audio_path=None, video_path=None)] * n_real
        return (lambda: res) if defer_render else res


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_serve_sheds_load_and_expires_deadlines_as_jax_app(kind):
    """A full queue answers 503, a request whose decode could not start
    within deadline_s 504, in both apps."""
    mod = jserve if kind == "jax" else pserve
    pipe = _HeldPipeline()
    app = mod.ServeApp(v2m=pipe, test_ds=object(), max_batch=1,
                       max_wait_ms=1, max_queue=1)
    server = _serve(mod, app)
    body = dict(features=_features(2, 0))
    got = {}

    def post(name, b):
        got[name] = _call(server, "POST", "/generate", b)[0]

    try:
        first = threading.Thread(target=post, args=("held", body))
        first.start()
        assert pipe.entered.wait(60)
        queued = threading.Thread(target=post, args=(
            "deadline", dict(body, deadline_s=0.05)))
        queued.start()
        while app.batcher._q.qsize() < 1:
            threading.Event().wait(0.01)
        post("full", body)
        threading.Event().wait(0.2)
        pipe.release.set()
        first.join(60)
        queued.join(60)
    finally:
        pipe.release.set()
        server.shutdown()
        app.stop()
    assert got == {"full": 503, "held": 200, "deadline": 504}


# ---------------------------------------------------------------------------
# generate / demo
# ---------------------------------------------------------------------------

def _tiny_v2m(**kw):
    return Video2music(**dict(kw, amt_overrides=KW["amt_overrides"],
                              reg_overrides=KW["reg_overrides"]))


def test_generate_cli_writes_video2music_chords(tree768, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(pgenerate, "Video2music", _tiny_v2m)
    out = str(tmp_path / "out")
    result = pgenerate.main(["-dataset_dir", tree768, "-test_id", "ccc",
                             "-motion_type", "0", "-output_dir", out,
                             "-seed", "3", "-device", "cpu"])
    with open(os.path.join(out, "output.lab")) as f:
        lab = [line.split(" ", 1)[1].strip() for line in f]
    _, _, test_ds = create_vevo_datasets(tree768)
    sample = test_ds[test_ds.ids.index("ccc")]
    inv = chord_inv_dict()
    n = min(30, int((sample["chord"] != C.CHORD_PAD).sum()))
    primer = " ".join(inv[int(c)].replace(":min", "m").replace(":", "")
                      for c in sample["chord"][:n] if int(c) < C.CHORD_END)
    want = _tiny_v2m(device="cpu", music_gen_version="2.2",
                     reg_model="bimamba+", motion_type=0).generate(
        primer=primer, features={k: sample[k] for k in (
            "semantic", "emotion", "scene_offset", "motion")},
        output_dir=str(tmp_path / "want"), seed=3)
    assert lab == want.chords == result.chords
    assert os.path.getsize(result.midi_path) > 0


def test_demo_page_carries_the_chords(tree768, tmp_path):
    _, _, test_ds = create_vevo_datasets(tree768)
    v2m = Video2music(device="cpu", **KW)
    app = pdemo.DemoApp(v2m=v2m, test_ds=test_ds,
                        output_dir=str(tmp_path / "demo"))
    assert '<option value="ddd">' in app.index_html()
    page = app.generate({"test_id": ["ddd"], "primer": ["C G"],
                         "key": ["C major"], "temperature": ["1.0"]})
    want = v2m.generate(primer="C G", key="C major", features={
        k: test_ds[3][k] for k in ("semantic", "emotion", "scene_offset",
                                   "motion")},
        output_dir=str(tmp_path / "want"))
    assert " ".join(want.chords[:64]) in page
    assert app.file_bytes("run_001/output.mid") is not None
    assert app.file_bytes("../x") is None


# ---------------------------------------------------------------------------
# extract_features
# ---------------------------------------------------------------------------

def _params_file(path, params):
    np.save(path, jax.tree_util.tree_map(np.asarray, params),
            allow_pickle=True)
    return path


def _tiny_extractors(monkeypatch):
    """Both CLIs' extractor configs (and the JAX CLI's host preprocessing
    size) at the video tests' tiny widths."""
    for mod, name, cfg in ((jclip, "clip_vit_l14_336_config", JCFG),
                           (pclip, "clip_vit_l14_336_config", PCFG),
                           (jmaxvit, "maxvit_t_config", JMCFG),
                           (pmaxvit, "maxvit_t_config", PMCFG)):
        monkeypatch.setattr(mod, name, lambda cfg=cfg: cfg)
    monkeypatch.setattr(jclip, "preprocess_frames", functools.partial(
        jclip.preprocess_frames, image_size=56))
    monkeypatch.setattr(jmaxvit, "preprocess_diff_frames", functools.partial(
        jmaxvit.preprocess_diff_frames, image_size=56))


def _run_both(sub, flags, tmp_path, port_flags=()):
    for tag, mod, extra in (("jax", jextract, []),
                            ("port", pextract, list(port_flags))):
        mod.main([sub] + flags + ["-out_dir", str(tmp_path / tag / sub)]
                 + extra)
    return tmp_path / "jax" / sub, tmp_path / "port" / sub


def _lab_values(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], np.asarray([[float(v) for v in line.split()[1:]]
                                 for line in lines[1:]])


def test_extract_features_network_subcommands_match_jax(extractors,
                                                        tmp_path,
                                                        monkeypatch):
    """semantic, emotion and motion -motion_type 1 on a two-scene clip:
    the port's files to the video tests' tolerance (the emotion .lab's
    four decimals to one unit of the last); the weight files are the JAX
    CLI's pickled params, and a torch.save'd state dict serves alike."""
    clip_params, mv_params, text, _ = extractors
    _tiny_extractors(monkeypatch)
    vids = tmp_path / "videos"
    vids.mkdir()
    _write_clip(str(vids / "v1.mp4"), seconds=6, n_scenes=2)
    cp = _params_file(str(tmp_path / "clip.npy"), clip_params)
    mp = _params_file(str(tmp_path / "maxvit.npy"), mv_params)
    np.save(tmp_path / "text.npy", text)
    dev = ["-device", "cpu"]
    v = ["-video_dir", str(vids)]
    j, p = _run_both("semantic", v + ["-clip_params", cp], tmp_path, dev)
    want = np.load(j / "v1.npy")
    np.testing.assert_allclose(np.load(p / "v1.npy"), want, rtol=RTOL,
                               atol=ATOL)
    assert want.shape == (6, 768)
    j, p = _run_both("emotion", v + ["-clip_params", cp, "-text_embeds",
                                     str(tmp_path / "text.npy")],
                     tmp_path, dev)
    (gh, got), (wh, wanted) = _lab_values(p / "v1.lab"), \
        _lab_values(j / "v1.lab")
    assert gh == wh and got.shape == wanted.shape == (6, 6)
    np.testing.assert_allclose(got, wanted, rtol=0, atol=1.01e-4)
    j, p = _run_both("motion", v + ["-motion_type", "1", "-maxvit_params",
                                    mp], tmp_path, dev)
    np.testing.assert_allclose(np.load(p / "v1.npy"), np.load(j / "v1.npy"),
                               rtol=RTOL, atol=ATOL)
    # a torch.save'd state dict of the port's CLIP gives the same features
    sd = str(tmp_path / "clip.pt")
    torch.save(pextract.load_state(cp, clip_from_jax), sd)
    pextract.main(["semantic"] + v + ["-clip_params", sd, "-out_dir",
                                      str(tmp_path / "sd")] + dev)
    semantic = np.load(p.parent / "semantic" / "v1.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "sd" / "v1.npy"),
                                  semantic)
    # the files equal the port's Video2music.extract_features of the clip
    # (float32 extractors, the PIL resize), as the card's CLIs phase holds
    # them; the scene offsets too
    pextract.main(["scene"] + v + ["-out_dir", str(tmp_path / "scene"),
                                   "-offset_dir", str(tmp_path / "off")])
    ref = Video2music(
        device="cpu", motion_type=1, clip_cfg=PCFG, maxvit_cfg=PMCFG,
        extractor_dtype="float32", resize_backend="pil",
        clip_params=clip_from_jax(clip_params),
        maxvit_params=maxvit_from_jax(mv_params), emotion_text_embeds=text)
    want = ref.extract_features(str(vids / "v1.mp4"))
    np.testing.assert_allclose(semantic, want["semantic"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, want["emotion"], rtol=0, atol=1.01e-4)
    np.testing.assert_allclose(np.load(p / "v1.npy"), want["motion"],
                               rtol=RTOL, atol=ATOL)
    with open(tmp_path / "off" / "v1.lab") as f:
        offsets = [int(line.split()[1]) for line in f]
    assert offsets == (want["scene_offset"] - 1).astype(int).tolist()


def _write_wav(path, seconds, rate=8000):
    t = np.arange(int(seconds * rate)) / rate
    x = (8000 * np.sin(2 * np.pi * 220 * t) * np.linspace(0, 1, t.size))
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.repeat(x.astype(np.int16), 2).tobytes())


def test_extract_features_numpy_subcommands_write_jax_files(tmp_path):
    vids = tmp_path / "videos"
    vids.mkdir()
    _write_clip(str(vids / "v1.mp4"), seconds=8, n_scenes=3)
    wavs, mids, probs = (tmp_path / d for d in ("wav", "mid", "prob"))
    for d in (wavs, mids, probs):
        d.mkdir()
    _write_wav(str(wavs / "a.wav"), 2.5)
    midi = MIDIFile(1)
    midi.addTempo(0, 0, 100)
    for i in range(12):
        midi.addNote(0, 0, 50 + i, 0.4 * i, 1.1, 90)
    with open(mids / "a.mid", "wb") as f:
        midi.writeFile(f)
    r = np.random.default_rng(0)
    with open(probs / "a.csv", "w") as f:
        f.write("i0,i1,i2\n" + "\n".join(
            ",".join(f"{v:.3f}" for v in row)
            for row in r.uniform(0, 0.3, (5, 3))) + "\n")
    runs = [("scene", ["-video_dir", str(vids)]),
            ("motion", ["-video_dir", str(vids), "-motion_type", "0"]),
            ("loudness", ["-wav_dir", str(wavs)]),
            ("note_density", ["-midi_dir", str(mids)]),
            ("threshold_instrument", ["-prob_dir", str(probs)])]
    for sub, flags in runs:
        j, p = _run_both(sub, flags, tmp_path)
        names = sorted(os.listdir(j))
        assert names and sorted(os.listdir(p)) == names, sub
        for name in names:
            assert (p / name).read_bytes() == (j / name).read_bytes(), \
                (sub, name)


# ---------------------------------------------------------------------------
# the framework-free CLIs run as the JAX package's
# ---------------------------------------------------------------------------

def test_analyze_cli_writes_jax_files(tree, tmp_path):
    from video2music_tpu.cli import analyze as janalyze
    from video2music_tpu_torch.cli import analyze as panalyze
    for sub, names in (("chord_weight", ["chord_count.npy",
                                         "chord_weight.npy"]),
                       ("emotion_chord", ["emotion_chord.json"])):
        for tag, mod in (("jax", janalyze), ("port", panalyze)):
            mod.main([sub, "-dataset_dir", tree, "-out_dir",
                      str(tmp_path / tag)])
        for name in names:
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name


def test_key_detection_matches_jax(tmp_path):
    """The sklearn key classifier on a separable synthetic emotion -> key
    set: the same metrics from both packages' runs."""
    from video2music_tpu.cli import key_detection as jkey
    from video2music_tpu_torch.cli import key_detection as pkey
    from sklearn.naive_bayes import GaussianNB

    def split(n, seed):
        r = np.random.default_rng(seed)
        out = []
        for _ in range(n):
            key_val = float(r.integers(0, 3))
            emo = r.uniform(size=(20, 6)).astype(np.float32)
            emo[:, int(key_val)] += 2.0
            out.append({"emotion": emo, "key_val": np.asarray([key_val])})
        return out

    results = {}
    for tag, mod in (("jax", jkey), ("port", pkey)):
        results[tag] = mod.run_key_detection(
            split(30, 0), split(10, 1), split(10, 2),
            model_dir=str(tmp_path / tag),
            results_path=str(tmp_path / f"{tag}.json"),
            models={"GaussianNB": GaussianNB()}, log=lambda *a: None)
    assert results["port"] == results["jax"]
    assert results["port"]["GaussianNB"]["Acc"] > 0.8
    assert os.path.exists(tmp_path / "port" / "GaussianNB.pkl")


# ---------------------------------------------------------------------------
# flags and the device contract
# ---------------------------------------------------------------------------

def _parser_defaults(parser):
    out = {}
    for a in parser._actions:
        if a.dest in ("help", "device"):
            continue
        if hasattr(a, "choices") and isinstance(a.choices, dict):
            for name, sub in a.choices.items():
                out[name] = _parser_defaults(sub)
        else:
            out[a.dest] = (a.option_strings, a.default, a.choices, a.type,
                           a.required)
    return out


@pytest.mark.parametrize("pair", [(jtrain_amt, ptrain_amt),
                                  (jtrain_reg, ptrain_reg),
                                  (jextract, pextract)],
                         ids=["train_amt", "train_regression",
                              "extract_features"])
def test_cli_flags_equal_jax(pair):
    """Every flag of the JAX CLI, with its default, choices and type, and
    ``-device`` besides (default cuda)."""
    jmod, pmod = pair
    assert _parser_defaults(pmod.build_parser()) == \
        _parser_defaults(jmod.build_parser())
    actions = [a for a in pmod.build_parser()._actions
               if a.dest == "device"]
    if pmod is pextract:
        sub = next(a for a in pmod.build_parser()._actions
                   if isinstance(a.choices, dict)).choices
        actions = [a for name in ("semantic", "emotion", "motion")
                   for a in sub[name]._actions if a.dest == "device"]
    assert actions and all(a.default == "cuda" for a in actions)


DEVICE_CASES = {
    "train_amt": (ptrain_amt, ["-dataset_dir", "x"]),
    "train_regression": (ptrain_reg, ["-dataset_dir", "x"]),
    "evaluate": (peval, ["-model_weights", "x"]),
    "evaluate_regression": (peval_reg, ["-model_weights", "x"]),
    "generate": (pgenerate, []),
    "serve": (pserve, []),
    "demo": (pdemo, []),
    "extract_semantic": (pextract, ["semantic", "-video_dir", "x",
                                    "-out_dir", "y", "-clip_params", "z"]),
    "extract_emotion": (pextract, ["emotion", "-video_dir", "x", "-out_dir",
                                   "y", "-clip_params", "z",
                                   "-text_embeds", "t"]),
    "extract_motion": (pextract, ["motion", "-video_dir", "x", "-out_dir",
                                  "y", "-motion_type", "1",
                                  "-maxvit_params", "z"]),
}


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_cli_device_cuda_raises_without_cuda(case, monkeypatch, tmp_path):
    """-device cuda (the default, and given) raises without CUDA, before
    any file is read: no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod, argv = DEVICE_CASES[case]
    for extra in ([], ["-device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv + extra)
    assert os.listdir(tmp_path) == []
