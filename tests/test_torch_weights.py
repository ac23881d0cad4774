"""The published weight layouts into the port, on the CPU in f32, with
random weights in those layouts (the real files are not in the
repository): ``focal_loss`` against the JAX function; ``convert_hf_clip``
on a small ``transformers`` CLIPModel against HF's forward and the JAX
converter; ``convert_torchvision_maxvit`` on a small
tools/torch_maxvit_mirror.py model against the mirror and the JAX
converter; the reference's V1 / V2 / V3 state dicts through
train/convert.py and ``weights.amt_from_jax`` against the JAX model on the
JAX converter's tree; and the three ``cli/convert_*`` entry points end to
end with ``-device cpu``."""

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import reference_state_dict
from tests.test_convert import _synthetic_v1_sd
from tools.torch_maxvit_mirror import MaxVit as MirrorMaxVit
from tools.torch_maxvit_mirror import feature_extractor, maxvit_t_mirror
from video2music_tpu.core.config import amt_config as jax_amt_config
from video2music_tpu.features import clip as jax_clip
from video2music_tpu.features import maxvit as jax_maxvit
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.ops.losses import focal_loss as jax_focal_loss
from video2music_tpu.train import convert as jax_convert
from video2music_tpu_torch.cli import (convert_clip, convert_maxvit,
                                       convert_reference_checkpoint)
from video2music_tpu_torch.core import constants as C
from video2music_tpu_torch.core.config import amt_config
from video2music_tpu_torch.features.clip import (CLIP, CLIPConfig,
                                                 CLIPTextConfig,
                                                 CLIPVisionConfig,
                                                 convert_hf_clip)
from video2music_tpu_torch.features.maxvit import (MaxViT, MaxViTConfig,
                                                   convert_torchvision_maxvit)
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.ops.losses import focal_loss
from video2music_tpu_torch.pipeline.api import Video2music
from video2music_tpu_torch.train import convert as port_convert
from video2music_tpu_torch.train.checkpoint import load_weights
from video2music_tpu_torch.weights import (amt_from_jax, clip_from_jax,
                                           maxvit_from_jax,
                                           regression_from_jax)

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5  # f32, another summation order only


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _same_state(got, want):
    """Key for key, bit for bit."""
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))[:6]
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


# ---------------------------------------------------------------------------
# (a) focal_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gamma,weight", [(2.0, 0.1), (0.5, 1.0)])
def test_focal_loss_matches_jax(gamma, weight):
    """f32, rtol 1e-6; a third of the rows carry ignore_index."""
    r = np.random.default_rng(0)
    V, pad = C.CHORD_SIZE, C.CHORD_PAD
    logits = (3 * r.standard_normal((4, 9, V))).astype(np.float32)
    tgt = r.integers(0, V, (4, 9))
    tgt[r.uniform(size=tgt.shape) < 1 / 3] = pad
    kw = dict(vocab_size=V, ignore_index=pad, gamma=gamma, weight=weight)
    want = jax_focal_loss(jnp.asarray(logits), jnp.asarray(tgt), **kw)
    got = focal_loss(torch.from_numpy(logits), torch.from_numpy(tgt), **kw)
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# (b) convert_hf_clip
# ---------------------------------------------------------------------------

EOT = 98  # the largest id, as OpenAI's EOT (49407) is


def _hf_clip_config():
    """tests/test_clip.py's small config."""
    from transformers import CLIPConfig as HFCLIPConfig

    return HFCLIPConfig(
        text_config={"hidden_size": 32, "intermediate_size": 128,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "vocab_size": 99, "max_position_embeddings": 16,
                     "hidden_act": "quick_gelu", "eos_token_id": EOT},
        vision_config={"hidden_size": 48, "intermediate_size": 192,
                       "num_hidden_layers": 2, "num_attention_heads": 2,
                       "image_size": 32, "patch_size": 8,
                       "hidden_act": "quick_gelu"},
        projection_dim=24)


CLIP_CFG = CLIPConfig(
    vision=CLIPVisionConfig(hidden_size=48, layers=2, heads=2, patch_size=8,
                            image_size=32, projection_dim=24),
    text=CLIPTextConfig(hidden_size=32, layers=2, heads=2, vocab_size=99,
                        context_length=16, projection_dim=24))


@pytest.fixture(scope="module")
def clip_pair():
    from transformers import CLIPModel

    torch.manual_seed(0)
    hf = CLIPModel(_hf_clip_config()).eval()
    model = CLIP(CLIP_CFG).eval()
    model.load_state_dict(convert_hf_clip(hf.state_dict(), CLIP_CFG))
    return hf, model


def test_convert_hf_clip_towers_match_hf(clip_pair):
    """The image and text towers against HF's forward, rtol 2e-4."""
    hf, model = clip_pair
    r = np.random.default_rng(0)
    pixels = torch.from_numpy(r.standard_normal((3, 32, 32, 3)).astype(
        np.float32))
    ids = torch.from_numpy(r.integers(1, 90, (4, 16)))
    ids[:, -1] = EOT
    with torch.no_grad():
        _close(model.encode_image(pixels),
               hf.get_image_features(pixels.permute(0, 3, 1, 2)))
        _close(model.encode_text(ids), hf.get_text_features(ids))


def test_convert_hf_clip_is_the_jax_conversion_bridged(clip_pair):
    """Key for key and bit for bit weights.clip_from_jax of the JAX
    converter's tree, from torch tensors and from numpy arrays."""
    hf, _ = clip_pair
    sd = hf.state_dict()
    want = clip_from_jax(jax_clip.convert_hf_clip(sd, CLIP_CFG))
    _same_state(convert_hf_clip(sd, CLIP_CFG), want)
    _same_state(convert_hf_clip({k: v.numpy() for k, v in sd.items()},
                                CLIP_CFG), want)


def test_convert_hf_clip_emotion_probs_match_jax(clip_pair):
    """Zero-shot emotion probabilities against the JAX CLIP on the JAX
    converter's params, rtol 2e-4."""
    hf, model = clip_pair
    r = np.random.default_rng(3)
    pixels = r.standard_normal((5, 32, 32, 3)).astype(np.float32)
    text = r.standard_normal((6, 24)).astype(np.float32)
    jm = jax_clip.CLIP(cfg=jax_clip.CLIPConfig(
        vision=jax_clip.CLIPVisionConfig(**vars(CLIP_CFG.vision)),
        text=jax_clip.CLIPTextConfig(**vars(CLIP_CFG.text))))
    params = jax_clip.convert_hf_clip(hf.state_dict(), CLIP_CFG)
    want = jm.apply({"params": params}, jnp.asarray(pixels),
                    jnp.asarray(text), method=jm.emotion_probs)
    with torch.no_grad():
        got = model.emotion_probs(torch.from_numpy(pixels),
                                  torch.from_numpy(text))
    _close(got, want)


# ---------------------------------------------------------------------------
# (c) convert_torchvision_maxvit
# ---------------------------------------------------------------------------

def _randomize_(mirror):
    """Random weights and BatchNorm statistics, as tests/test_features.py
    gives its mirror."""
    with torch.no_grad():
        for p in mirror.parameters():
            p.copy_(torch.randn_like(p) * 0.2)
        for name, b in mirror.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn_like(b) * 0.2)
            elif name.endswith("running_var"):
                b.copy_(torch.rand_like(b) + 0.5)
    return mirror


def test_convert_torchvision_maxvit_matches_mirror():
    """A small mirror covering every structural case (stride-2 MBConv with
    a channel change, a stride-1 identity MBConv, window and grid
    attention at g > 1 and g == 1): the port's features against the
    mirror's, rtol 1e-4 / atol 1e-4 (tests/test_features.py's bound for
    the JAX module), and its state dict bit for bit
    weights.maxvit_from_jax of the JAX converter's tree."""
    torch.manual_seed(0)
    mirror = _randomize_(feature_extractor(MirrorMaxVit(
        input_size=(16, 16), stem_channels=8, partition_size=2,
        block_channels=(8, 16), block_layers=(2, 1), head_dim=4)).eval())
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = mirror(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    kw = dict(channels=(8, 16), depths=(2, 1), stem_channels=8, partition=2,
              head_dim=4, image_size=16)
    sd = mirror.state_dict()
    state = convert_torchvision_maxvit(sd, MaxViTConfig(**kw))
    _same_state(state, maxvit_from_jax(jax_maxvit.convert_torchvision_maxvit(
        sd, jax_maxvit.MaxViTConfig(**kw))))
    model = MaxViT(MaxViTConfig(**kw)).eval()
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# (d) the reference's AMT state dicts, V1 / V2 / V3
# ---------------------------------------------------------------------------

D, FF, HEADS, N_LAYERS, E, VF, L = 16, 32, 2, 4, 6, 11, 12


def _reference_sd(rng, version):
    """A reference-named state dict: tests/test_convert.py's V1 trees, and
    chip_smoke.py's builder for V2 / V3 (the one the card's
    published-layouts phase serves at full width)."""
    if version.startswith("1."):
        return _synthetic_v1_sd(rng, version, D, FF, HEADS, N_LAYERS, E, VF)
    return reference_state_dict("amt_v3" if version.startswith("3.")
                                else "amt_v2", 7, d=D, ff=FF, heads=HEADS,
                                n=N_LAYERS, E=E, vf=VF)


def _convert(module, sd, version):
    """(params, moe_state) of ``module``'s converters (the JAX package's
    train/convert.py or the port's copy)."""
    kw = dict(n_layers=N_LAYERS, n_experts=E)
    if version.startswith("1."):
        return module.convert_reference_amt_v1(sd, version, **kw), None
    if version.startswith("2."):
        return (module.convert_reference_amt_v2(sd, **kw),
                module.convert_reference_moe_state(sd, N_LAYERS))
    return (module.convert_reference_amt_v3(sd, version, **kw),
            module.convert_reference_moe_state(sd, N_LAYERS))


@pytest.mark.parametrize("version", ["1.0", "1.1", "2.2", "3.1"])
def test_reference_amt_state_dicts_load_through_convert(version):
    """convert_reference_amt_v1 (1.0, 1.1), _v2 with
    convert_reference_moe_state (2.2) and _v3 with it (3.1, the balancing
    biases) -> weights.amt_from_jax -> the port's model: the same logits
    as the JAX model on the JAX converter's tree, rtol 2e-4."""
    r = np.random.default_rng(7)
    sd = _reference_sd(r, version)
    kw = dict(n_layers=N_LAYERS, num_heads=HEADS, d_model=D, d_ff=FF,
              dropout=0.0, max_seq_video=L, max_seq_chord=L,
              total_vf_dim=VF)
    params, moe_state = _convert(port_convert, sd, version)
    model = VideoMusicTransformer(amt_config(version, **kw)).eval()
    model.load_state_dict(amt_from_jax(params, moe_state))
    jparams, jmoe = _convert(jax_convert, sd, version)
    if version == "3.1":  # the balancing biases reach the model
        assert jmoe and sum(len(v) for v in jmoe.values()) == 2 * (
            N_LAYERS - min(3, N_LAYERS - 1))
    args = [r.integers(0, C.CHORD_END, (2, L)), r.integers(0, 13, (2, L)),
            r.integers(0, 14, (2, L)),
            r.standard_normal((2, L, VF - 4)).astype(np.float32),
            r.integers(0, 2, (2, 1)).astype(np.float32),
            r.integers(0, 5, (2, L)).astype(np.float32),
            r.standard_normal((2, L)).astype(np.float32),
            r.uniform(size=(2, L, 2)).astype(np.float32)]
    variables = {"params": jparams}
    if jmoe:
        variables["moe_state"] = jmoe
    want, _ = JaxAMT(cfg=jax_amt_config(version, **kw)).apply(
        variables, *(jnp.asarray(a) for a in args),
        mutable=["metrics", "moe_state"])
    with torch.no_grad():
        got = model(*(torch.as_tensor(a) for a in args))
    _close(got, want)


# ---------------------------------------------------------------------------
# (e) the three convert CLIs, -device cpu
# ---------------------------------------------------------------------------

PIPE = dict(music_gen_version="2.2", reg_model="bimamba+", motion_type=0,
            amt_overrides=dict(n_layers=2, num_heads=2, d_model=16, d_ff=32),
            reg_overrides=dict(n_layers=1, d_model=8, d_hidden=16),
            device="cpu")


def _features(n_sec, seed):
    r = np.random.default_rng(seed)
    return {"semantic": r.standard_normal((n_sec, 768)).astype(np.float32),
            "emotion": r.uniform(size=(n_sec, 6)).astype(np.float32),
            "scene_offset": np.arange(n_sec, dtype=np.float32),
            "motion": r.standard_normal((n_sec,)).astype(np.float32)}


def test_convert_reference_checkpoint_cli_serves(tmp_path):
    """A tiny 2.2 reference pickle through the converter CLI (-device cpu,
    --kind amt_v2): Video2music(amt_checkpoint=out) answers as a
    Video2music given the in-memory conversion, token for token."""
    sd = reference_state_dict("amt_v2", 3, d=16, ff=32, heads=2, n=2,
                              vf=776)
    pickle = tmp_path / "best_loss_weights.pickle"
    torch.save(sd, pickle)
    out = str(tmp_path / "weights" / "best_loss_weights")
    convert_reference_checkpoint.main([
        "--weights", str(pickle), "--kind", "amt_v2", "--n_layers", "2",
        "--out", out, "-device", "cpu"])
    assert set(load_weights(out, "VideoMusicTransformer")) == set(
        VideoMusicTransformer(amt_config("2.2", **PIPE["amt_overrides"]))
        .state_dict())
    served = Video2music(amt_checkpoint=out, **PIPE)
    want = Video2music(**PIPE)
    want.load_state_dicts(amt_from_jax(
        port_convert.convert_reference_amt_v2(sd, n_layers=2),
        port_convert.convert_reference_moe_state(sd, n_layers=2)))
    kw = dict(features=_features(12, 5), primer="C Am", seed=2)
    got = served.generate(output_dir=str(tmp_path / "served"), **kw)
    ref = want.generate(output_dir=str(tmp_path / "memory"), **kw)
    np.testing.assert_array_equal(got.chord_ids, ref.chord_ids)


@pytest.mark.parametrize("kind", ["amt", "regression"])
def test_convert_reference_checkpoint_cli_kinds(tmp_path, kind):
    """--kind amt (the base AMT) and --kind regression (the reference's
    bilstm, tests/test_convert.py's mirror): the checkpoint holds the
    in-memory conversion bit for bit, under the config the weights' shapes
    give (heads from the RPR table, depth from the LSTM's layers)."""
    from tests.test_convert import _TorchReg

    torch.manual_seed(4)
    if kind == "amt":
        sd = reference_state_dict("amt", 4, d=16, ff=32, heads=2, n=2,
                                  vf=776)
        want = amt_from_jax(port_convert.convert_reference_amt(sd, 2))
        cfg = dict(version=None, d_model=16, num_heads=2, d_ff=32,
                   n_layers=2, max_seq_chord=300, total_vf_dim=776)
    else:
        sd = _TorchReg(774, 8).state_dict()
        want = regression_from_jax(
            port_convert.convert_reference_regression(sd, "bilstm"))
        cfg = dict(reg_model="bilstm", n_layers=2, d_model=8,
                   total_vf_dim=774)
    torch.save(sd, tmp_path / "w.pickle")
    out = str(tmp_path / "ckpt")
    convert_reference_checkpoint.main([
        "--weights", str(tmp_path / "w.pickle"), "--kind", kind,
        "--n_layers", "2", "--out", out, "-device", "cpu"])
    tree = torch.load(out, weights_only=True)
    _same_state(tree["model"], want)
    assert {k: tree["config"][k] for k in cfg} == cfg


def _tiny_tokenizer_files(d):
    """vocab.json / merges.txt of a letter-level CLIP BPE: every letter
    alone and word-final, <|startoftext|> 97 and <|endoftext|> 98 (the
    largest id, where both poolings land)."""
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    vocab = {t: i for i, t in enumerate(letters + [c + "</w>"
                                                   for c in letters])}
    vocab.update({"<|startoftext|>": 97, "<|endoftext|>": EOT})
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")


def test_convert_clip_cli(tmp_path, clip_pair):
    """A small HF checkpoint directory (save_pretrained, a letter-level
    tokenizer) through the CLI: the state dict is convert_hf_clip's, the
    text embeddings HF's get_text_features of the six prompts; a missing
    directory raises."""
    from transformers import CLIPTokenizer

    hf, _ = clip_pair
    model_dir = tmp_path / "clip"
    model_dir.mkdir()
    _tiny_tokenizer_files(model_dir)
    tok = CLIPTokenizer(str(model_dir / "vocab.json"),
                        str(model_dir / "merges.txt"))
    tok.save_pretrained(str(model_dir))
    hf.save_pretrained(str(model_dir))
    out = tmp_path / "out" / "clip.pt"
    convert_clip.main(["--model", str(model_dir), "--out", str(out),
                       "-device", "cpu"])
    _same_state(torch.load(out, weights_only=True),
                convert_hf_clip(hf.state_dict(), CLIP_CFG))
    ids = tok(list(jax_clip.EMOTION_PROMPTS), padding=True,
              return_tensors="pt")
    with torch.no_grad():
        want = hf.get_text_features(**ids).numpy()
    got = np.load(tmp_path / "out" / "clip_text_embeds.npy")
    assert got.shape == (6, 24)
    _close(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(FileNotFoundError, match="local checkpoint"):
        convert_clip.main(["--model", str(tmp_path / "absent"), "--out",
                           str(out), "-device", "cpu"])


def test_convert_maxvit_cli(tmp_path, monkeypatch):
    """Without torchvision (both machines) the CLI raises saying so; with
    tools/torch_maxvit_mirror.py standing in for torchvision's maxvit_t, a
    full-size MaxViT-T weights file converts to
    convert_torchvision_maxvit's state dict (the CLI's own check against
    the mirror's features passing); a missing file raises."""
    torch.manual_seed(1)
    weights = tmp_path / "maxvit_t.pth"
    sd = _randomize_(maxvit_t_mirror()).state_dict()
    torch.save(sd, weights)
    out = tmp_path / "maxvit.pt"
    argv = ["--model", str(weights), "--out", str(out), "-device", "cpu"]
    monkeypatch.setitem(sys.modules, "torchvision", None)
    with pytest.raises(RuntimeError, match="torchvision is not installed"):
        convert_maxvit.main(argv)
    tv = types.ModuleType("torchvision")
    tv.models = types.ModuleType("torchvision.models")
    tv.models.maxvit_t = maxvit_t_mirror
    monkeypatch.setitem(sys.modules, "torchvision", tv)
    monkeypatch.setitem(sys.modules, "torchvision.models", tv.models)
    convert_maxvit.main(argv)
    _same_state(torch.load(out, weights_only=True),
                convert_torchvision_maxvit(sd))
    with pytest.raises(FileNotFoundError, match="local weights file"):
        convert_maxvit.main(["--model", str(tmp_path / "absent.pth"),
                             "--out", str(out), "-device", "cpu"])
