"""The port's RNN, CNN-GRU and minGRU regression backbones against the JAX
package (CPU, f32): the seven backbones through ``VideoRegression`` on
bridged weights, the scans (``gru_scan``, ``lstm_scan``,
``heinsen_log_scan``) against the JAX functions, the cuDNN-backed
``RNNStack`` against the plain cell loops, the minGRU parts (``MinGRU``
with a previous hidden state, ``MinGRULM`` with the causal conv), and
``Video2music`` ``generate`` with the default ``bilstm`` and ``mingru``
regressions token for token and byte for byte against the JAX pipeline."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video2music_tpu.core import constants as C
from video2music_tpu.core.config import RegressionConfig
from video2music_tpu.models.mingru import MinGRU as JaxMinGRU
from video2music_tpu.models.mingru import MinGRULM as JaxMinGRULM
from video2music_tpu.models.regression import VideoRegression as JaxRegression
from video2music_tpu.ops import scan as jscan
from video2music_tpu.pipeline import Video2music as JaxVideo2music
from video2music_tpu_torch.models.mingru import MinGRU, MinGRULM
from video2music_tpu_torch.models.regression import VideoRegression
from video2music_tpu_torch.models.rnn import RNNStack
from video2music_tpu_torch.ops import scan
from video2music_tpu_torch.pipeline import Video2music
from video2music_tpu_torch.weights import (amt_from_jax, init_weights_,
                                           regression_from_jax)

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5  # f32, sums taken in another order
NEW = ["bilstm", "bigru", "lstm", "gru", "cnngru", "cnnbigru", "mingru"]
T = 300


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("reg_model", NEW)
def test_new_backbone_matches_jax(reg_model):
    """B=2, L=20, d_model 16, 2 layers (a bidirectional RNN's heads take
    2 d_model), through regression_from_jax."""
    rng = np.random.default_rng(NEW.index(reg_model))
    cfg = RegressionConfig(reg_model=reg_model, total_vf_dim=10 + 6,
                           d_model=16, d_hidden=32, n_layers=2)
    L = 20
    sem = rng.standard_normal((2, L, 10)).astype(np.float32)
    emo = rng.uniform(size=(2, L, 6)).astype(np.float32)
    zeros = np.zeros((2, L), np.float32)
    jr = JaxRegression(cfg=cfg)
    variables = jr.init({"params": jax.random.PRNGKey(3)}, sem, zeros,
                        zeros, emo)
    (want_ln, want_inst), _ = jr.apply(variables, sem, zeros, zeros, emo,
                                       mutable=["moe_state", "metrics"])
    pr = VideoRegression(cfg).eval()
    pr.load_state_dict(regression_from_jax(jax.device_get(
        variables["params"])))
    width = 32 if reg_model in cfg.BIDIRECTIONAL_RNNS else 16
    assert pr.regressor.in_features == pr.classifier.in_features == width
    with torch.no_grad():
        ln, inst = pr(torch.from_numpy(sem), None, None,
                      torch.from_numpy(emo))
    assert ln.shape == (2, L, 2) and inst.shape == (2, L, 40)
    _close(ln, want_ln, "ln_nd")
    _close(inst, want_inst, "instrument")
    # seeded initialisation covers every parameter of the new modules
    fresh = init_weights_(VideoRegression(cfg),
                          torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in fresh.parameters())


@pytest.mark.parametrize("cell,reverse", [("gru", False), ("gru", True),
                                          ("lstm", False), ("lstm", True)])
def test_rnn_cell_scans_match_jax(cell, reverse):
    rng = np.random.default_rng(7)
    B, L, I, H = 3, 9, 5, 4
    g = 3 if cell == "gru" else 4
    x = rng.standard_normal((B, L, I)).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32)
    c0 = rng.standard_normal((B, H)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.5
         for s in ((g * H, I), (g * H, H), (g * H,), (g * H,))]
    t = lambda a: torch.from_numpy(a)
    if cell == "gru":
        got = scan.gru_scan(t(x), t(h0), *map(t, w), reverse=reverse)
        want = jscan.gru_scan(x, h0, *w, reverse=reverse)
    else:
        got = scan.lstm_scan(t(x), t(h0), t(c0), *map(t, w), reverse=reverse)
        want = jscan.lstm_scan(x, h0, c0, *w, reverse=reverse)
    _close(got, want)


def test_heinsen_log_scan_matches_jax():
    """The log-space scan, with -inf log values (zero values, as a
    previous hidden state of zero gives) that must stay finite after."""
    rng = np.random.default_rng(8)
    log_coeffs = -np.abs(rng.standard_normal((2, 17, 6))).astype(np.float32)
    log_values = rng.standard_normal((2, 17, 6)).astype(np.float32)
    log_values[:, :3, :2] = -np.inf
    got = scan.heinsen_log_scan(torch.from_numpy(log_coeffs),
                                torch.from_numpy(log_values))
    want = jscan.heinsen_log_scan(log_coeffs, log_values)
    assert np.isfinite(got.numpy()).all()
    _close(got, want)
    x = log_values.copy()
    _close(scan.logcumsumexp(torch.from_numpy(x)), jscan.logcumsumexp(x))


@pytest.mark.parametrize("cell,bidirectional",
                         [("gru", False), ("gru", True), ("lstm", False),
                          ("lstm", True)])
def test_rnn_stack_matches_plain_cell_loops(cell, bidirectional):
    """The nn.GRU / nn.LSTM stack (2 layers) against gru_scan / lstm_scan
    run layer by layer on its own weights, each direction concatenated."""
    torch.manual_seed(0)
    stack = RNNStack(cell, 6, 5, n_layers=2, bidirectional=bidirectional,
                     dropout_rate=0.3).eval()
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 11, 6)).astype(np.float32))
    with torch.no_grad():
        got = stack(x)
        h = x
        for layer in range(2):
            outs = []
            for d in range(2 if bidirectional else 1):
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                w = [getattr(stack.rnn, f"{n}{sfx}") for n in
                     ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
                z = torch.zeros(2, 5)
                outs.append(scan.gru_scan(h, z, *w, reverse=bool(d))
                            if cell == "gru" else
                            scan.lstm_scan(h, z, z, *w, reverse=bool(d)))
            h = torch.cat(outs, dim=-1)
    assert got.shape == (2, 11, 10 if bidirectional else 5)
    _close(got, h)
    # inter-layer dropout acts in a training call only (a generator
    # given), which runs the layers one at a time on the stack's weights
    stack.train()
    with torch.no_grad():
        _close(stack(x), got)
        dropped = stack(x, torch.Generator().manual_seed(0))
        assert dropped.shape == got.shape and not torch.equal(dropped, got)
        stack.dropout_rate = 0.0
        _close(stack._layered(x, torch.Generator()), got)


def test_mingru_parts_match_jax():
    """MinGRU with a previous hidden state (and its next hidden state),
    and MinGRULM with the causal depthwise conv, on the JAX params."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 7, 8)).astype(np.float32)
    prev = rng.uniform(0.1, 1.0, (2, 1, 12)).astype(np.float32)
    jm = JaxMinGRU(dim=8, expansion_factor=1.5)
    p = jm.init(jax.random.PRNGKey(0), x)["params"]
    want, want_h = jm.apply({"params": p}, x, jnp.asarray(prev), True)
    m = MinGRU(8, 1.5)
    with torch.no_grad():
        m.to_hidden_and_gate.weight.copy_(torch.from_numpy(np.asarray(
            p["to_hidden_and_gate"]["kernel"]).T))
        m.to_out.weight.copy_(torch.from_numpy(np.asarray(
            p["to_out"]["kernel"]).T))
        got, got_h = m(torch.from_numpy(x), torch.from_numpy(prev), True)
    _close(got, want)
    _close(got_h, want_h)

    jlm = JaxMinGRULM(total_vf_dim=10, dim=8, depth=2, enable_conv=True)
    xs = rng.standard_normal((2, 9, 10)).astype(np.float32)
    lp = jax.device_get(jlm.init(jax.random.PRNGKey(1), xs)["params"])
    lm = MinGRULM(10, 8, 2, enable_conv=True).eval()
    sd = {"in_proj.weight": lp["in_proj"]["kernel"].T,
          "in_proj.bias": lp["in_proj"]["bias"],
          "final_norm.gamma": lp["final_norm"]["gamma"] + 0.3,
          "to_logits.weight": lp["to_logits"]["kernel"].T}
    for i in range(2):
        c = lp[f"conv_{i}"]
        sd[f"conv.{i}.depthwise.weight"] = np.transpose(c["depthwise"],
                                                        (2, 1, 0))
        sd[f"conv.{i}.depthwise.bias"] = c["depthwise_bias"] + 0.1
        sd[f"conv.{i}.pointwise.weight"] = c["pointwise"]["kernel"].T
        sd[f"conv.{i}.pointwise.bias"] = c["pointwise"]["bias"]
        for n in ("norm", "ff_norm"):
            sd[f"blocks.{i}.{n}.gamma"] = lp[f"{n}_{i}"]["gamma"] - 0.2
        for n in ("to_hidden_and_gate", "to_out"):
            sd[f"blocks.{i}.mingru.{n}.weight"] = \
                lp[f"mingru_{i}"][n]["kernel"].T
        for n in ("ff1", "ff2"):
            sd[f"blocks.{i}.{n}.weight"] = lp[f"{n}_{i}"]["kernel"].T
            sd[f"blocks.{i}.{n}.bias"] = lp[f"{n}_{i}"]["bias"]
    lm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v,
                                                                 np.float32))
                        for k, v in sd.items()})
    # the same shifts on the JAX side (non-zero gammas and conv bias)
    lp["final_norm"]["gamma"] = lp["final_norm"]["gamma"] + 0.3
    for i in range(2):
        lp[f"conv_{i}"]["depthwise_bias"] = lp[f"conv_{i}"][
            "depthwise_bias"] + 0.1
        for n in ("norm", "ff_norm"):
            lp[f"{n}_{i}"]["gamma"] = lp[f"{n}_{i}"]["gamma"] - 0.2
    with torch.no_grad():
        got = lm(torch.from_numpy(xs))
    _close(got, jlm.apply({"params": lp}, xs))


KW = dict(music_gen_version="2.2", motion_type=0,
          amt_overrides=dict(n_layers=2, num_heads=2, d_model=16, d_ff=32),
          reg_overrides=dict(n_layers=2, d_model=16, d_hidden=32))


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


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("reg_model", ["bilstm", "mingru"])
def test_generate_with_new_backbone_matches_jax_pipeline(reg_model,
                                                         tmp_path):
    """``bilstm`` (the RegressionConfig default) and ``mingru`` behind a
    tiny 2.2: the same chords, densities, velocities and instruments, and
    byte-identical MIDI, stems and inst.csv."""
    jv = JaxVideo2music(reg_model=reg_model, **KW)
    pv = Video2music(device="cpu", reg_model=reg_model, **KW)
    pv.load_state_dicts(
        amt_from_jax(jax.device_get(jv.variables["params"])),
        regression_from_jax(jax.device_get(jv.reg_variables["params"])))
    kw = dict(primer="C Am", key="C major", features=_features(18, 4),
              seed=3, temperature=0.9, compute_dtype="float32")
    want = jv.generate(output_dir=str(tmp_path / "jax"), **kw)
    got = pv.generate(output_dir=str(tmp_path / "port"),
                      _gumbel=_jax_gumbel(3), **kw)
    np.testing.assert_array_equal(got.chord_ids, want.chord_ids)
    assert got.densities == want.densities
    assert got.velocities == want.velocities
    np.testing.assert_array_equal(got.instruments, want.instruments)
    jax_files = _files(tmp_path / "jax")
    assert jax_files and _files(tmp_path / "port") == jax_files
