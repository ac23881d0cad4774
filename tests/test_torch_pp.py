"""The port's pipeline parallelism (and tensor parallelism on a 1x2 mesh)
on the CPU against the JAX package, in spawned gloo worlds, at the tiny
widths of tests/test_torch_parallel.py: the GPipe step on the base AMT
at 1x2 (one 2-layer segment a stack, with and without remat) and on the
2.2 3 shallow + 3 deep split at 1x3 (two segments a stack), each held to
three f32 AdamW steps of the JAX single-device step at dropout 0; tp at
1x2 likewise; with dropout 0.1 the pipelined loss falls (its per-
microbatch, per-layer streams equal the single-device step in
distribution only, as in JAX); every stage holding the whole current
model and MoE state; the microbatch and stacking helpers."""

import pytest
import torch

from tests.test_torch_parallel import (BATCHES, _case, _World,
                                       check_against_jax)
from video2music_tpu_torch.parallel.pipeline import (microbatch,
                                                     stack_subtrees,
                                                     unmicrobatch,
                                                     unstack_subtrees)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    t = tmp_path_factory.mktemp("pp_worlds")
    return {
        "1x2": _World(t / "w1x2", (1, 2), [
            _case("tp12", "2.2", "tp"),
            _case("pp12", "base", "pp", microbatches=2),
            _case("pp12_remat", "base", "pp", microbatches=4, remat=True),
            dict(_case("pp_drop", "base", "pp", 0.1, jax_weights=False,
                       microbatches=2, remat=True),
                 batches=[BATCHES[0]] * 6)]),
        "1x3": _World(t / "w1x3", (1, 3),
                      [_case("pp3", "2.2x6", "pp", microbatches=2),
                       _case("pp3_bal", "2.2x6bal", "pp", microbatches=2,
                             jax_weights=False)]),
    }


@pytest.mark.parametrize("world,case,key", [
    ("1x2", "tp12", "2.2"), ("1x2", "pp12", "base"),
    ("1x2", "pp12_remat", "base"), ("1x3", "pp3", "2.2x6")])
def test_step_matches_jax_single_device(worlds, world, case, key):
    """Three f32 AdamW steps at dropout 0 equal the JAX package's
    single-device step: losses (rtol 1e-4) and every parameter (the
    pipelined ones gathered from their stages)."""
    got = worlds[world]()[case]
    check_against_jax(got, key)
    # every stage's rank returns the same synced whole loss
    assert worlds[world](1)[case]["losses"] == got["losses"]


def test_pipeline_with_dropout_trains(worlds):
    """pp with dropout 0.1 and remat: the loss on one repeated batch
    falls."""
    losses = worlds["1x2"]()["pp_drop"]["losses"]
    assert all(map(lambda v: v == v, losses)) and losses[-1] < losses[0]


def test_pipeline_stages_hold_the_whole_current_model(worlds):
    """After three pipelined steps of a balancing 2.2 (one deep MoE layer a
    stage) every stage holds the same parameters and every layer's
    balancing bias, moved by the stage that runs it."""
    ranks = [worlds["1x3"](r)["pp3_bal"] for r in range(3)]
    assert len({r["digest"] for r in ranks}) == 1
    biases = {k: v for k, v in ranks[0]["moe_state"].items()
              if k.endswith("balance_bias")}
    assert len(biases) == 6 and all(v.abs().max() > 0
                                    for v in biases.values())
    for r in ranks[1:]:
        assert sorted(r["moe_state"]) == sorted(ranks[0]["moe_state"])
        for k, v in ranks[0]["moe_state"].items():
            assert torch.equal(r["moe_state"][k], v), k


def test_microbatch_and_stack_helpers():
    x = torch.arange(24.0).view(6, 2, 2)
    mb = microbatch({"x": x}, 3)
    assert mb["x"].shape == (3, 2, 2, 2)
    assert torch.equal(unmicrobatch(mb)["x"], x)
    with pytest.raises(ValueError, match="not divisible"):
        microbatch(x, 4)
    trees = {f"l{i}": {"w": torch.full((3,), float(i)),
                       "b": torch.full((2, 2), float(-i))} for i in range(4)}
    names = [f"l{i}" for i in range(4)]
    stacked = stack_subtrees(trees, names)
    assert stacked["w"].shape == (4, 3)
    back = unstack_subtrees(stacked, names)
    assert torch.equal(back["l2"]["b"], trees["l2"]["b"])
