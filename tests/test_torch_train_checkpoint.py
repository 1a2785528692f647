"""The port's checkpoints (the reference's on-disk format) and its
``Trainer`` on the CPU, mirrors of the reference's ``test_substrates``:
round trips, the format shared both ways, bf16 leaves, typed errors, the
atomic commit, a run that checkpoints, a restart that replays the
uninterrupted run's losses exactly, the device default, the heartbeat
monitor's rules and the ``train_lm`` example."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as rckpt
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.optim import tree_leaves
from repro_torch.runtime import HeartbeatMonitor, Trainer, TrainerConfig


# -- checkpoint -------------------------------------------------------------
def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "layers": [{"a": torch.ones((2,))},
                                  {"a": torch.zeros((2,))}]},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    ckpt.save(str(tmp_path), 7, state)
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored = ckpt.restore(str(tmp_path), 7, state)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_format_is_the_reference_one(tmp_path):
    """The same state saved by both packages gives the same manifest (leaf
    paths, files, dtypes, shapes) and the same .npy files; each package
    restores the other's."""
    state = _state()
    jstate = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state)
    ckpt.save(str(tmp_path / "port"), 7, state)
    rckpt.save(str(tmp_path / "ref"), 7, jstate)
    assert ckpt.manifest_for(str(tmp_path / "port"), 7) == \
        rckpt.manifest_for(str(tmp_path / "ref"), 7)
    mine = ckpt.restore(str(tmp_path / "ref"), 7, state)
    theirs = rckpt.restore(str(tmp_path / "port"), 7, jstate)
    for a, b, c in zip(tree_leaves(state), tree_leaves(mine),
                       jax.tree.leaves(theirs)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_checkpoint_keeps_bf16_and_the_like_devices(tmp_path):
    state = {"w": torch.randn(4, 3).to(torch.bfloat16),
             "b": torch.randn(3)}
    ckpt.save(str(tmp_path), 2, state)
    meta = ckpt.manifest_for(str(tmp_path), 2)["leaves"]
    assert meta["w"]["dtype"] == "bfloat16"
    back = ckpt.restore(str(tmp_path), 2, state)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], state["w"])
    assert back["b"].device == state["b"].device


def test_checkpoint_mismatch_and_missing_leaf_raise_typed(tmp_path):
    state = _state()
    ckpt.save(str(tmp_path), 1, state)
    other = dict(state, extra=torch.zeros(1))
    with pytest.raises(ckpt.CheckpointError, match="extra"):
        ckpt.restore(str(tmp_path), 1, other)
    d = tmp_path / "step_00000001"
    meta = json.loads((d / "manifest.json").read_text())
    (d / meta["leaves"]["step"]["file"]).unlink()
    with pytest.raises(ckpt.CheckpointError, match="missing"):
        ckpt.restore(str(tmp_path), 1, state)
    with pytest.raises(NotImplementedError, match="step 10"):
        ckpt.restore(str(tmp_path), 1, state, shardings={})


def test_checkpoint_commit_replaces_atomically(tmp_path):
    """A second save of a step replaces it through the tmp dir, leaving no
    ``.tmp`` or ``.old`` directory; those never count as a step."""
    state = _state()
    ckpt.save(str(tmp_path), 3, state)
    state["params"]["w"] += 1
    ckpt.save(str(tmp_path), 3, state)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003"]
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000008.old").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert torch.equal(ckpt.restore(str(tmp_path), 3, state)["params"]["w"],
                       state["params"]["w"])


# -- trainer ------------------------------------------------------------------
def _tiny_trainer(tmp_path, steps=8):
    cfg = get_config("granite-3-2b").reduced()
    tcfg = TrainerConfig(steps=steps, checkpoint_every=4,
                         ckpt_dir=str(tmp_path))
    return Trainer(cfg, None, tcfg, seq_len=32, global_batch=4,
                   device="cpu")


def test_trainer_runs_and_checkpoints(tmp_path):
    tr = _tiny_trainer(tmp_path)
    out = tr.run()
    assert len(out["log"]) == 8
    assert all(np.isfinite(m["loss"]) for m in out["log"])
    assert ckpt.latest_step(str(tmp_path)) == 8


def test_trainer_restart_resumes(tmp_path):
    """A restart resumes at the last checkpoint and replays the
    uninterrupted run's losses exactly (counter-based data, the state
    restored bit for bit)."""
    whole = _tiny_trainer(tmp_path / "whole", steps=6).run()
    tr = _tiny_trainer(tmp_path / "cut", steps=4)
    tr.run()
    tr2 = _tiny_trainer(tmp_path / "cut", steps=6)
    out = tr2.run()
    assert out["log"][0]["step"] == 4
    assert out["log"][-1]["step"] == 5
    assert [m["loss"] for m in out["log"]] == \
        [m["loss"] for m in whole["log"][4:]]


def test_trainer_takes_the_card_unless_told(tmp_path):
    cfg = get_config("granite-3-2b").reduced()
    if torch.cuda.is_available():
        assert Trainer(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg)
    with pytest.raises(NotImplementedError, match="step 10"):
        Trainer(cfg, object(), device="cpu")


def test_heartbeat_monitor_flags_stragglers_and_deaths():
    """The reference's rules: past the deadline is dead; over
    straggler_factor times the median of the last finite durations (at
    least 4) is a straggler; a dead step's duration stays out of the
    median."""
    mon = HeartbeatMonitor(deadline_s=10.0, straggler_factor=2.0)
    assert [mon.record(0, d) for d in (1.0, 1.1, 0.9, 1.0)] == ["ok"] * 4
    assert mon.record(1, 3.0) == "straggler"
    assert mon.record(2, float("inf")) == "dead"
    assert mon.record(0, 1.05) == "ok"
    assert mon.events[0][:2] == ("straggler", 1)
    assert mon.events[1][:2] == ("dead", 2)
    assert mon.host_status == {0: "ok", 1: "straggler", 2: "dead"}


def test_train_lm_example_runs_and_refuses_cluster_sim(tmp_path):
    """The example trains its reduced model on the CPU through the
    ``Trainer``, its LM100M is the reference example's, and
    ``--cluster-sim`` raises naming step 10."""
    from repro_torch.examples import train_lm
    out = train_lm.main(["--tiny", "--steps", "3", "--batch", "2", "--seq",
                         "16", "--device", "cpu", "--ckpt-dir",
                         str(tmp_path)])
    assert [m["step"] for m in out["log"]] == [0, 1, 2]
    spec = importlib.util.spec_from_file_location(
        "ref_train_lm", Path(__file__).resolve().parents[1] / "examples"
        / "train_lm.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert dataclasses.asdict(train_lm.LM100M) == \
        dataclasses.asdict(ref.LM100M)
    with pytest.raises(NotImplementedError, match="step 10"):
        train_lm.main(["--cluster-sim"])


