"""The port's training path against the reference's on the same numpy
inputs, on the CPU: ``TransformerLM.loss`` / ``EncDecLM.loss`` and every
parameter's gradient against ``jax.value_and_grad`` of the reference's
loss (weights carried across by ``lm_params_from_reference`` /
``encdec_params_from_reference``, fp32 activations) for a reduced dense,
MoE, RWKV, hybrid, VLM and enc-dec model, naive and chunked attention;
``remat`` on and off; ``make_train_step`` against the reference's step for
3 steps (AdamW and Adafactor); checkpoints (the reference's on-disk
format) and the ``Trainer`` (mirrors of ``test_substrates``); the plain
backward versions of ``flash_attention`` and ``wkv_chunked`` against
autograd through the plain forwards and against ``jax.vjp`` of the
reference's ``attention_chunked`` and ``_wkv_chunked``; and
``test_perf_variants`` mirrored with gradients.

Tolerances, each measured first: a loss rtol 1e-5; a gradient leaf
max |g - g_ref| <= 1e-4 max |g_ref| (the worst measured 2.3e-5, a reduced
llama4-scout's MoE leaves, whose one-hot dispatch sums in another order);
a train step's loss and grad norm rtol 1e-5, its parameters after 3 steps
atol 1e-6 (updates of at most the schedule's ~1e-5); the plain backwards
against autograd or jax.vjp 1e-5 of the largest gradient (1e-4 for dw,
which divides by w)."""
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
from repro.configs import get_config as rget_config
from repro.launch.mesh import make_smoke_mesh
from repro.launch.steps import make_train_step as rmake_train_step
from repro.models import blocks as rblocks
from repro.models import build_model as rbuild_model
from repro.models import example_batch as rexample_batch
from repro.models import layers as rlayers
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.kernels.attention import (flash_attention,
                                           flash_attention_bwd_ref,
                                           flash_attention_ref)
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.rwkv import (wkv_chunked, wkv_chunked_bwd_ref,
                                      wkv_chunked_ref)
from repro_torch.launch import make_train_step
from repro_torch.models import (build_model, encdec_params_from_reference,
                                example_batch, lm_params_from_reference)
from repro_torch.optim import tree_leaves
from repro_torch.runtime import HeartbeatMonitor, Trainer, TrainerConfig

FAMILIES = ["granite-3-2b", "llama4-scout-17b-a16e", "rwkv6-7b",
            "jamba-1.5-large-398b", "phi-3-vision-4.2b",
            "seamless-m4t-medium"]


def _configs(arch, **changes):
    return tuple(dataclasses.replace(g(arch).reduced(),
                                     activation_dtype="float32", **changes)
                 for g in (rget_config, get_config))


def _carry(model, tree):
    conv = encdec_params_from_reference if model.cfg.family == "encdec" \
        else lm_params_from_reference
    return conv(model, jax.tree.map(np.asarray, tree))


def _batch(cfg, seed=0, B=2, S=32):
    b = rexample_batch(cfg, "train", B, S, seed=seed)
    if cfg.family == "vlm":
        b["stub_embeds"] = b["stub_embeds"][:, :cfg.n_stub_tokens]
    return b


def _grads(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, {k: torch.as_tensor(v)
                               for k, v in batch.items()})
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _leaf_close(got, want, tol=1e-4):
    for a, b in zip(got, want):
        a = a.detach().double()
        b = torch.as_tensor(np.asarray(b)).double()
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * scale + 1e-12, \
            (float((a - b).abs().max()), scale)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch, impl):
    rcfg, cfg = _configs(arch, attention_impl=impl)
    rmodel, model = rbuild_model(rcfg), build_model(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = _carry(model, rparams)
    batch = _batch(cfg)
    rloss, rgrads = jax.value_and_grad(rmodel.loss)(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _grads(model, params, batch)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    want = tree_leaves(_carry(model, rgrads))
    assert len(want) == len(grads)
    _leaf_close(grads, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gives_the_same_loss_and_gradients(arch):
    """Activation checkpointing recomputes each block in the backward pass:
    the same loss and gradients, bit for bit on the CPU."""
    _, cfg = _configs(arch, attention_impl="chunked")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg, seed=1)
    loss, grads = _grads(model, params, batch)
    model.remat = True
    loss2, grads2 = _grads(model, params, batch)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_remat_recomputes_each_block_once():
    """Under remat each layer's forward runs again in the backward pass
    (one more ``wkv_chunked`` call a layer), and not with a cache."""
    from repro_torch.models import blocks
    _, cfg = _configs("rwkv6-7b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    calls = []
    real = blocks._wkv_chunked

    def counted(*a):
        calls.append(1)
        return real(*a)

    blocks._wkv_chunked = counted
    try:
        _grads(model, params, _batch(cfg))
        plain = len(calls)
        model.remat = True
        _grads(model, params, _batch(cfg))
    finally:
        blocks._wkv_chunked = real
    assert plain == cfg.n_layers and len(calls) - plain == 2 * cfg.n_layers


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-7b",
                                  "seamless-m4t-medium"])
def test_train_step_tracks_reference(arch, opt_name):
    """Three steps of ``make_train_step`` against the reference's
    (unjitted) step from the same weights and batches: loss and grad norm
    each step, the parameters after the last."""
    rcfg, cfg = _configs(arch, attention_impl="chunked")
    rstep, _, _, rmodel, ropt = rmake_train_step(
        rcfg, make_smoke_mesh(), optimizer_name=opt_name)
    step, model, opt = make_train_step(cfg, optimizer_name=opt_name)
    assert model.remat and rmodel.remat
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = _carry(model, rparams)
    rstate = {"params": rparams, "opt": ropt.init(rparams),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    for i in range(3):
        batch = _batch(cfg, seed=i)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-5)
        assert int(state["step"]) == int(rstate["step"]) == i + 1
    for a, b in zip(tree_leaves(state["params"]),
                    tree_leaves(_carry(model, rstate["params"]))):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=0,
                                   atol=1e-6)


def test_train_step_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="step 10"):
        make_train_step(get_config("granite-3-2b").reduced(), mesh=object())


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


# -- the plain backward versions ------------------------------------------------
#: (B, Sq, Sk, Hq, Hkv, Dh, causal, window, q_offset): causal, windowed,
#: GQA, Sq != Sk both ways, q_offset, rows that admit no key (a negative
#: offset; a window past the keys), non-causal with a window
ATTN_CASES = [(2, 24, 24, 4, 4, 8, True, None, 0),
              (2, 37, 37, 4, 2, 8, True, 9, 0),
              (1, 20, 50, 4, 1, 16, False, None, 0),
              (2, 50, 20, 6, 2, 8, True, 8, 0),
              (1, 25, 60, 2, 1, 8, True, 16, 40),
              (1, 20, 20, 2, 1, 8, True, None, -3),
              (1, 24, 16, 2, 1, 8, False, 4, 0)]


def _attn_inputs(case, seed=0):
    B, Sq, Sk, Hq, Hkv, Dh = case[:6]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, Dh)).astype(np.float32)
               for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
    do = rng.standard_normal((B, Sq, Hq, Dh)).astype(np.float32)
    return q, k, v, do


def _close_max(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * np.abs(want).max() + 1e-12


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_bwd_plain_matches_autograd_and_reference(case):
    """The plain backward (explicit formulas, KV chunks of 7) against
    autograd through the plain forward and against ``jax.vjp`` of the
    reference's ``attention_chunked``; the forward's log-sum-exp against
    a direct logsumexp of the masked scores."""
    q, k, v, do = _attn_inputs(case)
    kw = dict(causal=case[6], window=case[7], q_offset=case[8])
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attention_ref(tq, tk, tv, **kw, bk=5)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do))
    with torch.no_grad():
        out, lse = flash_attention_ref(tq, tk, tv, **kw, bk=5,
                                       return_lse=True)
        got = flash_attention_bwd_ref(tq, tk, tv, out, lse,
                                      torch.tensor(do), **kw, bk=7)
    _, vjp = jax.vjp(lambda a, b, c: rlayers.attention_chunked(
        a, b, c, **kw, bk=case[2]), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    for g, a, r in zip(got, auto, ref):
        _close_max(g, a, 1e-5)
        _close_max(g, r, 1e-5)
    some = attn_ref.admitted_rows(case[1], case[2], *kw.values())
    s = np.einsum("bqhd,bkhd->bhqk", q, np.repeat(k, case[3] // case[4], 2)
                  ) / np.sqrt(case[5])
    qp = case[8] + np.arange(case[1])[:, None]
    kp = np.arange(case[2])[None, :]
    mask = np.ones_like(qp + kp, bool)
    if kw["causal"]:
        mask &= kp <= qp
    if kw["window"]:
        mask &= kp > qp - kw["window"]
    s = np.where(mask, s, -np.inf)
    with np.errstate(invalid="ignore"):     # rows that admit no key
        want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
            s.max(-1)
    np.testing.assert_allclose(lse.numpy()[..., some.numpy()],
                               want[..., some.numpy()], rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_is_differentiable_through_the_wrapper():
    """Under autograd the wrapper records its gradient (the plain backward
    on CPU tensors) and ``attention_chunked`` (autograd through the plain
    forward on CPU tensors) gives the same; without grad the wrapper
    returns the plain forward unchanged."""
    from repro_torch.models import layers
    q, k, v, do = _attn_inputs(ATTN_CASES[1], seed=1)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = flash_attention(*ts, window=9)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ts, torch.tensor(do))
    want = torch.autograd.grad(flash_attention_ref(*ts, window=9), ts,
                               torch.tensor(do))
    chunked = torch.autograd.grad(
        layers.attention_chunked(*ts, window=9, bk=8), ts, torch.tensor(do))
    for a, b, c in zip(got, want, chunked):
        _close_max(a, b, 1e-5)
        _close_max(c, b, 1e-5)
    with torch.no_grad():
        assert torch.equal(flash_attention(*ts, window=9),
                           flash_attention_ref(*ts, window=9))


def _wkv_np(seed, B, S, H, hd, tiny_w=False):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, hd)) for _ in range(3))
    w = np.exp(-0.5 - 3.0 * rng.random((B, S, H, hd)))
    if tiny_w:
        w[0, 2, 0, :2] = 1e-9
    u = 0.3 * rng.standard_normal((H, hd))
    s0 = 0.1 * rng.standard_normal((B, H, hd, hd))
    do = rng.standard_normal((B, S, H, hd))
    ds = rng.standard_normal((B, H, hd, hd))
    return [x.astype(np.float32) for x in (r, k, v, w, u, s0, do, ds)]


@pytest.mark.parametrize("shape,with_state", [((2, 32, 3, 8), True),
                                              ((1, 48, 2, 5), False),
                                              ((2, 16, 1, 4), True),
                                              ((1, 32, 2, 16), False)])
def test_wkv_bwd_plain_matches_autograd_and_reference(shape, with_state):
    """The plain WKV backward against autograd through the plain chunked
    forward and against ``jax.vjp`` of the reference's ``_wkv_chunked``
    (a zero state0 where none is given), with a final-state gradient; dw
    is 0 where w is under the 1e-8 clamp."""
    r, k, v, w, u, s0, do, ds = _wkv_np(shape[1], *shape,
                                        tiny_w=not with_state)
    ops = [torch.tensor(x, requires_grad=True) for x in (r, k, v, w, u, s0)]
    state0 = ops[5] if with_state else None
    out, st = wkv_chunked_ref(*ops[:5], state0)
    auto = torch.autograd.grad((out, st), ops[:5] + ([ops[5]] if with_state
                                                     else []),
                               (torch.tensor(do), torch.tensor(ds)))
    with torch.no_grad():
        got = wkv_chunked_bwd_ref(*ops[:5], state0, torch.tensor(do),
                                  torch.tensor(ds))
    z = s0 if with_state else np.zeros_like(s0)
    _, vjp = jax.vjp(rblocks._wkv_chunked,
                     *map(jnp.asarray, (r, k, v, w, u, z)))
    ref = vjp((jnp.asarray(do), jnp.asarray(ds)))
    n = 6 if with_state else 5
    for i in range(n):
        tol = 1e-4 if i == 3 else 1e-5
        _close_max(got[i], auto[i], tol)
        _close_max(got[i], ref[i], tol)
    if not with_state:
        assert np.all(got[3].numpy()[0, 2, 0, :2] == 0)
        _close_max(got[5], ref[5], 1e-5)    # dstate0 of a zero state


def test_wkv_is_differentiable_through_the_wrapper():
    """Under autograd ``wkv_chunked`` and the model's ``_wkv_chunked``
    record their gradient (the plain backward on CPU tensors), the final
    state's included; without grad they return the plain forward."""
    from repro_torch.models import blocks
    r, k, v, w, u, s0, do, ds = _wkv_np(3, 1, 32, 2, 8)
    ops = [torch.tensor(x, requires_grad=True) for x in (r, k, v, w, u, s0)]
    out, st = blocks._wkv_chunked(*ops)
    assert out.grad_fn is not None and st.grad_fn is not None
    got = torch.autograd.grad((out, st), ops, (torch.tensor(do),
                                               torch.tensor(ds)))
    out, st = wkv_chunked_ref(*ops)
    want = torch.autograd.grad((out, st), ops, (torch.tensor(do),
                                                torch.tensor(ds)))
    for i, (a, b) in enumerate(zip(got, want)):
        _close_max(a, b, 1e-4 if i == 3 else 1e-5)
    with torch.no_grad():
        a, b = wkv_chunked(*ops), wkv_chunked_ref(*ops)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -- test_perf_variants mirrored, with gradients ------------------------------
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("gqa", [(8, 8), (8, 2)])
def test_chunked_attention_matches_naive_with_gradients(window, gqa):
    from repro_torch.models import layers
    hq, hkv = gqa
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.standard_normal((2, 128, hq, 32)),
                     dtype=torch.float32, requires_grad=True)
    k, v = (torch.tensor(rng.standard_normal((2, 128, hkv, 32)),
                         dtype=torch.float32, requires_grad=True)
            for _ in range(2))
    do = torch.tensor(rng.standard_normal((2, 128, hq, 32)),
                      dtype=torch.float32)
    naive = layers.attention_xla(q, k, v, causal=True, window=window)
    chunked = layers.attention_chunked(q, k, v, causal=True, window=window,
                                       bk=32)
    np.testing.assert_allclose(chunked.detach().numpy(),
                               naive.detach().numpy(), rtol=2e-4, atol=2e-4)
    for a, b in zip(torch.autograd.grad(chunked, (q, k, v), do),
                    torch.autograd.grad(naive, (q, k, v), do)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_sort_moe_matches_onehot_with_gradients():
    from repro_torch.models import layers
    rng = np.random.default_rng(5)
    b, s, d, e, f, k = 2, 16, 8, 4, 16, 2
    x = torch.tensor(rng.standard_normal((b, s, d)), dtype=torch.float32,
                     requires_grad=True)
    ws = [torch.tensor(rng.standard_normal(sh) * sc, dtype=torch.float32,
                       requires_grad=True)
          for sh, sc in (((d, e), 1.0), ((e, d, f), 0.3), ((e, d, f), 0.3),
                         ((e, f, d), 0.3))]
    outs = [layers.moe_block(x, *ws, top_k=k, capacity_factor=8.0,
                             dispatch=dp) for dp in ("onehot", "sort")]
    np.testing.assert_allclose(outs[1][0].detach().numpy(),
                               outs[0][0].detach().numpy(), rtol=2e-4,
                               atol=2e-4)
    assert float(outs[1][1].detach()) == pytest.approx(
        float(outs[0][1].detach()), rel=1e-5)
    grads = [torch.autograd.grad(o.square().sum() + a, [x] + ws)
             for o, a in outs]
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("arch", ["yi-34b", "llama4-scout-17b-a16e"])
def test_optimized_model_matches_baseline_with_gradients(arch):
    base_cfg = dataclasses.replace(get_config(arch).reduced(),
                                   activation_dtype="float32")
    opt_cfg = dataclasses.replace(base_cfg, attention_impl="chunked",
                                  moe_dispatch="sort")
    m1, m2 = build_model(base_cfg), build_model(opt_cfg)
    params = m1.init(torch.Generator().manual_seed(0))
    batch = example_batch(base_cfg, "train", 2, 32)
    l1, g1 = _grads(m1, params, batch)
    l2, g2 = _grads(m2, params, batch)
    assert float(l2) == pytest.approx(float(l1), rel=3e-3)
    for a, b in zip(g2, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-3,
                                   atol=3e-3)


def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    """The typed limits of the forwards hold for the backwards on every
    device (a head over 256, an hd over 256), as do the shape checks; the
    CPU path counts no launch."""
    from repro_torch.kernels.attention import (FlashAttentionLimitError,
                                               flash_attention_bwd)
    from repro_torch.kernels.rwkv import WKVLimitError, wkv_chunked_bwd
    q = torch.zeros(1, 4, 2, 260)
    lse = torch.zeros(1, 2, 4)
    before = flash_attention_bwd.launches
    with pytest.raises(FlashAttentionLimitError):
        flash_attention_bwd(q, q, q, q, lse, q)
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q, q, q, torch.zeros(1, 4, 2), q)
    flash_attention_bwd(q, q, q, q, lse, q)
    assert flash_attention_bwd.launches == before
    z = torch.zeros(1, 16, 1, 257)
    before = wkv_chunked_bwd.launches
    with pytest.raises(WKVLimitError):
        wkv_chunked_bwd(z, z, z, z, torch.zeros(1, 257), None, z)
    z = torch.zeros(1, 16, 1, 8)
    with pytest.raises(ValueError, match="dout"):
        wkv_chunked_bwd(z, z, z, z, torch.zeros(1, 8), None, z[:, :8])
    wkv_chunked_bwd(z, z, z, z, torch.zeros(1, 8), None, z)
    assert wkv_chunked_bwd.launches == before
