"""The plain backward versions of ``flash_attention`` and ``wkv_chunked``
on the CPU against autograd through the plain forwards and against
``jax.vjp`` of the reference's ``attention_chunked`` and ``_wkv_chunked``;
the wrappers' gradients under autograd; ``test_perf_variants`` mirrored
with gradients; the backward wrappers' refusals. Tolerances, each
measured first: the plain backwards against autograd or jax.vjp 1e-5 of
the largest gradient (1e-4 for dw, which divides by w)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as rblocks
from repro.models import layers as rlayers
from repro_torch.configs import get_config
from repro_torch.kernels.attention import (flash_attention,
                                           flash_attention_bwd_ref,
                                           flash_attention_ref)
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.rwkv import (wkv_chunked, wkv_chunked_bwd_ref,
                                      wkv_chunked_ref)
from repro_torch.models import build_model, example_batch
from repro_torch.optim import tree_leaves


def _grads(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, {k: torch.as_tensor(v)
                               for k, v in batch.items()})
    return loss.detach(), torch.autograd.grad(loss, leaves)



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
