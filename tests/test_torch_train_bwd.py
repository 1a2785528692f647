"""The plain backward versions of ``flash_attention`` and ``wkv_chunked``
on the CPU against autograd through the plain forwards and against
``jax.vjp`` of the reference's ``attention_chunked`` and ``_wkv_chunked``;
the wrappers' gradients under autograd; ``test_perf_variants`` mirrored
with gradients; the backward wrappers' refusals; the WKV backward
kernel's source (its products, its shared memory from its own ``Plan``,
its span decomposition in float64, ``chip_smoke.py``'s planted edits of
it). Tolerances, each measured first: the plain backwards against
autograd or jax.vjp 1e-5 of the largest gradient (1e-4 for dw, which
divides by w); the span decomposition 1e-12 of the largest gradient
(measured: 4e-14), both sides in float64."""
import dataclasses
import importlib.util
import re
from pathlib import Path

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


# -- the WKV backward kernel's source (csrc/wkv_bwd.cu) -----------------------
def _wkv_bwd_source():
    from repro_torch.kernels import build
    return (build.CSRC / "wkv_bwd.cu").read_text()


def test_wkv_backward_source_takes_its_products_on_the_tensor_cores():
    """The WKV backward's CUDA source takes its products as the shared
    header's tf32 MMAs, stages its tiles with cp.async, builds with the
    others, and calls no library kernel and no atomic."""
    from repro_torch.kernels import build
    src = _wkv_bwd_source()
    assert "wkv_bwd" in build.KERNELS
    assert re.findall(r'#include "([^"]+)"', src) == ["mma_tf32.cuh"]
    assert "mma_tf32(" in src and "cp_async16(" in src
    assert "mma.sync" not in src and "0xffffe000u" not in src
    whole = src + (build.CSRC / "mma_tf32.cuh").read_text()
    for call in ("cublas", "cudnn", "torch"):
        assert call not in whole.lower()
    assert not re.search(r"atomic\w*\(", whole)
    assert not re.search(r"\b(atom|red)\.", whole)


def _c_expr(expr):
    """A C integer expression of the source as Python: casts of sizeof, LL
    suffixes, integer division, ternaries (right associative)."""
    expr = " ".join(re.sub(r"(\d)LL\b", r"\1", expr).split())
    expr = re.sub(r"static_cast<int(?:64_t)?>\((sizeof\(T\))\)", r"\1",
                  expr)
    return _ternaries(expr.replace("/", "//").replace("&&", " and "))


def _ternaries(expr):
    depth, q = 0, None
    for i, ch in enumerate(expr):
        depth += (ch == "(") - (ch == ")")
        if ch == "?" and depth == 0:
            q = i
            break
    if q is None:
        return expr
    nested, depth = 0, 0
    for i in range(q + 1, len(expr)):
        ch = expr[i]
        depth += (ch == "(") - (ch == ")")
        if depth == 0 and ch == "?":
            nested += 1
        elif depth == 0 and ch == ":":
            if nested == 0:
                break
            nested -= 1
    cond, then, other = expr[:q], expr[q + 1:i], expr[i + 1:]
    return f"(({_ternaries(then)}) if ({cond}) else ({_ternaries(other)}))"


def _wkv_plan(size):
    """The backward source's ``Plan<T>`` with ``size``-byte operands,
    evaluated from the source's own text (its namespace constants, the
    slab width and the struct's constants and functions), so that the test
    holds the tiling the kernel compiles, not a copy of it."""
    src = _wkv_bwd_source()
    env = {}
    for name, val in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src,
                                re.M):
        env[name] = eval(_c_expr(val), env)
    env["sizeof"] = lambda t: size
    env["T"] = None
    body = re.search(r"struct Plan \{\n(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//.*", "", body)
    for m in re.finditer(
            r"static constexpr \w+ (\w+)(?: = (.*?);|\((.*?)\) \{\s*"
            r"return (.*?);\s*\})", body, re.S):
        name, value, args, ret = m.groups()
        if value is not None:
            env[name] = eval(_c_expr(value), env)
        else:
            params = ", ".join(a.split()[-1] for a in args.split(",") if a)
            env[name] = eval(f"lambda {params}: {_c_expr(ret)}", env)
    return env


@pytest.mark.parametrize("size", [2, 4])
def test_wkv_backward_shared_memory_fits_a_block_at_every_head(size):
    """Every launch's shared memory (the source's ``Plan``) fits Hopper's
    227 KB at every head the wrapper takes, hd 1 to 256; at rwkv6-7b's hd
    64 each launch's blocks fit as many an SM as its launch bounds ask (1
    KB reserved a block), but the keys' three in fp32; the span shrinks
    with hd so that a block's rows fit."""
    plan = _wkv_plan(size)
    for hd in range(1, 257):
        for launch in ("spans_bytes", "keys_bytes", "values_bytes"):
            assert plan[launch](hd) <= 232_448, (launch, hd)
    src = _wkv_bwd_source()
    for launch in ("spans", "keys", "values"):
        n = int(re.search(r"__launch_bounds__\(kThreads, (\d)\)\n"
                          rf"wkv_bwd_{launch}\(", src).group(1))
        if launch == "keys" and size == 4:
            n = 3
        assert (plan[f"{launch}_bytes"](64) + 1024) * n <= 233_472
    assert [plan["span"](hd) for hd in (1, 64, 128, 129, 256)] == \
        [32, 32, 32, 16, 16]
    # fp32 at hd 64: r, k, v, dout (32 x 68); la (32 x 68); five 32 x 36
    # tiles (after two 32-row slabs of S and G, 32 x 68); the chunks' decay,
    # u, dov's diagonal, the slabs' tail terms, the reverse sums' parts
    if size == 4:
        assert plan["keys_bytes"](64) == \
            4 * 32 * 68 * 4 + (32 * 68 + 5 * 32 * 36 + 2 * 64 + 64 + 32
                               + 32 + 4 * 32) * 4


def _span_decomposition(r, k, v, w, u, state0, dout, dstate, nc):
    """The backward as ``wkv_bwd.cu`` decomposes it, in float64: spans of
    16 nc positions (the last one short, w = 1 past S) whose sums U and W
    are scanned into the states entering and the gradients leaving each
    span; within a span, chunk pairs (a, b <= a) with the decays split at
    chunk a's first position (the diagonal pair in the reference's own k /
    A form); d la's tail sum_j Kr_j (G v_j) + A_last rowsum(S o G) at the
    span's last position; the values' side from the same factors."""
    f64 = torch.float64
    B, S, H, hd = r.shape
    C, L = 16, 16 * nc
    N = -(-S // L)
    pad = N * L - S

    def spans(x, fill=0.0):
        z = torch.full((B, pad, H, hd), fill, dtype=f64)
        return torch.cat([x.to(f64), z], 1).reshape(B, N, L, H, hd)
    rc, kc, vc, dc = (spans(x) for x in (r, k, v, dout))
    wc = spans(w, 1.0)
    lw = torch.log2(torch.clamp(wc, min=1e-8))
    before = torch.cumsum(lw, 2) - lw
    after = torch.flip(torch.cumsum(torch.flip(lw, [2]), 2), [2]) - lw
    a_last = 2 ** lw.sum(2)
    U = torch.einsum("bnjhd,bnjhe->bnhde", kc * 2 ** after, vc)
    W = torch.einsum("bnthd,bnthe->bnhde", rc * 2 ** before, dc)
    st = torch.zeros(B, H, hd, hd, dtype=f64) if state0 is None \
        else state0.to(f64)
    states = []
    for n in range(N):
        states.append(st)
        st = a_last[:, n][..., None] * st + U[:, n]
    states.append(st)
    g = torch.zeros(B, H, hd, hd, dtype=f64) if dstate is None \
        else dstate.to(f64)
    grads = [None] * N
    for n in reversed(range(N)):
        grads[n] = g
        g = a_last[:, n][..., None] * g + W[:, n]
    Sn, Gn = torch.stack(states[:N], 1), torch.stack(grads, 1)
    kr_gv = kc * 2 ** after * torch.einsum("bnhde,bnjhe->bnjhd", Gn, vc)
    tail = kr_gv.sum(2) + a_last * (Sn * Gn).sum(-1)
    lam = torch.cumsum(lw.reshape(B, N, nc, C, H, hd), 3)
    tc = lam[:, :, :, -1]
    lam_prev = torch.cat([torch.zeros_like(lam[:, :, :, :1]),
                          lam[:, :, :, :-1]], 3)
    rr, kk, vv, dd = (x.reshape(B, N, nc, C, H, hd) for x in (rc, kc, vc, dc))
    dov = torch.einsum("bnthe,bnjhe->bnhtj", dc, vc)
    diag = torch.diagonal(dov, dim1=-2, dim2=-1).permute(0, 1, 3, 2)
    diag = diag.reshape(B, N, nc, C, H, 1)
    lower = torch.tril(torch.ones(C, C, dtype=torch.bool), -1)
    uu = u.to(f64)

    def csum(lo, hi):
        return sum((tc[:, :, c] for c in range(lo, hi)),
                   torch.zeros_like(tc[:, :, 0]))[:, :, None]
    dr, dk, dv, x, dlae = (torch.zeros_like(rr) for _ in range(5))
    for a in range(nc):
        ta = slice(C * a, C * a + C)
        aq = torch.einsum("bnthe,bnhde->bnthd", dd[:, :, a], Sn) * \
            2 ** csum(0, a)
        for b in range(a + 1):
            blk = dov[..., ta, C * b:C * b + C] * (lower if b == a else 1)
            aq = aq + torch.einsum("bnhtj,bnjhd->bnthd", blk, kk[:, :, b]
                                   * 2 ** (csum(b, a) - lam[:, :, b]))
        ak = torch.einsum("bnjhe,bnhde->bnjhd", vv[:, :, a], Gn) * \
            2 ** csum(a + 1, nc)
        for a2 in range(a, nc):
            blk = dov[..., C * a2:C * a2 + C, ta] * (lower if a2 == a else 1)
            D = csum(a + 1, a2) if a2 > a else -tc[:, :, a][:, :, None]
            ak = ak + torch.einsum("bnhtj,bnthd->bnjhd", blk, rr[:, :, a2]
                                   * 2 ** (lam_prev[:, :, a2] + D))
        dq = 2 ** lam_prev[:, :, a] * aq
        kg = 2 ** (tc[:, :, a][:, :, None] - lam[:, :, a]) * ak
        dr[:, :, a] = dq + diag[:, :, a] * uu * kk[:, :, a]
        dk[:, :, a] = kg + diag[:, :, a] * uu * rr[:, :, a]
        dla = -kk[:, :, a] * kg
        if a == nc - 1:
            dla[:, :, -1] += tail
        dlae[:, :, a] = rr[:, :, a] * dq
        x[:, :, a] = dla + dlae[:, :, a]
    x, dlae = x.reshape(B, N, L, H, hd), dlae.reshape(B, N, L, H, hd)
    dlw = torch.flip(torch.cumsum(torch.flip(x, [2]), 2), [2]) - dlae
    dw = torch.where(wc >= 1e-8, dlw / wc, torch.zeros((), dtype=f64))
    du = (diag.reshape(B, N, L, H, 1) * rc * kc).sum((0, 1, 2))
    bonus = torch.einsum("bnthd,hd,bnthd->bnth", rc, uu, kc)
    bonus = bonus.reshape(B, N, nc, C, H).permute(0, 1, 2, 4, 3)
    q_t = rr * 2 ** lam_prev
    k_h = kk * 2 ** (tc[:, :, :, None] - lam)
    upper = torch.triu(torch.ones(C, C, dtype=torch.bool), 1)
    for b in range(nc):
        acc = torch.einsum("bnjhd,bnhde->bnjhe",
                           k_h[:, :, b] * 2 ** csum(b + 1, nc), Gn)
        for a in range(b, nc):
            F = 2 ** (csum(b + 1, a) if a > b else -tc[:, :, a][:, :, None])
            pt = torch.einsum("bnjhd,bnthd->bnhjt", k_h[:, :, b] * F,
                              q_t[:, :, a])
            if a == b:
                pt = pt * upper + torch.diag_embed(bonus[:, :, b])
            acc = acc + torch.einsum("bnhjt,bnthe->bnjhe", pt, dd[:, :, a])
        dv[:, :, b] = acc

    def back(y):
        return y.reshape(B, N * L, H, hd)[:, :S]
    return back(dr), back(dk), back(dv), back(dw), du, g


@pytest.mark.parametrize("nc", [1, 2])
@pytest.mark.parametrize("shape,with_state", [((2, 48, 3, 8), True),
                                              ((1, 80, 2, 5), False),
                                              ((2, 16, 1, 4), True),
                                              ((1, 128, 2, 6), False)])
def test_wkv_backward_span_decomposition_matches_the_plain_version(
        shape, with_state, nc):
    """The kernel's decomposition (spans of 16 or 32 positions, whole, or
    short at the end: S 16, 48, 80 and 128) gives the plain backward's
    six gradients in float64, with and without a state0 and dw 0 under
    the clamp."""
    ops = [torch.tensor(x, dtype=torch.float64)
           for x in _wkv_np(sum(shape) + nc, *shape, tiny_w=True)]
    if not with_state:
        ops[5] = None
    got = _span_decomposition(*ops, nc)
    want = wkv_chunked_bwd_ref(*ops)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    assert bool((got[3][0, 2, 0, :2] == 0).all())


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_planted_wkv_backward_edits_change_one_line_each():
    """``chip_smoke.py``'s planted fault (the reverse scan's carry of G
    without the span's decay) and its control (the hi x hi product alone,
    one tf32 product where the kernel takes three) each find their line
    once in the source and change nothing else."""
    mod = _chip_smoke()
    text = _wkv_bwd_source()
    bad = mod.undecayed_source(text)
    assert bad != text and "gs = carry(1.0f, gs, x[j]);" in bad
    assert bad.replace("carry(1.0f, gs", "carry(a[j], gs") == text
    once = mod.tf32_once_source(text)
    assert "mma_tf32(small" not in once and "mma_tf32(small" in text
    assert once.count("mma_tf32(big, ahi, bh0, bh1);") == 1
    assert len(text.splitlines()) - len(once.splitlines()) == 2
