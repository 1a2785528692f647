"""The port's optimizers (``repro_torch.optim``) against the reference's
``repro.optim`` on the same numpy inputs: the warmup-cosine schedule, the
global norm and its clipping (the 1e-9, the per-leaf cast back), AdamW and
Adafactor (the factored ``vr``/``vc``, the RMS update clipping) over
several steps of the same gradients, and mirrors of ``test_substrates``'
optimizer tests. The port updates in place; that is pinned here too.
Tolerances: the schedule and the norm rtol 1e-6 (float32 scalars); an
update rtol 1e-5 / atol 1e-7 over five steps of float32 elementwise
arithmetic in another order (the bf16 leaf: one bf16 ulp, 2^-8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as roptim
from repro_torch import optim
from repro_torch.optim import tree_leaves, tree_map


def _tree(rng):
    """A parameter tree as the port's: dicts, a list of layers, matrices,
    a vector and stacked (E, D, F) experts."""
    t = {"embed": rng.standard_normal((12, 8)).astype(np.float32),
         "layers": [{"w": rng.standard_normal((8, 8)).astype(np.float32),
                     "scale": rng.standard_normal(8).astype(np.float32)}
                    for _ in range(2)],
         "experts": rng.standard_normal((3, 8, 5)).astype(np.float32)}
    return t


def _to_torch(t, dtype=torch.float32):
    return tree_map(lambda a: torch.tensor(np.asarray(a)).to(dtype), t)


def _to_jax(t, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), t)


@pytest.mark.parametrize("step", [0, 1, 7, 99, 100, 101, 2500, 9999, 10000,
                                  12345])
def test_warmup_cosine_matches_reference(step):
    want = float(roptim.warmup_cosine(3e-4, 100, 10000)(
        jnp.asarray(step, jnp.int32)))
    got = float(optim.warmup_cosine(3e-4, 100, 10000)(
        torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("max_norm", [1e3, 1.0, 1e-3])
def test_global_norm_and_clip_match_reference(max_norm):
    """The norm of every leaf summed in float32 and the clip, a bf16 leaf
    cast back to bf16 after its float32 product; the port scales the
    gradients it is given in place."""
    rng = np.random.default_rng(0)
    t = _tree(rng)
    jt = _to_jax(t)
    jt["layers"][1]["w"] = jt["layers"][1]["w"].astype(jnp.bfloat16)
    tt = _to_torch(t)
    tt["layers"][1]["w"] = tt["layers"][1]["w"].to(torch.bfloat16)
    want_norm = float(roptim.global_norm(jt))
    assert float(optim.global_norm(tt)) == pytest.approx(want_norm,
                                                         rel=1e-6)
    want, wn = roptim.clip_by_global_norm(jt, max_norm)
    before = [x.data_ptr() for x in tree_leaves(tt)]
    got, gn = optim.clip_by_global_norm(tt, max_norm)
    assert got is tt and [x.data_ptr() for x in tree_leaves(got)] == before
    assert float(gn) == pytest.approx(float(wn), rel=1e-6)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert str(a.dtype).split(".")[1] == str(b.dtype)
        tol = 2.0 ** -8 if a.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=tol,
                                   atol=1e-7)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_match_reference_over_steps(name):
    """Five steps of the same gradients (the schedule short, so that the
    learning rate is not 0) through both packages: parameters and every
    optimizer-state leaf."""
    rng = np.random.default_rng(1)
    t = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    make = {"adamw": lambda m: m.adamw(m.warmup_cosine(1e-2, 2, 20)),
            "adafactor": lambda m: m.adafactor(m.warmup_cosine(1e-2, 2,
                                                               20))}[name]
    ropt, opt = make(roptim), make(optim)
    jp, tp = _to_jax(t), _to_torch(t)
    js, ts = ropt.init(jp), opt.init(tp)
    for i, g in enumerate(grads):
        jp, js = ropt.update(_to_jax(g), js, jp, jnp.asarray(i, jnp.int32))
        tp, ts = opt.update(_to_torch(g), ts, tp,
                            torch.tensor(i, dtype=torch.int32))
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
        for a, b in zip(tree_leaves(ts), jax.tree.leaves(js)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_works_in_place(name):
    """``update`` writes the new parameters and state into the tensors it
    is given and returns those same objects (no second copy of a model's
    parameters or moments); a bf16 parameter stays bf16."""
    rng = np.random.default_rng(2)
    opt = optim.get_optimizer(name, lr=0.1, warmup=1, total=10)
    params = _to_torch(_tree(rng))
    params["layers"][0]["w"] = params["layers"][0]["w"].to(torch.bfloat16)
    state = opt.init(params)
    p_ptrs = [x.data_ptr() for x in tree_leaves(params)]
    s_ptrs = [x.data_ptr() for x in tree_leaves(state)]
    old = [x.clone() for x in tree_leaves(params)]
    g = _to_torch(_tree(rng))
    new_p, new_s = opt.update(g, state, params, torch.tensor(3))
    assert new_p is params and new_s is state
    assert [x.data_ptr() for x in tree_leaves(new_p)] == p_ptrs
    assert [x.data_ptr() for x in tree_leaves(new_s)] == s_ptrs
    assert all(not torch.equal(a, b) for a, b in zip(old, tree_leaves(new_p)))
    assert params["layers"][0]["w"].dtype == torch.bfloat16


# -- mirrors of tests/test_substrates.py ------------------------------------
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_descends_quadratic(name):
    opt = optim.get_optimizer(name, lr=0.1, warmup=1, total=200)
    params = {"w": torch.ones((8, 4)) * 3.0, "b": torch.ones((4,)) * -2.0}
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    l0 = float(loss(params))
    for step in range(60):
        for p in params.values():
            p.requires_grad_(True)
        gs = torch.autograd.grad(loss(params), list(params.values()))
        g = dict(zip(params, gs))
        params, state = opt.update(g, state, params,
                                   torch.tensor(step, dtype=torch.int32))
    assert float(loss(params).detach()) < 0.05 * l0


def test_adafactor_state_is_factored():
    opt = optim.adafactor(optim.warmup_cosine(1e-3, 10, 100))
    params = {"w": torch.ones((64, 32))}
    st = opt.init(params)
    assert st["w"]["vr"].shape == (64,)
    assert st["w"]["vc"].shape == (32,)


def test_get_optimizer_refuses_unknown():
    with pytest.raises(ValueError):
        optim.get_optimizer("sgd")


def test_tree_helpers_keep_the_reference_leaf_order():
    """Dict keys in sorted order and list items in order, as
    ``jax.tree.leaves``; ``tree_unflatten`` inverts ``tree_leaves``."""
    rng = np.random.default_rng(3)
    t = _tree(rng)
    got = [x.numpy() for x in tree_leaves(_to_torch(t))]
    want = jax.tree.leaves(t)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    tt = _to_torch(t)
    back = optim.tree_unflatten(tt, [x + 1 for x in tree_leaves(tt)])
    for a, b in zip(tree_leaves(back), tree_leaves(tt)):
        assert torch.equal(a, b + 1)


def test_adafactor_updates_stacked_groups_as_the_reference_array():
    """Leaves the reference stacks into one array (a layer's vector and
    matrix over 3 periods) updated through ``stacks`` equal the reference's
    Adafactor on the stacked arrays: the vectors factored as a (3, d)
    matrix, the update's RMS clipped over the whole array."""
    rng = np.random.default_rng(4)
    vec = rng.standard_normal((3, 6)).astype(np.float32)
    mat = rng.standard_normal((3, 6, 5)).astype(np.float32)
    grads = [(rng.standard_normal((3, 6)).astype(np.float32),
              rng.standard_normal((3, 6, 5)).astype(np.float32))
             for _ in range(4)]
    sched = (roptim.warmup_cosine(1e-2, 2, 20),
             optim.warmup_cosine(1e-2, 2, 20))
    ropt = roptim.adafactor(sched[0])
    layers = [{"m": torch.tensor(mat[i]), "v": torch.tensor(vec[i])}
              for i in range(3)]
    params = {"layers": layers}
    # tree_leaves order: layer 0's m, v, layer 1's m, v, ...
    stacks = lambda p: [(True, [0, 2, 4]), (True, [1, 3, 5])]  # noqa: E731
    opt = optim.adafactor(sched[1], stacks=stacks)
    jp = {"m": jnp.asarray(mat), "v": jnp.asarray(vec)}
    js, ts = ropt.init(jp), opt.init(params)
    assert ts["layers"][0]["v"]["vc"].shape == (6,)
    for i, (gv, gm) in enumerate(grads):
        jp, js = ropt.update({"m": jnp.asarray(gm), "v": jnp.asarray(gv)},
                             js, jp, jnp.asarray(i, jnp.int32))
        g = {"layers": [{"m": torch.tensor(gm[j]), "v": torch.tensor(gv[j])}
                        for j in range(3)]}
        params, ts = opt.update(g, ts, params, torch.tensor(i))
        for j in range(3):
            np.testing.assert_allclose(params["layers"][j]["m"].numpy(),
                                       np.asarray(jp["m"][j]), rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(params["layers"][j]["v"].numpy(),
                                       np.asarray(jp["v"][j]), rtol=1e-5,
                                       atol=1e-7)
