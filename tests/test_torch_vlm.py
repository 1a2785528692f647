"""The port's VLM family against the reference package on the same inputs:
the reduced phi-3-vision-4.2b's forward with and without its stub patch
embeddings (``stub_proj`` carried across from the reference's weights),
decode against the forward, the served streams against the reference
Scheduler's, the registry's ``input_specs`` and ``example_batch``, and the
generated attention row kernel at head widths that are not a power of two
(phi-3's Dh 96, kimi-k2's 112) under the CPU emulator. Tolerances: logits
rtol/atol 1e-5 (``tests/test_torch_models.py``'s dense forward), decode
against the forward 2e-3 (``tests/test_models_smoke.py``), the attention
kernel 1e-5 in fp32 and 2^-7 in bf16 (``tests/test_torch_serving.py``).
Everything runs on the CPU; the card runs phi-3 in
``test_torch_gpu.py -k phi3`` and at full width and depth in
``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget_config
from repro.frontends.api import Program as RProgram
from repro.library import PagedAttnDecode as RPagedAttnDecode
from repro.models import example_batch as rexample_batch
from repro.models.registry import input_specs as rinput_specs
from repro.models.transformer import TransformerLM as RTransformerLM
from repro.pipeline import lower as rlower
from repro.pipeline.cache import CompilationCache as RCompilationCache
from repro.serving import Scheduler as RScheduler
from repro_torch import programs
from repro_torch.configs import SHAPES, get_config
from repro_torch.models import (TransformerLM, build_model, example_batch,
                                input_specs, lm_params_from_reference)
from repro_torch.pipeline import lower
from repro_torch.pipeline.cache import CompilationCache
from repro_torch.serving import Scheduler

from test_torch_grid import _emulated_launch

ARCH = "phi-3-vision-4.2b"


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def phi3():
    """(reference model, its PRNGKey(0) params, port model, the same
    params), fp32 activations."""
    rcfg = dataclasses.replace(rget_config(ARCH).reduced(),
                               activation_dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              activation_dtype="float32")
    rmodel, model = RTransformerLM(rcfg), TransformerLM(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = lm_params_from_reference(model, jax.tree.map(np.asarray,
                                                          rparams))
    return rmodel, rparams, model, params


def test_build_model_runs_the_vlm_family():
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    assert isinstance(model, TransformerLM)
    params = model.init(torch.Generator().manual_seed(0))
    assert params["stub_proj"].shape == (cfg.d_model, cfg.d_model)
    batch = {k: torch.as_tensor(v)
             for k, v in example_batch(cfg, "train", 2, 6).items()}
    logits, aux = model.forward(params, batch)
    assert logits.shape == (2, 6, model.vocab_padded)
    assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())
    assert float(aux) == 0.0


def test_stub_proj_carried_from_the_reference(phi3):
    _, rparams, model, params = phi3
    d = model.cfg.d_model
    assert params["stub_proj"].shape == (d, d)
    assert np.array_equal(params["stub_proj"].numpy(),
                          np.asarray(rparams["stub_proj"]))


@pytest.mark.parametrize("stub", [True, False], ids=["stub", "text"])
def test_forward_matches_reference(phi3, stub):
    """Logits of the text positions, the stub embeddings projected and put
    in front of the tokens (and sliced off after the head); without
    ``stub_embeds`` the model reads the text alone, as the reference's."""
    rmodel, rparams, model, params = phi3
    cfg = model.cfg
    batch = example_batch(cfg, "train", 2, 12, seed=3)
    if not stub:
        del batch["stub_embeds"]
    want, _ = rmodel.forward(rparams, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    got, aux = model.forward(params, {k: torch.as_tensor(v)
                                      for k, v in batch.items()})
    assert got.shape == (2, 12, model.vocab_padded)
    assert float(aux) == 0.0
    _close(got, want)
    if stub:
        # the stub positions reach the text: the text alone differs
        text, _ = model.forward(params, {"tokens": torch.as_tensor(
            batch["tokens"])})
        assert float((text - got).abs().max()) > 1e-2


def test_decode_matches_forward(phi3):
    """Text-only decode (the served path) against the text-only forward at
    the reference's 2e-3."""
    _, _, model, params = phi3
    T = 10
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab, (2, T)).astype(np.int32))
    full, _ = model.forward(params, {"tokens": toks})
    cache = model.init_cache(2, 16, dtype=torch.float32)
    outs = []
    for t in range(T):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1])
        outs.append(lg)
    _close(torch.cat(outs, 1), full, 2e-3, 2e-3)


def test_streams_match_reference_scheduler(phi3):
    """test_serving.py:188's geometry (4 requests of 6 in 4 slots, prefill
    chunks of 4): the served step decodes text tokens, as the
    reference's."""
    rmodel, rparams, model, params = phi3
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, 6), 0, model.cfg.vocab))
    kw = dict(max_slots=4, page_size=8, n_pages=32, max_model_len=64,
              prefill_chunk=4)
    rs = RScheduler(rmodel, rparams, compile_cache=RCompilationCache(), **kw)
    s = Scheduler(model, params, device="cpu",
                  compile_cache=CompilationCache(), **kw)
    for sched in (rs, s):
        for p in prompts:
            sched.submit(list(map(int, p)), 5)
    want = [r.tokens_out for r in rs.run()]
    assert [r.tokens_out for r in s.run()] == want
    s.check_invariants()
    for key, step in s.compiler._steps.items():
        assert step.rung == "grid"
        assert step.report["grid_kernels"] == \
            rs.compiler._steps[key].report["grid_kernels"]


# ---------------------------------------------------------------------------
# the registry's inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", [ARCH, "starcoder2-3b",
                                  "seamless-m4t-medium"])
def test_input_specs_match_reference(arch, shape):
    """Names, shapes and dtypes of the reference's stand-ins (a VLM's
    prompt shapes hold S - 576 text tokens); meta tensors, no storage."""
    want = rinput_specs(rget_config(arch), RSHAPES[shape])
    got = input_specs(get_config(arch), SHAPES[shape])
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert all(v.is_meta for v in got.values())
    if arch == ARCH and shape != "decode_32k":
        assert got["tokens"].shape[1] == SHAPES[shape].seq_len - 576
    small = input_specs(get_config(arch), SHAPES[shape], batch_override=3)
    assert {v.shape[0] for v in small.values()} == {3}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("arch", [ARCH, "starcoder2-3b"])
def test_example_batch_matches_reference(arch, seed):
    cfg = get_config(arch).reduced()
    want = rexample_batch(rget_config(arch).reduced(), "train", 2, 9, seed)
    got = example_batch(cfg, "train", 2, 9, seed)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# the generated attention row kernel at head widths not a power of two
# ---------------------------------------------------------------------------
def _rattn_program(B, C, H, Dh):
    p = RProgram("decode_attention")
    q = p.input("q", (B, H, Dh), "float32")
    k = p.input("k", (B, C, H, Dh), "float32")
    v = p.input("v", (B, C, H, Dh), "float32")
    pos = p.input("pos", (B,), "int32")
    out = p.add_op(RPagedAttnDecode("attn0", window=None),
                   {"q": q, "k": k, "v": v, "pos": pos},
                   out_shapes={"out": (B, H, Dh)},
                   out_dtypes={"out": "float32"})
    p.output("out", out)
    return p.finalize()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh", [96, 112])
def test_generated_attention_at_odd_head_width(Dh, dt):
    """The served attention at phi-3's head width (Dh 96) and kimi-k2's
    (112): the generated row kernel's Triton source, whose column range is
    a power of two masked to Dh, under the CPU emulator against the
    reference's plain attention (``PagedAttnDecode`` at its ``xla`` level)
    on the same seeded numpy inputs, bf16 rounded for both; at pos 38 in a
    64-row context (serve_bench's bucket) and at the context's ends."""
    B, C, H = 5, 64, 4
    rng = np.random.default_rng(Dh)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, C, H, Dh)).astype(np.float32)
            for _ in range(2))
    pos = np.array([38, 0, 63, 31, 32], np.int32)
    tdt = getattr(torch, dt)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    sdfg = programs.decode_attention_program(B, C, H, Dh, None, dt)
    c = lower(sdfg).compile("cuda", cache=None, device="cpu")
    assert c.report["grid_kernels"] == ["attn0_grid_tiled"]
    (kernel,) = {id(n.map): n.map.annotations["grid_kernel"]
                 for st in c.sdfg.states for n in st.nodes
                 if "grid_kernel" in getattr(getattr(n, "map", None),
                                             "annotations", {})}.values()
    assert "tl.arange(0, 128)" in kernel.source
    assert f"< {Dh}" in kernel.source
    outs = {"out": torch.zeros(B, H, Dh, dtype=tdt)}
    _emulated_launch(kernel.desc, kernel.source,
                     {"q": tq, "k": tk, "v": tv, "pos": torch.as_tensor(pos)},
                     outs)
    rc = rlower(_rattn_program(B, C, H, Dh)).compile(
        backend="jnp", expansion_level="xla", cache=None)
    want = np.asarray(rc(q=tq.float().numpy(), k=tk.float().numpy(),
                         v=tv.float().numpy(), pos=pos)["out"])
    tol = 2.0 ** -7 if dt == "bfloat16" else 1e-5
    np.testing.assert_allclose(outs["out"].float().numpy(), want, rtol=tol,
                               atol=tol)
