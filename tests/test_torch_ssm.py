"""The port's SSM and hybrid LMs against the JAX package's, on the
falcon-mamba-7B and zamba2-2.7B smoke configs, with the JAX init's
parameters carried across as numpy; and the serving engine on both,
token for token against the JAX engine."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import LM as JaxLM  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

ARCHS = ["falcon_mamba_7b", "zamba2_2_7b"]
# relative max error: f32 up to summation order; bf16 as tests/test_models.py
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# S <= 256: the JAX selective_scan's h_final is right only for S <= 256
# or a multiple of 256 (ROADMAP.md Queue 3)
B, S, MAX_LEN, STEPS = 2, 12, 20, 3


def _rel(port, ref):
    port = port.float().numpy()
    ref = np.asarray(ref, np.float32)
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-9)


def _setup(arch, dtype, seed=0):
    over = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = replace(jax_get_config(arch).smoke(), **over)
    cfg = replace(get_config(arch).smoke(), **over)
    tree = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(seed)))
    return (JaxLM(jcfg), jax.tree.map(jnp.asarray, tree),
            LM(cfg, device="cpu"), params_from_numpy(tree, "cpu"))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape, dtype=np.int32)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    jlm, jparams, lm, params = _setup(arch, dtype)
    toks = _tokens(lm.cfg, (B, S + STEPS))
    jcache, jlogits = jlm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])}, MAX_LEN)
    cache, logits = lm.prefill(params, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                               MAX_LEN)
    assert set(cache) == set(jcache)
    assert _rel(logits, jlogits) < TOL[dtype]
    for key in cache:
        if key == "len":
            continue
        assert cache[key].shape == jcache[key].shape, key
        assert str(cache[key].dtype).removeprefix("torch.") == str(jcache[key].dtype), key
        assert _rel(cache[key], jcache[key]) < TOL[dtype], key
    assert int(cache["len"]) == int(jcache["len"]) == S

    for i in range(STEPS):
        tok = toks[:, S + i]
        jcache, jlogits = jlm.decode_step(jparams, jcache, jnp.asarray(tok))
        cache, logits = lm.decode_step(params, cache, torch.from_numpy(tok).long())
        assert logits.dtype == torch.float32 and logits.shape == (B, lm.cfg.padded_vocab)
        assert _rel(logits, jlogits) < TOL[dtype], i
        for key in cache:
            if key != "len":
                assert _rel(cache[key], jcache[key]) < TOL[dtype], (i, key)
    assert int(cache["len"]) == S + STEPS


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch, dtype):
    jlm, jparams, lm, params = _setup(arch, dtype, seed=2)
    toks = _tokens(lm.cfg, (B, 16), seed=3)
    labels = _tokens(lm.cfg, (B, 16), seed=4)
    jx, jaux = jlm.forward(jparams, {"tokens": jnp.asarray(toks)}, remat=False)
    x, aux = lm.forward(params, {"tokens": torch.from_numpy(toks).long()}, remat=False)
    assert _rel(x, jx) < TOL[dtype]
    assert float(aux) == float(jaux) == 0.0
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}
    jloss = float(jlm.loss(jparams, jbatch, loss_chunk=8))
    loss = lm.loss(params, batch, loss_chunk=8)
    assert abs(float(loss) - jloss) / abs(jloss) < TOL[dtype]
    # on the CPU the scan is the plain version, so the loss is differentiable
    leaves = [params["blocks"]["in_proj"], params["blocks"]["A_log"]]
    for leaf in leaves:
        leaf.requires_grad_(True)
    grads = torch.autograd.grad(lm.loss(params, batch, loss_chunk=8), leaves)
    assert all(bool(torch.isfinite(g).all()) and g.abs().max() > 0 for g in grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_tree(arch):
    jcfg = jax_get_config(arch).smoke()
    jtree = JaxLM(jcfg).init(jax.random.PRNGKey(0))
    params = LM(get_config(arch).smoke(), device="cpu").init(seed=0)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    ours = {f"{k}/{kk}" if isinstance(v, dict) else k: vv
            for k, v in params.items()
            for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)])}
    assert set(flat) == set(ours)
    for key, leaf in flat.items():
        assert tuple(ours[key].shape) == leaf.shape, key
        assert str(ours[key].dtype).removeprefix("torch.") == str(leaf.dtype), key
    # the deterministic leaves are the JAX init's, value for value
    for key in ("blocks/A_log", "blocks/D", "blocks/dt_bias", "blocks/ln"):
        np.testing.assert_array_equal(ours[key].float().numpy(),
                                      np.asarray(flat[key], np.float32))


def test_decode_after_a_ragged_prefill_matches_forward():
    """prefill(S) + decode(token S) == forward(S+1) at S = 300, which is not
    a multiple of 256: the prefill's SSM cache is the state after the last
    prompt token."""
    cfg = replace(get_config("falcon_mamba_7b").smoke(), param_dtype="float32",
                  compute_dtype="float32")
    lm = LM(cfg, device="cpu")
    params = lm.init(seed=5)
    toks = torch.from_numpy(_tokens(cfg, (1, 301), seed=6)).long()
    x, _ = lm.forward(params, {"tokens": toks}, remat=False)
    full = (x[:, 300] @ lm.lm_head(params)).float()
    cache, _ = lm.prefill(params, {"tokens": toks[:, :300]}, max_len=304)
    _, dec = lm.decode_step(params, cache, toks[:, 300])
    assert ((full - dec).abs().max() / full.abs().max()).item() < 1e-5


# At the default init scale every request repeats one token, which would
# make token equality vacuous; at this scale the tokens vary.
SCALE = 0.5


def _engine_params(arch, seed=0):
    jcfg = replace(jax_get_config(arch).smoke(), param_dtype="float32",
                   compute_dtype="float32")
    shapes = JaxLM(jcfg).abstract_params()
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (SCALE * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _serve(engine, cls):
    rng = np.random.default_rng(1)
    reqs = [cls(rid=i, prompt=rng.integers(1, 128, 4 + i % 3).tolist(),
                max_new_tokens=3 + i % 4) for i in range(5)]
    for r in reqs:
        engine.submit(r)
    return engine.run(), [r.out_tokens for r in reqs]


# falcon: max_batch equal to its conv window K-1 = 3; zamba2 smoke: equal
# to its 2 applications of the shared block -- the engine's splice must
# still find the batch axis
@pytest.mark.parametrize("arch,max_batch", [("falcon_mamba_7b", 3), ("zamba2_2_7b", 2)])
def test_engine_matches_jax_token_for_token(arch, max_batch):
    tree = _engine_params(arch)
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    engine = dict(max_batch=max_batch, max_len=32, prompt_len=6)
    jstats, jtoks = _serve(JaxEngine(replace(jax_get_config(arch).smoke(), **f32),
                                     jax.tree.map(jnp.asarray, tree), **engine), JaxRequest)
    stats, toks = _serve(ServingEngine(replace(get_config(arch).smoke(), **f32),
                                       params_from_numpy(tree, "cpu"), device="cpu",
                                       **engine), Request)
    assert stats == jstats
    assert stats["completed"] == 5
    assert toks == jtoks
    assert len({t for seq in toks for t in seq}) > 3, toks
