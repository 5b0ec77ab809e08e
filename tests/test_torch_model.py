"""The port's dense LM against the JAX package's, on the qwen2-0.5B
smoke config, with the JAX init's parameters carried across as numpy."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import LM as JaxLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402

# relative max error: f32 up to summation order; bf16 as tests/test_models.py
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S, MAX_LEN, STEPS = 2, 12, 20, 3


def _rel(port, ref):
    port = port.float().numpy()
    ref = np.asarray(ref, np.float32)
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-9)


def _configs(dtype):
    over = dict(param_dtype=dtype, compute_dtype=dtype)
    return (replace(jax_get_config("qwen2_0_5b").smoke(), **over),
            replace(get_config("qwen2_0_5b").smoke(), **over))


def _params(jcfg, seed=0):
    """JAX init -> numpy, with the zero-initialised QKV biases given
    values so the bias path is exercised."""
    tree = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        a = tree["blocks"][name]
        tree["blocks"][name] = (a.astype(np.float32)
                                + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype)
    return tree


@pytest.mark.parametrize("dtype", list(TOL))
def test_prefill_and_decode_match_jax(dtype):
    jcfg, cfg = _configs(dtype)
    tree = _params(jcfg)
    jlm, lm = JaxLM(jcfg), LM(cfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(tree, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + STEPS), dtype=np.int32)

    jcache, jlogits = jlm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])}, MAX_LEN)
    cache, logits = lm.prefill(params, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                               MAX_LEN)
    assert _rel(logits, jlogits) < TOL[dtype]
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        assert _rel(cache[key], jcache[key]) < TOL[dtype]
    assert int(cache["len"]) == int(jcache["len"]) == S

    for i in range(STEPS):
        tok = toks[:, S + i]
        jcache, jlogits = jlm.decode_step(jparams, jcache, jnp.asarray(tok))
        cache, logits = lm.decode_step(params, cache, torch.from_numpy(tok).long())
        assert logits.dtype == torch.float32 and logits.shape == (B, cfg.padded_vocab)
        assert _rel(logits, jlogits) < TOL[dtype], i
        assert _rel(cache["k"], jcache["k"]) < TOL[dtype], i
    assert int(cache["len"]) == S + STEPS


@pytest.mark.parametrize("dtype", list(TOL))
def test_decode_matches_forward(dtype):
    """prefill(S) + decode(token S) == forward(S+1) last logits."""
    jcfg, cfg = _configs(dtype)
    lm = LM(cfg, device="cpu")
    params = params_from_numpy(_params(jcfg, seed=2), "cpu")
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (B, S + 1))).long()
    x, _ = lm.forward(params, {"tokens": toks}, remat=False)
    full = (x[:, S] @ lm.lm_head(params)).float()
    cache, _ = lm.prefill(params, {"tokens": toks[:, :S]}, max_len=S + 4)
    _, dec = lm.decode_step(params, cache, toks[:, S])
    rel = ((full - dec).abs().max() / full.abs().max()).item()
    assert rel < TOL[dtype], rel


def test_init_shapes_match_jax_tree():
    jcfg, cfg = _configs("bfloat16")
    jtree = JaxLM(jcfg).abstract_params()
    params = LM(cfg, device="cpu").init(seed=0)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    ours = {f"{k}/{kk}" if isinstance(v, dict) else k: vv
            for k, v in params.items()
            for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)])}
    assert set(flat) == set(ours)
    for key, leaf in flat.items():
        assert tuple(ours[key].shape) == tuple(leaf.shape), key
        assert ours[key].dtype == torch.bfloat16, key
