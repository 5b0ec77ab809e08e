"""The port's serving engine against the JAX package's, token for token,
at f32 with the same parameters."""

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
from repro_torch.serving import Request, ServingEngine  # noqa: E402

F32 = dict(param_dtype="float32", compute_dtype="float32")
ENGINE = dict(max_batch=2, max_len=32, prompt_len=6)
# At the default init scale (0.02) every request repeats one token, which
# would make token equality vacuous; at this scale the tokens vary.
SCALE = 0.5


def _params(seed=0):
    jcfg = replace(jax_get_config("qwen2_0_5b").smoke(), **F32)
    shapes = JaxLM(jcfg).abstract_params()
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (SCALE * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _requests(cls):
    rng = np.random.default_rng(1)
    return [cls(rid=i, prompt=rng.integers(1, 128, 4 + i % 3).tolist(),
                max_new_tokens=3 + i % 4) for i in range(5)]


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return engine.run(), [r.out_tokens for r in reqs]


def test_engine_matches_jax_token_for_token():
    tree = _params()
    jstats, jtoks = _serve(
        JaxEngine(replace(jax_get_config("qwen2_0_5b").smoke(), **F32),
                  jax.tree.map(jnp.asarray, tree), **ENGINE),
        _requests(JaxRequest))
    stats, toks = _serve(
        ServingEngine(replace(get_config("qwen2_0_5b").smoke(), **F32),
                      params_from_numpy(tree, "cpu"), device="cpu", **ENGINE),
        _requests(Request))
    assert stats == jstats
    assert stats["completed"] == 5
    assert toks == jtoks
    assert len({t for seq in toks for t in seq}) > 3, toks


def test_engine_from_seed_is_deterministic():
    cfg = get_config("qwen2_0_5b").smoke()

    def run():
        return _serve(ServingEngine(cfg, seed=1, device="cpu", **ENGINE),
                      _requests(Request))

    (s1, t1), (s2, t2) = run(), run()
    assert s1 == s2 and t1 == t2
    assert s1["completed"] == 5
    assert all(len(t) >= 3 for t in t1)
