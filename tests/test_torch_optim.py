"""The port's AdamW, clipping and schedule against the JAX package's."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import LM as JaxLM  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import clip_by_global_norm as jax_clip  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import AdamW, OptState, clip_by_global_norm, cosine_schedule  # noqa: E402
from repro_torch.tree import flatten_with_keys  # noqa: E402

# f32 to a few ulps (the schedule and bias corrections are f32 on both
# sides); bf16 parameters and moments round once more
TOL = {"float32": 1e-6, "bfloat16": 1e-2}


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_close(port_tree, jax_tree, tol):
    want, got = _flat_jax(jax_tree), dict(flatten_with_keys(port_tree))
    assert set(got) == set(want)
    for key, leaf in want.items():
        ref = np.asarray(leaf, np.float32)
        assert got[key].dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                                  "int32": torch.int32}[str(leaf.dtype)], key
        np.testing.assert_allclose(got[key].float().numpy(), ref, atol=tol, rtol=tol,
                                   err_msg=key)


def test_adamw_converges_quadratic():
    """tests/test_substrate.py::test_adamw_converges_quadratic, in the port."""
    opt = AdamW(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=200)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    loss = lambda p: ((p["w"] - 1.0) ** 2).sum()
    for _ in range(150):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state, _ = opt.update({"w": g}, state, params)
    assert float(loss(params)) < 1e-2


@pytest.mark.parametrize("max_norm", [1.0, 50.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32) * 10,
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    clipped, norm = clip_by_global_norm(params_from_numpy(tree, "cpu"), max_norm)
    jclipped, jnorm = jax_clip(jax.tree.map(jnp.asarray, tree), max_norm)
    assert abs(float(norm) - float(jnorm)) < 1e-5 * float(jnorm)
    _assert_close(clipped, jclipped, 1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 20), (0, 5)])
def test_cosine_schedule_matches_jax(warmup, total):
    lr, jlr = cosine_schedule(3e-4, warmup, total), jax_cosine(3e-4, warmup, total)
    for step in (0, 1, warmup, warmup + 1, total // 2, total - 1, total, total + 7):
        got = lr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(jlr(step)), rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_leaf_by_leaf(dtype, moments):
    """Three updates of the smoke LM's parameters with the same gradients
    on both sides (the default eps and weight decay, clipping active)."""
    cfg = replace(jax_get_config("qwen2_0_5b").smoke(), param_dtype=dtype)
    tree = jax.tree.map(np.asarray, JaxLM(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, moment_dtype=moments)
    opt, jopt = AdamW(**kw), JaxAdamW(**kw)
    params, jparams = params_from_numpy(tree, "cpu"), jax.tree.map(jnp.asarray, tree)
    state, jstate = opt.init(params), jopt.init(jparams)
    assert isinstance(state, OptState) and state.step.dtype == torch.int32
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: (0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)
        params, state, gnorm = opt.update(params_from_numpy(grads, "cpu"), state, params)
        jparams, jstate, jgnorm = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                              jparams)
        assert abs(float(gnorm) - float(jgnorm)) < 1e-5 * float(jgnorm)
    assert int(state.step) == int(jstate.step) == 3
    tol = max(TOL[dtype], TOL[moments])
    _assert_close(params, jparams, tol)
    _assert_close(state.m, jstate.m, tol)
    _assert_close(state.v, jstate.v, tol)
