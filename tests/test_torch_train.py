"""The port's training path against the JAX package's on the qwen2-0.5B
smoke config, with the JAX init's parameters carried across as numpy:
``LM.forward``, ``LM.loss`` and its gradients, and ``make_train_step``
with and without microbatches."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import TokenDataset as JaxTokenDataset  # noqa: E402
from repro.models.transformer import LM as JaxLM  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_keys, leaves, unflatten_like  # noqa: E402

# loss: absolute; hidden states, gradients and parameters: max error over
# the leaf's max magnitude.  f32 differs only by summation order; bf16 as
# tests/test_models.py (5e-2)
LOSS_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
REL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S, CHUNK = 2, 16, 8


def _configs(dtype):
    over = dict(param_dtype=dtype, compute_dtype=dtype)
    return (replace(jax_get_config("qwen2_0_5b").smoke(), **over),
            replace(get_config("qwen2_0_5b").smoke(), **over))


def _setup(dtype, seed=0, batch=B):
    """(JAX LM, port LM, JAX params, port params, JAX batch, port batch).
    The zero-initialised QKV biases get values so their gradient path is
    exercised."""
    jcfg, cfg = _configs(dtype)
    tree = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        a = tree["blocks"][name]
        tree["blocks"][name] = (a.astype(np.float32)
                                + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype)
    data = JaxTokenDataset(jcfg, seq_len=S, global_batch=batch, seed=seed).get_batch(0)
    return (JaxLM(jcfg), LM(cfg, device="cpu"), jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"),
            {k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.from_numpy(v) for k, v in data.items()})


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(port, ref):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port - ref).max() / (np.abs(ref).max() + 1e-12))


def _assert_trees_close(port_tree, jax_tree, tol):
    want = _flat_jax(jax_tree)
    got = dict(flatten_with_keys(port_tree))
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert tuple(got[key].shape) == tuple(leaf.shape), key
        assert _rel(got[key], leaf) < tol, (key, _rel(got[key], leaf))


def _port_value_and_grad(lm, params, batch, remat):
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = lm.loss(unflatten_like(params, flat), batch, remat=remat, loss_chunk=CHUNK)
    return loss, unflatten_like(params, list(torch.autograd.grad(loss, flat)))


def _assert_loss_close(got, want, dtype):
    """f32: absolute; bf16: relative."""
    scale = abs(float(want)) if dtype == "bfloat16" else 1.0
    assert abs(float(got) - float(want)) < LOSS_TOL[dtype] * scale, (float(got), float(want))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("dtype", list(REL_TOL))
def test_forward_returns_x_and_aux_matching_jax(dtype, remat):
    jlm, lm, jparams, params, jbatch, batch = _setup(dtype)
    jx, jaux = jlm.forward(jparams, jbatch, remat=remat)
    x, aux = lm.forward(params, batch, remat=remat)
    assert x.shape == jx.shape and x.dtype == params["emb"].dtype
    assert _rel(x, jx) < REL_TOL[dtype]
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("dtype", list(REL_TOL))
def test_loss_and_grads_match_jax(dtype):
    jlm, lm, jparams, params, jbatch, batch = _setup(dtype)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.loss(p, jbatch, loss_chunk=CHUNK))(jparams)
    loss, grads = _port_value_and_grad(lm, params, batch, remat=True)
    assert loss.dtype == torch.float32
    _assert_loss_close(loss.detach(), jloss, dtype)
    _assert_trees_close(grads, jgrads, REL_TOL[dtype])


def test_remat_changes_nothing():
    """Checkpointed layers and chunks recompute exactly what was dropped."""
    _, lm, _, params, _, batch = _setup("float32", seed=1)
    l1, g1 = _port_value_and_grad(lm, params, batch, remat=True)
    l2, g2 = _port_value_and_grad(lm, params, batch, remat=False)
    assert torch.equal(l1, l2)
    for (k, a), (_, b) in zip(flatten_with_keys(g1), flatten_with_keys(g2)):
        assert torch.equal(a, b), k


def test_loss_counts_the_last_label():
    """The last label of each row is 0 and counts like any other: the loss
    is the mean over all B·S positions (no ignore_index)."""
    _, lm, _, params, _, batch = _setup("float32", seed=2)
    assert int(batch["labels"][:, -1].abs().sum()) == 0
    x, _ = lm.forward(params, batch, remat=False)
    logits = (x @ lm.lm_head(params)).float()
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             batch["labels"].reshape(-1).long())
    got = lm.loss(params, batch, loss_chunk=CHUNK)
    assert abs(float(got) - float(want)) < 1e-5


def test_loss_rejects_a_ragged_chunk():
    _, lm, _, params, _, batch = _setup("float32")
    with pytest.raises(ValueError, match="multiple"):
        lm.loss(params, batch, loss_chunk=5)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("dtype", list(REL_TOL))
def test_train_step_matches_jax(dtype, microbatches):
    jlm, lm, jparams, params, jbatch, batch = _setup(dtype, seed=3, batch=4)
    # Adam's first step is lr·g/(|g| + eps): with the default eps it is the
    # sign of g, which flips between two correct implementations wherever
    # g is near 0.  A larger eps makes the step a smooth function of g, so
    # the parameters compare at the gradients' tolerance.  The default eps
    # is held leaf by leaf, on identical gradients, in test_torch_optim.py.
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-2)
    jopt, opt = JaxAdamW(**kw), AdamW(**kw)
    jstep = jax.jit(jax_make_train_step(jlm, jopt, microbatches=microbatches))
    step = make_train_step(lm, opt, microbatches=microbatches)
    jp, jst, jm = jstep(jparams, jopt.init(jparams), jbatch)
    p, st, m = step(params, opt.init(params), batch)
    _assert_loss_close(m["loss"], jm["loss"], dtype)
    assert abs(float(m["gnorm"]) - float(jm["gnorm"])) < REL_TOL[dtype] * float(jm["gnorm"])
    assert int(st.step) == int(jst.step) == 1
    _assert_trees_close(p, jp, REL_TOL[dtype])
    _assert_trees_close(st.m, jst.m, REL_TOL[dtype])
    # the caller's parameters are left as they were and carry no graph
    assert all(not t.requires_grad for _, t in flatten_with_keys(params))


def test_train_step_reduces_loss():
    """tests/test_models.py::test_train_step_reduces_loss, in the port."""
    _, lm, _, params, _, batch = _setup("float32", seed=4)
    opt = AdamW(lr=3e-3, warmup_steps=1, total_steps=20)
    step, state, losses = make_train_step(lm, opt), opt.init(params), []
    for _ in range(8):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
