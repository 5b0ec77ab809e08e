"""The port's dense layers against the JAX package's, at f32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = 1e-6


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol, rtol=tol)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 64), _rand(rng, 64)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("style", ["full", "half"])
@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_rope(style, theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 32)
    pos = np.arange(5, 12, dtype=np.int32)
    np.testing.assert_array_equal(tl.rope_freqs(32, theta, style),
                                  jl.rope_freqs(32, theta, style))
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, style),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, style))


@pytest.mark.parametrize("hq,hkv", [(4, 1), (6, 2), (4, 4)])
def test_expand_kv(hq, hkv):
    rng = np.random.default_rng(2)
    k = _rand(rng, 2, 5, hkv, 8)
    out = tl._expand_kv(torch.from_numpy(k), hq)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jl._expand_kv(jnp.asarray(k), hq)))


def test_swiglu():
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 5, 16)
    wg, wu, wd = _rand(rng, 16, 24) * 0.3, _rand(rng, 16, 24) * 0.3, _rand(rng, 24, 16) * 0.3
    _close(tl.swiglu(*map(torch.from_numpy, (x, wg, wu, wd))),
           jl.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))
