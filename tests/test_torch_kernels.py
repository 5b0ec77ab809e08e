"""The plain versions of the port's attention kernels against the JAX
package: the Pallas kernels in interpret mode and the jnp layers.  The
CUDA kernels themselves are held against these plain versions on the GPU
by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

# the JAX kernel tests' shapes and tolerances (tests/test_kernels.py)
FA_SHAPES = [
    # (B, S, T, Hq, Hkv, D, bq, bk)
    (1, 64, 64, 1, 1, 32, 32, 32),
    (2, 128, 128, 4, 2, 64, 64, 64),
    (1, 100, 100, 8, 8, 64, 64, 64),
    (2, 64, 192, 4, 1, 48, 32, 64),
]
DEC_SHAPES = [
    # (B, T, Hq, Hkv, D, bk)
    (1, 128, 1, 1, 32, 64),
    (2, 256, 4, 2, 64, 128),
    (3, 300, 8, 4, 48, 128),
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(seed, dtype, *shapes):
    """The same values for both frameworks: f32 numpy, each side rounding
    to ``dtype`` the same way (round to nearest even)."""
    tdt, jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a).astype(jdt) for a in arrs])


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FA_SHAPES)
def test_flash_plain_matches_jax(shape, causal, dtype):
    b, s, t, hq, hkv, d, bq, bk = shape
    tol = DTYPES[dtype][2]
    (q, k, v), (jq, jk, jv) = _inputs(0, dtype, (b, s, hq, d), (b, t, hkv, d),
                                      (b, t, hkv, d))
    if causal and s != t:
        # top-left vs bottom-right alignment: held against the jnp layer
        # only, with the query block placed at the end of the keys
        off = t - s
        _close(flash_attention(q, k, v, causal=True, q_offset=off),
               jl.blocked_attention(jq, jk, jv, causal=True, q_offset=off), tol)
        return
    o = flash_attention(q, k, v, causal=causal)
    _close(o, jl.blocked_attention(jq, jk, jv, causal=causal), tol)
    _close(o, ops.flash_attention(jq, jk, jv, causal=causal, bq=bq, bk=bk,
                                  interpret=True), tol)


def test_flash_plain_lse_matches_jax():
    (q, k, v), (jq, jk, jv) = _inputs(1, "float32", (2, 40, 4, 32), (2, 40, 2, 32),
                                      (2, 40, 2, 32))
    _, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    kx, vx = jl._expand_kv(jk, 4), jl._expand_kv(jv, 4)
    _, jlse = jl._flash_core(jq, kx, vx, True, 0, 512)
    _close(lse, jlse, 2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", DEC_SHAPES)
def test_decode_plain_matches_jax(shape, dtype):
    b, t, hq, hkv, d, bk = shape
    tol = DTYPES[dtype][2]
    (q, k, v), (jq, jk, jv) = _inputs(2, dtype, (b, 1, hq, d), (b, t, hkv, d),
                                      (b, t, hkv, d))
    for length in (1, t // 2, t - 1):
        o = decode_attention(q, k, v, torch.tensor(length, dtype=torch.int32))
        _close(o, jl.decode_attention(jq, jk, jv, length), tol)
        _close(o, ops.decode_attention(jq, jk, jv, jnp.int32(length), bk=bk,
                                       interpret=True), tol)
    # one length per batch row (layers.decode_attention's (B,) form)
    lengths = np.array([t - 1 - 37 * i for i in range(b)], np.int32)
    _close(decode_attention(q, k, v, torch.from_numpy(lengths)),
           jl.decode_attention(jq, jk, jv, jnp.asarray(lengths)), tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_kv_len_masks_the_tail(causal):
    """Keys at or past kv_len are masked: the same as cutting them off."""
    (q, k, v), _ = _inputs(3, "float32", (2, 48, 4, 32), (2, 80, 2, 32), (2, 80, 2, 32))
    o, lse = flash_attention(q, k, v, causal=causal, q_offset=10, kv_len=50,
                             return_lse=True)
    o_cut, lse_cut = flash_attention(q, k[:, :50], v[:, :50], causal=causal,
                                     q_offset=10, return_lse=True)
    torch.testing.assert_close(o, o_cut, atol=2e-6, rtol=2e-6)
    torch.testing.assert_close(lse, lse_cut, atol=2e-6, rtol=2e-6)
