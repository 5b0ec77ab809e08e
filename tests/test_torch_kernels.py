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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    KEY_TILE,
    MAX_SPLITS,
    decode_attention,
    decode_splits,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS,
    check_rows,
    flash_attention,
    readable_rows,
)

# the JAX kernel tests' shapes and tolerances (tests/test_kernels.py)
FA_SHAPES = [
    # (B, S, T, Hq, Hkv, D, bq, bk)
    (1, 64, 64, 1, 1, 32, 32, 32),
    (2, 128, 128, 4, 2, 64, 64, 64),
    (1, 100, 100, 8, 8, 64, 64, 64),
    (2, 64, 192, 4, 1, 48, 32, 64),
    (2, 64, 64, 4, 2, 16, 32, 32),      # head dim 16: every smoke config's
]
DEC_SHAPES = [
    # (B, T, Hq, Hkv, D, bk)
    (1, 128, 1, 1, 32, 64),
    (2, 256, 4, 2, 64, 128),
    (3, 300, 8, 4, 48, 128),
    (2, 128, 4, 2, 16, 64),             # head dim 16
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


def test_flash_plain_lse_matches_jax_at_head_dim_16():
    (q, k, v), (jq, jk, jv) = _inputs(4, "float32", (2, 40, 4, 16), (2, 40, 2, 16),
                                      (2, 40, 2, 16))
    _, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    kx, vx = jl._expand_kv(jk, 4), jl._expand_kv(jv, 4)
    _, jlse = jl._flash_core(jq, kx, vx, True, 0, 512)
    _close(lse, jlse, 2e-5)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "zamba2_2_7b"])
def test_smoke_configs_have_a_head_dim_the_kernels_take(arch):
    """The examples and launchers run the smoke configs on the card."""
    assert get_config(arch).smoke().hd in HEAD_DIMS


@pytest.mark.parametrize("b,t,hkv,sms,want", [
    (4, 512, 2, 132, 16),      # qwen2-0.5B's serve shape: 8 (KV head, row) pairs
    (4, 512, 32, 132, 1),      # zamba2-2.7B's: 128 pairs fill the card alone
    (1, 64, 1, 132, 2),        # at most one split per tile of 32 rows
    (1, 8192, 1, 132, 16),     # at most 16 splits (one cluster)
    (64, 512, 8, 132, 1),      # never below 1
])
def test_decode_splits_depends_on_shapes_alone(b, t, hkv, sms, want):
    n = decode_splits(b, t, hkv, sms)
    assert n == want
    tiles = -(-t // KEY_TILE)
    assert 1 <= n <= min(tiles, MAX_SPLITS)
    # within one block per SM, and no more splits would be
    assert n == 1 or n * b * hkv <= sms
    assert n in (tiles, MAX_SPLITS) or (n + 1) * b * hkv > sms


def test_rows_need_16_byte_alignment():
    """The kernels copy rows 16 bytes at a time: a bf16 row start 4- but not
    8-aligned is refused by the GPU check and copied by readable_rows."""
    base = torch.zeros(2 * 4 * 16 + 4, dtype=torch.bfloat16)
    x = base[4:].view(1, 2, 4, 16)
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError, match="16 bytes"):
        check_rows("x", x)
    y = readable_rows(x)
    check_rows("y", y)
    assert torch.equal(x, y)


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
