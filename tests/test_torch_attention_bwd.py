"""The port's flash-attention backward against the JAX package: its plain
version and the autograd path of ``layers.blocked_attention`` against
``jax.grad`` of the jnp layer (whose custom VJP is ``_flash_bwd``) and
against the Pallas backward kernel in interpret mode.  The CUDA kernel
itself is held against the plain version on the GPU by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels.flash_attention import check_rows, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import (  # noqa: E402
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from repro_torch.models import layers as tl  # noqa: E402

# (B, S, T, Hq, Hkv, D): the JAX backward tests' shapes, a cross length and
# head dim 16
SHAPES = [(2, 64, 64, 4, 2, 32), (1, 96, 96, 8, 8, 64), (2, 64, 192, 4, 1, 48),
          (2, 64, 64, 4, 2, 16)]       # head dim 16: every smoke config's
# atol = rtol: the JAX VJP test's 1e-4/1e-3 for f32 (tests/test_kernels.py:
# 152-168); 2e-2 for bf16, where JAX rounds each query head's dk/dv to bf16
# before the GQA sum and the port sums in f32 and rounds once
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4, 1e-3),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2, 2e-2)}
KERNEL_TOL = 5e-4     # the Pallas backward kernel test's tolerance


def _cases():
    for shape in SHAPES:
        for causal in (True, False):
            if causal and shape[1] != shape[2]:
                continue          # the cross-length case is non-causal
            for dtype in DTYPES:
                yield pytest.param(shape, causal, dtype,
                                   id=f"{'x'.join(map(str, shape))}-"
                                      f"{'causal' if causal else 'full'}-{dtype}")


def _inputs(seed, shape, dtype):
    b, s, t, hq, hkv, d = shape
    tdt, jdt = DTYPES[dtype][:2]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, hq, d))]
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a).astype(jdt) for a in arrs])


def _jax_grads(jq, jk, jv, jdo, causal):
    f = lambda q, k, v: (jl.blocked_attention(q, k, v, causal=causal)
                         .astype(jnp.float32) * jdo.astype(jnp.float32)).sum()
    return jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)


def _close(port, ref, atol, rtol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("shape,causal,dtype", list(_cases()))
def test_bwd_plain_matches_jax_grad(shape, causal, dtype):
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(0, shape, dtype)
    _, _, atol, rtol = DTYPES[dtype]
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd_plain(q, k, v, o, do, lse, causal)
    for g, want, x in zip(got, _jax_grads(jq, jk, jv, jdo, causal), (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        _close(g, want, atol, rtol)


@pytest.mark.parametrize("shape,causal,dtype", list(_cases()))
def test_blocked_attention_autograd_matches_jax_grad(shape, causal, dtype):
    """The model's path: the autograd Function around both wrappers."""
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(1, shape, dtype)
    _, _, atol, rtol = DTYPES[dtype]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tl.blocked_attention(*leaves, causal=causal)
    _close(out.detach(), jl.blocked_attention(jq, jk, jv, causal=causal), atol, rtol)
    out.backward(do)
    for x, want in zip(leaves, _jax_grads(jq, jk, jv, jdo, causal)):
        _close(x.grad, want, atol, rtol)


def test_autograd_takes_a_strided_gradient(monkeypatch):
    """The gradient autograd hands over may be a strided view (here a
    broadcast one, stride 0); the Function makes it contiguous before
    the kernel's wrapper, which would refuse it on the GPU, sees it."""
    (q, k, v, _), _ = _inputs(2, (1, 16, 16, 4, 2, 32), "float32")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tl.blocked_attention(*leaves, causal=True)
    seen, orig = [], tl._flash_bwd_kernel

    def spy(*args):
        seen.append(args[4].is_contiguous())
        return orig(*args)

    monkeypatch.setattr(tl, "_flash_bwd_kernel", spy)
    out.transpose(1, 2).sum().backward()
    assert seen == [True]
    assert all(torch.isfinite(x.grad).all() for x in leaves)


def test_autograd_takes_a_misaligned_gradient(monkeypatch):
    """A contiguous gradient whose data starts one element past a 4-element
    boundary is copied before the kernel's wrapper sees it, and gives the
    same gradients as the aligned one."""
    shape = (1, 16, 16, 4, 2, 32)
    (q, k, v, do), _ = _inputs(3, shape, "float32")
    base = torch.empty(do.numel() + 1, dtype=do.dtype)
    misaligned = base[1:].view(do.shape).copy_(do)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % (4 * do.element_size())
    with pytest.raises(ValueError, match="4-aligned"):
        check_rows("do", misaligned)
    seen, orig = [], tl._flash_bwd_kernel

    def spy(*args):
        check_rows("do", args[4])          # the GPU wrapper's test; raises on refusal
        seen.append(args[4].data_ptr())
        return orig(*args)

    monkeypatch.setattr(tl, "_flash_bwd_kernel", spy)
    grads = []
    for g in (misaligned, do):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        tl.blocked_attention(*leaves, causal=True).backward(g)
        grads.append([x.grad for x in leaves])
    # the misaligned gradient was copied, the aligned one read in place
    assert seen[0] != misaligned.data_ptr() and seen[1] == do.data_ptr()
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_bwd_q_offset_matches_masked_reference():
    """q_offset shifts the top-left causal mask as in the forward; held
    against autograd of a dense masked softmax in f64."""
    b, s, t, hq, hkv, d, off = 1, 12, 20, 4, 2, 32, 5
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh))
                   for sh in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, hq, d)))
    o, lse = flash_attention(q.float(), k.float(), v.float(), causal=True, q_offset=off,
                             return_lse=True)
    got = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o, do.float(), lse,
                                    True, q_offset=off)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    kx, vx = (x.repeat_interleave(hq // hkv, dim=2) for x in leaves[1:])
    logits = torch.einsum("bshd,bthd->bhst", leaves[0], kx) / np.sqrt(d)
    mask = torch.arange(t)[None, :] <= off + torch.arange(s)[:, None]
    p = torch.softmax(logits.masked_fill(~mask, -torch.inf), dim=-1)
    torch.einsum("bhst,bthd->bshd", p, vx).backward(do)
    for g, x in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), x.grad.numpy(), atol=1e-5, rtol=1e-4)


def test_bwd_plain_matches_pallas_kernel_interpret():
    """Against the Pallas backward kernel (interpret mode) on the same
    q, k, v, o, do and lse; non-causal, as in tier 1 of the JAX tests."""
    shape = (2, 64, 64, 4, 2, 32)
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(4, shape, "float32")
    o, lse = flash_attention(q, k, v, causal=False, return_lse=True)
    want = ops.flash_attention_bwd(jq, jk, jv, jnp.asarray(o.numpy()), jdo,
                                   jnp.asarray(lse.numpy()), causal=False, bq=32, bk=32,
                                   interpret=True)
    for g, w in zip(flash_attention_bwd_plain(q, k, v, o, do, lse, False), want):
        _close(g, w, KERNEL_TOL, KERNEL_TOL)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    (q, k, v, do), _ = _inputs(5, (1, 16, 24, 4, 1, 32), "float32")
    o, lse = flash_attention(q, k, v, causal=False, return_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse, False)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert flash_attention_bwd.launches == before     # counts kernel launches only
