"""The port's selective scan and Mamba layers against the JAX package: the
scan's plain version against the Pallas kernel in interpret mode and the
step-by-step reference, and the conv, scan and decode-step layers against
their jnp counterparts.  The CUDA kernel itself is held against the plain
version on the GPU by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain, softplus  # noqa: E402
from repro_torch.models import layers  # noqa: E402

# the JAX kernel tests' shapes and tolerances (tests/test_kernels.py)
MAMBA_SHAPES = [
    # (Bt, S, Din, N, bd, chunk)
    (1, 32, 16, 4, 16, 8),
    (2, 96, 64, 8, 32, 16),
    (1, 100, 128, 16, 64, 32),
]
ATOL, RTOL = 5e-5, 5e-4


def _scan_inputs(seed, bt, s, din, n, with_h0=False):
    """numpy f32 (x, dt, A, B, C, D[, h0]) at the JAX kernel test's scales,
    with D drawn per channel (the JAX test's ones would not show a D read
    at the wrong channel)."""
    rng = np.random.default_rng(seed)
    g = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    arrs = [0.5 * g(bt, s, din), 0.5 * g(bt, s, din), -np.exp(0.3 * g(din, n)),
            0.5 * g(bt, s, n), 0.5 * g(bt, s, n), 1 + 0.5 * g(din)]
    if with_h0:
        arrs.append(0.5 * g(bt, din, n))
    return arrs


def _close(port, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", MAMBA_SHAPES)
def test_scan_plain_matches_pallas_and_ref(shape, with_h0):
    bt, s, din, n, bd, chunk = shape
    arrs = _scan_inputs(0, bt, s, din, n, with_h0)
    y, h = mamba_scan(*map(torch.from_numpy, arrs))
    y_ref, h_ref = ref.mamba_scan_ref(*map(jnp.asarray, arrs))
    _close(y, y_ref)
    _close(h, h_ref)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    if not with_h0:                       # the Pallas kernel starts from zeros
        _close(y, ops.mamba_scan(*map(jnp.asarray, arrs), bd=bd, chunk=chunk,
                                 interpret=True))


@pytest.mark.parametrize("s", [1, 31, 33])
def test_scan_of_offset_slices_matches_ref(s):
    """x and dt one element into wider rows, B and C strided slices of one
    projection one element past its start (the card's plain-load staging),
    at lengths either side of the kernel's 32-step chunk."""
    bt, din, n = 2, 24, 16
    x, dt, A, B, C, D, h0 = _scan_inputs(1, bt, s, din, n, with_h0=True)
    rng = np.random.default_rng(2)
    wide = lambda a: np.concatenate([rng.standard_normal(a.shape[:-1] + (1,)), a],
                                    axis=-1).astype(np.float32)
    proj = wide(np.concatenate([0.5 * rng.standard_normal((bt, s, n)), B, C], -1))
    x_w, dt_w, proj_t = map(torch.from_numpy, (wide(x), wide(dt), proj))
    slices = (x_w[..., 1:], dt_w[..., 1:], torch.from_numpy(A), proj_t[..., 1 + n:1 + 2 * n],
              proj_t[..., 1 + 2 * n:], torch.from_numpy(D), torch.from_numpy(h0))
    assert not slices[3].is_contiguous() and slices[0].storage_offset() == 1
    y, h = mamba_scan(*slices)
    y_ref, h_ref = ref.mamba_scan_ref(*map(jnp.asarray, (x, dt, A, B, C, D, h0)))
    _close(y, y_ref)
    _close(h, h_ref)


def test_scan_final_state_of_a_ragged_sequence_matches_ref():
    """S = 300 is not a multiple of the JAX layer's 256-step chunk: the
    port's h_final is the reference's, the state after step 299."""
    arrs = _scan_inputs(0, 1, 300, 16, 4)
    y, h = layers.selective_scan(*map(torch.from_numpy, arrs))
    y_ref, h_ref = ref.mamba_scan_ref(*map(jnp.asarray, arrs))
    _close(y, y_ref)
    _close(h, h_ref)
    # and it is the state the step-by-step decode reaches
    x, dt, A, B, C, D = map(torch.from_numpy, arrs)
    h_step = torch.zeros_like(h)
    for t in range(300):
        _, h_step = layers.selective_scan_step(x[:, t], dt[:, t], A, B[:, t], C[:, t],
                                               D, h_step)
    torch.testing.assert_close(h, h_step, atol=ATOL, rtol=RTOL)


def test_scan_plain_rounds_y_to_the_input_dtype():
    arrs = _scan_inputs(1, 2, 40, 32, 8)
    xs = [torch.from_numpy(a) for a in arrs]
    for i in (0, 1, 3, 4):
        xs[i] = xs[i].bfloat16()
    y, h = mamba_scan_plain(*xs)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jx = [jnp.asarray(a) for a in arrs]
    for i in (0, 1, 3, 4):
        jx[i] = jx[i].astype(jnp.bfloat16)
    y_ref, h_ref = ref.mamba_scan_ref(*jx)
    _close(y, y_ref, atol=2e-2, rtol=2e-2)
    _close(h, h_ref)


def test_softplus_matches_jax():
    x = np.array([-80.0, -20.0, -1.0, 0.0, 0.5, 19.0, 20.5, 25.0, 80.0], np.float32)
    np.testing.assert_allclose(softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, 24)).astype(np.float32)
    w = (0.1 * rng.standard_normal((4, 24))).astype(np.float32)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for st in (None, state):
        y, new = layers.causal_conv1d(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                                      None if st is None else torch.from_numpy(st).to(tdt))
        jy, jnew = jl.causal_conv1d(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                                    None if st is None else jnp.asarray(st).astype(jdt))
        assert y.dtype == tdt and tuple(new.shape) == jnew.shape
        _close(y, jy, tol, tol)
        _close(new, jnew, tol, tol)
    # one token at a time through the state equals the whole sequence
    st = torch.zeros((2, 3, 24))
    ys = []
    for t in range(10):
        y1, st = layers.causal_conv1d(torch.from_numpy(x[:, t:t + 1]), torch.from_numpy(w), st)
        ys.append(y1)
    full, _ = layers.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w))
    torch.testing.assert_close(torch.cat(ys, dim=1), full)


def test_selective_scan_and_step_match_jax_layers():
    """As tests/test_kernels.py::test_layers_selective_scan_matches_ref,
    the port's layers against the JAX layers and the reference."""
    bt, s, din, n = 2, 48, 32, 8
    arrs = _scan_inputs(3, bt, s, din, n)
    jarrs = list(map(jnp.asarray, arrs))
    x, dt, A, B, C, D = map(torch.from_numpy, arrs)
    y, h = layers.selective_scan(x, dt, A, B, C, D)
    jy, jh = jl.selective_scan(*jarrs, chunk=16)
    _close(y, jy)
    _close(h, jh)
    y_ref, _ = ref.mamba_scan_ref(*jarrs)
    h_c, jh_c, ys = torch.zeros((bt, din, n)), jnp.zeros((bt, din, n)), []
    for t in range(s):
        y1, h_c = layers.selective_scan_step(x[:, t], dt[:, t], A, B[:, t], C[:, t], D, h_c)
        jy1, jh_c = jl.selective_scan_step(jarrs[0][:, t], jarrs[1][:, t], jarrs[2],
                                           jarrs[3][:, t], jarrs[4][:, t], jarrs[5], jh_c)
        _close(y1, jy1)
        ys.append(y1)
    _close(h_c, jh_c)
    _close(torch.stack(ys, dim=1), y_ref)


def test_selective_scan_from_a_state_continues_the_sequence():
    """Scanning S1 steps, then S2 more from the first run's final state,
    equals one scan over S1 + S2 steps."""
    x, dt, A, B, C, D = map(torch.from_numpy, _scan_inputs(4, 2, 50, 16, 8))
    y, h = layers.selective_scan(x, dt, A, B, C, D)
    y1, h1 = layers.selective_scan(x[:, :20], dt[:, :20], A, B[:, :20], C[:, :20], D)
    y2, h2 = layers.selective_scan(x[:, 20:], dt[:, 20:], A, B[:, 20:], C[:, 20:], D, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y)
    torch.testing.assert_close(h2, h)


def test_selective_scan_adds_D_times_x_per_channel():
    """The skip term is D[d] * x[d] channel by channel: the scan with D
    differs from the scan with D = 0 by exactly that, and h_final not at
    all."""
    x, dt, A, B, C, D = map(torch.from_numpy, _scan_inputs(5, 2, 12, 16, 4))
    y, h = layers.selective_scan(x, dt, A, B, C, D)
    y0, h0 = layers.selective_scan(x, dt, A, B, C, torch.zeros_like(D))
    torch.testing.assert_close(y - y0, D * x, atol=1e-6, rtol=0)
    torch.testing.assert_close(h, h0, atol=0, rtol=0)
