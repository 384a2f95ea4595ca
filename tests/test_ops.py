"""Unit tests for the finite-difference physics core (SURVEY.md §4 test plan).

Pins down: analytic derivatives, exact interior divergence-freeness of
curl-produced fields (the reference's key architectural invariant), shape
preservation, batching, and the stencils and their gradients against an
independent numpy reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepfluids_tpu import ops


def _grid2d(h, w):
    y = np.arange(h, dtype=np.float64)[:, None]
    x = np.arange(w, dtype=np.float64)[None, :]
    return y, x


class TestCurl2D:
    def test_shapes(self):
        psi = jnp.zeros((2, 16, 12, 1))
        u = ops.curl2d(psi)
        assert u.shape == (2, 16, 12, 2)

    def test_linear_psi_constant_velocity(self):
        # psi = 2y - 3x  ->  u = dpsi/dy = 2, v = -dpsi/dx = 3 (everywhere,
        # including the replicated edge, since derivatives are constant).
        h, w = 16, 12
        y, x = _grid2d(h, w)
        psi = (2.0 * y - 3.0 * x)[None, :, :, None]
        u = np.asarray(ops.curl2d(jnp.asarray(psi, jnp.float32)))
        np.testing.assert_allclose(u[..., 0], 2.0, atol=1e-5)
        np.testing.assert_allclose(u[..., 1], 3.0, atol=1e-5)

    def test_divergence_free_interior(self):
        # Random psi -> curl -> forward-diff divergence must vanish exactly
        # in the interior (forward differences commute).
        rng = np.random.default_rng(1)
        psi = jnp.asarray(rng.standard_normal((3, 24, 20, 1)), jnp.float32)
        u = ops.curl2d(psi)
        div = np.asarray(ops.divergence2d(u))[:, :-2, :-2, :]
        np.testing.assert_allclose(div, 0.0, atol=1e-5)

    def test_forward_diff_edge_replication(self):
        # psi = y^2: dpsi/dy forward diff at row i is (i+1)^2 - i^2 = 2i+1,
        # and the last row replicates row H-2's derivative.
        h, w = 8, 8
        y, x = _grid2d(h, w)
        psi = (y * y * np.ones_like(x))[None, :, :, None]
        u = np.asarray(ops.curl2d(jnp.asarray(psi, jnp.float32)))[0, :, :, 0]
        expect = 2.0 * np.arange(h) + 1.0
        expect[-1] = expect[-2]
        np.testing.assert_allclose(u[:, 0], expect, atol=1e-4)


class TestJacobian2D:
    def test_shapes(self):
        x = jnp.zeros((2, 16, 12, 2))
        j, w = ops.jacobian2d(x)
        assert j.shape == (2, 16, 12, 4)
        assert w.shape == (2, 16, 12, 1)

    def test_linear_field(self):
        # u = x + 2y, v = 3x + 4y -> J = (1, 2, 3, 4), vort = 3 - 2 = 1.
        h, w = 10, 14
        y, x = _grid2d(h, w)
        u = x + 2 * y
        v = 3 * x + 4 * y
        vel = jnp.asarray(np.stack([u, v], -1)[None], jnp.float32)
        j, vort = ops.jacobian2d(vel)
        j, vort = np.asarray(j), np.asarray(vort)
        for k, val in enumerate([1.0, 2.0, 3.0, 4.0]):
            np.testing.assert_allclose(j[..., k], val, atol=1e-5)
        np.testing.assert_allclose(vort[..., 0], 1.0, atol=1e-5)

    def test_vorticity_matches_jacobian(self):
        rng = np.random.default_rng(2)
        vel = jnp.asarray(rng.standard_normal((2, 12, 12, 2)), jnp.float32)
        _, w1 = ops.jacobian2d(vel)
        w2 = ops.vorticity2d(vel)
        np.testing.assert_allclose(np.asarray(w1), np.asarray(w2), atol=1e-6)


class TestCurl3D:
    def test_shapes(self):
        psi = jnp.zeros((2, 8, 10, 12, 3))
        u = ops.curl3d(psi)
        assert u.shape == (2, 8, 10, 12, 3)

    def test_divergence_free_interior(self):
        rng = np.random.default_rng(3)
        psi = jnp.asarray(rng.standard_normal((2, 10, 12, 14, 3)), jnp.float32)
        u = ops.curl3d(psi)
        div = np.asarray(ops.divergence3d(u))[:, :-2, :-2, :-2, :]
        np.testing.assert_allclose(div, 0.0, atol=1e-5)

    def test_analytic_curl(self):
        # Psi = (0, 0, c) with c = 2y - 5x -> u = dc/dy = 2, v = -dc/dx = 5, w = 0.
        d, h, w = 6, 8, 10
        z = np.zeros((d, h, w))
        y = np.arange(h, dtype=np.float64)[None, :, None] * np.ones((d, 1, w))
        x = np.arange(w, dtype=np.float64)[None, None, :] * np.ones((d, h, 1))
        c = 2.0 * y - 5.0 * x
        psi = jnp.asarray(np.stack([z, z, c], -1)[None], jnp.float32)
        u = np.asarray(ops.curl3d(psi))
        np.testing.assert_allclose(u[..., 0], 2.0, atol=1e-5)
        np.testing.assert_allclose(u[..., 1], 5.0, atol=1e-5)
        np.testing.assert_allclose(u[..., 2], 0.0, atol=1e-5)


class TestJacobian3D:
    def test_shapes_and_linear(self):
        d, h, w = 5, 6, 7
        z = np.arange(d, dtype=np.float64)[:, None, None] * np.ones((1, h, w))
        y = np.arange(h, dtype=np.float64)[None, :, None] * np.ones((d, 1, w))
        x = np.arange(w, dtype=np.float64)[None, None, :] * np.ones((d, h, 1))
        # u = x + 2y + 3z, v = 4x + 5y + 6z, w = 7x + 8y + 9z
        vel = np.stack(
            [x + 2 * y + 3 * z, 4 * x + 5 * y + 6 * z, 7 * x + 8 * y + 9 * z],
            axis=-1,
        )[None]
        j, vort = ops.jacobian3d(jnp.asarray(vel, jnp.float32))
        j, vort = np.asarray(j), np.asarray(vort)
        assert j.shape == (1, d, h, w, 9)
        assert vort.shape == (1, d, h, w, 3)
        for k in range(9):
            np.testing.assert_allclose(j[..., k], float(k + 1), atol=1e-4)
        # vort = (dwdy - dvdz, dudz - dwdx, dvdx - dudy) = (8-6, 3-7, 4-2)
        np.testing.assert_allclose(vort[..., 0], 2.0, atol=1e-4)
        np.testing.assert_allclose(vort[..., 1], -4.0, atol=1e-4)
        np.testing.assert_allclose(vort[..., 2], 2.0, atol=1e-4)


class TestGradFlow:
    def test_curl_is_differentiable(self):
        def loss(psi):
            return jnp.sum(ops.curl2d(psi) ** 2)

        g = jax.grad(loss)(jnp.ones((1, 8, 8, 1)))
        assert g.shape == (1, 8, 8, 1)
        assert np.isfinite(np.asarray(g)).all()


def _np_fdiff(x, axis):
    """Independent forward difference: explicit index arithmetic, last
    sample repeats the previous derivative (edge replication)."""
    x = np.moveaxis(np.asarray(x, np.float64), axis, 0)
    d = np.empty_like(x)
    d[:-1] = x[1:] - x[:-1]
    d[-1] = x[-1] - x[-2]
    return np.moveaxis(d, 0, axis)


def _np_fdiff_t(g, axis):
    """Explicit transpose of the edge-replicated forward difference W
    (x_bar = W^T d_bar), written out per row:

      x_bar[0]   = -d_bar[0]
      x_bar[j]   = d_bar[j-1] - d_bar[j]                   (interior)
      x_bar[n-2] = d_bar[n-3] - d_bar[n-2] - d_bar[n-1]
      x_bar[n-1] = d_bar[n-2] + d_bar[n-1]
    """
    g = np.moveaxis(np.asarray(g, np.float64), axis, 0)
    x = np.zeros_like(g)
    x[0] = -g[0]
    x[1:] = g[:-1] - g[1:]
    x[-2] = g[-3] - g[-2] - g[-1]
    x[-1] = g[-2] + g[-1]
    return np.moveaxis(x, 0, axis)


def _np_curl2d(psi):
    p = psi[..., 0]
    return np.stack([_np_fdiff(p, -2), -_np_fdiff(p, -1)], -1)


def _np_jacobian2d(x):
    u, v = x[..., 0], x[..., 1]
    j = np.stack([_np_fdiff(u, -1), _np_fdiff(u, -2),
                  _np_fdiff(v, -1), _np_fdiff(v, -2)], -1)
    return j, (j[..., 2] - j[..., 1])[..., None]


def _np_curl3d(psi):
    a, b, c = psi[..., 0], psi[..., 1], psi[..., 2]
    return np.stack([_np_fdiff(c, -2) - _np_fdiff(b, -3),
                     _np_fdiff(a, -3) - _np_fdiff(c, -1),
                     _np_fdiff(b, -1) - _np_fdiff(a, -2)], -1)


def _np_jacobian3d(x):
    d = [[_np_fdiff(x[..., i], ax) for ax in (-1, -2, -3)] for i in range(3)]
    j = np.stack([d[i][k] for i in range(3) for k in range(3)], -1)
    vort = np.stack([d[2][1] - d[1][2], d[0][2] - d[2][0],
                     d[1][0] - d[0][1]], -1)
    return j, vort


class TestOracleVsNumpy:
    """ops.fd against an independent numpy forward-difference reference,
    at the shapes the removed kernels were checked at."""

    @pytest.mark.parametrize("shape", [(2, 16, 12), (1, 128, 96), (3, 8, 8)])
    def test_curl2d(self, shape):
        psi = np.random.default_rng(4).standard_normal(shape + (1,))
        got = np.asarray(ops.curl2d(jnp.asarray(psi, jnp.float32)))
        np.testing.assert_allclose(got, _np_curl2d(psi), atol=1e-5)

    @pytest.mark.parametrize("shape", [(2, 16, 12), (1, 128, 96)])
    def test_jacobian2d(self, shape):
        x = np.random.default_rng(5).standard_normal(shape + (2,))
        gj, gw = ops.jacobian2d(jnp.asarray(x, jnp.float32))
        wj, ww = _np_jacobian2d(x)
        np.testing.assert_allclose(np.asarray(gj), wj, atol=1e-5)
        np.testing.assert_allclose(np.asarray(gw), ww, atol=1e-5)

    @pytest.mark.parametrize("shape", [(2, 6, 10, 12), (1, 8, 16, 16)])
    def test_curl3d(self, shape):
        psi = np.random.default_rng(6).standard_normal(shape + (3,))
        got = np.asarray(ops.curl3d(jnp.asarray(psi, jnp.float32)))
        np.testing.assert_allclose(got, _np_curl3d(psi), atol=1e-5)

    @pytest.mark.parametrize("shape", [(2, 6, 10, 12)])
    def test_jacobian3d(self, shape):
        x = np.random.default_rng(7).standard_normal(shape + (3,))
        gj, gw = ops.jacobian3d(jnp.asarray(x, jnp.float32))
        wj, ww = _np_jacobian3d(x)
        np.testing.assert_allclose(np.asarray(gj), wj, atol=1e-5)
        np.testing.assert_allclose(np.asarray(gw), ww, atol=1e-5)

    def test_curl3d_divfree(self):
        psi = np.random.default_rng(8).standard_normal((1, 8, 12, 16, 3))
        u = _np_curl3d(psi)
        div = (_np_fdiff(u[..., 0], -1) + _np_fdiff(u[..., 1], -2)
               + _np_fdiff(u[..., 2], -3))[:, :-2, :-2, :-2]
        np.testing.assert_allclose(div, 0.0, atol=1e-10)


class TestTransposedStencil:
    """jax.grad of the oracle against the explicit transposed stencil."""

    def test_curl2d_grad(self):
        rng = np.random.default_rng(9)
        psi = jnp.asarray(rng.standard_normal((2, 16, 12, 1)), jnp.float32)
        g = rng.standard_normal((2, 16, 12, 2))
        got = jax.grad(lambda p: jnp.sum(ops.curl2d(p) * g))(psi)
        want = _np_fdiff_t(g[..., 0], -2) - _np_fdiff_t(g[..., 1], -1)
        np.testing.assert_allclose(np.asarray(got)[..., 0], want, atol=1e-5)

    def test_jacobian2d_grad(self):
        rng = np.random.default_rng(10)
        x = jnp.asarray(rng.standard_normal((2, 16, 12, 2)), jnp.float32)
        gj = rng.standard_normal((2, 16, 12, 4))
        gw = rng.standard_normal((2, 16, 12, 1))[..., 0]

        def lo(v):
            j, w = ops.jacobian2d(v)
            return jnp.sum(j * gj) + jnp.sum(w[..., 0] * gw)

        got = np.asarray(jax.grad(lo)(x))
        t = _np_fdiff_t
        # w = dvdx - dudy adds -gw to dudy's and +gw to dvdx's cotangent.
        u = t(gj[..., 0], -1) + t(gj[..., 1] - gw, -2)
        v = t(gj[..., 2] + gw, -1) + t(gj[..., 3], -2)
        np.testing.assert_allclose(got, np.stack([u, v], -1), atol=1e-5)

    def test_vjp_loss_path_end_to_end(self):
        # The actual train-loss composition through the dispatching wrappers.
        from deepfluids_tpu.train import generator_loss

        rng = np.random.default_rng(11)
        psi = jnp.asarray(rng.standard_normal((2, 16, 12, 1)), jnp.float32)
        x = jnp.asarray(rng.standard_normal((2, 16, 12, 2)), jnp.float32)
        g = jax.grad(lambda p: generator_loss(p, x, True, 1.0, 1.0)[0])(psi)
        assert np.isfinite(np.asarray(g)).all()

    def test_curl3d_grad(self):
        rng = np.random.default_rng(12)
        psi = jnp.asarray(rng.standard_normal((2, 6, 10, 12, 3)),
                          jnp.float32)
        g = rng.standard_normal((2, 6, 10, 12, 3))
        got = np.asarray(jax.grad(lambda p: jnp.sum(ops.curl3d(p) * g))(psi))
        t = _np_fdiff_t
        gu, gv, gw = g[..., 0], g[..., 1], g[..., 2]
        # u = dc/dy - db/dz, v = da/dz - dc/dx, w = db/dx - da/dy
        a = t(gv, -3) - t(gw, -2)
        b = t(gw, -1) - t(gu, -3)
        c = t(gu, -2) - t(gv, -1)
        np.testing.assert_allclose(got, np.stack([a, b, c], -1), atol=1e-5)

    def test_jacobian3d_grad(self):
        rng = np.random.default_rng(13)
        x = jnp.asarray(rng.standard_normal((1, 6, 10, 12, 3)), jnp.float32)
        gj = rng.standard_normal((1, 6, 10, 12, 9))
        gv = rng.standard_normal((1, 6, 10, 12, 3))

        def lo(v):
            j, w = ops.jacobian3d(v)
            return jnp.sum(j * gj) + jnp.sum(w * gv)

        got = np.asarray(jax.grad(lo)(x))
        # Cotangent of each derivative d_i/d_ax: its J entry plus the
        # vorticity terms it appears in (w0 = dwdy - dvdz, w1 = dudz -
        # dwdx, w2 = dvdx - dudy).
        cot = [[gj[..., 3 * i + k].copy() for k in range(3)]
               for i in range(3)]
        cot[2][1] += gv[..., 0]
        cot[1][2] -= gv[..., 0]
        cot[0][2] += gv[..., 1]
        cot[2][0] -= gv[..., 1]
        cot[1][0] += gv[..., 2]
        cot[0][1] -= gv[..., 2]
        want = np.stack([sum(_np_fdiff_t(cot[i][k], ax)
                             for k, ax in enumerate((-1, -2, -3)))
                         for i in range(3)], -1)
        np.testing.assert_allclose(got, want, atol=1e-5)
