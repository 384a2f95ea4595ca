"""tools/profile_step.py's reduction from HLO and trace events to metrics
(the chip run feeds it a real trace; here it gets a CPU-compiled step and
synthetic events)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import profile_step as ps  # noqa: E402

from deepfluids_tpu.train import losses  # noqa: E402

SCOPES = (losses.CURL_SCOPE, losses.JACOBIAN_SCOPE)


@pytest.fixture(scope="module")
def step_hlo():
    def loss(psi, x):
        return losses.generator_loss(psi, x, True, 1.0, 1.0)[0]

    psi = jnp.zeros((2, 16, 12, 1))
    x = jnp.ones((2, 16, 12, 2))
    return jax.jit(jax.value_and_grad(loss)).lower(psi, x).compile().as_text()


class TestStencilOps:
    def test_finds_forward_and_vjp_ops(self, step_hlo):
        ops = ps.stencil_ops(step_hlo, SCOPES)
        assert any(ops.values()) and not all(ops.values())

    def test_unknown_scope_finds_nothing(self, step_hlo):
        assert ps.stencil_ops(step_hlo, ("no_such_scope",)) == {}

    def test_scope_in_called_computation(self):
        hlo = "\n".join([
            "%fused_computation (p: f32[4]) -> f32[4] {",
            '  ROOT %s = f32[4] subtract(%p, %p), metadata={op_name='
            '"jit(f)/transpose(jvp(fd_curl))/sub"}',
            "}",
            "ENTRY %main (a: f32[4]) -> f32[4] {",
            "  %a = f32[4] parameter(0)",
            "  ROOT %fusion.3 = f32[4] fusion(%a), kind=kLoop, "
            "calls=%fused_computation",
            "}"])
        assert ps.stencil_ops(hlo, SCOPES) == {"fusion.3": True}


class TestReduction:
    @pytest.mark.parametrize("shape,units", [((8, 128, 96, 2), 16),
                                             ((4, 32, 64, 112, 3), 27)])
    def test_stencil_bytes(self, shape, units):
        # 2D: curl 1+2, loss 2+2, loss VJP 2+2+2, curl VJP 2+1 channels;
        # 3D: 3+3, 3+3, 3+3+3, 3+3 — f32 over every grid point.
        assert ps.stencil_bytes(shape) == 4 * units * int(np.prod(shape[:-1]))

    def test_busy_is_union_of_intervals(self):
        ev = [{"start": 0, "dur": 10}, {"start": 5, "dur": 10},
              {"start": 30, "dur": 5}, {"start": 31, "dur": 1}]
        assert ps.busy_ns(ev) == 20

    def test_layers_and_shares(self):
        def ev(op, start, dur):
            return {"hlo_op": op, "name": op, "start": start, "dur": dur}

        events = [ev("cudnn-conv-bw-filter.1", 0, 600),
                  ev("fusion.7", 600, 100), ev("fusion.8", 700, 100),
                  ev("loop_add_fusion", 800, 200), ev("cublas-gemm.2", 1000,
                                                      0)]
        r = ps.reduce_trace(events, {"fusion.7": False, "fusion.8": True},
                            steps=2, kind="NVIDIA H100 80GB HBM3",
                            nbytes=335)
        assert r["device_busy_ms_per_step"] == pytest.approx(500e-6)
        assert r["ms_per_step_by_layer"] == pytest.approx({
            "conv": 300e-6, "stencil_fwd": 50e-6, "stencil_vjp": 50e-6,
            "other": 100e-6, "matmul": 0.0})
        assert r["stencil_share_of_busy"] == pytest.approx(0.2)
        # 335 B per step in 100 ns per step.
        assert r["stencil_bytes_per_s"] == pytest.approx(3.35e9)
        assert r["stencil_share_of_hbm_peak"] == pytest.approx(1e-3)

    def test_unknown_device_kind_gets_no_share(self):
        r = ps.reduce_trace([{"hlo_op": "f", "name": "f", "start": 0,
                              "dur": 5}], {"f": False}, 1, "Some GPU", 10)
        assert r["hbm_peak_bytes_per_s"] is None
        assert r["stencil_share_of_hbm_peak"] is None
