"""train/checkpoint.py: one .npz per step, keyed by tree path."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deepfluids_tpu.train import checkpoint


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    params = {"fc_in": {"kernel": rng.normal(size=(3, 8)).astype(np.float32),
                        "bias": np.zeros(8, np.float32)},
              "conv_0_0": {"kernel": rng.normal(size=(3, 3, 8, 8))
                           .astype(np.float32)}}
    opt = optax.adam(1e-3).init(jax.tree.map(jnp.asarray, params))
    return {"params": params, "opt_state": opt, "step": np.int32(7)}


class TestCheckpoint:
    def test_round_trip(self, tmp_path):
        tree = _tree()
        path = checkpoint.save(str(tmp_path), 7, jax.device_get(tree))
        assert os.path.basename(path) == "step_00000007.npz"
        flat = checkpoint.load_flat(str(tmp_path), 7)
        assert "params/fc_in/kernel" in flat and "step" in flat
        back = checkpoint.restore(str(tmp_path), 7, _tree(seed=1))
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)), back, jax.device_get(tree))
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(tree))

    def test_keeps_newest_three_and_no_temp_files(self, tmp_path):
        for step in (1, 2, 3, 4, 5):
            checkpoint.save(str(tmp_path), step, _tree())
        assert checkpoint.steps(str(tmp_path)) == [3, 4, 5]
        assert sorted(os.listdir(tmp_path)) == [
            "step_00000003.npz", "step_00000004.npz", "step_00000005.npz"]
        assert checkpoint.steps(str(tmp_path / "absent")) == []

    def test_other_structure_raises_value_error(self, tmp_path):
        checkpoint.save(str(tmp_path), 1, _tree())
        other = dict(_tree(), opt_state=optax.sgd(1e-3).init(
            _tree()["params"]))
        with pytest.raises(ValueError):
            checkpoint.restore(str(tmp_path), 1, other)
        wrong_shape = _tree()
        wrong_shape["params"]["fc_in"]["bias"] = np.zeros(9, np.float32)
        with pytest.raises(ValueError):
            checkpoint.restore(str(tmp_path), 1, wrong_shape)
