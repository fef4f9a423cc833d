"""Checkpoint migration: separate-head params merge exactly; legacy
two-branch-encoder checkpoints are rejected with a clear error."""

import numpy as np
import pytest

from text2video.train.checkpoints import migrate_generator_params


def _head(rng, out_ch):
    return {
        "kernel": rng.rand(7, 7, 64, out_ch).astype(np.float32),
        "bias": rng.rand(out_ch).astype(np.float32),
    }


def test_head_merge_is_exact_concat():
    rng = np.random.RandomState(0)
    img, flow, mask = _head(rng, 3), _head(rng, 2), _head(rng, 1)
    old = {
        "params": {
            "GlobalTrunk_0": {"ConvBlock_0": {"Conv_0": {"kernel": np.zeros((7, 7, 15, 64))}}},
            "img_head": img,
            "flow_head": flow,
            "mask_head": mask,
        }
    }
    new = migrate_generator_params(old)
    p = new["params"]
    assert "img_head" not in p and "heads" in p
    assert p["heads"]["kernel"].shape == (7, 7, 64, 6)
    np.testing.assert_array_equal(p["heads"]["kernel"][..., 0:3], img["kernel"])
    np.testing.assert_array_equal(p["heads"]["kernel"][..., 3:5], flow["kernel"])
    np.testing.assert_array_equal(p["heads"]["kernel"][..., 5:6], mask["kernel"])
    np.testing.assert_array_equal(
        p["heads"]["bias"], np.concatenate([img["bias"], flow["bias"], mask["bias"]])
    )


def test_merged_params_pass_through():
    tree = {"params": {"heads": {"kernel": np.zeros((7, 7, 64, 6))}}}
    assert migrate_generator_params(tree) is tree


def test_two_branch_encoder_rejected():
    old = {
        "params": {
            "GlobalTrunk_0": {
                "ConvBlock_0": {"Conv_0": {"kernel": np.zeros((7, 7, 9, 64))}},
                "ConvBlock_1": {"Conv_0": {"kernel": np.zeros((7, 7, 6, 64))}},
            },
            "img_head": {"kernel": np.zeros((7, 7, 64, 3)), "bias": np.zeros(3)},
        }
    }
    with pytest.raises(ValueError, match="two-branch"):
        migrate_generator_params(old)


def test_latest_step_dir_skips_incomplete_tmp(tmp_path):
    """A kill mid-save leaves step_*.orbax-checkpoint-tmp; auto-resume
    must skip it and pick the newest COMPLETE checkpoint."""
    from text2video.train.checkpoints import latest_step_dir

    (tmp_path / "step_00000200").mkdir()
    (tmp_path / "step_00000400.orbax-checkpoint-tmp").mkdir()
    assert latest_step_dir(str(tmp_path)).endswith("step_00000200")
    import shutil

    shutil.rmtree(tmp_path / "step_00000200")
    assert latest_step_dir(str(tmp_path)) is None
