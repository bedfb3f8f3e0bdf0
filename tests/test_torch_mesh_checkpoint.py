"""Checkpoints of the sharded train step (``launch.train --mesh``) on a
gloo world on the CPU.

A 2×2 mesh saves its state by building the global tree on rank 0's
host one leaf at a time (``models.model.gather_tree_to_host``), and
resumes by reading each rank's own blocks, one leaf at a time
(``CheckpointManager.restore(placements=...)``).  A run resumed from
step 1 on the mesh writes the same step-2 checkpoint, bit for bit, as
the run that went on without stopping; the same checkpoint resumes on
one process.  Whether each rank's blocks, and the state built on rank
0's host, equal the gathered state in every layout is held in
``test_torch_sharded_step.py``.
"""
import shutil

import numpy as np
import pytest

from repro_torch.launch import train

ARGS = ["--arch", "yi-6b", "--smoke", "--device", "cpu",
        "--global-batch", "4", "--seq-len", "16"]


def _leaves(root, step):
    with np.load(root / f"step_{step:08d}" / "shard_00000.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """A 2×2 run of two steps, a checkpoint after each."""
    root = tmp_path_factory.mktemp("straight")
    train.main(ARGS + ["--mesh", "2x2", "--steps", "2", "--ckpt-dir",
                       str(root), "--ckpt-every", "1"])
    return root


def test_mesh_resume_is_bit_for_bit(straight, tmp_path):
    shutil.copytree(straight / "step_00000001", tmp_path / "step_00000001")
    train.main(ARGS + ["--mesh", "2x2", "--steps", "2", "--ckpt-dir",
                       str(tmp_path), "--resume"])
    want, got = _leaves(straight, 2), _leaves(tmp_path, 2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mesh_checkpoint_resumes_on_one_process(straight, tmp_path, capsys):
    shutil.copytree(straight / "step_00000002", tmp_path / "step_00000002")
    train.main(ARGS + ["--steps", "3", "--ckpt-dir", str(tmp_path),
                       "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    before, after = _leaves(tmp_path, 2), _leaves(tmp_path, 3)
    assert sorted(after) == sorted(before)
    assert all(after[k].shape == before[k].shape for k in before)
    assert any(not np.array_equal(after[k], before[k]) for k in before)
