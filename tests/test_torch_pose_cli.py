"""The port's CLI pose chain on the CPU, on a synthetic root with the
fixture's frames and rig (``data/synthetic_root.py``): ``perception --task
pose2d-train`` -> ``pose2d-infer`` (the ``pred_or_4d_hrnet_coco_*.npz``)
-> ``pose3d-train --pred-pose2d`` -> ``pose3d-infer`` (the ``pred_*.npy``)
-> ``instance-labels --poses-dir``: the L1 -> L2 chain for humans. The
models are shrunk as ``tests/test_nogt_chain.py`` shrinks the JAX CLI's
(64 x 64 images; a 12^3 / 8^3 grid, 3 proposals), the architecture kept,
and the 3D driver keeps every proposal (random weights score under its
0.1 threshold).

2D inference and VoxelPose run on the val split (two frames, twelve
images). The CLI's files equal what the port's drivers write from the checkpoints
the CLI saved (the drivers are held against the JAX drivers in
``tests/test_torch_pose_hrnet.py`` and ``tests/test_torch_pose_voxelpose.py``),
checkpoints resume (the step, the root-cube accumulator), and the L2 labels
take the predicted humans.
"""

import functools
from pathlib import Path

import numpy as np
import torch

from or4d_tpu_torch import cli
from or4d_tpu_torch.data import higherhrnet_dataset as hd
from or4d_tpu_torch.data import voxelpose_dataset as vd
from or4d_tpu_torch.pipeline import perception_infer as pi
from or4d_tpu_torch.train import checkpoint as ckpt
from or4d_tpu_torch.train import perception_trainers as pt

FRAMES = Path(__file__).parent / "golden" / "real_data" / "export_holistic_take1_processed"
VOXELPOSE = dict(initial_cube=(12, 12, 12), fine_cube=(8, 8, 8), max_people=3)


def _tiny_pose(monkeypatch):
    """Shrink the pose models and datasets the CLI constructs."""
    monkeypatch.setattr(hd, "HigherHRNetDataset", functools.partial(hd.HigherHRNetDataset, input_size=64,
                                                                    output_sizes=(16, 32)))
    monkeypatch.setattr(vd, "VoxelPoseDataset", functools.partial(vd.VoxelPoseDataset, max_people=3))
    monkeypatch.setattr(vd, "generate_3d_target", functools.partial(vd.generate_3d_target, cube_size=(12, 12, 12)))
    monkeypatch.setattr(pt, "VoxelPoseTrainer", functools.partial(pt.VoxelPoseTrainer, model_kwargs=VOXELPOSE))


def test_pose_chain_from_a_synthetic_root(tmp_path, monkeypatch, capsys):
    from or4d_tpu_torch.data.synthetic_root import add_camera_frames, add_pose_annotations, write_data_root
    from or4d_tpu_torch.pipeline.perception_infer import run_2d_inference_for_voxelpose, \
        run_3d_pose_inference_for_take

    _tiny_pose(monkeypatch)
    monkeypatch.chdir(tmp_path)
    root = tmp_path / "root"
    write_data_root(root, seed=2, scans_per_take=1, n_staff=2, points_per_object=150, floor_points=200)
    add_camera_frames(root, FRAMES / "colorimage", scans_per_take=1)
    add_pose_annotations(root, FRAMES)
    base = ["perception", "--data-root", str(root), "--device", "cpu"]

    assert cli.main([*base, "--task", "pose2d-train", "--checkpoint-dir", "h", "--limit", "4"]) == 0
    assert "pose2d epoch 0: loss=" in capsys.readouterr().out
    assert [p.name for p in (tmp_path / "h").iterdir()] == ["step_00000002.pt"]
    npz = tmp_path / "pred_or_4d_hrnet_coco_val.npz"
    assert cli.main([*base, "--task", "pose2d-infer", "--checkpoint-dir", "h", "--split", "val"]) == 0
    assert f"wrote {npz.name} (12 images)" in capsys.readouterr().out
    got = np.load(npz, allow_pickle=True)["arr_0"].item()
    assert len(got) == 12
    tr = pt.HigherHRNetTrainer(device="cpu")
    assert ckpt.restore(tmp_path / "h", tr.model, tr.optimizer) == 2
    want = run_2d_inference_for_voxelpose(tr.model, hd.HigherHRNetDataset(root, "val", augment=False,
                                                                          take_indices=[4]), tmp_path / "direct.npz")
    assert len(want) == 6
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # VoxelPose on the val split's two frames, three epochs in two runs
    p3 = [*base, "--split", "val", "--pred-pose2d", str(npz), "--checkpoint-dir", "v"]
    assert cli.main([*p3, "--task", "pose3d-train"]) == 0
    assert "pose3d epoch 0: loss=" in capsys.readouterr().out
    assert cli.main([*p3, "--task", "pose3d-train", "--epochs", "2"]) == 0  # resumes: iterations 3-6
    tr3 = pt.VoxelPoseTrainer(device="cpu")
    extra = {}
    assert ckpt.restore(tmp_path / "v", tr3.model, tr3.optimizer, extra) == 6
    assert len(extra["accum3d"]) == len(list(tr3.model.proposal_v2v.parameters()))
    assert tr3.optimizer.state_dict()["state"][0]["step"] >= 1  # the accumulator fired on iteration 4

    # random weights score under run_3d_pose_inference_for_take's 0.1 threshold: keep every proposal
    monkeypatch.setattr(pi, "run_3d_pose_inference_for_take",
                        functools.partial(pi.run_3d_pose_inference_for_take, threshold=-np.inf))
    out = tmp_path / "poses"
    assert cli.main([*p3, "--task", "pose3d-infer", "--split", "val", "--output-dir", str(out)]) == 0
    text = capsys.readouterr().out
    files = sorted(p.name for p in out.glob("pred_*.npy"))
    assert f"wrote {len(files)} pose files" in text and "RANDOM INITIALIZATION" not in text
    ds = vd.VoxelPoseDataset(root, "val", pred_pose2d_path=npz, inference=True)
    direct = tmp_path / "direct"
    n = sum(run_3d_pose_inference_for_take(tr3.model, ds, t, direct, threshold=-np.inf) for t in (4, 8))
    assert files == sorted(p.name for p in direct.glob("pred_*.npy")) == ["pred_4_000000.npy", "pred_8_000000.npy"]
    assert n == 2
    for f in files:
        pose = np.load(out / f)
        assert pose.shape == (3, 14, 3) and np.isfinite(pose).all()
        np.testing.assert_array_equal(pose, np.load(direct / f))

    assert cli.main(["instance-labels", "--data-root", str(root), "--poses-dir", str(out), "--device", "cpu",
                     "--output-dir", "l2"]) == 0
    from or4d_tpu_torch.pipeline.instance_labels import poses_from_npy

    for f in files:
        scan = f[len("pred_"):-len(".npy")]
        labels = np.load(tmp_path / "l2" / "instance_labels_pred" / f"{scan}.npz")["arr_0"]
        assert labels.dtype == np.int8 and labels.shape == (1250,)
        joints = np.load(tmp_path / "l2" / "human_name_to_3D_joints" / f"{scan.split('_')[0]}_GT_False.npz",
                         allow_pickle=True)["arr_0"].item()[scan.split("_")[1]]
        assert sorted(joints) == sorted(poses_from_npy(out / f))
    assert torch.get_default_dtype() == torch.float32
