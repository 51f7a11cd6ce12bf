"""On the card: the pose models' forwards against the CPU's, from one set of
random weights (float32, TF32 off on both sides).

* HigherHRNet's eval forward at a 128 x 128 input, B = 1: both heads within
  1e-4 of their largest value;
* VoxelPose's eval forward on the fixture's rig and frame at a reduced grid
  (24^3 root cube, 16^3 pose cubes, 3 proposals): the proposal set equal
  (near-equal root-cube maxima may come in another order), each proposal's
  score, centre and pose within 1e-4 of their largest value, the root cube
  too; the coarse grid's points whose in-image test differs between the two
  (a point on an image border) are counted and must be none here.

No kernel of the port runs in these models (convolutions are cuDNN's).
Every test carries the ``cuda`` marker and skips inside the test when no
card is present. This file imports no JAX:

    python -m pytest tests/test_torch_cuda_pose.py -m cuda --noconftest -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
FIXTURE = Path(__file__).parent / "golden" / "real_data"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def close(got: torch.Tensor, want: torch.Tensor, tol: float, what: str) -> None:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    scale = max(float(want.abs().max()), 1e-12)
    d = float((got - want).abs().max())
    assert d <= tol * scale, f"{what}: max |diff| {d} of {scale}"


def test_higherhrnet_forward_on_the_card_equals_the_cpu(card):
    from or4d_tpu_torch.models.higherhrnet import HigherHRNet

    cpu = HigherHRNet(device="cpu", seed=3)
    gpu = HigherHRNet(device=card, seed=3)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 128, 128, 3)).astype(np.float32))
    with torch.no_grad():
        want = cpu(x, train=False)
        got = gpu(x.to(card), train=False)
    for g, w, name in zip(got, want, ("low", "high")):
        assert g.shape == w.shape
        close(g, w, 1e-4, name)


def test_voxelpose_forward_on_the_card_equals_the_cpu(card):
    from or4d_tpu_torch.data.voxelpose_dataset import VoxelPoseDataset
    from or4d_tpu_torch.models.voxelpose import VoxelPose, compute_grid, project_points
    from or4d_tpu_torch.train.perception_trainers import cameras_on

    kw = dict(initial_cube=(24, 24, 24), fine_cube=(16, 16, 16), max_people=3)
    ds = VoxelPoseDataset(FIXTURE, "train", take_indices=[1], max_people=3)
    hm = torch.from_numpy(ds.sample(0)["input_heatmaps"])
    hs = torch.from_numpy(ds.heatmap_scale)
    outs, inb = [], []
    for dev in ("cpu", card):
        model = VoxelPose(**kw, device=dev, seed=5)
        cams = cameras_on(ds.cameras, dev)
        with torch.no_grad():
            outs.append([t.cpu() for t in model(hm.to(dev), cams, hs.to(dev), train=False)])
        grid = compute_grid(model.space_size, torch.tensor(model.space_center), model.initial_cube, dev)
        inb.append(torch.stack([
            ((xy[:, 0] >= 0) & (xy[:, 1] >= 0) & (xy[:, 0] < cams["size"][v][0]) & (xy[:, 1] < cams["size"][v][1]))
            for v in range(6) for xy in [project_points(grid, *(cams[k][v] for k in "RTfc"))]]).cpu())
    assert int((inb[0] != inb[1]).sum()) == 0
    (p_c, s_c, c_c, r_c), (p_g, s_g, c_g, r_g) = outs
    close(r_g, r_c, 1e-4, "root cube")
    order = [int((c_c - c).abs().sum(1).argmin()) for c in c_g]
    assert sorted(order) == [0, 1, 2]
    close(c_g, c_c[order], 1e-6, "centres")
    close(s_g, s_c[order], 1e-4, "scores")
    close(p_g, p_c[order], 1e-4, "poses")
