"""VoxelPose — multi-view 3D human pose estimation (port of
``or4d_tpu/models/voxelpose.py``).

Reference: `external_src/voxelpose/voxelpose_lib/models/*` adapted to 4D-OR:
  * ProjectLayer (project_layer.py:15-109): a voxel grid over the OR space
    (8000^3 mm cube centered (296.1, 826.0, -190.4), 80^3 bins) is projected
    into each of the 6 cameras and bilinearly samples the per-camera 2D joint
    heatmaps; samples are averaged over the cameras whose image bounds
    contain the projection, clamped to [0, 1];
  * CuboidProposalNet: V2VNet(num_joints -> 1) over the fused cube proposes
    person centers; 3D max-pool NMS + top-K (core/proposal.py:24-40,
    MAX_PEOPLE_NUM 10);
  * PoseRegressionNet: per proposal, a fine 2000^3 mm / 56^3 grid is
    re-projected and V2VNet(num_joints -> num_joints) + beta-softmax
    soft-argmax over the grid regresses the 14 joints
    (pose_regression_net.py:15-55);
  * training loss: per-joint L1 with patient weighting x4
    (multi_person_posenet.py:36-103).

As in the JAX module, shapes are static: always ``max_people`` proposals
(invalid ones masked by the score threshold), the K proposals' fine grids
projected at once and the pose V2V run once with the K proposals as its
batch, so train-mode BN pools over all K (the JAX package's deviation from
the reference's per-proposal loop; eval mode is equivalent).
``bilinear_sample`` is an explicit four-tap gather with zero padding.
The 3D convolutions are ``F.conv3d`` (cuDNN on the card, TF32 off); the
V2V's ``Up3D`` weight is flax's ``ConvTranspose`` kernel flipped in every
spatial axis (:mod:`or4d_tpu_torch.convert`). Top-k is a stable descending
sort: ``lax.top_k`` takes the lowest index among equal values, and the
non-maxima of the NMS are all 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from or4d_tpu_torch.device import resolve_device
from or4d_tpu_torch.models.layers import ConvNd, FlaxBatchNorm, no_tf32

SPACE_SIZE = (8000.0, 8000.0, 8000.0)
SPACE_CENTER = (296.1, 826.0, -190.4)
INITIAL_CUBE = (80, 80, 80)
FINE_GRID = (2000.0, 2000.0, 2000.0)
FINE_CUBE = (56, 56, 56)
NUM_JOINTS = 14
MAX_PEOPLE = 10
MATCH_RADIUS = 500.0  # ProposalLayer.filter_proposal's validity gate (mm)


def project_points(points: torch.Tensor, R: torch.Tensor, T: torch.Tensor, f: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """(N, 3) world -> (N, 2) pixel coordinates."""
    cam = (points - T) @ R.T
    z = torch.clamp_min(cam[:, 2:3], 1e-6)
    return cam[:, :2] / z * f + c


def linspace(start: float, stop: float, num: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in ``dtype``: start * (1 - t) +
    stop * t at t = i / (num - 1), the last point ``stop`` itself."""
    if num == 1:
        return torch.tensor([start], dtype=dtype, device=device)
    t = torch.arange(num - 1, dtype=dtype, device=device) / torch.tensor(float(num - 1), dtype=dtype, device=device)
    lo, hi = torch.tensor(start, dtype=dtype, device=device), torch.tensor(stop, dtype=dtype, device=device)
    return torch.cat([lo * (1 - t) + hi * t, hi[None]])


def compute_grid(box_size, box_center, n_bins, device=None, dtype=torch.float32) -> torch.Tensor:
    """Reference compute_grid (project_layer.py:29-47): meshgrid of bin
    centers, x-major flattening, in ``dtype`` (the heatmaps'). ``box_center``
    a sequence or a (3,) tensor."""
    center = torch.as_tensor(box_center, device=device)
    center = center if center.is_floating_point() else center.to(dtype)
    axes = [linspace(-box_size[i] / 2, box_size[i] / 2, n_bins[i], dtype, device) + center[i] for i in range(3)]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], dim=1)


def bilinear_sample(hm: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """heatmap (J, H, W), uv (N, 2) in pixel coords of the heatmap -> (J, N):
    align_corners=True grid_sample semantics with zero padding, as four
    explicit taps."""
    J, H, W = hm.shape
    x, y = uv[:, 0], uv[:, 1]
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = x0 + 1, y0 + 1
    wx, wy = x - x0, y - y0
    flat = hm.reshape(J, H * W)

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = flat[:, yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        return torch.where(inb[None, :], v, torch.zeros((), dtype=hm.dtype, device=hm.device))

    return (tap(y0, x0) * ((1 - wx) * (1 - wy))[None] + tap(y0, x1) * (wx * (1 - wy))[None]
            + tap(y1, x0) * ((1 - wx) * wy)[None] + tap(y1, x1) * (wx * wy)[None])


def project_heatmaps_to_cube(heatmaps: torch.Tensor, cameras: dict, grid: torch.Tensor,
                             heatmap_scale: torch.Tensor) -> torch.Tensor:
    """The fused-cube construction (get_voxel :49-105): per camera, project,
    bound-check, bilinear sample; bounded average over cameras; clamp.
    ``heatmaps`` (C, J, H, W), ``cameras`` {R (C,3,3), T (C,3), f (C,2),
    c (C,2), size (C,2)}, ``grid`` (nbins, 3) -> (J, nbins)."""
    acc = count = None
    for v in range(heatmaps.shape[0]):
        size = cameras["size"][v]
        xy = project_points(grid, cameras["R"][v], cameras["T"][v], cameras["f"][v], cameras["c"][v])
        inb = (xy[:, 0] >= 0) & (xy[:, 1] >= 0) & (xy[:, 0] < size[0]) & (xy[:, 1] < size[1])
        uv = torch.minimum(torch.clamp_min(xy, -1.0), size.max()) * heatmap_scale
        b = inb.to(heatmaps.dtype)
        s = bilinear_sample(heatmaps[v], uv) * b[None, :]
        acc, count = (s, b) if acc is None else (acc + s, count + b)
    return torch.clamp(acc / (count + 1e-6), 0.0, 1.0)


def _conv3(cin, cout, k, **kw) -> ConvNd:
    return ConvNd(3, cin, cout, k, 1, True, **kw)


class Basic3D(nn.Module):
    def __init__(self, cin: int, features: int, ksize: int, **kw):
        super().__init__()
        self.conv, self.bn = _conv3(cin, features, ksize, **kw), FlaxBatchNorm(features, device=kw["device"])

    def forward(self, x, train: bool = True):
        return F.relu(self.bn(self.conv(x), train))


class Res3D(nn.Module):
    def __init__(self, cin: int, features: int, **kw):
        super().__init__()
        dev = kw["device"]
        self.conv1, self.bn1 = _conv3(cin, features, 3, **kw), FlaxBatchNorm(features, device=dev)
        self.conv2, self.bn2 = _conv3(features, features, 3, **kw), FlaxBatchNorm(features, device=dev)
        self.skip = cin != features
        if self.skip:
            self.skip_conv, self.skip_bn = _conv3(cin, features, 1, **kw), FlaxBatchNorm(features, device=dev)

    def forward(self, x, train: bool = True):
        r = F.relu(self.bn1(self.conv1(x), train))
        r = self.bn2(self.conv2(r), train)
        if self.skip:
            x = self.skip_bn(self.skip_conv(x), train)
        return F.relu(r + x)


class Up3D(nn.Module):
    def __init__(self, cin: int, features: int, **kw):
        super().__init__()
        self.deconv = ConvNd(3, cin, features, 2, 2, True, transpose=True, **kw)
        self.bn = FlaxBatchNorm(features, device=kw["device"])

    def forward(self, x, train: bool = True):
        return F.relu(self.bn(self.deconv(x), train))


class V2VNet(nn.Module):
    """v2v_net.py:73-144 — hourglass 3D CNN, (N, C, D, H, W) in and out."""

    def __init__(self, in_channels: int, out_channels: int, **kw):
        super().__init__()
        self.front1 = Basic3D(in_channels, 16, 7, **kw)
        self.front2 = Res3D(16, 32, **kw)
        self.skip1 = Res3D(32, 32, **kw)
        self.enc1 = Res3D(32, 64, **kw)
        self.skip2 = Res3D(64, 64, **kw)
        self.enc2 = Res3D(64, 128, **kw)
        self.mid = Res3D(128, 128, **kw)
        self.dec2 = Res3D(128, 128, **kw)
        self.up2 = Up3D(128, 64, **kw)
        self.dec1 = Res3D(64, 64, **kw)
        self.up1 = Up3D(64, 32, **kw)
        self.output = _conv3(32, out_channels, 1, **kw)

    def forward(self, x, train: bool = True):
        x = self.front2(self.front1(x, train), train)
        s1 = self.skip1(x, train)
        x = self.enc1(F.max_pool3d(x, 2), train)
        s2 = self.skip2(x, train)
        x = self.enc2(F.max_pool3d(x, 2), train)
        x = self.dec2(self.mid(x, train), train)
        x = self.up2(x, train) + s2
        x = self.up1(self.dec1(x, train), train) + s1
        return self.output(x)


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` of a 1-D tensor: the k largest values, largest first,
    equal values in index order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def nms_topk(cube: torch.Tensor, k: int = MAX_PEOPLE) -> tuple[torch.Tensor, torch.Tensor]:
    """3D max-pool NMS + top-k (core/proposal.py:24-40): keep local maxima,
    return (values, (k, 3) voxel indices)."""
    D, H, W = cube.shape
    mx = F.max_pool3d(cube[None, None], 3, stride=1, padding=1)[0, 0]
    kept = torch.where(cube == mx, cube, torch.zeros((), dtype=cube.dtype, device=cube.device)).reshape(-1)
    vals, idx = topk_stable(kept, k)
    return vals, torch.stack([idx // (H * W), (idx % (H * W)) // W, idx % W], dim=1)


def voxel_to_world(index: torch.Tensor, cube_size=INITIAL_CUBE, grid_size=SPACE_SIZE,
                   grid_center=SPACE_CENTER) -> torch.Tensor:
    """ProposalLayer.get_real_loc (cuboid_proposal_net.py:41-47)."""
    f32, dev = torch.float32, index.device
    cs = torch.tensor(cube_size, dtype=f32, device=dev)
    gs = torch.tensor(grid_size, dtype=f32, device=dev)
    gc = torch.tensor(grid_center, dtype=f32, device=dev)
    return index.to(f32) / (cs - 1) * gs + gc - gs / 2.0


class VoxelPose(nn.Module):
    """Full multi-person net (multi_person_posenet.py:36-103), static shapes:
    always ``max_people`` proposals, invalid ones masked by score threshold.
    The geometry is overridable (tests and small deployments shrink the
    voxel grids without touching the architecture). Built on ``device``
    (the card unless given "cpu"; raises without one) from a CPU generator
    seeded with ``seed``."""

    def __init__(self, num_joints: int = NUM_JOINTS, beta: float = 100.0, threshold: float = 0.1,
                 space_size: tuple = SPACE_SIZE, space_center: tuple = SPACE_CENTER,
                 initial_cube: tuple = INITIAL_CUBE, fine_grid: tuple = FINE_GRID, fine_cube: tuple = FINE_CUBE,
                 max_people: int = MAX_PEOPLE, device=None, generator: torch.Generator | None = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.num_joints, self.beta, self.threshold = num_joints, beta, threshold
        self.space_size, self.space_center = tuple(space_size), tuple(space_center)
        self.initial_cube, self.fine_grid = tuple(initial_cube), tuple(fine_grid)
        self.fine_cube, self.max_people = tuple(fine_cube), max_people
        kw = dict(device=device, generator=generator)
        self.proposal_v2v = V2VNet(num_joints, 1, **kw)
        self.pose_v2v = V2VNet(num_joints, num_joints, **kw)

    def forward(self, heatmaps: torch.Tensor, cameras: dict, heatmap_scale: torch.Tensor, train: bool = True):
        """heatmaps (C, J, H, W); cameras dict of stacked per-camera params.
        Returns (poses (K, J, 3), scores (K,), centers (K, 3), root cube)."""
        with no_tf32():
            return self._forward(heatmaps, cameras, heatmap_scale, train)

    def _forward(self, heatmaps, cameras, heatmap_scale, train):
        dev, J = heatmaps.device, self.num_joints
        dt = heatmaps.dtype
        coarse = compute_grid(self.space_size, torch.tensor(self.space_center, dtype=dt), self.initial_cube, dev, dt)
        cube = project_heatmaps_to_cube(heatmaps, cameras, coarse, heatmap_scale)
        root = self.proposal_v2v(cube.reshape(1, J, *self.initial_cube), train)[0, 0]
        scores, vox_idx = nms_topk(root.detach(), self.max_people)
        centers = voxel_to_world(vox_idx, self.initial_cube, self.space_size, self.space_center)
        K, n = centers.shape[0], self.fine_cube[0] * self.fine_cube[1] * self.fine_cube[2]
        grids = torch.stack([compute_grid(self.fine_grid, centers[i], self.fine_cube, dev, dt) for i in range(K)])
        fine = project_heatmaps_to_cube(heatmaps, cameras, grids.reshape(K * n, 3), heatmap_scale)
        fine = fine.reshape(J, K, *self.fine_cube).transpose(0, 1)
        logits = self.pose_v2v(fine, train).reshape(K, J, n)
        w = torch.softmax(self.beta * logits, dim=-1)  # soft-argmax
        poses = torch.einsum("kjn,knd->kjd", w, grids.to(w.dtype))
        return poses, scores, centers, root


def match_proposals_to_gt(centers, gt_roots, gt_mask, radius: float = MATCH_RADIUS):
    """ProposalLayer.filter_proposal (cuboid_proposal_net.py:25-40): each
    PROPOSAL takes its nearest GT root (several proposals may share one GT);
    proposals farther than 500mm from every GT are invalid. Returns
    (cand2gt (K,) int, valid (K,) bool)."""
    d = torch.linalg.vector_norm(centers[:, None, :] - gt_roots[None, :, :], dim=-1)  # (K, G)
    d = torch.where(gt_mask[None, :], d, torch.full((), float("inf"), dtype=d.dtype, device=d.device))
    return torch.argmin(d, dim=1), d.amin(dim=1) <= radius


def voxelpose_loss_3d(root_cube, target_3d):
    """loss_3d: mean-MSE of the proposal net's root cube against the 3D
    root-gaussian target (multi_person_posenet.py:57,69-71). The only loss
    that reaches the proposal V2V net — grid centers flow through top-k
    indices, which carry no gradient."""
    return ((root_cube - target_3d) ** 2).mean()


def voxelpose_loss(pred_poses, centers, gt_roots, gt_poses, gt_vis, gt_mask, patient_slot_mask=None,
                   patient_weight: float = 4.0):
    """The reference training loss (multi_person_posenet.py:75-103 +
    PerJointL1Loss): per valid proposal, weighted-L1 against its matched GT
    — weights the per-joint visibility, x ``patient_weight`` when the
    PROPOSAL SLOT's patient flag is set (the reference's quirk, kept) — the
    mean over (J, 3) per proposal, averaged over the valid proposals."""
    cand2gt, valid = match_proposals_to_gt(centers, gt_roots, gt_mask)
    matched = gt_poses[cand2gt]  # (K, J, 3)
    w = gt_vis[cand2gt].to(pred_poses.dtype)[..., None]  # (K, J, 1)
    if patient_slot_mask is not None:
        one = torch.ones((), dtype=pred_poses.dtype, device=pred_poses.device)
        w = w * torch.where(patient_slot_mask, one * patient_weight, one)[:, None, None]
    per_cand = (torch.abs(pred_poses - matched) * w).mean(dim=(1, 2))  # (K,)
    v = valid.to(pred_poses.dtype)
    return (per_cand * v).sum() / torch.clamp(v.sum(), min=1.0)
