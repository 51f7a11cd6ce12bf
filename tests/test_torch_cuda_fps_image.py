"""On the card: the cluster FPS kernel (``csrc/fps_cluster.cu``, N > 8192)
against its plain version, ``instance-labels --from-gt`` on registered
object scans over 8192 points against ``--device cpu``, and the image
path (JPEG decoding, the image branch) on the card against the CPU.

Every test carries the ``cuda`` marker and skips inside the test when no
card is present. This file imports no JAX:

    python -m pytest tests/test_torch_cuda_fps_image.py -m cuda --noconftest -q

Tolerances: indices, counts, bounds, labels and decoded pixels exactly;
the image embedding within 1e-4 of its largest value (float32 with TF32
off on both sides; sums in another order).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from or4d_tpu_torch.ops import launch_counts, reset_launch_counts
from or4d_tpu_torch.ops import fps

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).parent / "golden" / "real_data"
SCALES = ((0.1, 16), (0.2, 32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(seed, B, N):
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
    xyz[:, 3:6] = 0.0  # |p|^2 <= 1e-3: never selected
    return torch.from_numpy(xyz)


def _grid(N, spacing=0.05):
    side = int(np.ceil(N ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)[:N]
    pts = ((g - side // 2) * spacing).astype(np.float32)
    pts[[0, side * side // 2]] = pts[[side * side // 2, 0]]
    return torch.from_numpy(pts)[None]


@pytest.mark.parametrize("N,npoint", [(8193, 256), (20000, 512), (65536, 128), (65537, 128), (150000, 64)])
def test_cluster_fps_exact(card, N, npoint):
    xyz = _cloud(N, 2, N)
    reset_launch_counts()
    got = fps.furthest_point_sample(xyz.to(card), npoint)
    assert launch_counts()["fps.fps_large"] == 1 and launch_counts()["fps.fps"] == 0
    torch.testing.assert_close(got.cpu(), fps.furthest_point_sample(xyz, npoint), rtol=0, atol=0)


@pytest.mark.parametrize("N", [20000, 100000])
def test_cluster_fps_exact_on_tied_grids(card, N):
    xyz = _grid(N)
    got = fps.furthest_point_sample(xyz.to(card), 256)
    torch.testing.assert_close(got.cpu(), fps.furthest_point_sample(xyz, 256), rtol=0, atol=0)


@pytest.mark.parametrize("N", [20000, 70000])
def test_cluster_fps_counts_and_bounds_exact(card, N):
    xyz = _cloud(N + 1, 2, N)
    radii = tuple(r for r, _ in SCALES)
    reset_launch_counts()
    idx, counts = fps.furthest_point_sample_with_counts(xyz.to(card), 128, radii)
    bidx, need = fps.furthest_point_sample_with_bounds(xyz.to(card), 128, SCALES)
    n = launch_counts()
    assert n["fps.fps_large_counts"] == 1 and n["fps.fps_large_bounds"] == 1
    widx, wcounts = fps.furthest_point_sample_with_counts(xyz, 128, radii)
    _, wneed = fps.furthest_point_sample_with_bounds(xyz, 128, SCALES)
    torch.testing.assert_close(idx.cpu(), widx, rtol=0, atol=0)
    torch.testing.assert_close(bidx.cpu(), widx, rtol=0, atol=0)
    for c, w in zip(counts, wcounts):
        torch.testing.assert_close(c.cpu(), w, rtol=0, atol=0)
    for c, w in zip(need, wneed):
        torch.testing.assert_close(c.cpu(), w, rtol=0, atol=0)


def test_clouds_of_8192_points_keep_the_single_block_kernel(card):
    reset_launch_counts()
    xyz = _cloud(1, 2, 8192).to(card)
    fps.furthest_point_sample(xyz, 64)
    fps.furthest_point_sample_with_bounds(xyz, 64, SCALES)
    n = launch_counts()
    assert n["fps.fps"] == 1 and n["fps.fps_bounds"] == 1
    assert n["fps.fps_large"] == n["fps.fps_large_bounds"] == 0


def test_instance_labels_from_gt_on_scans_over_8192_points(card, tmp_path):
    from or4d_tpu_torch import cli
    from or4d_tpu_torch.data.synthetic_root import densify_object_scan

    out = {}
    for dev in ("cuda", "cpu"):
        root = tmp_path / dev
        shutil.copytree(ROOT, root)
        for name in ("instrument_table", "operating_table"):
            densify_object_scan(root, name, 1, 20000)
        shutil.rmtree(root / "instance_labels")
        reset_launch_counts()
        assert cli.main(["instance-labels", "--from-gt", "--data-root", str(root), "--device", dev]) == 0
        if dev == "cuda":
            assert launch_counts()["fps.fps_large"] > 0
        out[dev] = {p.name: np.load(p)["arr_0"] for p in sorted((root / "instance_labels").glob("*.npz"))}
    assert list(out["cuda"]) == list(out["cpu"]) == ["1_000000.npz", "1_000001.npz", "4_000000.npz"]
    for k in out["cpu"]:
        np.testing.assert_array_equal(out["cuda"][k], out["cpu"][k], err_msg=k)


def test_jpeg_decoding_on_the_card_equals_the_cpu(card):
    from or4d_tpu_torch.data import images
    from or4d_tpu_torch.data.jpeg import read_jpeg

    for path in sorted(ROOT.glob("export_holistic_take1_processed/colorimage/*.jpg")):
        got, want = read_jpeg(path, card), read_jpeg(path)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
        torch.testing.assert_close(images.b5_transform(got).cpu(), images.b5_transform(want), rtol=0, atol=0)


def test_image_branch_on_the_card_follows_the_cpu(card):
    from or4d_tpu_torch.models.efficientnet import ImageBranch

    cpu = ImageBranch(device="cpu", generator=torch.Generator().manual_seed(3))
    gpu = ImageBranch(device=card)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 6, 456, 456, 3)).astype(np.float32))
    with torch.no_grad():
        want = cpu(x)
        got = gpu(x.to(card)).cpu()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
