"""The port's Group-Free detection dataset
(``or4d_tpu_torch.data.groupfree_dataset``) against the JAX package's:
ret dicts, ``batch()`` and ``mean_size_arr`` exactly equal (values and
dtypes) on the real-format fixture ``tests/golden/real_data`` and on a data
root written by ``or4d_tpu_torch.data.synthetic_root`` (whose registered
furniture scans the JAX loader reads too), each side with its own ret-dict
cache; the first principal component the port computes without
scikit-learn exactly equal to ``sklearn.decomposition.PCA``'s on float32
and float64 points, on both of its solver paths; the heading bins.
"""

from pathlib import Path

import numpy as np
import pytest

from or4d_tpu.data import groupfree_dataset as J

from or4d_tpu_torch.data import groupfree_dataset as T

ROOT = Path(__file__).parent / "golden" / "real_data"


def assert_same(got, want, path: str = "") -> None:
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("n", [5, 19, 20, 400])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_first_principal_component_equals_sklearn(n, dtype):
    from sklearn.decomposition import PCA

    rng = np.random.default_rng(n)
    for _ in range(20):
        X = (rng.standard_normal((n, 2)) * rng.uniform(0.1, 3.0, 2) + rng.standard_normal(2)).astype(dtype)
        np.testing.assert_array_equal(T.first_principal_component(X), PCA(n_components=1).fit(X).components_[0])


def test_headings_and_obbs_equal_the_jax_functions():
    for angle in np.linspace(-np.pi, np.pi, 41):
        assert T.angle2class(float(angle)) == J.angle2class(float(angle))
        cls, res = J.angle2class(float(angle))
        assert T.class2angle(cls, res) == J.class2angle(cls, res)
    rng = np.random.default_rng(0)
    for _ in range(10):
        v = rng.standard_normal(2)
        assert T.vec_ang(v, [1, 0]) == J.vec_ang(v, [1, 0])
    from or4d_tpu_torch.pipeline.instance_labels import load_gt_objects

    for take, scan in ((1, "000000"), (4, "000000")):
        for _name, pts in load_gt_objects(ROOT, take, scan):
            np.testing.assert_array_equal(T.pca_obb(pts), J.pca_obb(pts))


@pytest.mark.parametrize("split", ["train", "val"])
def test_ret_dicts_and_batches_equal_the_jax_dataset_on_the_fixture(split, tmp_path):
    kw = dict(num_points=4096, max_num_obj=8)
    want = J.GroupFreeDetectionDataset(ROOT, split, cache_dir=tmp_path / "jax", **kw)
    got = T.GroupFreeDetectionDataset(ROOT, split, cache_dir=tmp_path / "port", **kw)
    assert got.scan_names == want.scan_names and len(got) == len(want) > 0
    for i in range(len(want)):
        assert_same(got[i], want[i], f"{split} {i}")
    assert_same(got.batch(range(len(got))), want.batch(range(len(want))))
    assert_same(got.mean_size_arr(), want.mean_size_arr())
    # a second dataset reads the port's cache files
    again = T.GroupFreeDetectionDataset(ROOT, split, cache_dir=tmp_path / "port", **kw)
    assert_same(again.batch(range(len(again))), want.batch(range(len(want))))


def test_datasets_equal_on_a_synthetic_root(tmp_path):
    from or4d_tpu_torch.data.synthetic_root import write_data_root

    write_data_root(tmp_path / "root", seed=2, scans_per_take=1, n_staff=2, points_per_object=150, floor_points=200)
    kw = dict(num_points=2048, max_num_obj=8)
    want = J.GroupFreeDetectionDataset(tmp_path / "root", "train", cache_dir=tmp_path / "jax", **kw)
    got = T.GroupFreeDetectionDataset(tmp_path / "root", "train", cache_dir=tmp_path / "port", **kw)
    assert got.scan_names == want.scan_names == ["10_000000", "1_000000", "3_000000", "5_000000", "7_000000",
                                                 "9_000000"]
    assert_same(got.batch(range(len(got))), want.batch(range(len(want))))
    assert_same(got.mean_size_arr(), want.mean_size_arr())
    ret = got[0]
    assert int(ret["box_label_mask"].sum()) == 4 and set(ret["sem_cls_label"][:4].tolist()) == {0, 1, 2, 3}
    assert (ret["point_instance_label"] >= 0).mean() > 0.3
