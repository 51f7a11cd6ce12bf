"""The port's parallel and public-op modules against the JAX package, in
one process: dp-sharded ``SlotPack`` plans and ``gather_rows_local``
(exact), the mesh's sizes, refusals and ``shard_batch`` rule (against the
JAX shards on the conftest's virtual devices), ``TPUConfig``'s mesh keys,
``ops.grouping`` and ``ops.scatter`` (empty segments included),
``utils.profiling``'s ``StepTimer`` and ``trace``, and a dp block of
scenes augmented alone against the same scenes of the batch augmented.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or4d_tpu import ops as jops
from or4d_tpu.config import DatasetConfig as JDatasetConfig, ExperimentConfig as JExperimentConfig
from or4d_tpu.data.scene_batch import SceneBatch as JSceneBatch, SlotPack as JSlotPack
from or4d_tpu.data.scene_batch import gather_rows_local as j_gather_rows_local
from or4d_tpu.data.synthetic import make_scene_sample
from or4d_tpu.parallel.mesh import make_mesh as j_make_mesh, shard_batch as j_shard_batch
from tests.test_torch_train import _port_batch

from or4d_tpu_torch import ops
from or4d_tpu_torch.config import ExperimentConfig
from or4d_tpu_torch.data.scene_batch import SlotPack, gather_rows_local
from or4d_tpu_torch.parallel import Mesh, make_mesh, shard_batch
from or4d_tpu_torch.utils import profiling

DS = JDatasetConfig(num_points_objects=64, num_points_relation=64, max_objects=6, max_edges=30)
FIELDS = ("obj_points", "rel_points", "edge_index", "rel_onehot", "gt_class", "gt_rels", "obj_mask", "edge_mask",
          "rel_hand_points")


def _jbatch(objects=(3, 5, 4, 6, 2, 6, 5, 3), pair_shared=False):
    """Scenes of unequal object counts, so the shards' blocks differ."""
    return JSceneBatch.stack([make_scene_sample(40 + i, n_objects=n, ds=DS, scan_idx=i, points_per_obj=120,
                                                pair_shared=pair_shared) for i, n in enumerate(objects)])


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("bucket", [8, 128])
def test_sharded_slot_pack_equals_jax(shards, paired, bucket):
    jbatch = _jbatch(pair_shared=paired)
    want = JSlotPack.build(jbatch, bucket=bucket, shards=shards, paired=paired)
    got = SlotPack.build(_port_batch(jbatch), bucket=bucket, shards=shards, paired=paired)
    for f in dataclasses.fields(JSlotPack):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if w is None:
            assert g is None, f.name
            continue
        assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w), f.name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f.name)
    if shards > 1:  # a rank's row is the plan of its block, indexing its own rows
        row = got.row(1)
        assert row.obj_idx.shape == got.obj_idx.shape[1:]
        np.testing.assert_array_equal(row.edge_idx, got.edge_idx[1])


def test_sharded_slot_pack_refuses_uneven_shards():
    with pytest.raises(ValueError, match="not divisible"):
        SlotPack.build(_port_batch(_jbatch((3, 4, 5))), shards=2)


def test_gather_rows_local_equals_jax():
    jbatch = _jbatch()
    pack = JSlotPack.build(jbatch, bucket=8, shards=4)
    flat = np.asarray(jbatch.rel_points).reshape(-1, *jbatch.rel_points.shape[2:])
    want = np.asarray(j_gather_rows_local(jnp.asarray(flat), jnp.asarray(pack.edge_idx)))
    got = gather_rows_local(torch.from_numpy(flat), torch.from_numpy(pack.edge_idx))
    np.testing.assert_array_equal(got.numpy(), want)
    per, cap = flat.shape[0] // 4, pack.edge_idx.shape[1]  # rank d gathers its own block with its row
    torch.testing.assert_close(got[cap:2 * cap],
                               torch.from_numpy(flat[per:2 * per])[torch.from_numpy(pack.edge_idx[1]).long()])


@pytest.mark.parametrize("dp, mp", [(2, 1), (4, 1), (2, 2), (1, 2)])
def test_shard_batch_equals_the_jax_shards(dp, mp):
    """Rank r's block is the shard JAX puts on device r of its (dp, mp)
    mesh; images over dp only; S = 7 scenes pad to a multiple of dp."""
    jbatch = _jbatch((3, 5, 4, 6, 2, 6, 5))
    jbatch = dataclasses.replace(jbatch, images=np.arange(7 * 2 * 3, dtype=np.float32).reshape(7, 2, 3))
    jmesh = j_make_mesh(dp=dp, mp=mp)
    placed = j_shard_batch(jbatch, jmesh)
    devices = list(jmesh.devices.reshape(-1))
    for r in range(dp * mp):
        got = shard_batch(dataclasses.replace(_port_batch(jbatch), images=np.asarray(jbatch.images)),
                          Mesh(dp=dp, mp=mp, rank=r))
        for f in (*FIELDS, "images"):
            arr = getattr(placed, f)
            shard = next(s for s in arr.addressable_shards if s.device == devices[r])
            np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(shard.data), err_msg=f"{f} r{r}")


def test_shard_batch_refuses_slots_that_do_not_divide_mp():
    """Six object slots over mp = 4: both packages refuse."""
    jbatch = _jbatch((3, 5, 4, 6))
    with pytest.raises(ValueError, match="divisible by 4"):
        j_shard_batch(jbatch, j_make_mesh(dp=1, mp=4))
    with pytest.raises(ValueError, match="does not divide mp=4"):
        shard_batch(_port_batch(jbatch), Mesh(dp=1, mp=4, rank=0))


def test_make_mesh_without_a_process_group():
    assert make_mesh() == make_mesh(1, 1) == Mesh() and Mesh().world is None
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(2)
    with pytest.raises(ValueError, match="not divisible by mp=2"):
        make_mesh(-1, 2)
    m = Mesh(dp=2, mp=3, rank=4)
    assert (m.dp_rank, m.mp_rank, m.shape) == (1, 1, {"dp": 2, "mp": 3})


def test_mesh_keys_load_as_the_jax_config_loads_them(tmp_path):
    raw = {"TPU": {"mesh_data": 2, "mesh_model": 2, "scene_batch": 4}}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(raw))
    got, want = ExperimentConfig.from_reference_json(str(path)), JExperimentConfig.from_reference_json(str(path))
    assert (got.tpu.mesh_data, got.tpu.mesh_model) == (want.tpu.mesh_data, want.tpu.mesh_model) == (2, 2)
    default = ExperimentConfig().tpu
    assert (default.mesh_data, default.mesh_model) == (JExperimentConfig().tpu.mesh_data,
                                                        JExperimentConfig().tpu.mesh_model) == (-1, 1)


def _clouds(seed=0, B=3, N=200, M=24, C=5):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    new_xyz = xyz[:, rng.choice(N, M, replace=False)]
    feats = rng.standard_normal((B, C, N)).astype(np.float32)
    return xyz, new_xyz, feats


def test_grouping_operation_and_group_all_equal_jax():
    xyz, new_xyz, feats = _clouds()
    idx = np.random.default_rng(1).integers(0, xyz.shape[1], (3, 24, 7)).astype(np.int32)
    np.testing.assert_array_equal(ops.grouping_operation(torch.from_numpy(feats), torch.from_numpy(idx)).numpy(),
                                  np.asarray(jops.grouping_operation(jnp.asarray(feats), jnp.asarray(idx))))
    np.testing.assert_array_equal(ops.gather_points(torch.from_numpy(feats), torch.from_numpy(idx[..., 0])).numpy(),
                                  np.asarray(jops.gather_points(jnp.asarray(feats), jnp.asarray(idx[..., 0]))))
    for f in (feats, None):
        for use_xyz in (True, False):
            if f is None and not use_xyz:
                continue
            want = np.asarray(jops.group_all(jnp.asarray(xyz), None if f is None else jnp.asarray(f), use_xyz))
            got = ops.group_all(torch.from_numpy(xyz), None if f is None else torch.from_numpy(f), use_xyz)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_xyz, with_features", [(True, True), (False, True), (True, False)])
def test_query_and_group_equals_jax(use_xyz, with_features):
    """Both sides' ball queries agree on these inputs first (the JAX one
    expands |a - b|^2, the port's takes the direct difference), then the
    grouped tensor is equal; gradients of the features too."""
    xyz, new_xyz, feats = _clouds(2)
    r, ns = 0.3, 8
    jidx = np.asarray(jops.ball_query(r, ns, jnp.asarray(xyz), jnp.asarray(new_xyz)))
    np.testing.assert_array_equal(ops.ball_query.ball_query(r, ns, torch.from_numpy(xyz),
                                                            torch.from_numpy(new_xyz)).numpy(),
                                  jidx)
    f = torch.from_numpy(feats).requires_grad_() if with_features else None
    got = ops.query_and_group(r, ns, torch.from_numpy(xyz), torch.from_numpy(new_xyz), f, use_xyz)
    jf = jnp.asarray(feats) if with_features else None
    want = jops.query_and_group(r, ns, jnp.asarray(xyz), jnp.asarray(new_xyz), jf, use_xyz)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-7)
    if with_features:
        cot = np.random.default_rng(3).standard_normal(got.shape).astype(np.float32)
        got.backward(torch.from_numpy(cot))
        _, vjp = jax.vjp(lambda x: jops.query_and_group(r, ns, jnp.asarray(xyz), jnp.asarray(new_xyz), x, use_xyz), jf)
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="neither"):
        ops.query_and_group(r, ns, torch.from_numpy(xyz), torch.from_numpy(new_xyz), None, use_xyz=False)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_ops_equal_jax_with_empty_segments(dtype):
    """Segments 1 and 4 are empty (segment_max gives -inf, or the lowest
    integer, as JAX does); ids outside [0, 6) are dropped."""
    rng = np.random.default_rng(4)
    data = (rng.standard_normal((12, 3)) * 10).astype(dtype)
    ids = np.array([0, 2, 2, 3, 5, 0, 3, 3, 6, -1, 2, 5], np.int32)
    for name in ("segment_sum", "segment_max", "segment_mean"):
        if name == "segment_mean" and dtype != np.float32:
            continue
        want = np.asarray(getattr(jops, name)(jnp.asarray(data), jnp.asarray(ids), 6))
        got = getattr(ops, name)(torch.from_numpy(data), torch.from_numpy(ids), 6).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)
    mx = ops.segment_max(torch.from_numpy(data), torch.from_numpy(ids), 6)
    lowest = -np.inf if dtype == np.float32 else np.iinfo(dtype).min
    assert (mx[[1, 4]] == lowest).all()


def test_step_timer_numbers(monkeypatch):
    clock = iter([0.0, 0.010, 1.0, 1.030, 2.0, 2.020])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(window=2)
    assert timer.summary() == "no steps" and timer.mean_ms == 0.0
    for _ in range(3):
        with timer.step():
            pass
    assert timer.mean_ms == pytest.approx(25.0)  # the last two steps: 30 and 20 ms
    assert timer.summary() == "25.0 ms/step, 40.00 steps/s"


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(tmp_path / "tr") as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(path.read_text())["traceEvents"]
    assert path.parent == tmp_path / "tr" and any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("dp", [2, 4])
def test_augmenting_a_block_equals_that_block_of_the_augmented_batch(dp):
    """The augmentation is element-wise (a crop's sums are trees of adds, its
    rotations 3 x 3 products summed in one order), so a dp rank's block of
    scenes augmented alone equals those scenes of the whole batch augmented,
    bit for bit: each rank augments only its block."""
    from or4d_tpu_torch.data.augment import augment_batch_with, draw_augment

    batch = _port_batch(_jbatch()).to("cpu")
    S, O, E = batch.num_scenes, batch.obj_points.shape[1], batch.rel_points.shape[1]
    draws = draw_augment(S, O, E, torch.Generator().manual_seed(2))
    whole = augment_batch_with(batch, draws)
    per = S // dp
    for r in range(dp):
        lo, hi = r * per, (r + 1) * per
        block = dataclasses.replace(batch, **{f: getattr(batch, f)[lo:hi] for f in (
            "obj_points", "rel_points", "rel_hand_points", "gt_rels")})
        got = augment_batch_with(block, draws.scenes(slice(lo, hi)))
        assert torch.equal(got.obj_points, whole.obj_points[lo:hi])
        assert torch.equal(got.rel_points, whole.rel_points[lo:hi])
