"""The slice end to end: synthetic pair-shared scenes -> SlotPack -> SGPN
eval -> scan_relations, the port (plain versions on the CPU) against the
JAX package's trainer (``Trainer.eval_step`` / ``Trainer.predict_relations``,
paired pack, float32).

Small depth: the TINY encoder centroid/sample counts and two scenes, with
relation crops (600 points) and object crops (520 points) above one
512-point chunk, so the port reaches its counts-bounded raw-mode SA path.
On the CPU the JAX model runs its XLA fallback, whose ball query uses the
|a|^2 + |b|^2 - 2ab expansion; the port follows the kernels' direct
difference. So the test first checks that, on these inputs, the JAX ball
query equals the scan-order numpy reference: any later mismatch is the
port's. Log-probs agree to 2e-4 (the tolerance of test_paired_rel.py:160).
"""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from or4d_tpu.config import DatasetConfig, ExperimentConfig, ModelConfig, TPUConfig
from or4d_tpu.data.scene_batch import is_pair_shared as j_is_pair_shared
from or4d_tpu.data.synthetic import make_scene_batch as j_make_scene_batch
from or4d_tpu.data.vocab import DEFAULT_VOCAB as J_VOCAB
from or4d_tpu.ops.ball_query import ball_query as j_ball_query
from or4d_tpu.ops.fps import furthest_point_sample as j_fps
from or4d_tpu.parallel.mesh import make_mesh
from or4d_tpu.train.loop import Trainer
from tests.reference_impls import ball_query_np
from tests.test_torch_models import randomize

from or4d_tpu_torch.config import DatasetConfig as TDatasetConfig
from or4d_tpu_torch.convert import from_jax_variables
from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack, is_pair_shared
from or4d_tpu_torch.data.synthetic import make_scene_batch
from or4d_tpu_torch.infer import predict_relations
from or4d_tpu_torch.models import SGPN

SA_NPOINTS, SA_NSAMPLES = (32, 16), ((4, 8), (8, 8))
DS = dict(num_points_objects=520, num_points_relation=600, max_objects=5, max_edges=20)
DATA = dict(num_scenes=2, seed=11, n_objects=4, points_per_obj=300, pair_shared=True)
_FIELDS = ("obj_points", "rel_points", "edge_index", "rel_onehot", "gt_class", "gt_rels", "obj_mask",
           "edge_mask", "rel_hand_points")


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer on a one-device mesh with randomized variables: its
    batch, eval outputs and scan_relations."""
    batch = j_make_scene_batch(ds=DatasetConfig(**DS), **DATA)
    cfg = ExperimentConfig(model=ModelConfig(sa_npoints=SA_NPOINTS, sa_nsamples=SA_NSAMPLES),
                           tpu=TPUConfig(scene_batch=2, compute_dtype="float32"))
    trainer = Trainer(cfg, J_VOCAB, np.ones(12, np.float32), np.ones(15, np.float32), mesh=make_mesh(1, 1))
    state = trainer.init_state(jax.random.key(0), batch)
    variables = randomize({"params": state.params, "batch_stats": state.batch_stats}, seed=21)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    rel, obj = trainer.eval_step(state, batch)
    relations = trainer.predict_relations(state, [batch])
    return batch, variables, np.asarray(rel), np.asarray(obj), relations


@pytest.fixture(scope="module")
def port_model(jax_run):
    _, variables, *_ = jax_run
    model = SGPN(num_classes=12, num_relations=15, sa_npoints=SA_NPOINTS, sa_nsamples=SA_NSAMPLES, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model))
    return model


def test_synthetic_batch_and_pack_match_jax(jax_run):
    jbatch = jax_run[0]
    batch = make_scene_batch(ds=TDatasetConfig(**DS), **DATA)
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(batch, f), np.asarray(getattr(jbatch, f)), err_msg=f)
    assert batch.scan_ids == jbatch.scan_ids and batch.slot_names == jbatch.slot_names
    assert is_pair_shared(batch) and j_is_pair_shared(jbatch)
    from or4d_tpu.data.scene_batch import SlotPack as JSlotPack

    want, got = JSlotPack.build(jbatch, paired=True), SlotPack.build(batch, paired=True)
    for f in ("obj_idx", "obj_valid", "edge_idx", "edge_valid", "pair_idx", "pair_rev_idx", "pair_valid"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)


def test_jax_ball_query_is_scan_order_exact_on_these_inputs(jax_run):
    """Precondition: the JAX CPU path's expansion-formula ball query picks
    the same neighbours as the direct-difference reference on every SA1
    query of this batch."""
    batch = jax_run[0]
    for pts in (np.asarray(batch.obj_points), np.asarray(batch.rel_points)):
        rows = pts.reshape(-1, *pts.shape[2:])[:, :, :3]
        rows = rows[np.abs(rows).sum((1, 2)) > 0]  # padded slots carry no crop
        xyz = jnp.asarray(rows)
        new_xyz = np.take_along_axis(rows, np.asarray(j_fps(xyz, SA_NPOINTS[0]))[..., None].astype(np.int64), 1)
        for r, ns in zip((0.1, 0.2), SA_NSAMPLES[0]):
            want = ball_query_np(r, ns, rows, new_xyz)
            np.testing.assert_array_equal(np.asarray(j_ball_query(r, ns, xyz, jnp.asarray(new_xyz))), want)


def test_logprobs_match_jax(jax_run, port_model):
    jbatch, _, rel, obj, _ = jax_run
    batch = SceneBatch(**{f: np.asarray(getattr(jbatch, f)) for f in _FIELDS}, scan_ids=jbatch.scan_ids,
                       take_idxs=jbatch.take_idxs, slot_names=jbatch.slot_names)
    with torch.no_grad():  # an eval forward, as the eval entry points run it
        out = port_model(batch.to("cpu"), SlotPack.build(batch, paired=True).to("cpu"))
    em, om = np.asarray(jbatch.edge_mask), np.asarray(jbatch.obj_mask)
    np.testing.assert_allclose(out.rel_logprobs.numpy()[em], rel[em], atol=2e-4, rtol=0)
    np.testing.assert_allclose(out.obj_logprobs.numpy()[om], obj[om], atol=2e-4, rtol=0)


def test_predict_relations_matches_jax(jax_run, port_model):
    jbatch, _, rel, _, want = jax_run
    em = np.asarray(jbatch.edge_mask)
    top2 = np.sort(rel[em], axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 1e-3).all(), "argmax too close to call on these inputs"
    batch = make_scene_batch(ds=TDatasetConfig(**DS), **DATA)
    got = predict_relations(port_model, [batch])
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert sum(len(v) for v in got.values()) > 0
