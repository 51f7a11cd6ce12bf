"""MULTI_REL_OUTPUTS and the image-fused relation head of the port against
the JAX package, on the CPU: ``prepare_scene``'s multi-hot ``gt_rels``, the
sigmoid relation head with the 768-d image embedding fused between the
trunk's features and the one-hots, ``weighted_bce``, the multi-hot metric,
and a tiny ``no_gt_image`` + MULTI_REL ``Trainer`` step (loss, gradients of
every trainable parameter, parameters after the step, the frozen trunk
unchanged) and its 0.5-thresholded ``scan_relations`` JSON against the JAX
``Trainer``.

Both trainers start from the same randomized variables (the image trunk's
kernels scaled by their fan-in, so 39 blocks keep the activations bounded)
and the port is handed the JAX step's dropout keep-masks (recorded as in
``tests/test_torch_train.py``). Images are 32 x 32 so the B5 trunk runs at
full width in seconds.

The step uses ``tests/test_torch_train.py``'s first key. With the key
``jax.random.key(11)`` itself the forward still agrees (features to 1e-5)
but the gradients differ by up to 4.2e-3 of the largest, on the parent
tree as here (ROADMAP Queue 3 records it as an open fault, not isolated).

Tolerances: prep exactly; head outputs and the loss 1e-5 (float32 sums in
another order); gradients 1e-3 of the largest trainable gradient and
parameters 1e-4, as ``tests/test_torch_train.py`` states them; the JSON
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or4d_tpu.config import TINY as J_TINY
from or4d_tpu.data.prep import prepare_scene as j_prepare_scene
from or4d_tpu.data.scene_batch import SlotPack as JSlotPack
from or4d_tpu.data.synthetic import make_scene_batch as j_make_scene_batch, make_scene_sample as j_make_scene_sample
from or4d_tpu.data.vocab import DEFAULT_VOCAB as J_VOCAB
from or4d_tpu.models.heads import RelationClsHead as JRelHead
from or4d_tpu.models.sgpn import weighted_bce as j_weighted_bce
from or4d_tpu.parallel.mesh import make_mesh
from or4d_tpu.train.loop import Trainer as JTrainer
from or4d_tpu.train.metrics import RelationMetricAccumulator as JAcc
from tests.test_torch_models import randomize
from or4d_tpu.data import augment as jaug
from tests.test_torch_train import FIELDS, _check_ball_query_agrees, _recorder, jax_draws

from or4d_tpu_torch.config import TINY
from or4d_tpu_torch.convert import from_jax_variables
from or4d_tpu_torch.data.prep import prepare_scene
from or4d_tpu_torch.data.scene_batch import SceneBatch
from or4d_tpu_torch.data.synthetic import make_scene_sample
from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
from or4d_tpu_torch.models.heads import RelationClsHead
from or4d_tpu_torch.models.sgpn import weighted_bce
from or4d_tpu_torch.train.loop import Trainer
from or4d_tpu_torch.train.metrics import RelationMetricAccumulator

IMG = 32
LR = 1e-5


def test_prepare_scene_multi_hot_equals_jax():
    for seed in (1, 2):
        want = j_make_scene_sample(seed, n_objects=6, ds=J_TINY.dataset, points_per_obj=150, multi_rel=True)
        got = make_scene_sample(seed, n_objects=6, ds=TINY.dataset, points_per_obj=150, multi_rel=True)
        assert got.gt_rels.shape == (TINY.dataset.max_edges, DEFAULT_VOCAB.num_relations)
        assert got.gt_rels.dtype == np.float32 and got.gt_rels.sum() > 0
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_multi_hot_accumulates_every_relation_of_an_edge():
    """Two relations on one directed edge both set their bit (the single
    label's last write wins), an unknown name sets none."""
    rng = np.random.default_rng(0)
    points = np.concatenate([rng.normal(c, 0.1, (200, 3)) for c in (0.0, 1.0, 2.0)]).astype(np.float32)
    points = np.concatenate([points, rng.uniform(0, 1, (600, 3)).astype(np.float32)], axis=1)
    instances = np.repeat([1, 2, 3], 200)
    objs = {1: "Patient", 2: "instrument", 3: "human_0"}
    rels = [[3, 2, 0, "Holding"], [3, 2, 0, "CloseTo"], [3, 1, 0, "NotARelation"], [1, 2, 0, "CloseTo"]]
    out = {}
    for name, fn, ds, vocab in (("jax", j_prepare_scene, J_TINY.dataset, J_VOCAB),
                                ("port", prepare_scene, TINY.dataset, DEFAULT_VOCAB)):
        out[name] = fn(points, instances, objs, rels, vocab, ds, np.random.default_rng(3), multi_rel=True)
    np.testing.assert_array_equal(out["port"].gt_rels, out["jax"].gt_rels)
    g, e = out["port"].gt_rels, out["port"].edge_index
    edge = {(int(a), int(b)): i for i, (a, b) in enumerate(e[: int(out["port"].edge_mask.sum())])}
    names = DEFAULT_VOCAB.relation_names
    assert {names[r] for r in np.nonzero(g[edge[(2, 1)]])[0]} == {"Holding", "CloseTo"}
    assert g[edge[(2, 0)]].sum() == 0


@pytest.mark.parametrize("multi_label", [True, False])
def test_relation_head_with_image_fusion_equals_jax(multi_label):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 256)).astype(np.float32)
    onehot = (rng.uniform(size=(2, 7, 12)) > 0.7).astype(np.float32)
    img = rng.standard_normal((2, 768)).astype(np.float32)
    jm = JRelHead(15, multi_label=multi_label)
    v = randomize(jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(onehot),
                                                 jnp.asarray(img), train=False)), 5)
    want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(onehot), jnp.asarray(img), train=False))
    head = RelationClsHead(256, 15, image_features=768, multi_label=multi_label, device="cpu")
    head.load_state_dict(from_jax_variables(v, head))
    with torch.no_grad():
        got = head(torch.from_numpy(x), torch.from_numpy(onehot), image_embeddings=torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if multi_label:
        assert (got > 0).all() and (got < 1).all()


def test_weighted_bce_equals_jax():
    rng = np.random.default_rng(6)
    probs = rng.uniform(0, 1, (3, 9, 15)).astype(np.float32)
    probs[0, 0, :3] = (0.0, 1.0, 0.5)  # clipped to [1e-7, 1 - 1e-7]
    targets = (rng.uniform(size=(3, 9, 15)) > 0.8).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 15).astype(np.float32)
    mask = rng.uniform(size=(3, 9)) > 0.3
    want = float(j_weighted_bce(jnp.asarray(probs), jnp.asarray(targets), jnp.asarray(w), jnp.asarray(mask)))
    got = float(weighted_bce(*(torch.from_numpy(a) for a in (probs, targets, w, mask))))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_multi_hot_metric_equals_jax():
    rng = np.random.default_rng(7)
    batch = j_make_scene_batch(3, seed=9, n_objects=5, ds=J_TINY.dataset, points_per_obj=100, multi_rel=True)
    probs = rng.uniform(0, 1, batch.gt_rels.shape).astype(np.float32) * 0.9
    names = list(J_VOCAB.relation_names)
    j, p = JAcc(names), RelationMetricAccumulator(names)
    j.update_batch(batch, probs)
    p.update_batch(batch, probs)
    assert p.macro_f1 == j.macro_f1
    assert p.take_preds == j.take_preds and p.take_gts == j.take_gts


def _cfgs():
    """tiny with the image branch (32 x 32 frames), MULTI_REL and, as
    ``tests/test_torch_train.py`` runs it, augmentation, JAX and port."""
    return tuple(dataclasses.replace(base, lr=LR, image_input="full",
                                     dataset=dataclasses.replace(base.dataset, data_augmentation=True),
                                     model=dataclasses.replace(base.model, image_model="tf_efficientnet_b5_ns",
                                                               image_size=IMG, multi_rel_outputs=True))
                 for base in (J_TINY, TINY))


def _randomize(variables):
    """``randomize`` of every leaf, the image trunk's kernels then N(0,
    1/fan_in) over their whole receptive field."""
    v = randomize(variables, seed=3)
    rng = np.random.default_rng(4)

    def leaf(path, x):
        keys = [str(getattr(p, "key", p)) for p in path]
        if "image_branch" not in keys or keys[-1] != "kernel":
            return x
        return (rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, v)


@pytest.fixture(scope="module")
def step():
    """One train step of the JAX trainer and of the port's trainer from the
    same variables and dropout masks, then each side's scan_relations."""
    jcfg, tcfg = _cfgs()
    jbatch = j_make_scene_batch(2, seed=5, n_objects=4, ds=jcfg.dataset, points_per_obj=150, multi_rel=True)
    jbatch = dataclasses.replace(jbatch, images=np.random.default_rng(8).standard_normal(
        (2, 6, IMG, IMG, 3)).astype(np.float32))
    rng = np.random.default_rng(7)
    w_obj = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    w_rel = rng.uniform(0.5, 1.5, 15).astype(np.float32)
    jt = JTrainer(jcfg, J_VOCAB, w_obj, w_rel, mesh=make_mesh(dp=1, devices=jax.devices()[:1]))
    state = jt.init_state(jax.random.key(0), jbatch)
    variables = _randomize({"params": state.params, "batch_stats": state.batch_stats})
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=jt.tx.init(variables["params"]))
    port = Trainer(tcfg, DEFAULT_VOCAB, w_obj, w_rel, device="cpu")
    port.model.load_state_dict(from_jax_variables(variables, port.model))
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    batch = SceneBatch(**{f: np.asarray(getattr(jbatch, f)) for f in FIELDS}, images=np.asarray(jbatch.images),
                       scan_ids=jbatch.scan_ids, take_idxs=jbatch.take_idxs, slot_names=jbatch.slot_names)

    key = jax.random.fold_in(jax.random.key(11), 0)  # tests/test_torch_train.py's first step's key
    aug_key, drop_key = jax.random.split(key)
    aug = jaug.augment_batch(aug_key, jbatch)
    _check_ball_query_agrees(np.asarray(aug.obj_points), jcfg)
    _check_ball_query_agrees(np.asarray(aug.rel_points), jcfg)
    drops, jgrads = _recorder(jt)(state.params, state.batch_stats, aug, JSlotPack.build(jbatch), drop_key)
    keep = {"obj": torch.from_numpy(np.asarray(drops["obj_predictor"]) != 0),
            "rel": torch.from_numpy(np.asarray(drops["rel_predictor"]) != 0)}
    state, jparts, _ = jt.train_step(state, jbatch, key)
    S, O = batch.obj_points.shape[:2]
    tparts = port.train_step(batch, augment_draws=jax_draws(aug_key, S, O, batch.rel_points.shape[1]),
                             dropout_keep=keep)
    want = from_jax_variables({"params": jax.device_get(state.params),
                               "batch_stats": jax.device_get(state.batch_stats)}, port.model)
    named = from_jax_variables({"params": jax.device_get(jgrads), "batch_stats": jax.device_get(state.batch_stats)},
                               port.model)
    return {"jparts": {k: float(v) for k, v in jparts.items()}, "tparts": {k: float(v) for k, v in tparts.items()},
            "want": want, "got": dict(port.model.state_dict()), "before": before,
            "wgrad": {k: named[k] for k, p in port.model.named_parameters() if p.requires_grad},
            "grads": {k: p.grad for k, p in port.model.named_parameters() if p.requires_grad},
            "frozen": [k for k, p in port.model.named_parameters() if not p.requires_grad],
            "json": (jt.predict_relations(state, [jbatch]), port.predict_relations([batch]))}


def test_image_multirel_train_step_equals_jax_trainer(step):
    for k in ("loss", "loss_obj", "loss_rel"):
        np.testing.assert_allclose(step["tparts"][k], step["jparts"][k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert any(k.startswith("image_branch.trunk.conv_head") for k in step["grads"])
    assert any(k.startswith("image_branch.reduction") for k in step["grads"])
    scale = max(float(g.abs().max()) for g in step["wgrad"].values())
    for k, g in step["grads"].items():
        np.testing.assert_allclose(g.numpy(), step["wgrad"][k].numpy(), rtol=0, atol=1e-3 * scale, err_msg=k)
    for k, w in step["want"].items():
        np.testing.assert_allclose(step["got"][k].numpy(), w.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


def test_frozen_trunk_takes_no_update_or_decay(step):
    frozen = step["frozen"]
    assert "image_branch.trunk.bn_head.weight" in frozen and "image_branch.trunk.conv_stem.weight" in frozen
    assert not any(k.startswith(("image_branch.trunk.conv_head", "image_branch.reduction")) for k in frozen)
    for k in frozen:
        assert torch.equal(step["got"][k], step["before"][k]), k
        np.testing.assert_array_equal(step["want"][k].numpy(), step["before"][k].numpy(), err_msg=k)


def test_thresholded_scan_relations_equal_jax(step):
    want, got = step["json"]
    assert got == {k: [tuple(r) for r in v] for k, v in want.items()}
    n = [len(v) for v in got.values()]
    assert sum(n) > 0


def test_pad_scenes_with_images_equals_jax():
    """Zero scenes pad the batch, images included (or4d_tpu/data/scene_batch.py:108-127)."""
    jbatch = j_make_scene_batch(3, seed=2, n_objects=4, ds=J_TINY.dataset, points_per_obj=100, multi_rel=True)
    jbatch = dataclasses.replace(jbatch, images=np.random.default_rng(1).standard_normal(
        (3, 6, 8, 8, 3)).astype(np.float32))
    batch = SceneBatch(**{f: np.asarray(getattr(jbatch, f)) for f in FIELDS}, images=np.asarray(jbatch.images),
                       scan_ids=jbatch.scan_ids, take_idxs=jbatch.take_idxs, slot_names=jbatch.slot_names)
    want, got = jbatch.pad_scenes(4), batch.pad_scenes(4)
    assert got.num_scenes == 4 and batch.pad_scenes(3).num_scenes == 3
    for f in (*FIELDS, "images"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
