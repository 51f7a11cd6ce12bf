"""The port's data parallelism against the JAX package's: train steps on
dp = 2 and dp = 4 meshes of gloo ranks on the CPU (``parallel.launch.spawn``)
against the JAX ``Trainer`` on meshes of as many of the conftest's virtual
CPU devices, and against the port's own one-process step; scene padding,
gathered eval outputs, dp-sharded serving, the "dp-only" refusal and an
mp = 2 x dp = 2 mesh.

Each world size is spawned once for the module (``ranks``): every scenario
of that size runs in it, from the same randomized variables, and the
fixture returns each one's numbers. The JAX side is the trainer's own model,
mesh, dp-sharded pack and ``shard_batch``, with its loss differentiated in
one jitted call that also returns the new BN statistics; both sides apply
the heads' dropout with the same keep-masks (drawn with numpy), and with
augmentation the port's steps are handed the values ``augment_batch``
draws (``jax_draws``). The ranks run while the JAX side computes. The batch's
scenes hold 3, 5, 4 and 6 objects, so the ranks' blocks differ in how many
rows are valid: a missing reduction would show.

Tolerances: against JAX on the same mesh size, loss parts rtol 1e-5,
gradients 1e-3 of the largest (``tests/test_torch_train.py`` says why) and
BN running statistics 1e-5; against the port's one-process step, the loss
rtol 2e-4 (``tests/test_packing.py``); parameters after a step bit-equal on
every rank; serving F1 within 1e-6 of one process's.

Augmentation uses JAX's ``fold_in(key(11), 1)`` draws. With JAX's own
dropout draws instead of these masks (two keys), JAX's jitted and eager
dp = 1, 2 and 4 gradients lay 2.7e-3 to 5.2e-3 of the largest apart, each
summation order routing a few SA max-pool and ReLU decisions made within
float32 rounding its own way (ROADMAP Queue 3); on the masks drawn here
every pair of meshes agrees within 5e-6, on both sides.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from or4d_tpu.config import DatasetConfig as JDatasetConfig, ExperimentConfig as JExperimentConfig
from or4d_tpu.config import ModelConfig as JModelConfig, TPUConfig as JTPUConfig
from or4d_tpu.data import augment as jaug
from or4d_tpu.data.scene_batch import SceneBatch as JSceneBatch
from or4d_tpu.data.synthetic import make_scene_sample
from or4d_tpu.data.vocab import DEFAULT_VOCAB as J_VOCAB
from or4d_tpu.models.sgpn import sgpn_loss as j_sgpn_loss
from or4d_tpu.parallel.mesh import make_mesh as j_make_mesh, shard_batch as j_shard_batch
from or4d_tpu.train.loop import Trainer as JTrainer
from tests.test_torch_models import randomize
from tests.test_torch_train import _check_ball_query_agrees, _port_batch, jax_draws

from or4d_tpu_torch.config import DatasetConfig, ExperimentConfig, ModelConfig, TPUConfig
from or4d_tpu_torch.convert import from_jax_variables
from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
from or4d_tpu_torch.parallel.launch import spawn, trainer_jobs
from or4d_tpu_torch.train.loop import Trainer

DS = dict(num_points_objects=96, num_points_relation=128, max_objects=6, max_edges=30)
MODEL = dict(sa_npoints=(16, 8), sa_nsamples=((4, 8), (8, 8)))
OBJECTS = (3, 5, 4, 6)
LR = 1e-5
CASES = ("plain", "aug")  # the step jobs each world runs first, in this order


def _port_cfg(dp=-1, mp=1, aug=False) -> ExperimentConfig:
    return ExperimentConfig(lr=LR, model=ModelConfig(**MODEL), dataset=DatasetConfig(**DS, data_augmentation=aug),
                            tpu=TPUConfig(scene_batch=4, mesh_data=dp, mesh_model=mp))


def _jax_cfg(dp, aug=False) -> JExperimentConfig:
    return JExperimentConfig(lr=LR, model=JModelConfig(**MODEL),
                             dataset=JDatasetConfig(**DS, data_augmentation=aug),
                             tpu=JTPUConfig(scene_batch=4, mesh_data=dp, mesh_model=1, donate_state=False))


def _jax_reference(jt):
    """A function of (variables, batch, keep-masks): the JAX trainer's loss
    parts, gradients and new BN statistics on its mesh, the heads' dropout
    applied with the given masks (one jitted call, compiled once)."""

    def run(params, stats, batch, pack, keep_obj, keep_rel):
        keep = {"obj_predictor": keep_obj, "rel_predictor": keep_rel}

        def interceptor(next_fun, args, kwargs, context):
            if isinstance(context.module, nn.Dropout):  # the given masks, not a draw
                return jnp.where(keep[context.module.parent.name], args[0] / (1.0 - context.module.rate), 0.0)
            return next_fun(*args, **kwargs)

        def loss(p):
            with nn.intercept_methods(interceptor):
                o, mutated = jt.model.apply({"params": p, "batch_stats": stats}, batch, train=True, pack=pack,
                                            rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
            total, parts = j_sgpn_loss(o, batch, jt._w_obj, jt._w_rel, jt.cfg.model.lambda_o)
            return total, (parts, mutated["batch_stats"])

        grads, aux = jax.grad(loss, has_aux=True)(params)
        return aux, grads

    jitted = jax.jit(run)

    def reference(variables, batch, keep):
        with jt.mesh:
            (parts, stats), grads = jitted(variables["params"], variables["batch_stats"],
                                           j_shard_batch(batch, jt.mesh), jt._pack_for(batch),
                                           keep["obj"].numpy(), keep["rel"].numpy())
        return {k: float(v) for k, v in parts.items()}, jax.device_get(grads), jax.device_get(stats)

    return reference


def _keep(seed: int) -> dict:
    """The heads' dropout keep-masks (keep probability 0.7) of the batch."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.random((len(OBJECTS), n, 256)) < 0.7)
            for k, n in (("obj", DS["max_objects"]), ("rel", DS["max_edges"]))}


@pytest.fixture(scope="module")
def setup():
    """The batch, class weights, randomized variables (and the port's
    state_dict of them), the augmentation draws, the keep-masks, the ranks
    of both world sizes (started at once, and run while the JAX side
    computes; ``ranks`` collects them) and the JAX references per mesh size
    and case."""
    jds = JDatasetConfig(**DS)
    jbatch = JSceneBatch.stack([make_scene_sample(20 + i, n_objects=n, ds=jds, scan_idx=i, points_per_obj=150)
                                for i, n in enumerate(OBJECTS)])
    rng = np.random.default_rng(7)
    w_obj = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    w_rel = rng.uniform(0.5, 1.5, 15).astype(np.float32)
    j1 = JTrainer(_jax_cfg(1), J_VOCAB, w_obj, w_rel, mesh=j_make_mesh(dp=1, devices=jax.devices()[:1]))
    shapes = jax.eval_shape(lambda: j1.model.init({"params": jax.random.key(0), "dropout": jax.random.key(0)},
                                                  jbatch, train=False))
    variables = randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes), seed=3)
    port = Trainer(_port_cfg(), DEFAULT_VOCAB, w_obj, w_rel, device="cpu")
    S, O = jbatch.obj_points.shape[:2]
    aug_key = jax.random.fold_in(jax.random.key(11), 1)
    s = dict(batch=_port_batch(jbatch), weights=(w_obj, w_rel), state=from_jax_variables(variables, port.model),
             draws={"plain": None, "aug": jax_draws(aug_key, S, O, jbatch.rel_points.shape[1])},
             keeps={"plain": _keep(5), "aug": _keep(6)}, port=port)
    pool = concurrent.futures.ThreadPoolExecutor(2)
    s["futures"] = {D: pool.submit(spawn, trainer_jobs, D, (_jobs(s, D),), threads=1) for D in (2, 4)}
    pool.shutdown(wait=False)

    batches = {"plain": jbatch, "aug": jaug.augment_batch(aug_key, jbatch)}
    for b in batches.values():  # the JAX CPU ball query's expansion picks the scan-order neighbours
        _check_ball_query_agrees(np.asarray(b.obj_points), j1.cfg)
        _check_ball_query_agrees(np.asarray(b.rel_points), j1.cfg)
    s["ref"] = {}
    for D in (2, 4):
        jt = JTrainer(_jax_cfg(D), J_VOCAB, w_obj, w_rel)
        assert jt.mesh.shape["dp"] == D and jt._pack_for(jbatch).obj_idx.shape[0] == D
        reference = _jax_reference(jt)
        for name, b in batches.items():
            s["ref"][D, name] = reference(variables, b, s["keeps"][name])
    return s


def _jobs(s, D):
    """Every scenario of world size D, in order."""
    base = dict(weights=s["weights"], state=s["state"])
    batch, keeps = s["batch"], s["keeps"]
    jobs = [dict(base, cfg=_port_cfg(D, aug=name != "plain"),
                 train=[dict(batch=batch, keep=keeps[name], draws=s["draws"][name])]) for name in CASES]
    three = _three(batch)
    if D == 2:  # scene 3's masks cover the padded scene
        jobs += [dict(base, cfg=_port_cfg(2), train=[dict(batch=three, keep=keeps["plain"])]),
                 dict(base, cfg=_port_cfg(2), eval=[three, batch]),
                 dict(base, cfg=_port_cfg(1, 2), refusal=[batch])]
    else:
        jobs += [dict(base, cfg=_port_cfg(4), serving=[batch, three]),
                 dict(base, cfg=_port_cfg(2, 2), train=jobs[0]["train"])]
    return jobs


def _three(batch):
    """The first three scenes: dp = 2 pads them to four."""
    return dataclasses.replace(batch, **{f: getattr(batch, f)[:3] for f in (
        "obj_points", "rel_points", "edge_index", "rel_onehot", "gt_class", "gt_rels", "obj_mask", "edge_mask",
        "rel_hand_points")}, scan_ids=batch.scan_ids[:3], take_idxs=batch.take_idxs[:3],
        slot_names=batch.slot_names[:3])


@pytest.fixture(scope="module")
def ranks(setup):
    """{D: [rank 0's job results, rank 1's, ...]} for D = 2 and 4."""
    return {D: f.result() for D, f in setup["futures"].items()}


@pytest.fixture(scope="module")
def one(setup):
    """The port's one-process results (no process group) of the scenarios,
    each once: {"plain", "aug", "three"} steps, "eval" and "f1"."""
    s = setup
    base = dict(weights=s["weights"], state=s["state"], cfg=_port_cfg(1))
    three = _three(s["batch"])
    jobs = [dict(base, cfg=_port_cfg(1, aug=name != "plain"), train=_jobs(s, 2)[i]["train"])
            for i, name in enumerate(CASES)]
    jobs += [dict(base, train=[dict(batch=three, keep={k: v[:3] for k, v in s["keeps"]["plain"].items()})]),
             dict(base, eval=[three, s["batch"]]), dict(base, serving=[s["batch"], three])]
    res = trainer_jobs(jobs)
    n = len(CASES)
    return {**dict(zip(CASES, res)), "three": res[n], "eval": res[n + 1]["eval"], "f1": res[n + 2]["f1"]}


def _max_rel(got: dict, want: dict) -> float:
    scale = max(float(v.abs().max()) for v in want.values())
    return max(float((got[k] - want[k]).abs().max()) for k in want) / scale


def _jax_named(setup, D, name):
    """JAX's gradients and new BN statistics of a case, by the port's names."""
    _parts, jgrads, jstats = setup["ref"][D, name]
    return from_jax_variables({"params": jgrads, "batch_stats": jstats}, setup["port"].model)


def _grads(named, model):
    return {k: named[k] for k, _ in model.named_parameters()}


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_dp_step_matches_the_jax_trainer_on_the_same_mesh(setup, ranks, D, name):
    res = ranks[D][0][CASES.index(name)]
    assert res["mesh"] == {"dp": D, "mp": 1}
    for k, v in setup["ref"][D, name][0].items():
        np.testing.assert_allclose(res["parts"][0][k], v, rtol=1e-5, err_msg=k)
    model = setup["port"].model
    named = _jax_named(setup, D, name)
    assert _max_rel(res["grads"], _grads(named, model)) < 1e-3
    stats = [k for k in named if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        torch.testing.assert_close(res["state"][k], named[k], rtol=1e-5, atol=1e-5, msg=k)


def test_augmented_gradients_agree_across_meshes(ranks, one):
    """The port's dp = 2, dp = 4 and one-process gradients of the augmented
    step agree within 1e-5 of the largest (a mesh changes only summation
    orders)."""
    i = CASES.index("aug")
    for D in (2, 4):
        assert _max_rel(ranks[D][0][i]["grads"], one["aug"]["grads"]) < 1e-5


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_dp_step_matches_one_process_and_ranks_agree(ranks, one, D, name):
    """The loss of the port's dp = D step equals its one-process step's
    (rtol 2e-4), and every rank holds the same parameters and statistics
    after it, bit for bit."""
    i = CASES.index(name)
    np.testing.assert_allclose(ranks[D][0][i]["parts"][0]["loss"], one[name]["parts"][0]["loss"], rtol=2e-4)
    for r in range(1, D):
        for k, v in ranks[D][0][i]["state"].items():
            assert torch.equal(ranks[D][r][i]["state"][k], v), (r, k)


def test_padded_scenes_add_nothing_and_eval_is_gathered_in_scene_order(setup, ranks, one):
    """S = 3 on dp = 2: the step's loss equals one process's on the three
    scenes (the padded fourth scene's keep-masks are never read), and the
    eval outputs come back as three scenes, in order, equal to one
    process's; the four-scene batch's too."""
    res, n = ranks[2][0], len(CASES)
    np.testing.assert_allclose(res[n]["parts"][0]["loss"], one["three"]["parts"][0]["loss"], rtol=2e-4)
    assert res[n]["rel_logprobs"].shape[0] == 3
    for (rel, obj), (wrel, wobj), b in zip(res[n + 1]["eval"], one["eval"], (_three(setup["batch"]), setup["batch"])):
        assert rel.shape == wrel.shape and obj.shape == wobj.shape
        em, om = torch.from_numpy(b.edge_mask), torch.from_numpy(b.obj_mask)
        torch.testing.assert_close(rel[em], wrel[em], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(obj[om], wobj[om], rtol=1e-5, atol=1e-5)
    for r in range(2):  # every rank gathers the same outputs
        for (rel, obj), (r0rel, r0obj) in zip(ranks[2][r][n + 1]["eval"], res[n + 1]["eval"]):
            assert torch.equal(rel, r0rel) and torch.equal(obj, r0obj)


def test_serving_on_dp4_matches_one_process(ranks, one):
    got = [ranks[4][r][len(CASES)]["f1"] for r in range(4)]
    assert all(abs(f - one["f1"]) < 1e-6 for f in got), (got, one["f1"])


def test_serving_refuses_an_mp_mesh(ranks):
    i = len(CASES) + 2
    assert ranks[2][0][i]["mesh"] == {"dp": 1, "mp": 2}
    assert all("dp-only" in ranks[2][r][i]["refusal"] for r in range(2))


def test_mp2_dp2_unpacked_loss_matches_dp4_packed(ranks):
    """As ``tests/test_packing.py``: the dp = 2 x mp = 2 step (no pack, the
    slot axes over mp) gives the dp = 4 packed step's loss (rtol 2e-4);
    every rank holds the same parameters after it."""
    i = len(CASES) + 1
    mp = ranks[4][0][i]
    assert mp["mesh"] == {"dp": 2, "mp": 2}
    np.testing.assert_allclose(mp["parts"][0]["loss"], ranks[4][0][0]["parts"][0]["loss"], rtol=2e-4)
    for r in range(1, 4):
        for k, v in mp["state"].items():
            assert torch.equal(ranks[4][r][i]["state"][k], v), (r, k)
