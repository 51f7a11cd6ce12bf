"""The train slice of the port against the JAX package: ``Trainer`` steps on
the ``tiny`` config (augmentation on), augmentation, class weights,
metrics and checkpoints.

Both trainers start from the same (randomized) variables. The port's
trainer is handed the random numbers the JAX step draws: the augmentation
values derived from the same key tree as ``augment_batch`` derives them,
and the heads' dropout keep-masks, recorded with
``flax.linen.intercept_methods`` around ``nn.Dropout`` (a unit is kept where
its output is nonzero). On the CPU the JAX SGPN runs its XLA fallback,
whose ball query uses the |a|^2 + |b|^2 - 2ab expansion; the test first
checks that it picks the same neighbours as the direct difference on every
augmented batch, so any later mismatch is the port's.

Tolerances: loss parts 1e-5; parameters and BN running statistics 1e-4
(f32 summation order); every parameter's gradient 1e-3 of the largest
gradient of the model: the jitted JAX gradient of the relation encoder's
SA1 on the CPU departs from JAX's own eager gradient by up to 1.6e-4 of
that scale on these inputs, and by 1% on un-augmented crops (ROADMAP
Queue 3), while the port matches the eager gradient to 1e-5. The trainers run at lr 1e-5: AdamW's first steps
scale each gradient element to about +-lr, so an element whose gradient is
rounding noise on both sides (a Dense bias that feeds a BN has an
analytically zero gradient) moves by +-lr at random; the gradients are
compared directly, and the AdamW arithmetic is checked against optax at
the tiny config's lr 1e-3 on its own.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax
from flax import linen as nn

from or4d_tpu.config import TINY as J_TINY
from or4d_tpu.data import augment as jaug
from or4d_tpu.data.scene_batch import SlotPack as JSlotPack
from or4d_tpu.data.synthetic import make_scene_batch as j_make_scene_batch
from or4d_tpu.data.vocab import DEFAULT_VOCAB as J_VOCAB
from or4d_tpu.data.weights import compute_weights as j_compute_weights
from or4d_tpu.models.sgpn import sgpn_loss as j_sgpn_loss
from or4d_tpu.ops.ball_query import ball_query as j_ball_query
from or4d_tpu.ops.fps import furthest_point_sample as j_fps
from or4d_tpu.parallel.mesh import make_mesh
from or4d_tpu.train.loop import Trainer as JTrainer
from or4d_tpu.train.metrics import RelationMetricAccumulator as JAcc
from tests.reference_impls import ball_query_np
from tests.test_torch_models import randomize

from or4d_tpu_torch.config import TINY
from or4d_tpu_torch.convert import from_jax_variables
from or4d_tpu_torch.data.augment import AugmentDraws, augment_batch_with
from or4d_tpu_torch.data.scene_batch import SceneBatch
from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
from or4d_tpu_torch.data.weights import compute_weights, sample_counts, weights_from_counts
from or4d_tpu_torch.train import checkpoint as ckpt
from or4d_tpu_torch.train.loop import Trainer
from or4d_tpu_torch.train.metrics import RelationMetricAccumulator

FIELDS = ("obj_points", "rel_points", "edge_index", "rel_onehot", "gt_class", "gt_rels", "obj_mask", "edge_mask",
          "rel_hand_points")
DATA = dict(num_scenes=2, seed=5, n_objects=4, points_per_obj=150)
STEPS = 3
LR = 1e-5


def _cfgs(lr=None):
    """tiny with augmentation on (and ``lr`` when given), JAX and port."""
    out = []
    for base in (J_TINY, TINY):
        out.append(dataclasses.replace(base, lr=lr or base.lr,
                                       dataset=dataclasses.replace(base.dataset, data_augmentation=True)))
    return tuple(out)


def _port_batch(jbatch) -> SceneBatch:
    return SceneBatch(**{f: np.asarray(getattr(jbatch, f)) for f in FIELDS}, scan_ids=jbatch.scan_ids,
                      take_idxs=jbatch.take_idxs, slot_names=jbatch.slot_names)


def jax_draws(key, S, O, E) -> AugmentDraws:
    """The values ``or4d_tpu.data.augment.augment_batch(key, ...)`` draws,
    split from the key exactly as it splits them."""

    def crop(k, cfg):
        kb, kc, ks, ky, kx, kz, kg = jax.random.split(k, 7)
        u = jax.random.uniform
        return {"brightness": u(kb, (), minval=-cfg["brightness"], maxval=cfg["brightness"]),
                "colors": u(kc, (3,), minval=-cfg["colors"], maxval=cfg["colors"]),
                "shift": u(ks, (3,), minval=-cfg["shift"], maxval=cfg["shift"]),
                "y_rot": u(ky, (), minval=-cfg["y_rot"], maxval=cfg["y_rot"]),
                "x_rot": u(kx, (), minval=-cfg["x_rot"], maxval=cfg["x_rot"]),
                "z_rot": u(kz, (), minval=-cfg["z_rot"], maxval=cfg["z_rot"]),
                "scale": u(kg, (), minval=cfg["scale"][0], maxval=cfg["scale"][1])}

    def rel(k):
        kt, ka, k1, k2 = jax.random.split(k, 4)
        return (jax.random.uniform(kt, (), minval=jaug.HAND_THRESHOLD, maxval=1.0),
                crop(ka, jaug.OBJ_CFG), crop(k1, jaug.REL_CFG), crop(k2, jaug.REL_CFG))

    k_apply, k_obj, k_rel = jax.random.split(key, 3)
    apply = jax.random.uniform(k_apply, (S,)) < 0.75
    obj = jax.vmap(jax.vmap(lambda k: crop(k, jaug.OBJ_CFG)))(jax.random.split(k_obj, (S, O)))
    thres, p0, p1, p2 = jax.vmap(jax.vmap(rel))(jax.random.split(k_rel, (S, E)))
    t = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    return AugmentDraws(torch.from_numpy(np.array(apply)), t(obj), torch.from_numpy(np.array(thres)),
                        (t(p0), t(p1), t(p2)))


def _recorder(jt):
    """A jitted copy of the JAX trainer's loss on an augmented batch that
    returns the heads' dropout outputs (keyed by head name) and the
    gradient of every parameter."""

    def run(params, stats, batch, pack, key):
        outs = {}

        def interceptor(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, nn.Dropout):
                outs[context.module.parent.name] = out
            return out

        def loss(p):
            with nn.intercept_methods(interceptor):
                o, _ = jt.model.apply({"params": p, "batch_stats": stats}, batch, train=True, pack=pack,
                                      rngs={"dropout": key}, mutable=["batch_stats"])
            return j_sgpn_loss(o, batch, jt._w_obj, jt._w_rel, jt.cfg.model.lambda_o)[0], dict(outs)

        grads, drops = jax.grad(loss, has_aux=True)(params)
        return drops, grads

    return jax.jit(run)


def _check_ball_query_agrees(points, cfg):
    """The JAX XLA ball query equals the scan-order reference on every query
    of SA1 and SA2 of the valid crops."""
    rows = points.reshape(-1, *points.shape[2:])[:, :, :3]
    rows = rows[np.abs(rows).sum((1, 2)) > 0]
    for npoint, radii, nsamples in zip(cfg.model.sa_npoints, ((0.1, 0.2), (0.2, 0.4)), cfg.model.sa_nsamples):
        idx = np.asarray(j_fps(jnp.asarray(rows), npoint)).astype(np.int64)
        q = np.take_along_axis(rows, idx[..., None], 1)
        for r, ns in zip(radii, nsamples):
            np.testing.assert_array_equal(np.asarray(j_ball_query(r, ns, jnp.asarray(rows), jnp.asarray(q))),
                                          ball_query_np(r, ns, rows, q))
        rows = q


def _setup():
    """The JAX trainer, its state from the randomized variables, and the
    inputs both trainers share."""
    jcfg, tcfg = _cfgs(LR)
    jbatch = j_make_scene_batch(ds=jcfg.dataset, **DATA)
    rng = np.random.default_rng(7)
    w_obj = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    w_rel = rng.uniform(0.5, 1.5, 15).astype(np.float32)
    jt = JTrainer(jcfg, J_VOCAB, w_obj, w_rel, mesh=make_mesh(dp=1, devices=jax.devices()[:1]))
    state = jt.init_state(jax.random.key(0), jbatch)
    variables = jax.device_get(randomize({"params": state.params, "batch_stats": state.batch_stats}, seed=3))

    init = jax.device_get(state)

    def fresh_state():  # a train step donates its state's buffers
        v = jax.device_put(variables)
        return jax.device_put(init).replace(params=v["params"], batch_stats=v["batch_stats"],
                                            opt_state=jt.tx.init(v["params"]))

    return jcfg, tcfg, jbatch, w_obj, w_rel, jt, fresh_state, variables


@pytest.fixture(scope="module")
def runs():
    """STEPS train steps of the JAX trainer and of the port's trainer from
    the same variables, draws and dropout masks (``fold_in(key(11), i)``),
    then, from the same variables again, one step on ``key(11)`` itself
    (``runs["key(11)"]``): per step the losses and both sides' variables
    (flattened to the port's state_dict names)."""
    jcfg, tcfg, jbatch, w_obj, w_rel, jt, fresh_state, variables = _setup()
    batch = _port_batch(jbatch)
    out = {}
    for name, keys in ((None, [jax.random.fold_in(jax.random.key(11), i) for i in range(STEPS)]),
                       ("key(11)", [jax.random.key(11)])):
        port = Trainer(tcfg, DEFAULT_VOCAB, w_obj, w_rel, device="cpu")
        port.model.load_state_dict(from_jax_variables(variables, port.model))
        steps = _steps(jt, fresh_state(), jbatch, jcfg, port, batch, keys)
        if name is None:
            out.update(enumerate(steps, 1))
        else:
            out[name] = steps[0]
    return out


def _steps(jt, state, jbatch, jcfg, port, batch, keys):
    S, O = batch.obj_points.shape[:2]
    E = batch.rel_points.shape[1]
    record = _recorder(jt)
    jpack = JSlotPack.build(jbatch)
    out = []
    for key in keys:
        aug_key, drop_key = jax.random.split(key)
        aug = jaug.augment_batch(aug_key, jbatch)
        _check_ball_query_agrees(np.asarray(aug.obj_points), jcfg)
        _check_ball_query_agrees(np.asarray(aug.rel_points), jcfg)
        drops, jgrads = record(state.params, state.batch_stats, aug, jpack, drop_key)
        keep = {"obj": torch.from_numpy(np.asarray(drops["obj_predictor"]) != 0),
                "rel": torch.from_numpy(np.asarray(drops["rel_predictor"]) != 0)}
        state, jparts, _ = jt.train_step(state, jbatch, key)
        tparts = port.train_step(batch, augment_draws=jax_draws(aug_key, S, O, E), dropout_keep=keep)
        want = from_jax_variables({"params": jax.device_get(state.params),
                                   "batch_stats": jax.device_get(state.batch_stats)}, port.model)
        got = {k: v.detach().clone() for k, v in port.model.state_dict().items()}
        named = from_jax_variables({"params": jax.device_get(jgrads), "batch_stats": jax.device_get(state.batch_stats)},
                                   port.model)
        wgrad = {k: named[k] for k, _ in port.model.named_parameters()}
        grads = {k: p.grad.clone() for k, p in port.model.named_parameters()}
        out.append(({k: float(v) for k, v in jparts.items()}, {k: float(v) for k, v in tparts.items()}, want, got,
                    wgrad, grads))
    return out


# the ReLU input that JAX's float32 forward rounds across zero on the
# key(11) draw: gcn.layer_0.nn1's second BN, scene 0, edge 1, channel 453
KEY11_FLIP = (("gcn", "layer_0", "nn1", "bn_1"), (0, 1, 453))


def float64_reference(path: str) -> None:
    """The JAX trainer's loss gradient on the key(11) draw in float64,
    written to ``path`` (npz, the port's parameter names), with the
    gcn.layer_0.nn1 second BN output (the ReLU input, ``relu_in``) in
    float64 and in float32.

    Runs the JAX package's own modules, eagerly: everything is drawn and
    recorded in float32 as the fixture does (augmentation, the heads'
    dropout keep-masks), then the model runs under ``jax.enable_x64`` with float64
    parameters and crops, ``compute_dtype`` float64, and the float32 casts
    of ``or4d_tpu.models.layers`` (masked BN) and ``or4d_tpu.models.sgpn``
    (masks, outputs, loss) made float64 by rebinding those modules' ``jnp``
    to a namespace whose ``float32`` is ``float64``. The geometry stays
    float32 (``pointnet2`` casts xyz itself), so FPS and the ball queries
    pick the float32 run's points. The rebinding stays in the process, so
    this runs in a subprocess of its own."""
    import types

    import or4d_tpu.models.layers as jlayers
    import or4d_tpu.models.sgpn as jsgpn

    jax.config.update("jax_platforms", "cpu")
    jcfg, tcfg, jbatch, w_obj, w_rel, jt, fresh_state, variables = _setup()
    state = fresh_state()
    aug_key, drop_key = jax.random.split(jax.random.key(11))
    aug = jaug.augment_batch(aug_key, jbatch)
    jpack = JSlotPack.build(jbatch)
    drops, _ = _recorder(jt)(state.params, state.batch_stats, aug, jpack, drop_key)
    keep = {k: np.asarray(v) != 0 for k, v in drops.items()}

    def loss_and_relu_in(dtype):
        """The loss and the flip's layer output (before its ReLU), as a
        function of the parameters."""

        def interceptor(next_fun, args, kwargs, context):
            if isinstance(context.module, nn.Dropout):  # the recorded masks, not a draw
                x = args[0]
                return jnp.where(keep[context.module.parent.name], x / (1.0 - context.module.rate), 0.0)
            out = next_fun(*args, **kwargs)
            if context.module.path == KEY11_FLIP[0] and context.method_name == "__call__":
                seen["y"] = out
            return out

        seen = {}
        model = dataclasses.replace(jt.model, compute_dtype=dtype)

        def loss(p, stats, batch):
            with nn.intercept_methods(interceptor):
                o, _ = model.apply({"params": p, "batch_stats": stats}, batch, train=True, pack=jpack,
                                   rngs={"dropout": drop_key}, mutable=["batch_stats"])
            w = lambda a: jnp.asarray(a, dtype)
            return jsgpn.sgpn_loss(o, batch, w(w_obj), w(w_rel), jt.cfg.model.lambda_o)[0], seen["y"]

        return loss

    # eager, not jitted: on the CPU the jitted float64 gradient of the
    # relation encoder's SA1 departs from the eager one by 0.33 of the
    # largest on this draw (the eager one equals the port's float64 gradient)
    _, y32 = loss_and_relu_in(jnp.float32)(state.params, state.batch_stats, aug)
    f64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    f64.float32 = jnp.float64
    jlayers.jnp = jsgpn.jnp = f64
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        batch64 = dataclasses.replace(aug, obj_points=jnp.asarray(np.asarray(aug.obj_points), jnp.float64),
                                      rel_points=jnp.asarray(np.asarray(aug.rel_points), jnp.float64))
        grads, y64 = jax.grad(loss_and_relu_in(jnp.float64), has_aux=True)(
            to64(state.params), to64(state.batch_stats), batch64)
        grads, y64 = jax.device_get(grads), np.asarray(y64)
    port = Trainer(tcfg, DEFAULT_VOCAB, w_obj, w_rel, device="cpu")
    named = from_jax_variables({"params": grads, "batch_stats": jax.device_get(state.batch_stats)}, port.model)
    np.savez(path, relu_in_f64=y64, relu_in_f32=np.asarray(y32),
             **{"grad/" + k: np.asarray(named[k], np.float64) for k, _ in port.model.named_parameters()})


@pytest.fixture(scope="module")
def key11_float64(tmp_path_factory):
    """:func:`float64_reference`, run in a subprocess (which dies with its
    test at the harness's time limit)."""
    import os
    import subprocess
    import sys

    path = tmp_path_factory.mktemp("f64") / "ref.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = f"from tests.test_torch_train import float64_reference; float64_reference({str(path)!r})"
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    ref = np.load(path)
    return ({k[5:]: torch.from_numpy(ref[k]) for k in ref.files if k.startswith("grad/")},
            ref["relu_in_f64"], ref["relu_in_f32"])


@pytest.mark.parametrize("step", [1, STEPS, "key(11)"])
def test_train_steps_match_jax_trainer(runs, step, request):
    """Steps 1 and STEPS of the fold_in draws against the JAX trainer; the
    key(11) draw's gradients against the JAX package's float64 gradient
    (:func:`float64_reference`), because there JAX's float32 forward rounds
    one ReLU input across zero (``test_key11_reference_rounds_a_relu_input_across_zero``)
    and its float32 gradient departs from its own float64 one by 4.2e-3 of
    the largest; everything else on that draw against the JAX trainer."""
    jparts, tparts, want, got, wgrad, grads = runs[step]
    for k in ("loss", "loss_obj", "loss_rel"):
        np.testing.assert_allclose(tparts[k], jparts[k], rtol=1e-5, atol=1e-5, err_msg=k)
    if step == "key(11)":
        wgrad = request.getfixturevalue("key11_float64")[0]
    scale = max(float(g.abs().max()) for g in wgrad.values())
    assert set(grads) == set(wgrad)
    for k in wgrad:
        np.testing.assert_allclose(grads[k].double().numpy(), wgrad[k].double().numpy(), rtol=0, atol=1e-3 * scale,
                                   err_msg=k)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
    if step == STEPS:  # later steps moved the parameters and the running statistics on
        for k in ("gcn.layer_0.nn1.dense_0.weight", "obj_encoder.sa1.mlp_0.bn_0.running_mean"):
            assert not torch.equal(got[k], runs[1][3][k]), k


def test_key11_reference_rounds_a_relu_input_across_zero(runs, key11_float64):
    """Why the key(11) case holds the port against float64: the one ReLU
    input of gcn.layer_0.nn1's second BN whose sign differs between JAX's
    float32 and float64 forwards (eager) is KEY11_FLIP, a value within 1e-5
    of zero, where the gradient of gcn.layer_0.nn1 is discontinuous. JAX's
    trainer's float32
    gradient is off its float64 one by more than the 1e-3 tolerance; the
    port's is within 1e-5 of the largest."""
    g64, y64, y32 = key11_float64
    valid = np.asarray(j_make_scene_batch(ds=_cfgs()[0].dataset, **DATA).edge_mask) > 0
    flips = np.argwhere(((y64 > 0) != (y32 > 0)) & valid[..., None])
    assert [tuple(f) for f in flips] == [KEY11_FLIP[1]]
    at = KEY11_FLIP[1]
    assert abs(y64[at]) < 1e-5 and y64[at] < 0 < y32[at]
    _, _, _, _, wgrad, grads = runs["key(11)"]
    scale = max(float(g.abs().max()) for g in g64.values())
    jax_gap = max(float((wgrad[k].double() - g64[k]).abs().max()) for k in g64) / scale
    port_gap = max(float((grads[k].double() - g64[k]).abs().max()) for k in g64) / scale
    assert jax_gap > 1e-3 and port_gap < 1e-5, (jax_gap, port_gap)


def test_adamw_matches_optax():
    """torch AdamW as the Trainer builds it against optax.adamw (the JAX
    trainer's optimizer) over three steps at the tiny config's lr."""
    _, tcfg = _cfgs()
    rng = np.random.default_rng(8)
    p0 = rng.standard_normal((64, 32)).astype(np.float32)
    grads = [rng.standard_normal((64, 32)).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    tx = optax.adamw(tcfg.lr, weight_decay=tcfg.w_decay)
    jp, opt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.AdamW([tp], lr=tcfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=tcfg.w_decay)
    for g in grads:
        upd, opt = tx.update(jnp.asarray(g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_augment_matches_jax_with_the_same_draws():
    jcfg, _ = _cfgs()
    jbatch = j_make_scene_batch(ds=jcfg.dataset, **DATA)
    key = jax.random.key(2)
    want = jaug.augment_batch(key, jbatch)
    batch = _port_batch(jbatch).to("cpu")
    S, O = batch.obj_points.shape[:2]
    got = augment_batch_with(batch, jax_draws(key, S, O, batch.rel_points.shape[1]))
    for f in ("obj_points", "rel_points"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    assert not np.array_equal(got.rel_points.numpy(), np.asarray(jbatch.rel_points))


def test_class_weights_match_jax():
    scans = [{"take_idx": 1, "scan": f"{i:06d}", "objects": {"1": "Patient", "2": "instrument", "3": "human_0"},
              "relationships": [[1, 2, 0, "Holding"], [3, 1, 0, "CloseTo"]] * (i + 1)} for i in range(3)]
    for got, want in zip(compute_weights(DEFAULT_VOCAB, scans), j_compute_weights(J_VOCAB, scans)):
        np.testing.assert_array_equal(got, want)
    jcfg, _ = _cfgs()
    samples_batch = _port_batch(j_make_scene_batch(ds=jcfg.dataset, **DATA))
    obj, rel = sample_counts(DEFAULT_VOCAB, [dataclasses.replace(samples_batch, **{
        f: getattr(samples_batch, f)[s] for f in FIELDS}) for s in range(2)])
    assert obj.sum() == samples_batch.obj_mask.sum() and rel[DEFAULT_VOCAB.none_index] == 0
    w_obj, w_rel = weights_from_counts(DEFAULT_VOCAB, obj, rel)
    assert w_rel[DEFAULT_VOCAB.none_index] == np.float32(1e-4) and np.isfinite(w_obj).all()


def test_relation_metrics_match_jax():
    jcfg, _ = _cfgs()
    jbatch = j_make_scene_batch(ds=jcfg.dataset, **dict(DATA, num_scenes=3))
    logits = np.random.default_rng(9).standard_normal(np.asarray(jbatch.gt_rels).shape + (15,)).astype(np.float32)
    got, want = RelationMetricAccumulator(list(DEFAULT_VOCAB.relation_names)), JAcc(list(J_VOCAB.relation_names))
    got.update_batch(_port_batch(jbatch), torch.from_numpy(logits))
    want.update_batch(jbatch, logits)
    assert got.macro_f1 == want.macro_f1
    assert got.overall_report().to_text() == want.overall_report().to_text()


def test_checkpoint_round_trip_and_resume(tmp_path):
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    batch = _port_batch(j_make_scene_batch(ds=jcfg.dataset, **DATA))
    w = np.ones(12, np.float32), np.ones(15, np.float32)
    gen = lambda s: torch.Generator().manual_seed(s)
    straight = Trainer(tcfg, DEFAULT_VOCAB, *w, device="cpu", seed=1)
    straight.train_step(batch, gen(21))
    first = Trainer(tcfg, DEFAULT_VOCAB, *w, device="cpu", seed=1)
    first.train_step(batch, gen(21))
    ckpt.save(tmp_path, first.model, first.optimizer, first.step)
    resumed = Trainer(tcfg, DEFAULT_VOCAB, *w, device="cpu", seed=2)
    assert ckpt.latest_step(tmp_path) == 1
    resumed.step = ckpt.restore(tmp_path, resumed.model, resumed.optimizer)
    for k, v in first.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    a = straight.train_step(batch, gen(22))
    b = resumed.train_step(batch, gen(22))
    assert resumed.step == straight.step == 2 and float(a["loss"]) == float(b["loss"])
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_fit_runs_epochs_with_validation_and_checkpoints(tmp_path):
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    batch = _port_batch(j_make_scene_batch(ds=jcfg.dataset, **DATA))
    trainer = Trainer(tcfg, DEFAULT_VOCAB, np.ones(12, np.float32), np.ones(15, np.float32), device="cpu")
    history = trainer.fit([batch], val_batches=[batch], epochs=2, log_every=0, checkpoint_dir=str(tmp_path))
    assert [h["epoch"] for h in history] == [0, 1] and trainer.step == 2
    assert all(np.isfinite(h["train_loss"]) and 0.0 <= h["val_macro_f1"] <= 1.0 for h in history)
    assert ckpt.latest_step(tmp_path) == 2
