"""The port's Group-Free losses and trainer against the JAX package on the
CPU.

* every loss term (``smoothl1``, ``sigmoid_focal_loss``,
  ``kps_objectness_loss``, ``layer_losses``, ``_ce``,
  ``groupfree_total_loss``) against ``or4d_tpu.models.groupfree_loss`` on
  random inputs, 1e-6 of the largest value; the KPS loss also where a box
  has fewer member seeds than topk, so its topk seeds include seeds at the
  tied distance 100.0 (ties to the lowest index: the labels must be the
  same);
* two ``GroupFreeTrainer`` steps (16 proposals, 2 decoder layers, dropout
  0 on both sides: the JAX ``DecoderLayer`` is replaced by a subclass with
  rate 0, which ``GroupFreeDetector`` looks up when it is traced) on a
  random room cloud with GT boxes, each from the JAX trainer's state:
  losses 1e-5, gradients 1e-3 of the largest (the JAX gradient of the
  trainer's own loss function, jitted) outside the SA stages, BN running
  statistics 1e-5 everywhere, and every parameter 1e-5 after the port's
  AdamW update of the JAX gradient;
* the LR schedule (optax's piecewise constant, float32);
* the float32 ill-conditioning of the SA stages' parameter gradients (a
  one-ulp input change moves them by over 1e-3 of the largest), which is
  why the step parity holds those parameters' gradients stage by stage
  (``tests/test_torch_groupfree.py``) and not end to end;
* the float64 witness: the JAX package's float64 step gradient, each SA
  stage's max routed as the port routes it, against the port's float32
  one (outside the SA stages 1e-3 of the largest; inside them no further
  off than the JAX trainer's own float32 gradient), and against the port's
  own plain step in float64 routed alike (every parameter 1e-5 of the
  largest, the SA stages included).

Trap guard: on the step's clouds the JAX FPS and ball query select what
the port's do at every SA level.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from or4d_tpu import ops as jops
from or4d_tpu.data.groupfree_dataset import GroupFreeDetectionDataset as JaxDataset
from or4d_tpu.models import groupfree as jgf
from or4d_tpu.models import groupfree_loss as jloss
from or4d_tpu.ops.ball_query import ball_query as jax_ball_query
from or4d_tpu.train.perception_trainers import GroupFreeTrainer as JaxTrainer

from or4d_tpu_torch.convert import groupfree_from_jax_variables
from or4d_tpu_torch.models import groupfree_loss as tloss
from or4d_tpu_torch.ops.ball_query import ball_query
from or4d_tpu_torch.ops.fps import furthest_point_sample
from or4d_tpu_torch.train.perception_trainers import GroupFreeTrainer, piecewise_constant_lr

ROOT = Path(__file__).parent / "golden" / "real_data"
T = torch.from_numpy


def close(got, want, what: str, tol: float) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    d = float(np.abs(got.astype(np.float64) - want).max())
    assert d <= tol * scale, f"{what}: max |diff| {d} of {scale}"


def head_out(rng, B: int, P: int, msa) -> dict:
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"objectness": f(B, P), "center": f(B, P, 3), "heading_scores": f(B, P, 12),
            "heading_residual": f(B, P, 12) * 0.2, "size_scores": f(B, P, 4),
            "size_residual": f(B, P, 4, 3) * 0.1 * msa[None, None], "sem_scores": f(B, P, 4)}


def gt_dict(rng, B: int, K2: int) -> dict:
    return {"center": rng.uniform(-2, 2, (B, K2, 3)).astype(np.float32),
            "size": rng.uniform(0.3, 1.5, (B, K2, 3)).astype(np.float32),
            "size_class": rng.integers(0, 4, (B, K2)), "size_residual": rng.normal(0, 0.1, (B, K2, 3)).astype(np.float32),
            "heading_class": rng.integers(0, 12, (B, K2)),
            "heading_residual": rng.uniform(-0.2, 0.2, (B, K2)).astype(np.float32),
            "sem_class": rng.integers(0, 4, (B, K2)), "mask": (rng.uniform(size=(B, K2)) < 0.7).astype(np.float32)}


def test_smoothl1_focal_and_ce_equal_the_jax_functions():
    rng = np.random.default_rng(0)
    e = rng.normal(0, 2, (64,)).astype(np.float32)
    close(tloss.smoothl1(T(e)), jloss.smoothl1(e), "smoothl1", 1e-6)
    logits = rng.normal(0, 3, (4, 50)).astype(np.float32)
    targets = (rng.uniform(size=(4, 50)) < 0.3).astype(np.float32)
    w = rng.uniform(size=(4, 50)).astype(np.float32)
    close(tloss.sigmoid_focal_loss(T(logits), T(targets), T(w)), jloss.sigmoid_focal_loss(logits, targets, w),
          "focal", 1e-6)
    labels = rng.integers(0, 50, (4,))
    close(tloss._ce(T(logits), T(labels)), jloss._ce(logits, labels), "ce", 1e-6)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_kps_objectness_loss_equals_the_jax_function(case):
    rng = np.random.default_rng(1)
    B, K, K2 = 2, 200, 6
    seed_xyz = rng.uniform(-2, 2, (B, K, 3)).astype(np.float32)
    logits = rng.normal(0, 2, (B, K)).astype(np.float32)
    gt_center = rng.uniform(-2, 2, (B, K2, 3)).astype(np.float32)
    gt_size = rng.uniform(0.3, 1.5, (B, K2, 3)).astype(np.float32)
    mask = np.ones((B, K2), np.float32)
    mask[:, -1] = 0
    inst = rng.integers(-1, K2 - 1, (B, K))
    if case == "ties":
        # boxes 0 and 1 get 2 and 3 member seeds: their top 5 run into the
        # 100.0 ties, which the lowest-indexed seeds (members of box 2) win
        inst = np.where(np.isin(inst, (0, 1)), 2, inst)
        inst[:, 50:52] = 0
        inst[:, 60:63] = 1
    args = (seed_xyz, logits, inst, gt_center, gt_size, mask)
    want = float(jloss.kps_objectness_loss(*[jnp.asarray(a) for a in args]))
    got = float(tloss.kps_objectness_loss(*[T(np.asarray(a)) for a in args]))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    if case == "ties":  # the tie-break decides the loss: another break gives another loss
        flipped = logits.copy()
        flipped[:, :3] = -flipped[:, :3]
        other = float(tloss.kps_objectness_loss(T(seed_xyz), T(flipped), *[T(np.asarray(a)) for a in args[2:]]))
        assert abs(other - got) > 1e-3 * abs(got)


def test_layer_and_total_losses_equal_the_jax_functions():
    rng = np.random.default_rng(2)
    B, P, K, K2 = 2, 32, 100, 8
    msa = rng.uniform(0.3, 1.2, (4, 3)).astype(np.float32)
    heads = [head_out(rng, B, P, msa) for _ in range(3)]
    gt = gt_dict(rng, B, K2)
    cand = rng.integers(-1, K2, (B, P))
    want = jloss.layer_losses({k: jnp.asarray(v) for k, v in heads[0].items()}, jnp.asarray(cand),
                              {k: jnp.asarray(v) for k, v in gt.items()}, msa)
    got = tloss.layer_losses({k: T(v) for k, v in heads[0].items()}, T(cand), {k: T(v) for k, v in gt.items()}, msa)
    for key in want:
        close(got[key], want[key], key, 1e-6)
    seed_inst = rng.integers(-1, K2, (B, K))
    outputs = {"seeds_obj_cls_logits": rng.normal(size=(B, K)).astype(np.float32),
               "sample_inds": np.stack([rng.permutation(K)[:P] for _ in range(B)]).astype(np.int32),
               "proposal": heads[0], "layers": heads[1:]}
    seed_xyz = rng.uniform(-2, 2, (B, K, 3)).astype(np.float32)
    jtot, jparts = jloss.groupfree_total_loss(jax.tree_util.tree_map(jnp.asarray, outputs), jnp.asarray(seed_inst),
                                              {k: jnp.asarray(v) for k, v in gt.items()}, msa, jnp.asarray(seed_xyz))
    ttot, tparts = tloss.groupfree_total_loss(jax.tree_util.tree_map(T, outputs), T(seed_inst),
                                              {k: T(v) for k, v in gt.items()}, msa, T(seed_xyz))
    close(ttot, jtot, "total", 1e-6)
    for name in ("proposal", "head_0", "head_1"):
        for key in jparts[name]:
            close(tparts[name][key], jparts[name][key], f"{name} {key}", 1e-6)


def test_lr_schedule_is_optax_piecewise_constant():
    import optax

    want = optax.piecewise_constant_schedule(6e-3, {s: 0.1 for s in (56000, 78000, 90000)})
    got = piecewise_constant_lr(6e-3, (56000, 78000, 90000), 0.1)
    for step in (0, 1, 55999, 56000, 77999, 78000, 90000, 120000):
        assert got(step) == float(want(step)), step


class NoDropoutDecoderLayer(jgf.DecoderLayer):
    dropout: float = 0.0


ROOM = np.array([5.0, 2.0, 5.0])  # metres


def detection_batch(seed: int, B: int = 2, N: int = 4096, K2: int = 8, boxes: int = 5, room=ROOM) -> dict:
    """A ``GroupFreeDetectionDataset.batch()``-shaped batch on a random
    cloud (no repeated points) in a ``room`` sized box: ``boxes`` GT boxes a
    scan, the points within 0.5 m of a box centre labelled with its index,
    padded boxes at +1000."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-room / 2, room / 2, (B, N, 3))
    pc = np.concatenate([xyz, rng.uniform(-0.5, 0.5, (B, N, 3))], -1).astype(np.float32)
    gt = gt_dict(rng, B, K2)
    gt["center"] = rng.uniform(-room / 2, room / 2, (B, K2, 3)).astype(np.float32)
    gt["mask"] = np.zeros((B, K2), np.float32)
    gt["mask"][:, :boxes] = 1
    gt["center"][:, boxes:] += 1000.0
    gt["sem_class"] = gt["size_class"]
    d = ((pc[:, :, None, :3] - gt["center"][:, None, :boxes]) ** 2).sum(-1)
    label = np.where(d.min(-1) < 0.25, d.argmin(-1), -1)
    return {"point_clouds": pc, "point_instance_label": label, "gt": gt}


SA = "backbone.sa"  # the SA stages' parameters (each stage ends in a max over its slots)


def _sync_from_jax(ttr: GroupFreeTrainer, state: dict) -> None:
    """The port trainer's model and AdamW state set to the JAX trainer's."""
    ttr.model.load_state_dict(groupfree_from_jax_variables(
        {"params": state["params"], "batch_stats": state["batch_stats"]}, ttr.model))
    adam = state["opt_state"][0]
    params_only = ParamsOnly(ttr.model)
    mu = groupfree_from_jax_variables({"params": adam.mu}, params_only)
    nu = groupfree_from_jax_variables({"params": adam.nu}, params_only)
    count = int(adam.count)
    for name, p in ttr.model.named_parameters():
        ttr.optimizer.state[p] = {"step": torch.tensor(float(count)), "exp_avg": mu[name].clone(),
                                  "exp_avg_sq": nu[name].clone()}
    ttr.step = count


def test_two_trainer_steps_equal_the_jax_trainer(monkeypatch):
    """Each step starts from the JAX trainer's state (weights, BN
    statistics, AdamW moments and count). Losses 1e-5; the gradients 1e-3
    of the largest, except the SA stages' parameters, whose float32 gradient
    is ill-conditioned (the next two tests: the float64 witness and the
    one-ulp nudge; their backward is held stage by stage in
    tests/test_torch_groupfree.py); the BN running statistics of every stage
    1e-5; the port's AdamW update applied to the JAX gradient from the same
    state: every parameter 1e-5 of the largest."""
    from or4d_tpu.train.perception_trainers import _make_state

    monkeypatch.setattr(jgf, "DecoderLayer", NoDropoutDecoderLayer)
    batch = detection_batch(3)
    msa = np.random.default_rng(4).uniform(0.3, 1.2, (4, 3))
    pc = batch["point_clouds"]
    # trap guard: FPS and ball query agree level by level on these clouds
    xyz = pc[..., :3]
    for npoint, radius, ns in ((2048, 0.2, 64), (1024, 0.4, 32), (512, 0.8, 16), (256, 1.2, 16)):
        idx = furthest_point_sample(T(np.ascontiguousarray(xyz)), npoint).numpy()
        np.testing.assert_array_equal(idx, np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), npoint)))
        new = np.take_along_axis(xyz, idx[..., None].astype(np.int64), 1)
        np.testing.assert_array_equal(ball_query(radius, ns, T(np.ascontiguousarray(xyz)), T(new)).numpy(),
                                      np.asarray(jax_ball_query(radius, ns, jnp.asarray(xyz), jnp.asarray(new))))
        xyz = new

    jtr = JaxTrainer(num_proposal=16, num_decoder_layers=2)
    jpc, jmsa = jnp.asarray(pc), jnp.asarray(msa, jnp.float32)
    # the trainer's init_state, jitted
    state = _make_state(jtr.model, jtr.tx, jax.jit(lambda k: jtr.model.init(k, jpc, jmsa, train=False))(
        jax.random.key(0)))
    ttr = GroupFreeTrainer(num_proposal=16, num_decoder_layers=2, dropout=0.0, device="cpu")
    jgt = {k: jnp.asarray(v) for k, v in batch["gt"].items()}
    jpil = jnp.asarray(batch["point_instance_label"])

    def loss_fn(params, stats):  # the JAX trainer's loss function (_step_impl)
        out, _ = jtr.model.apply({"params": params, "batch_stats": stats}, jpc, jmsa, train=True,
                                 mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
        seed_instance = jnp.take_along_axis(jpil, out["seed_inds"], axis=1)
        return jloss.groupfree_total_loss(out, seed_instance, jgt, jmsa, out["seed_xyz"])[0]

    grad_fn = jax.jit(jax.grad(loss_fn))
    params_only = ParamsOnly(ttr.model)
    for step in range(2):
        before = jax.tree_util.tree_map(np.asarray, state)  # the JAX step donates its state
        _sync_from_jax(ttr, before)
        grads = grad_fn(state["params"], state["batch_stats"])
        state, jl, jparts = jtr.train_step_from_batch(state, batch, msa, key=jax.random.key(step))
        tl, tparts = ttr.train_step_from_batch(batch, msa)
        assert ttr.step == int(state["step"]) == step + 1
        for key in ("total", "kps"):
            want = float(jl) if key == "total" else float(jparts[key])
            assert abs(float(tparts[key]) - want) <= 1e-5 * abs(want), (step, key, float(tparts[key]), want)
        jg = groupfree_from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, grads)}, params_only)
        scale = max(float(g.abs().max()) for g in jg.values())
        tg = dict(ttr.model.named_parameters())
        held = [k for k in jg if not k.startswith(SA)]
        assert len(held) > 150
        worst = max((float((tg[k].grad - jg[k]).abs().max()), k) for k in held)
        assert worst[0] <= 1e-3 * scale, (step, worst, scale)
        want = groupfree_from_jax_variables({"params": state["params"], "batch_stats": state["batch_stats"]},
                                            ttr.model)
        pscale = max(float(v.abs().max()) for v in want.values())
        got = ttr.model.state_dict()
        worst = max((float((got[k] - v).abs().max()), k) for k, v in want.items()
                    if k.endswith(("running_mean", "running_var")))
        assert worst[0] <= 1e-5 * pscale, (step, worst, pscale)
        # the update itself, from the same gradient: AdamW moves an entry by
        # ~lr * m / (sqrt(v) + 1e-8), whose sign and size are not determined
        # where the gradient is within rounding of 0 or of cancelling m, so
        # the port's AdamW is held on the JAX gradient, every parameter
        _sync_from_jax(ttr, before)
        for name, p in ttr.model.named_parameters():
            p.grad = jg[name].clone()
        ttr._update()
        got = ttr.model.state_dict()
        worst = max((float((got[k] - want[k]).abs().max()), k) for k in jg)
        assert worst[0] <= 1e-5 * pscale, (step, worst, pscale)


def test_step_gradients_against_the_float64_reference(monkeypatch):
    """The float64 witness of the step parity above, on its batch and the
    JAX trainer's initial state (dropout 0): the JAX package's gradient of
    the trainer's loss in float64 (jitted; ``jax_float64``), with each SA
    stage's max over the slots routed as the port's float32 forward routes
    it. The seeds and candidates are the port's; every slot max that the
    port routes apart from the float64 run's own values is a tie within
    rounding; outside the SA stages the port's float32 gradients are within
    1e-3 of the largest (measured 2.3e-4; the JAX trainer's 8.9e-5).
    Inside the SA stages neither float32 gradient is within 1e-3 of the
    float64 one (measured: the port's 4.2e-3, 3.1e-3 before the repairs
    below, the JAX trainer's 4.6e-3; they differ from each other by
    3.4e-3), because a ReLU or max decision within rounding of a tie
    routes a whole slot's cotangent one way or the other; the port's is
    held to be no further off than the JAX trainer's. With both sides in
    float64 and routed alike (``port_gradient_float64``) every gradient
    agrees within 1e-5 of the largest (measured 2.8e-9 outside the SA
    stages, 4.0e-8 inside), so the float32 gaps are conditioning. Before
    two repairs of the port it was 2.2e-4 outside the SA stages: the jitted JAX package divides by a constant as
    a product with its reciprocal (SA grouping's ``/ radius``) and computes
    the 3-NN weights ``(1/d) / sum(1/d)`` as ``1 / (d * sum(1/d))``
    (ROADMAP Queue 3)."""
    from tests.test_torch_groupfree import TIE_MARGIN, jax_float64, routing_margins, sa_interceptor, slot_routing

    monkeypatch.setattr(jgf, "DecoderLayer", NoDropoutDecoderLayer)
    batch = detection_batch(3)
    msa = np.random.default_rng(4).uniform(0.3, 1.2, (4, 3))
    pc = batch["point_clouds"]
    jtr = JaxTrainer(num_proposal=16, num_decoder_layers=2)
    variables = jax.device_get(jax.jit(lambda k: jtr.model.init(k, jnp.asarray(pc), jnp.asarray(msa, jnp.float32),
                                                                train=False))(jax.random.key(0)))
    ttr = GroupFreeTrainer(num_proposal=16, num_decoder_layers=2, dropout=0.0, device="cpu")
    ttr.model.load_state_dict(groupfree_from_jax_variables(variables, ttr.model))
    port_h = {}
    for i in range(1, 5):
        getattr(ttr.model.backbone, f"sa{i}").mlp.register_forward_hook(
            lambda _m, _a, out, name=f"sa{i}": port_h.update({name: out.detach().numpy()}))
    gt = {k: T(np.asarray(v)) for k, v in batch["gt"].items()}
    gt = {k: v.float() if v.is_floating_point() else v for k, v in gt.items()}
    total, _ = ttr.loss(T(pc), T(msa.astype(np.float32)), T(batch["point_instance_label"]), gt, None)
    total.backward()
    port = {k: p.grad.double() for k, p in ttr.model.named_parameters()}
    with torch.no_grad():
        pout = ttr.model(T(pc), T(msa.astype(np.float32)), train=True)
    routes = {name: slot_routing(h) for name, h in port_h.items()}
    jpil = jnp.asarray(batch["point_instance_label"])

    def gradient(dtype, routed):
        def loss(params, stats):  # the JAX trainer's loss function (_step_impl) in dtype
            seen = {}
            gtd = {k: jnp.asarray(v, dtype) if np.asarray(v).dtype.kind == "f" else jnp.asarray(v)
                   for k, v in batch["gt"].items()}
            with nn.intercept_methods(sa_interceptor(seen, routes if routed else None)):
                out, _ = jtr.model.apply({"params": params, "batch_stats": stats}, jnp.asarray(pc, dtype),
                                         jnp.asarray(msa, dtype), train=True, mutable=["batch_stats"],
                                         rngs={"dropout": jax.random.key(0)})
            seed_instance = jnp.take_along_axis(jpil, out["seed_inds"], axis=1)
            total = jloss.groupfree_total_loss(out, seed_instance, gtd, jnp.asarray(msa, dtype), out["seed_xyz"])[0]
            return total, (seen, out["seed_inds"], out["sample_inds"])

        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype), t)
        grads, aux = jax.jit(jax.grad(loss, has_aux=True))(cast(variables["params"]), cast(variables["batch_stats"]))
        named = groupfree_from_jax_variables(
            {"params": jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), grads)}, ParamsOnly(ttr.model))
        return named, jax.device_get(aux)

    with jax_float64():
        g64, (h64, seed64, sample64) = gradient(jnp.float64, True)
    g32, _ = gradient(jnp.float32, False)
    np.testing.assert_array_equal(seed64, pout["seed_inds"].numpy())
    np.testing.assert_array_equal(sample64, pout["sample_inds"].numpy())
    for name, route in routes.items():
        margins = routing_margins(h64[name], slot_routing(h64[name]), route)
        assert all(m <= TIE_MARGIN for m in margins), (name, margins)
    scale = max(float(g.abs().max()) for g in g64.values())

    def gap(grads, sa):
        return max(float((grads[k] - g64[k]).abs().max()) for k in g64 if k.startswith(SA) == sa) / scale

    assert gap(port, False) <= 1e-3, gap(port, False)
    assert gap(port, True) <= gap(g32, True), (gap(port, True), gap(g32, True))
    # both sides in float64, routed alike: the port's plain step agrees with
    # the JAX package's in every parameter, the SA stages included, so the
    # float32 gaps above are conditioning, not a fault (ROADMAP Queue 3)
    port64 = port_gradient_float64(ttr.model, batch, msa, routes)
    assert gap(port64, False) <= 1e-5, gap(port64, False)
    assert gap(port64, True) <= 1e-5, gap(port64, True)


class _MaskedBatchNormTrain64(torch.autograd.Function):
    """The port's train-mode masked BN (``layers._MaskedBatchNormTrain``)
    with its float32 casts made float64; autograd's backward. One process:
    no process group to reduce over."""

    @staticmethod
    def apply(x, mask, weight, bias, eps, relu, chunked=False, group=None):
        assert group is None
        B, C = x.shape[0], x.shape[-1]
        xf = x.double().reshape(B, -1, C)
        mb = torch.ones(B, dtype=torch.float64) if mask is None else mask.double().reshape(B)
        count = torch.clamp(mb.sum() * xf.shape[1], min=1.0)
        mean = (mb @ xf.sum(1)) / count
        var = (mb @ ((xf - mean) ** 2).sum(1)) / count
        y = (xf - mean) * torch.rsqrt(var + eps) * weight + bias
        y = torch.relu(y) if relu else y
        return y.reshape(x.shape), mean.detach(), var.detach(), count


def port_gradient_float64(model: torch.nn.Module, batch: dict, msa: np.ndarray, routes: dict) -> dict:
    """The port's plain step gradient (``GroupFreeTrainer.loss``) in
    float64 from ``model``'s state: a float64 copy of the model, float64
    colours, ground truth and mean sizes, the masked BN's float32 casts made
    float64 (``_MaskedBatchNormTrain64``) and so the Dense layers' compute
    dtype, and each SA stage's max over the
    slots routed by ``routes`` ({"sa1": slot_routing, ...}) as
    ``sa_interceptor`` routes JAX's. The geometry stays float32 (``Backbone``
    casts xyz itself), as in ``jax_float64``."""
    import copy

    from or4d_tpu_torch.models import layers as tlayers

    m64 = copy.deepcopy(model).double()
    for mod in m64.modules():  # the SharedMLPs' Dense layers compute in float32
        if isinstance(mod, tlayers.Dense) and mod.dtype is not None:
            mod.dtype = torch.float64
    for name in routes:
        route = torch.from_numpy(np.asarray(routes[name], np.float64))

        def hook(_m, _a, out, route=route):
            routed = (route * out).sum(2, keepdim=True)
            return out.detach() + (routed - routed.detach())

        getattr(m64.backbone, name).mlp.register_forward_hook(hook)
    saved = tlayers._MaskedBatchNormTrain
    tlayers._MaskedBatchNormTrain = _MaskedBatchNormTrain64
    try:
        msa64 = T(np.asarray(msa, np.float64))
        out = m64(T(batch["point_clouds"]).double(), msa64, train=True)
        seed_instance = torch.gather(T(batch["point_instance_label"]).long(), 1, out["seed_inds"].long())
        gt = {k: T(np.asarray(v)) for k, v in batch["gt"].items()}
        gt = {k: v.double() if v.is_floating_point() else v for k, v in gt.items()}
        tloss.groupfree_total_loss(out, seed_instance, gt, msa64, out["seed_xyz"])[0].backward()
    finally:
        tlayers._MaskedBatchNormTrain = saved
    return {k: p.grad for k, p in m64.named_parameters()}


def test_sa_stage_gradients_are_ill_conditioned_in_float32():
    """Why the step parity above leaves the SA stages' parameter gradients
    out: moving the input colours by one float32 ulp moves the port's own
    gradient of SA1's weights by more than 1e-3 of the largest gradient
    (thousands of max-pool and ReLU decisions over 2 x 2048 x 64 slots, each
    routing a slot's cotangent), while every other parameter's gradient
    moves by less than 1e-3. On the step parity's batch (N = 4096) JAX's
    jitted and eager float32 gradients differ by 5.9e-2 of the largest in
    the SA stages (7.5e-3 elsewhere), the port's from JAX's jitted one by
    4.8e-3 (2.3e-4 elsewhere) (ROADMAP Queue 3)."""
    from or4d_tpu_torch.models.groupfree import GroupFreeDetector

    batch = detection_batch(3, N=2048)
    msa = np.random.default_rng(4).uniform(0.3, 1.2, (4, 3)).astype(np.float32)
    model = GroupFreeDetector(num_proposal=16, num_decoder_layers=2, dropout=0.0, device="cpu", seed=0)
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def grads(pc):
        model.load_state_dict(state)
        model.zero_grad()
        out = model(T(pc), T(msa), train=True)
        seed_instance = torch.gather(T(batch["point_instance_label"]).long(), 1, out["seed_inds"].long())
        gt = {k: T(np.asarray(v)) for k, v in batch["gt"].items()}
        tloss.groupfree_total_loss(out, seed_instance, gt, msa, out["seed_xyz"])[0].backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    pc = batch["point_clouds"]
    nudged = pc.copy()
    nudged[..., 3:] = np.nextafter(nudged[..., 3:], np.float32(1))
    g0, g1 = grads(pc), grads(nudged)
    scale = max(float(g.abs().max()) for g in g0.values())
    moved = {k: float((g0[k] - g1[k]).abs().max()) / scale for k in g0}
    assert max(v for k, v in moved.items() if k.startswith(SA + "1")) > 1e-3, moved
    assert max(v for k, v in moved.items() if not k.startswith(SA)) < 1e-3, moved


class ParamsOnly(torch.nn.Module):
    """The parameters' state_dict keys of a model only, for mapping a flax
    gradient tree (params, no batch_stats) through the converter."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self._params = dict(model.named_parameters())

    def state_dict(self, *args, **kwargs):
        return {k: p.detach() for k, p in self._params.items()}
