"""The port's VoxelPose against the JAX package on the CPU, weights carried
by ``convert.voxelpose_from_jax_variables``, full channel widths at reduced
grids (the JAX module's own ``initial_cube`` / ``fine_cube`` /
``max_people`` overrides) on the fixture's camera rig and frames:

* ``project_points``, ``compute_grid``, ``bilinear_sample`` (out-of-image
  taps included) and ``project_heatmaps_to_cube``: 1e-6 of the largest
  value, the in-image test the same everywhere;
* ``nms_topk``: values and indices exact, ties included (a cube with fewer
  maxima than K, and a flat one, where ``lax.top_k`` takes the lowest
  index), and ``voxel_to_world``;
* ``V2VNet`` in train mode (BN batch statistics and the running ones after
  it; ``Up3D``'s transposed convolution): 1e-4 of the largest output, 1e-5
  of the largest statistic (eval mode runs inside the forward below);
* the ``VoxelPose`` eval forward: the proposal set, each proposal's pose,
  the root cube, 1e-4 of the largest;
* the losses on random inputs;
* five ``VoxelPoseTrainer`` iterations, each from the JAX trainer's state
  (weights, BN statistics, Adam moments and count, the root-cube
  accumulator): the loss 1e-5 relative against the JAX trainer's loss
  function in float64 (jitted) and loss_3d 1e-5 against its float32 one;
  every gradient 1e-4 of the largest with both sides in float64, and on
  the first iteration the port's float32 gradient 1e-3 of the largest of
  the float64 one; the running statistics 1e-5, and the port's update
  applied to
  the JAX gradients equal to the JAX trainer's new state (parameters and
  accumulator 1e-5 of the largest); the fourth iteration fires the
  accumulator (two Adam updates), and loss_cord's gradient is zero on the
  proposal net, loss_3d's on the pose net (why one backward serves both);
* ``run_3d_pose_inference_for_take``: the same ``pred_*.npy`` files as the
  JAX driver, poses 1e-4 of the largest.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or4d_tpu.data.voxelpose_dataset import VoxelPoseDataset, generate_3d_target
from or4d_tpu.models import voxelpose as jv
from or4d_tpu.train.perception_trainers import VoxelPoseTrainer as JaxTrainer
from or4d_tpu.train.perception_trainers import _make_state

from or4d_tpu_torch.convert import voxelpose_from_jax_variables
from or4d_tpu_torch.models import voxelpose as tv
from or4d_tpu_torch.train.perception_trainers import VoxelPoseTrainer, cameras_on

ROOT = Path(__file__).parent / "golden" / "real_data"
SMALL = dict(initial_cube=(16, 16, 16), fine_cube=(8, 8, 8), max_people=3)
T = torch.from_numpy


def close(got, want, tol: float, what: str = "") -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    d = float(np.abs(got.astype(np.float64) - want).max())
    assert d <= tol * scale, f"{what}: max |diff| {d} of {scale}"


def random_variables(shapes, seed: int):
    """Variables of a flax model's ``eval_shape``: kernels normal / sqrt(fan
    in), biases, BN scales and running statistics spread around their
    defaults (so eval mode is not the identity)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def frames():
    ds = VoxelPoseDataset(ROOT, "train", take_indices=[1], max_people=3)
    cams = {k: jnp.asarray(v) for k, v in ds.cameras.items()}
    return ds, cams, jnp.asarray(ds.heatmap_scale), [ds.sample(i) for i in range(len(ds))]


def test_geometry_equals_the_jax_functions(frames):
    ds, cams, hs, samples = frames
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3000, 3000, (500, 3)).astype(np.float32)
    c = {k: np.asarray(v) for k, v in ds.cameras.items()}
    for v in range(6):
        close(tv.project_points(T(pts), *(T(c[k][v]) for k in "RTfc")),
              jv.project_points(pts, *(c[k][v] for k in "RTfc")), 1e-6, "project_points")
    for size, center, n in ((jv.SPACE_SIZE, jv.SPACE_CENTER, (16, 12, 9)), (jv.FINE_GRID, (10.5, -3.0, 7.0), (8,) * 3)):
        close(tv.compute_grid(size, center, n), jv.compute_grid(size, center, n), 1e-6, "compute_grid")
    hm = rng.random((14, 20, 30)).astype(np.float32)
    uv = rng.uniform(-2, 32, (400, 2)).astype(np.float32)
    close(tv.bilinear_sample(T(hm), T(uv)), jv.bilinear_sample(hm, uv), 1e-6, "bilinear_sample")
    grid = np.asarray(jv.compute_grid(jv.SPACE_SIZE, jv.SPACE_CENTER, (16, 16, 16)))
    tc = {k: T(v) for k, v in c.items()}
    for s in samples:
        close(tv.project_heatmaps_to_cube(T(s["input_heatmaps"]), tc, T(grid), T(ds.heatmap_scale)),
              jv.project_heatmaps_to_cube(s["input_heatmaps"], cams, grid, hs), 1e-5, "cube")


@pytest.mark.parametrize("case", ["random", "two_peaks", "flat"])
def test_nms_topk_equals_lax_top_k_ties_included(case):
    rng = np.random.default_rng(1)
    cube = rng.random((12, 10, 8)).astype(np.float32)
    if case == "two_peaks":  # 2 maxima, K = 5: three zeros, taken in index order
        cube = np.zeros((12, 10, 8), np.float32)
        cube[3, 4, 5], cube[9, 1, 2] = 0.7, 0.9
    elif case == "flat":
        cube = np.full((12, 10, 8), 0.25, np.float32)
    vals, idx = tv.nms_topk(T(cube), 5)
    jvals, jidx = jv.nms_topk(jnp.asarray(cube), 5)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(tv.voxel_to_world(idx, (12, 10, 8)), jv.voxel_to_world(jidx, (12, 10, 8)), 1e-6, "voxel_to_world")


@pytest.mark.parametrize("train", [True])
def test_v2v_equals_the_flax_module(train):
    x = np.random.default_rng(2).random((2, 8, 8, 8, 14)).astype(np.float32)
    jm = jv.V2VNet(5)
    variables = random_variables(jax.eval_shape(lambda k: jm.init(k, x, train=False), jax.random.key(0)), 3)
    tm = tv.V2VNet(14, 5, device="cpu")
    tm.load_state_dict(voxelpose_from_jax_variables(variables, tm))
    want, mutated = jm.apply(variables, x, train=train, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm(T(x).permute(0, 4, 1, 2, 3), train=train).permute(0, 2, 3, 4, 1)
    close(got, want, 1e-4, "output")
    if train:
        new = voxelpose_from_jax_variables({"params": variables["params"], "batch_stats": mutated["batch_stats"]}, tm)
        stats = [k for k in new if k.endswith(("running_mean", "running_var"))]
        scale = max(float(new[k].abs().max()) for k in stats)
        worst = max(float((tm.state_dict()[k] - new[k]).abs().max()) for k in stats)
        assert worst <= 1e-5 * scale, (worst, scale)


def _voxelpose(frames, kwargs, seed):
    ds, cams, hs, samples = frames
    jm = jv.VoxelPose(**kwargs)
    shapes = jax.eval_shape(lambda k: jm.init(k, samples[0]["input_heatmaps"], cams, hs, train=False),
                            jax.random.key(0))
    variables = random_variables(shapes, seed)
    tm = tv.VoxelPose(**kwargs, device="cpu")
    tm.load_state_dict(voxelpose_from_jax_variables(variables, tm))
    return jm, tm, variables


def test_voxelpose_forward_equals_the_jax_model(frames):
    """Eval mode on both fixture frames: the proposals (scores and centres)
    as sets, then each proposal's pose matched by its centre; the root
    cube."""
    ds, cams, hs, samples = frames
    jm, tm, variables = _voxelpose(frames, SMALL, 4)
    fwd = jax.jit(lambda v, h: jm.apply(v, h, cams, hs, train=False))
    tc = cameras_on(ds.cameras, "cpu")
    for s in samples:
        poses, scores, centers, root = fwd(variables, s["input_heatmaps"])
        with torch.no_grad():
            tp, ts, tcen, troot = tm(T(s["input_heatmaps"]), tc, T(ds.heatmap_scale), train=False)
        close(troot, root, 1e-4, "root")
        order = [int(np.argmin(np.abs(np.asarray(centers) - c.numpy()).sum(1))) for c in tcen]
        assert sorted(order) == list(range(len(order)))
        close(tcen, np.asarray(centers)[order], 1e-6, "centers")
        close(ts, np.asarray(scores)[order], 1e-4, "scores")
        close(tp, np.asarray(poses)[order], 1e-4, "poses")


def test_losses_equal_the_jax_functions():
    rng = np.random.default_rng(5)
    K, G = 4, 3
    pred = rng.uniform(-500, 500, (K, 14, 3)).astype(np.float32)
    roots = rng.uniform(-600, 600, (G, 3)).astype(np.float32)
    centers = (roots[[0, 1, 2, 0]] + rng.uniform(-450, 450, (K, 3)) * [[1], [0.2], [0.2], [2]]).astype(np.float32)
    gt = rng.uniform(-500, 500, (G, 14, 3)).astype(np.float32)
    vis = (rng.random((G, 14)) < 0.8).astype(np.float32)
    mask, slots = np.array([True, True, False]), np.array([True, False, False, True])
    c2g, valid = tv.match_proposals_to_gt(T(centers), T(roots), T(mask))
    jc2g, jvalid = jv.match_proposals_to_gt(centers, roots, mask)
    np.testing.assert_array_equal(c2g.numpy(), np.asarray(jc2g))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < int(valid.sum()) < K
    close(tv.voxelpose_loss(T(pred), T(centers), T(roots), T(gt), T(vis), T(mask), T(slots)),
          jv.voxelpose_loss(pred, centers, roots, gt, vis, mask, slots), 1e-6, "loss")
    cube, target = rng.random((6, 6, 6)).astype(np.float32), rng.random((6, 6, 6)).astype(np.float32)
    close(tv.voxelpose_loss_3d(T(cube), T(target)), jv.voxelpose_loss_3d(cube, target), 1e-6, "loss_3d")


def _named(model, tree, stats):
    """A flax parameter-shaped tree as the port's {name: tensor}."""
    full = voxelpose_from_jax_variables({"params": tree, "batch_stats": stats}, model)
    return {k: full[k] for k, _ in model.named_parameters()}


def _sync(ttr: VoxelPoseTrainer, state: dict) -> None:
    """The port trainer set to the JAX trainer's state."""
    m = ttr.model
    m.load_state_dict(voxelpose_from_jax_variables({"params": state["params"], "batch_stats": state["batch_stats"]}, m))
    adam = state["opt_state"][0]
    mu, nu = _named(m, adam.mu, state["batch_stats"]), _named(m, adam.nu, state["batch_stats"])
    for name, p in m.named_parameters():
        ttr.optimizer.state[p] = {"step": torch.tensor(float(adam.count)), "exp_avg": mu[name].clone(),
                                  "exp_avg_sq": nu[name].clone()}
    acc = _named(m, state["accum3d"], state["batch_stats"])
    ttr.accum3d = [acc["proposal_v2v." + n].clone() for n, _ in m.proposal_v2v.named_parameters()]
    ttr.accum3d_loss = torch.tensor(float(state["accum3d_loss"]))
    ttr.step = int(state["step"])


def t64(a):
    a = np.asarray(a)
    return T(a).double() if a.dtype.kind == "f" else T(a)


def test_trainer_steps_equal_the_jax_trainer(frames):
    """Five iterations over the fixture's two frames, the space shrunk to
    500 mm around the first frame's first root so every proposal matches a
    person (loss_cord > 0 each iteration). The loss and gradients are held
    against the JAX trainer's loss function in float64 (jitted), because
    the train-mode V2Vs are ill-conditioned in float32 (BN over channels of
    little variance, at random weights): from the initial state the port's
    float32 gradient is held within 1e-3 of the largest of the float64
    one, but after updates a float32 gradient of either package can be off
    by a large part of the largest (a pose V2V's first convolution; the
    proposal net's output after the accumulator's update). In float64 on
    both sides every gradient of every iteration is held within 1e-4 of the
    largest (ROADMAP Queue 3)."""
    ds, cams, hs, samples = frames
    root0 = samples[0]["gt_roots"][0]
    kwargs = dict(SMALL, space_size=(500.0,) * 3, space_center=tuple(float(v) for v in root0))
    jtr = JaxTrainer(model_kwargs=kwargs)
    _jm, _tm, variables = _voxelpose(frames, kwargs, 6)
    state = _make_state(jtr.model, jtr.tx, variables)
    state["accum3d"] = jax.tree_util.tree_map(jnp.zeros_like, state["params"])
    state["accum3d_loss"] = jnp.zeros((), jnp.float32)
    ttr = VoxelPoseTrainer(model_kwargs=kwargs, device="cpu")
    tc = cameras_on(ds.cameras, "cpu")

    def both(state, s):
        """The trainer's step and, from the same state, its two gradients."""
        def fwd(params):
            (poses, _s, centers, root), mutated = jtr.model.apply(
                {"params": params, "batch_stats": state["batch_stats"]}, s["input_heatmaps"], cams, hs, train=True,
                mutable=["batch_stats"])
            cord = jv.voxelpose_loss(poses, centers, s["gt_roots"], s["gt_poses"], s["gt_vis"], s["gt_mask"],
                                     patient_slot_mask=s["patient_mask"], patient_weight=jtr.patient_weight)
            return (cord, jv.voxelpose_loss_3d(root, s["target_3d"])), mutated["batch_stats"]

        (cord, l3), vjp, stats = jax.vjp(fwd, state["params"], has_aux=True)
        one, zero = jnp.ones(()), jnp.zeros(())
        new = jtr._step_impl(state, s["input_heatmaps"], cams, hs, s["gt_roots"], s["gt_poses"], s["gt_vis"],
                             s["gt_mask"], s["patient_mask"], s["target_3d"])[0]
        return new, (cord, l3, vjp((one, zero))[0], vjp((zero, one))[0], stats)

    def loss64(params, stats, s):
        """The trainer's loss in float64 (both terms: their gradients are disjoint)."""
        (poses, _s, centers, root), _ = jtr.model.apply(
            {"params": params, "batch_stats": stats}, s["input_heatmaps"], s["cams"], s["hs"], train=True,
            mutable=["batch_stats"])
        cord = jv.voxelpose_loss(poses, centers, s["gt_roots"], s["gt_poses"], s["gt_vis"], s["gt_mask"],
                                 patient_slot_mask=s["patient_mask"], patient_weight=jtr.patient_weight)
        return cord + jv.voxelpose_loss_3d(root, s["target_3d"])

    def to64(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64) if np.asarray(a).dtype.kind == "f" else jnp.asarray(a),
            tree)

    step, grad64 = jax.jit(both), jax.jit(jax.value_and_grad(loss64))
    fired = 0
    for it in range(5):
        s = dict(samples[it % 2])
        s["target_3d"] = generate_3d_target(s["gt_roots"][s["gt_mask"]], kwargs["space_size"], kwargs["space_center"],
                                            kwargs["initial_cube"])
        s.pop("meta")
        s64 = dict(s, cams=ds.cameras, hs=ds.heatmap_scale)
        before = jax.device_get(state)
        new, (cord, l3, g_cord, g_3d, stats) = jax.device_get(step(state, s))
        g_cord, g_3d = _named(ttr.model, g_cord, stats), _named(ttr.model, g_3d, stats)
        assert float(cord) > 0 and float(l3) > 0
        for k in g_cord:  # the two losses reach disjoint parameters
            assert not (g_cord if k.startswith("proposal_v2v.") else g_3d)[k].any(), k

        _sync(ttr, before)
        lc, l3t = ttr.losses(T(s["input_heatmaps"]), tc, T(ds.heatmap_scale), T(s["gt_roots"]), T(s["gt_poses"]),
                             T(s["gt_vis"]), T(s["gt_mask"]), T(s["patient_mask"]), T(s["target_3d"]))
        with jax.enable_x64(True):
            l64, g64 = jax.device_get(grad64(*to64((before["params"], before["batch_stats"], s64))))
        m64 = copy.deepcopy(ttr.model).double()  # the synced weights, the BN statistics before the step
        g64 = _named(m64, g64, before["batch_stats"])
        total = float(lc) + float(l3t)
        assert abs(total - float(l64)) <= 1e-5 * float(l64), (it, total, float(l64))
        assert abs(float(l3t) - float(l3)) <= 1e-5 * float(l3), (it, float(l3t), float(l3))
        (lc + l3t).backward()
        want = {k: (g_3d if k.startswith("proposal_v2v.") else g_cord)[k] for k in g_cord}
        scale = max(float(g.abs().max()) for g in g64.values())
        if it == 0:  # from the initial state; see the docstring for the later iterations
            got = dict(ttr.model.named_parameters())
            worst = max((float((got[k].grad - g64[k]).abs().max()), k) for k in g64)
            assert worst[0] <= 1e-3 * scale, (it, worst, scale)
        m64.load_state_dict(voxelpose_from_jax_variables({"params": before["params"],
                                                          "batch_stats": before["batch_stats"]}, m64))
        poses, _sc, centers, root = m64(t64(s["input_heatmaps"]), {k: v.double() for k, v in tc.items()},
                                        t64(ds.heatmap_scale), train=True)
        (tv.voxelpose_loss(poses, centers, *map(t64, (s["gt_roots"], s["gt_poses"], s["gt_vis"], s["gt_mask"],
                                                     s["patient_mask"]))) + tv.voxelpose_loss_3d(
            root, t64(s["target_3d"]))).backward()
        worst = max((float((p.grad - g64[k]).abs().max()), k) for k, p in m64.named_parameters())
        assert worst[0] <= 1e-4 * scale, (it, worst, scale)
        new_stats = voxelpose_from_jax_variables({"params": before["params"], "batch_stats": stats}, ttr.model)
        keys = [k for k in new_stats if k.endswith(("running_mean", "running_var"))]
        sscale = max(float(new_stats[k].abs().max()) for k in keys)
        assert max(float((ttr.model.state_dict()[k] - new_stats[k]).abs().max()) for k in keys) <= 1e-5 * sscale

        # the updates, from the JAX gradients and losses
        _sync(ttr, before)
        params = dict(ttr.model.named_parameters())
        count = int(before["opt_state"][0].count)
        ttr.update(float(cord), torch.tensor(float(l3)), {params[k]: want[k] for k in want})
        assert ttr.step == int(new["step"]) == it + 1
        firing = int(new["opt_state"][0].count) - count == 2
        fired += firing
        assert firing == (it == 3)
        want_p = _named(ttr.model, new["params"], new["batch_stats"])
        pscale = max(float(v.abs().max()) for v in want_p.values())
        worst = max((float((params[k].detach() - v).abs().max()), k) for k, v in want_p.items())
        assert worst[0] <= 1e-5 * pscale, (it, worst, pscale)
        acc = _named(ttr.model, new["accum3d"], new["batch_stats"])
        acc = [acc["proposal_v2v." + n] for n, _ in ttr.model.proposal_v2v.named_parameters()]
        ascale = max(max(float(a.abs().max()) for a in acc), 1e-12)
        assert max(float((a - b).abs().max()) for a, b in zip(ttr.accum3d, acc)) <= 1e-5 * ascale
        assert abs(float(ttr.accum3d_loss) - float(new["accum3d_loss"])) <= 1e-6 * max(float(l3), 1e-12)
        state = new
    assert fired == 1


def test_3d_driver_writes_the_jax_drivers_files(frames, tmp_path):
    """Both fixture takes (inference mode: frames without annotations too)."""
    from or4d_tpu.data.voxelpose_dataset import VoxelPoseDataset as JaxDataset
    from or4d_tpu.pipeline.perception_infer import run_3d_pose_inference_for_take as jax_driver

    from or4d_tpu_torch.data.voxelpose_dataset import VoxelPoseDataset as PortDataset
    from or4d_tpu_torch.pipeline.perception_infer import run_3d_pose_inference_for_take

    jm, tm, variables = _voxelpose(frames, SMALL, 7)
    jds, tds = JaxDataset(ROOT, "val", inference=True, max_people=3), PortDataset(ROOT, "val", inference=True,
                                                                                max_people=3)
    for take in sorted({r["take_idx"] for r in jds.db}):
        assert run_3d_pose_inference_for_take(tm, tds, take, tmp_path / "port", threshold=0.0) == \
            jax_driver(jm, variables, jds, take, tmp_path / "jax", threshold=0.0) > 0
    names = sorted(p.name for p in (tmp_path / "jax").glob("pred_*.npy"))
    assert names and names == sorted(p.name for p in (tmp_path / "port").glob("pred_*.npy"))
    for name in names:
        want = np.load(tmp_path / "jax" / name)
        got = np.load(tmp_path / "port" / name)
        key = lambda p: tuple(np.round(p.mean(0), 1))  # proposals may come in another order
        close(np.stack(sorted(got, key=key)), np.stack(sorted(want, key=key)), 1e-4, name)
