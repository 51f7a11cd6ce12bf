"""The port's HigherHRNet against the JAX package on the CPU, weights carried
by ``convert.higherhrnet_from_jax_variables``, at full width (HRNet-W32,
14 joints + 14 tags) on 64 x 64 images:

* a strided "SAME" convolution (the odd pixel padded after, as ``lax``
  does) and the deconvolution (flax's ``ConvTranspose`` does not flip its
  kernel): 1e-5 of the largest output;
* ``FuseLayer`` of three branches in train mode (nearest upsampling, the
  strided chains) in float64 on both sides: outputs, BN running
  statistics and the backward 1e-9 of their largest;
* the eval forward, B = 1: both heads 1e-4 of the largest value;
* ``heatmap_loss``, ``ae_loss``, ``render_gt_heatmaps``, ``aggregate_heatmaps``
  (bilinear upsampling as ``jax.image.resize``) and ``group_people_by_tags``;
* the reference HeatmapParser on the JAX model's outputs
  (``_group_2d_people``): the same people;
* two ``HigherHRNetTrainer`` steps (B = 2), each from the JAX trainer's
  state, against its loss function in train mode in float64: the loss
  1e-5 relative, the BN running statistics 1e-4 of the largest, the
  port's float64 loss and batch statistics 1e-9, and the port's Adam
  update of its gradient equal to optax's (the JAX trainer's update) from
  the same state (1e-5);
* ``run_2d_inference_for_voxelpose`` on the fixture (64 x 64 inputs): the
  same npz keys and people as the JAX driver.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from or4d_tpu.models import higherhrnet as jh

from or4d_tpu_torch.convert import higherhrnet_from_jax_variables
from or4d_tpu_torch.models import higherhrnet as th
from or4d_tpu_torch.models.layers import ConvNd

from tests.test_torch_pose_voxelpose import close, random_variables

ROOT = Path(__file__).parent / "golden" / "real_data"
T = torch.from_numpy
S = 64  # input size


class _Wrap(nn.Module):
    """One flax layer under a fixed name, for the converter's paths."""

    layer: nn.Module

    @nn.compact
    def __call__(self, x):
        return self.layer(x)


class _Holder(torch.nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.layer = conv


@pytest.mark.parametrize("kind", ["strided", "deconv"])
def test_same_padding_and_the_deconvolution_equal_flax(kind):
    x = np.random.default_rng(0).standard_normal((1, 16, 16, 4)).astype(np.float32)
    if kind == "strided":
        layer, conv = nn.Conv(8, (3, 3), strides=2, padding="SAME", use_bias=False), ConvNd(2, 4, 8, 3, 2, False)
    else:
        layer = nn.ConvTranspose(8, (4, 4), strides=(2, 2), use_bias=False)
        conv = ConvNd(2, 4, 8, 4, 2, False, transpose=True)
    jm = _Wrap(layer)
    variables = random_variables(jax.eval_shape(lambda k: jm.init(k, x), jax.random.key(0)), 1)
    tm = _Holder(conv)
    tm.load_state_dict(higherhrnet_from_jax_variables(variables, tm))
    close(tm.layer(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), jm.apply(variables, x), 1e-5, kind)


@pytest.fixture(scope="module")
def hrnet():
    imgs = np.random.default_rng(3).standard_normal((2, S, S, 3)).astype(np.float32)
    jm = jh.HigherHRNet()
    variables = random_variables(jax.eval_shape(lambda k: jm.init(k, imgs, train=False), jax.random.key(0)), 4)
    tm = th.HigherHRNet(device="cpu")
    tm.load_state_dict(higherhrnet_from_jax_variables(variables, tm))
    fwd = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    return jm, tm, variables, fwd, imgs


def test_forward_equals_the_jax_model(hrnet):
    jm, tm, variables, fwd, imgs = hrnet
    low, high = fwd(variables, imgs[:1])
    with torch.no_grad():
        tlow, thigh = tm(T(imgs[:1]), train=False)
    close(tlow, low, 1e-4, "low")
    close(thigh, high, 1e-4, "high")


def test_losses_and_aggregation_equal_the_jax_functions():
    rng = np.random.default_rng(5)
    pred, gt = rng.random((2, 16, 16, 14)).astype(np.float32), rng.random((2, 16, 16, 14)).astype(np.float32)
    mask = (rng.random((2, 16, 16)) < 0.7).astype(np.float32)
    close(th.heatmap_loss(T(pred), T(gt), T(mask)), jh.heatmap_loss(pred, gt, mask), 1e-6, "heatmap_loss")
    tags = rng.standard_normal((16, 16, 14)).astype(np.float32)
    pos = rng.integers(-2, 18, (4, 14, 2)).astype(np.int32)
    valid = rng.random((4, 14)) < 0.6
    valid[3] = False
    got, parts = th.ae_loss(T(tags), T(pos), T(valid))
    want, jparts = jh.ae_loss(tags, pos, valid)
    close(got, want, 1e-6, "ae")
    for k in ("pull", "push"):
        close(parts[k], jparts[k], 1e-6, k)
    close(th.render_gt_heatmaps(T(pos), T(valid), (16, 16)), jh.render_gt_heatmaps(pos, valid, (16, 16)), 1e-6,
          "render_gt_heatmaps")
    low, high = rng.random((16, 16, 28)).astype(np.float32), rng.random((32, 32, 14)).astype(np.float32)
    close(th.aggregate_heatmaps(T(low), T(high)), jh.aggregate_heatmaps(low, high), 1e-6, "aggregate")
    hm = np.zeros((32, 32, 14), np.float32)
    tg = rng.standard_normal((32, 32, 14)).astype(np.float32) * 0.05
    for p, t0 in enumerate((0.0, 3.0)):
        ys, xs = rng.integers(0, 32, 14), rng.integers(0, 32, 14)
        hm[ys, xs, np.arange(14)] = 0.9 - 0.3 * p
        tg[ys, xs, np.arange(14)] = t0
    want = jh.group_people_by_tags(hm, tg)
    got = th.group_people_by_tags(hm, tg)
    assert len(want) == 2 and len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_grouping_of_the_jax_models_outputs(hrnet):
    """The port's aggregation + HeatmapParser on the JAX model's (1, ...)
    outputs for both images: the same people, positions exact."""
    from or4d_tpu.pipeline.perception_infer import _group_2d_people as jax_group

    from or4d_tpu_torch.pipeline.perception_infer import _group_2d_people

    jm, tm, variables, fwd, imgs = hrnet
    n = 0
    for i in range(2):
        low, high = (np.array(a) for a in fwd(variables, imgs[i:i + 1]))
        # sharpen the random heatmaps so people are found
        low[..., :14] *= 40.0
        high *= 40.0
        want = jax_group(low, high, max_people=10)
        got = _group_2d_people(T(low), T(high), max_people=10)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[..., :2], want[..., :2])
        close(got[..., 2], want[..., 2], 1e-5, "scores")
        n += len(want)
    assert n > 0


def test_fuse_layer_equals_flax_in_train_mode():
    """The fuse layer of three branches (nearest upsampling, the strided
    chains, train-mode BN) in float64 on both sides (float32 train-mode
    gradients are ill-conditioned: the next test): outputs, BN running
    statistics and the VJP of a random cotangent (every parameter's
    gradient and each input's) 1e-9 of their largest."""
    import copy

    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((2, 16 >> i, 16 >> i, w)) for i, w in enumerate(jh.WIDTHS[:3])]
    jm = jh.FuseLayer(jh.WIDTHS[:3])
    tm = th.FuseLayer(jh.WIDTHS[:3], device="cpu", generator=torch.Generator())
    variables = random_variables(jax.eval_shape(lambda k: jm.init(k, [a.astype(np.float32) for a in xs],
                                                                  train=False), jax.random.key(0)), 2)
    tm.load_state_dict(higherhrnet_from_jax_variables(variables, tm))
    t64 = copy.deepcopy(tm).double()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        fwd = lambda prm, x: jm.apply({"params": prm, "batch_stats": v64["batch_stats"]}, x, train=True,
                                      mutable=["batch_stats"])
        outs, vjp, mutated = jax.vjp(fwd, v64["params"], [jnp.asarray(a) for a in xs], has_aux=True)
        cts = [jnp.asarray(rng.standard_normal(o.shape)) for o in outs]
        g_params, g_x = jax.device_get(vjp(cts))
        outs, mutated = jax.device_get((outs, mutated))
    tx = [T(a).permute(0, 3, 1, 2).requires_grad_() for a in xs]
    got = t64(tx, train=True)
    for g, w in zip(got, outs, strict=True):
        close(g.permute(0, 2, 3, 1), w, 1e-9, "fuse")
    sum((o.permute(0, 2, 3, 1) * T(np.asarray(c))).sum() for o, c in zip(got, cts)).backward()
    new = higherhrnet_from_jax_variables({"params": v64["params"], "batch_stats": mutated["batch_stats"]}, t64)
    keys = [k for k in new if k.endswith(("running_mean", "running_var"))]
    assert max(float((t64.state_dict()[k] - new[k]).abs().max()) for k in keys) <= 1e-9 * max(
        float(new[k].abs().max()) for k in keys)
    want = higherhrnet_from_jax_variables({"params": g_params, "batch_stats": variables["batch_stats"]}, t64)
    scale = max(float(want[k].abs().max()) for k, _ in t64.named_parameters())
    worst = max((float((p.grad - want[k]).abs().max()), k) for k, p in t64.named_parameters())
    assert worst[0] <= 1e-9 * scale, (worst, scale)
    for g, w in zip(tx, g_x):
        close(g.grad.permute(0, 2, 3, 1), w, 1e-9, "input gradient")


def test_trainer_steps_equal_the_jax_trainer(hrnet):
    """Two ``HigherHRNetTrainer`` steps, each from the JAX trainer's state
    (weights, BN statistics, Adam moments and count) on random images and
    targets. The JAX side is the trainer's loss function in train mode in
    float64, jitted once; its gradient is not compiled: one XLA compile of
    HigherHRNet's whole backward takes a minute alone and several in the
    suite, and the train-mode float32 gradient is ill-conditioned anyway
    (BN over 8 values a channel at the 1/32 branch: both packages' float32
    gradients are further than 1e-3 of the largest from their float64
    ones). So the gradient is held through what defines it: the port's float64 loss and
    every BN batch statistic equal the JAX package's float64 ones (1e-9
    relative), the fuse layer's float64 backward equals JAX's (the test
    above), and the port's gradient feeds both optimizers. Held: the port's
    float32 loss 1e-5 relative and BN running statistics 1e-4 of the
    largest against float64; the port's Adam update and the JAX trainer's
    (optax ``tx.update`` and ``apply_updates``, as ``_apply_update``) of
    that gradient from the same state, every parameter within 1e-5 of the
    largest."""
    import copy

    import optax

    from or4d_tpu.train.perception_trainers import HigherHRNetTrainer as JaxTrainer

    from or4d_tpu_torch.train.perception_trainers import HigherHRNetTrainer

    jm, tm, variables, fwd, imgs = hrnet
    rng = np.random.default_rng(6)
    jtr = JaxTrainer()
    ttr = HigherHRNetTrainer(device="cpu")

    def loss_fn(params, stats, b):  # the JAX trainer's loss function (_step_impl)
        (low, high), mutated = jtr.model.apply({"params": params, "batch_stats": stats}, b["images"], train=True,
                                               mutable=["batch_stats"])
        J = jtr.num_joints
        l_ae = sum(jh.ae_loss(low[i, ..., J:], b["joint_pos"][i], b["joint_valid"][i])[0] for i in range(2))
        total = jh.heatmap_loss(low[..., :J], b["gt_low"]) + jh.heatmap_loss(high, b["gt_high"]) + \
            jtr.ae_weight * l_ae / 2
        return total, mutated["batch_stats"]

    loss64 = jax.jit(loss_fn)
    to64 = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64) if np.asarray(a).dtype.kind == "f" else jnp.asarray(a), t)
    m = ttr.model
    names = [k for k, _ in m.named_parameters()]
    params = {k: v.numpy() for k, v in higherhrnet_from_jax_variables(variables, m).items() if k in names}
    stats = variables["batch_stats"]
    opt = jtr.tx.init(params)  # optax's Adam state, the port's layout (elementwise)
    for it in range(2):
        b = {"images": rng.standard_normal((2, S, S, 3)).astype(np.float32),
             "gt_low": rng.random((2, S // 4, S // 4, 14)).astype(np.float32),
             "gt_high": rng.random((2, S // 2, S // 2, 14)).astype(np.float32),
             "joint_pos": rng.integers(0, S // 4, (2, 10, 14, 2)).astype(np.int32),
             "joint_valid": rng.random((2, 10, 14)) < 0.5}
        flax_params = _to_flax(params, variables["params"], m)
        with jax.enable_x64(True):
            loss, new_stats = jax.device_get(loss64(*to64((flax_params, stats, b))))
        loss = float(loss)
        state = higherhrnet_from_jax_variables({"params": flax_params, "batch_stats": stats}, m)
        m.load_state_dict(state)
        adam = opt[0]
        for name, p in m.named_parameters():
            ttr.optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                                      "exp_avg": torch.tensor(np.asarray(adam.mu[name])),
                                      "exp_avg_sq": torch.tensor(np.asarray(adam.nu[name]))}
        m64 = copy.deepcopy(m).double()
        args = (T(b["images"]), T(b["gt_low"]), T(b["gt_high"]), T(b["joint_pos"]), T(b["joint_valid"]))
        total = ttr.loss(*args)
        assert abs(float(total) - loss) <= 1e-5 * loss, (it, float(total), loss)
        want = higherhrnet_from_jax_variables({"params": flax_params, "batch_stats": new_stats}, m64)
        keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
        sscale = max(float(want[k].abs().max()) for k in keys)
        worst = max((float((m.state_dict()[k] - want[k]).abs().max()), k) for k in keys)
        assert worst[0] <= 1e-4 * sscale, (it, worst, sscale)
        ttr.model = m64  # the same loss function on the float64 copy
        with torch.no_grad():
            total64 = ttr.loss(*(a.double() if a.is_floating_point() else a for a in args))
        ttr.model = m
        assert abs(float(total64) - loss) <= 1e-9 * loss, (it, float(total64), loss)
        worst = max((float((m64.state_dict()[k] - want[k]).abs().max()), k) for k in keys)
        assert worst[0] <= 1e-9 * sscale, (it, worst, sscale)
        total.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
                 for k, p in m.named_parameters()}
        # the update of that gradient: the port's Adam, and optax's as the JAX trainer applies it
        m.load_state_dict(state)
        for k, p in m.named_parameters():
            p.grad = T(grads[k].copy())
        ttr.optimizer.step()
        updates, opt = jtr.tx.update(grads, opt, params)
        params = jax.device_get(optax.apply_updates(params, updates))
        pscale = max(float(np.abs(v).max()) for v in params.values())
        got = dict(m.named_parameters())
        worst = max((float(np.abs(got[k].detach().numpy() - v).max()), k) for k, v in params.items())
        assert worst[0] <= 1e-5 * pscale, (it, worst, pscale)
        stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), new_stats)


def _to_flax(named: dict, like, model) -> dict:
    """The port-layout parameters ``named`` as a flax tree shaped like
    ``like`` (the converter's layout change undone)."""
    from or4d_tpu_torch.models.layers import ConvNd

    def leaf(path, a):
        keys = [q.key for q in path]
        name = ".".join(keys[:-1] + [{"kernel": "weight", "scale": "weight", "bias": "bias"}[keys[-1]]])
        arr = np.asarray(named[name])
        if keys[-1] == "kernel":
            conv = model.get_submodule(".".join(keys[:-1]))
            nd = arr.ndim - 2
            if conv.transpose:
                arr = np.flip(arr, axis=tuple(range(2, nd + 2))).transpose(tuple(range(2, nd + 2)) + (0, 1))
            else:
                arr = arr.transpose(tuple(range(2, nd + 2)) + (1, 0))
        assert arr.shape == a.shape, (name, arr.shape, a.shape)
        return np.ascontiguousarray(arr)

    return jax.tree_util.tree_map_with_path(leaf, like)


def test_2d_driver_writes_the_jax_drivers_npz(hrnet, tmp_path, monkeypatch):
    """Both drivers over the fixture's twelve train images at 64 x 64: the
    same keys, and per image the same number of people; the positions are
    the same but where the grouping's quarter-pixel ``adjust`` or a peak
    meets a near-tie of the random model's flat heatmaps (at most 1 of 200
    values, none over one pixel), and the joints found at the same place
    have the same score (1e-4 of the largest)."""
    from or4d_tpu.data.higherhrnet_dataset import HigherHRNetDataset as JaxDataset
    from or4d_tpu.pipeline.perception_infer import run_2d_inference_for_voxelpose as jax_driver

    from or4d_tpu_torch.data.higherhrnet_dataset import HigherHRNetDataset
    from or4d_tpu_torch.pipeline.perception_infer import run_2d_inference_for_voxelpose

    jm, tm, variables, fwd, imgs = hrnet
    kw = dict(take_indices=[1], input_size=S, output_sizes=(S // 4, S // 2), augment=False)
    jds, tds = JaxDataset(ROOT, "train", **kw), HigherHRNetDataset(ROOT, "train", **kw)
    # the driver jits model.apply(v, x, train=False): the fixture's compiled forward
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda f, **_kw: fwd)
        want = jax_driver(jm, variables, jds, tmp_path / "jax.npz")
    got = run_2d_inference_for_voxelpose(tm, tds, tmp_path / "port.npz")
    loaded = np.load(tmp_path / "port.npz", allow_pickle=True)["arr_0"].item()
    assert sorted(loaded) == sorted(got) == sorted(want) and len(want) == 12
    moved = total = 0
    for k in want:
        assert loaded[k].shape == want[k].shape, k
        d = np.abs(loaded[k][..., :2] - want[k][..., :2])
        assert (d <= 1.0).all(), k
        moved, total = moved + int((d > 0).sum()), total + d.size
        same = (d == 0).all(-1)  # a joint found at the same place has the same score
        if same.any():
            close(loaded[k][..., 2][same], want[k][..., 2][same], 1e-4, k)
    assert total > 0 and moved <= total / 200, (moved, total)
