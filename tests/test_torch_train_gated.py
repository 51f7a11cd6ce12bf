"""The ``train_raw=False`` train path of the port vs the JAX package: TPU
kernel rows 9 (``ball_query_group_pallas_gated``, forward and backward) and
10 (``ball_query_bounds_pallas``), the relation encoder on that path, the
port's own train step with ``train_raw`` false against true, and the config
key that selects the path.

The same numpy inputs and cotangents go through ``jax.vjp`` of the Pallas
kernels in interpret mode and through the port's functions on CPU tensors
(their plain versions). Row 9's forward must agree exactly; dA to 1e-5 of
its largest value in float32 (summation order) plus one bf16 ulp in
bfloat16 (the f32 sums round once). Row 10 exactly, on inputs where no
support point lies near a radius: the TPU kernel's norm-expansion distances
and the port's direct difference may disagree there. Modules to 1e-4 in
float32 (BN statistics reassociate).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from or4d_tpu.models.pointnet2 import PointNet2MSGEncoder as JEncoder
from or4d_tpu.ops.pallas_ball_query import _counts_to_bounds, ball_query_bounds_pallas, ball_query_group_pallas_gated
from or4d_tpu.ops.pallas_fps import furthest_point_sample_with_counts as j_fps_counts
from tests.test_torch_models import randomize
from tests.test_torch_train_ops import _assert_bwd_close, _f32, _to_numpy

from or4d_tpu_torch.config import TINY, ExperimentConfig
from or4d_tpu_torch.convert import from_jax_variables
from or4d_tpu_torch.data.scene_batch import SceneBatch
from or4d_tpu_torch.data.synthetic import make_scene_samples
from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
from or4d_tpu_torch.models import pointnet2
from or4d_tpu_torch.models.pointnet2 import PointNet2MSGEncoder
from or4d_tpu_torch.ops import launch_counts, reset_launch_counts
from or4d_tpu_torch.ops.ball_query_bounds import ball_query_bounds
from or4d_tpu_torch.ops.ball_query_group import ball_query_group_gated
from or4d_tpu_torch.ops.fps import furthest_point_sample_with_counts
from or4d_tpu_torch.ops.sa_group_mlp import counts_to_bounds
from or4d_tpu_torch.train.loop import Trainer

SCALES = ((0.15, 4), (0.3, 8))
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cloud(rng, B, N, std=0.5):
    return (rng.standard_normal((B, N, 3)) * std).astype(np.float32)


def _fps_inputs(seed, B, N, M):
    """A cloud, its FPS centroids with query 3 of cloud 0 moved out of
    reach, and the JAX bounds (need, thr) per scale: from the FPS counts,
    and for the moved query from ``ball_query_bounds_pallas``."""
    rng = np.random.default_rng(seed)
    xyz = _cloud(rng, B, N)
    idx, counts = j_fps_counts(jnp.asarray(xyz), M, tuple(r for r, _ in SCALES), True)
    q = np.take_along_axis(xyz, np.asarray(idx)[..., None].astype(np.int64), 1)
    q[0, 3] = 50.0
    far = ball_query_bounds_pallas(SCALES, jnp.asarray(xyz), jnp.asarray(q), True)
    bounds = []
    for (_r, ns), (need, thr), (fneed, ftot) in zip(SCALES, _counts_to_bounds(SCALES, tuple(counts)), far):
        assert float(ftot[0, 3]) == 0.0 and float(fneed[0, 3]) == 1.0
        need = np.array(need)
        thr = np.array(thr)
        need[0, 3], thr[0, 3] = float(fneed[0, 3]), min(float(ftot[0, 3]), ns)
        bounds.append((need, thr))
    return rng, xyz, q, bounds


def _unpack(o):
    """(B, ns/2, M, 2C) slot pairs -> (B, ns, M, C) (slot s in lane half s % 2)."""
    o = np.asarray(o.astype(jnp.float32))
    C = o.shape[-1] // 2
    return np.stack([o[..., :C], o[..., C:]], axis=2).reshape(o.shape[0], -1, o.shape[2], C)


def _pack(g):
    """(B, ns, M, C) -> (B, ns/2, M, 2C), the inverse of :func:`_unpack`."""
    return np.concatenate([g[:, 0::2], g[:, 1::2]], axis=-1)


@pytest.mark.parametrize("dtype,pack", [("float32", False), ("bfloat16", False), ("float32", True)])
def test_row9_forward_and_backward_match_pallas_vjp(dtype, pack):
    """B=2, N=1024 (two chunks), M=64, two scales, bounds from the FPS
    counts. The JAX outputs are slot-major (B, ns, M, C), and with
    ``pack_slots`` slot pairs share a row; both are mapped to the port's
    query-major (B, M, ns, C)."""
    rng, xyz, q, bounds = _fps_inputs(12, 2, 1024, 64)
    B, N, M = 2, 1024, 64
    A = rng.standard_normal((B, N, 16)).astype(np.float32)
    feats = tuple(jnp.asarray(A).astype(JDT[dtype]) for _ in SCALES)
    jb = tuple((jnp.asarray(n), jnp.asarray(t)) for n, t in bounds)
    outs, vjp = jax.vjp(
        lambda f: ball_query_group_pallas_gated(SCALES, jnp.asarray(xyz), jnp.asarray(q), f, jb, True, pack), feats)
    gs = [rng.standard_normal((B, ns, M, 16)).astype(np.float32) for _r, ns in SCALES]
    cot = tuple(jnp.asarray(_pack(g) if pack else g).astype(JDT[dtype]) for g in gs)
    dAs = vjp(cot)[0]
    reset_launch_counts()
    for s, (r, ns) in enumerate(SCALES):
        want = _unpack(outs[s]) if pack else _f32(outs[s])
        At = torch.from_numpy(A).to(TDT[dtype]).requires_grad_(True)
        need = torch.from_numpy(bounds[s][0]).int()
        out = ball_query_group_gated(torch.from_numpy(xyz), torch.from_numpy(q), r, ns, At, need)
        assert out.shape == (B, M, ns, 16) and out.dtype == TDT[dtype]
        out.backward(torch.from_numpy(np.ascontiguousarray(gs[s].transpose(0, 2, 1, 3))).to(TDT[dtype]))
        np.testing.assert_array_equal(out.detach().float().numpy(), want.transpose(0, 2, 1, 3))
        assert not out[0, 3].any() and At.grad.dtype == TDT[dtype]
        _assert_bwd_close(At.grad.float().numpy(), _f32(dAs[s]), dtype, 1e-5)
    assert all(v == 0 for v in launch_counts().values())  # plain versions on the CPU


def test_row9_need_bound_is_exact():
    """The plain forward cut at need*512 points gives the rows and indices
    of the uncut search; a bound one chunk short would lose hits."""
    rng = np.random.default_rng(13)
    xyz = torch.from_numpy(_cloud(rng, 2, 1300))
    idx, counts = furthest_point_sample_with_counts(xyz, 48, (0.3,))
    q = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()
    need = counts_to_bounds(((0.3, 24),), counts)[0][0].int()
    A = torch.randn(2, 1300, 8)
    from or4d_tpu_torch.ops.ball_query_group import group_fwd

    cut, cut_idx = group_fwd(xyz, q, 0.3, 24, A, need)
    full, full_idx = group_fwd(xyz, q, 0.3, 24, A)
    assert torch.equal(cut_idx, full_idx) and torch.equal(cut, full) and int(need.max()) > 1
    short = (need - 1).clamp(min=1).int()
    assert not torch.equal(group_fwd(xyz, q, 0.3, 24, A, short)[1], full_idx)


def test_row10_matches_pallas_bounds_and_fps_counts():
    """N=1100 (three chunks, the last ragged), M=40, two scales, one query
    with no hit."""
    rng = np.random.default_rng(14)
    B, N, M = 2, 1100, 40
    xyz = _cloud(rng, B, N, std=0.3)
    q = xyz[:, rng.permutation(N)[:M]].copy()
    q[1, 7] = 30.0
    scales = ((0.1, 16), (0.2, 32))
    d2 = ((q[:, :, None, :].astype(np.float64) - xyz[:, None, :, :]) ** 2).sum(-1)
    for r, _ns in scales:
        assert np.abs(d2 - r * r).min() > 1e-5 * r * r  # no point on a radius
    want = ball_query_bounds_pallas(scales, jnp.asarray(xyz), jnp.asarray(q), True)
    reset_launch_counts()
    got = ball_query_bounds(scales, torch.from_numpy(xyz), torch.from_numpy(q))
    assert launch_counts()["bounds.prepass"] == 0  # the plain version on the CPU
    for (gn, gt), (wn, wt) in zip(got, want):
        assert gn.dtype == gt.dtype == torch.float32 and gn.shape == (B, M)
        np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
        assert gn[1, 7] == 1.0 and gt[1, 7] == 0.0
    # on FPS centroids: the need of counts_to_bounds and the sum of the FPS counts
    xt = torch.from_numpy(xyz)
    idx, counts = furthest_point_sample_with_counts(xt, M, tuple(r for r, _ in scales))
    cq = torch.gather(xt, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()
    got = ball_query_bounds(scales, xt, cq)
    for (gn, gt), (need, thr), c, (_r, ns) in zip(got, counts_to_bounds(scales, counts), counts, scales):
        assert torch.equal(gn, need) and torch.equal(gt, c.sum(-1)) and torch.equal(gt.clamp(max=ns), thr)
        assert int(gn.max()) > 1


@pytest.mark.parametrize("N,scales", [(1537, ((0.1, 16), (0.2, 32))), (1100, ((0.3, 8), (0.2, 16), (0.1, 4)))])
def test_row10_chunk_edges_match_pallas(N, scales):
    """N not a multiple of 512, scales in descending radius order too, M=40:
    a query with no hit, one whose ns-th hit at the first scale is the last
    point of chunk 0 (need 1), and one with fewer hits than any ns, all in
    chunk 2 (need 3). No point lies near a radius (see the module
    docstring)."""
    rng = np.random.default_rng(N)
    B, M = 2, 40
    xyz = _cloud(rng, B, N, std=0.3)
    q = xyz[:, rng.permutation(N)[:M]].copy()
    q[1, 7] = 30.0  # no hit
    ns0 = scales[0][1]
    xyz[0, 512 - ns0: 512] = 5.0 + 1e-3 * rng.standard_normal((ns0, 3)).astype(np.float32)
    q[0, 3] = 5.0
    xyz[0, 1030:1033] = -5.0 + 1e-3 * rng.standard_normal((3, 3)).astype(np.float32)
    q[0, 4] = -5.0
    d2 = ((q[:, :, None, :].astype(np.float64) - xyz[:, None, :, :]) ** 2).sum(-1)
    for r, _ns in scales:
        assert np.abs(d2 - r * r).min() > 1e-5 * r * r  # no point on a radius
    want = ball_query_bounds_pallas(scales, jnp.asarray(xyz), jnp.asarray(q), True)
    got = ball_query_bounds(scales, torch.from_numpy(xyz), torch.from_numpy(q))
    for (gn, gt), (wn, wt), (_r, ns) in zip(got, want, scales):
        np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
        assert gn[1, 7] == 1.0 and gt[1, 7] == 0.0
        assert gn[0, 4] == 3.0 and gt[0, 4] == 3.0 < ns
        assert gt[0, 3] == ns0 and gn[0, 3] == 1.0
    assert float(want[0][1][0, 3]) == ns0  # the first scale's ns-th hit is point 511


def test_row10_rejects_bad_inputs():
    xyz = torch.zeros(1, 600, 3)
    with pytest.raises(ValueError):  # five scales
        ball_query_bounds(((0.1, 4),) * 5, xyz, xyz[:, :8].contiguous())
    with pytest.raises(ValueError):  # nsample 0
        ball_query_bounds(((0.1, 0),), xyz, xyz[:, :8].contiguous())
    with pytest.raises(ValueError):  # float64 geometry
        ball_query_bounds(((0.1, 4),), xyz.double(), xyz[:, :8].contiguous())


def test_encoder_train_raw_false_matches_jax():
    """PointNet2MSGEncoder(train_raw=False) on relation crops wider than one
    chunk (SA1 through row 9, SA2 through row 6) against the JAX encoder
    with the TPU knobs (gated kernels, slot-pair packing, per-scale sort;
    interpret mode): output, every parameter's gradient and the updated
    running statistics, with one row masked out."""
    rng = np.random.default_rng(15)
    B, N = 3, 700
    xyz = _cloud(rng, B, N, std=0.25)
    rgb = rng.uniform(0, 1, (B, N, 3)).astype(np.float32)
    m = rng.integers(0, 3, (B, N, 1)).astype(np.float32)
    pc = np.concatenate([xyz, rgb, m], -1)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    kw = dict(input_dim=7, out_size=32, sa_npoints=(32, 16), sa_nsamples=((4, 8), (8, 8)))
    enc = JEncoder(fused_mode="train_kernel", kernel_interpret=True, train_raw=False, packed_slots=True,
                   train_per_scale_sort=True, **kw)
    v = randomize(jax.eval_shape(lambda: enc.init(jax.random.key(0), jnp.asarray(pc), train=False)), 16)
    proj = rng.standard_normal((B, 32)).astype(np.float32)

    def jloss(params):
        out, mut = enc.apply({**v, "params": params}, jnp.asarray(pc), mask=jnp.asarray(mask), train=True,
                             mutable=["batch_stats"])
        return jnp.sum(out * proj), (out, mut["batch_stats"])

    (_, (jout, jstats)), jg = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    port = PointNet2MSGEncoder(7, 32, sa_npoints=(32, 16), sa_nsamples=((4, 8), (8, 8)), train_raw=False)
    port.load_state_dict(from_jax_variables(v, port))
    out = port(torch.from_numpy(pc), mask=torch.from_numpy(mask), train=True)
    (out * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    want = from_jax_variables({"params": _to_numpy(jg), "batch_stats": _to_numpy(jstats)}, port)
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
    for k, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


# tiny shapes with crops wider than one chunk, so SA1 takes rows 9 or 5
WIDE = dataclasses.replace(TINY, dataset=dataclasses.replace(TINY.dataset, num_points_objects=600,
                                                              num_points_relation=1100),
                           tpu=dataclasses.replace(TINY.tpu, scene_batch=2))


def _wide_batch(seed=21):
    return SceneBatch.stack(make_scene_samples(2, seed=seed, n_objects=4, ds=WIDE.dataset, points_per_obj=400))


def test_train_step_train_raw_false_matches_true():
    """The port's train step on both SA1 paths, from the same weights and
    draws, float32 on the CPU: losses within 1e-5 and every parameter's
    gradient within 1e-3 of the model's largest. The two paths round A in
    another order (raw: rows built from the raw plane; plane: one product
    for the whole plane), and a last-bit difference can flip an SA max-pool
    winner (ROADMAP Queue 3). A JAX Trainer adds nothing here: the JAX SGPN
    exposes no ``fused_mode``, so on the CPU it runs its XLA fallback
    whatever ``train_raw`` says."""
    batch = _wide_batch()
    w = np.ones(DEFAULT_VOCAB.num_classes, np.float32), np.ones(DEFAULT_VOCAB.num_relations, np.float32)
    runs = {}
    for raw in (True, False):
        cfg = dataclasses.replace(WIDE, tpu=dataclasses.replace(WIDE.tpu, train_raw=raw))
        tr = Trainer(cfg, DEFAULT_VOCAB, *w, device="cpu", seed=3)
        reset_launch_counts()
        parts = tr.train_step(batch, torch.Generator().manual_seed(4))
        runs[raw] = ({k: float(v) for k, v in parts.items()},
                     {k: p.grad.clone() for k, p in tr.model.named_parameters()})
    (lt, gt), (lf, gf) = runs[True], runs[False]
    for k in lt:
        assert abs(lt[k] - lf[k]) <= 1e-5, (k, lt[k], lf[k])
    scale = max(float(g.abs().max()) for g in gt.values())
    for k in gt:
        np.testing.assert_allclose(gf[k].numpy(), gt[k].numpy(), rtol=0, atol=1e-3 * scale, err_msg=k)


def _wide_json(train_raw: bool) -> dict:
    return {"NAME": "tiny_wide", "LR": 1e-3,
            "MODEL": {"sa_npoints": [32, 16], "sa_nsamples": [[4, 8], [8, 8]]},
            "dataset": {"num_points_objects": 600, "num_points_relation": 1100, "data_augmentation": False},
            "TPU": {"scene_batch": 2, "max_objects": 6, "max_edges": 30, "train_raw": train_raw}}


def test_config_train_raw_reaches_row9(monkeypatch):
    """``{"TPU": {"train_raw": false}}`` in a reference JSON reaches SA1 of
    both encoders: the Trainer's train step groups through
    ``ball_query_group_gated`` and never through the raw grouping (a spy on
    both, since launch counters stay 0 on the CPU); the default keeps the
    raw path."""
    assert ExperimentConfig.from_reference_json({}).tpu.train_raw is True
    cfg = ExperimentConfig.from_reference_json(_wide_json(False))
    assert cfg.tpu.train_raw is False and cfg.dataset.num_points_relation == 1100
    calls = []
    for name in ("ball_query_group_gated", "ball_query_group_raw"):
        fn = getattr(pointnet2, name)
        monkeypatch.setattr(pointnet2, name, lambda *a, _n=name, _f=fn: calls.append((_n, a[0].shape[1])) or _f(*a))
    w = np.ones(DEFAULT_VOCAB.num_classes, np.float32), np.ones(DEFAULT_VOCAB.num_relations, np.float32)
    for raw in (False, True):
        calls.clear()
        cfg = ExperimentConfig.from_reference_json(_wide_json(raw))
        tr = Trainer(cfg, DEFAULT_VOCAB, *w, device="cpu")
        assert tr.model.obj_encoder.sa1.train_raw is raw and tr.model.rel_encoder.sa1.train_raw is raw
        assert tr.model.rel_encoder.sa2.train_raw is False  # SA2's features carry gradients
        tr.train_step(_wide_batch(), torch.Generator().manual_seed(1))
        used = "ball_query_group_raw" if raw else "ball_query_group_gated"
        # two scales of SA1 in each encoder, on the 600- and 1100-point crops
        assert sorted(calls) == sorted([(used, 600)] * 2 + [(used, 1100)] * 2), calls


def test_train_cli_with_train_raw_false_config(tmp_path, monkeypatch):
    from or4d_tpu_torch.train.__main__ import main as train_main

    path = tmp_path / "wide.json"
    path.write_text(json.dumps(_wide_json(False)))
    calls = []
    fn = pointnet2.ball_query_group_gated
    monkeypatch.setattr(pointnet2, "ball_query_group_gated", lambda *a: calls.append(1) or fn(*a))
    out = tmp_path / "history.json"
    res = train_main(["--synthetic", "--config", str(path), "--scenes", "2", "--steps", "1", "--device", "cpu",
                      "--output", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert len(res["history"]) == 1 and all(np.isfinite(res["history"][0][k]) for k in ("loss", "loss_obj"))
    assert len(calls) == 4
