"""Serving mode of the port (``or4d_tpu_torch.serving``) against the JAX
package's serving mode, and the evaluator's own contract, on the CPU.

Kernel rows: the multi-scale ball query (row 8) against
``ball_query_multiscale_pallas`` in interpret mode, indices exactly; the
serving SA1 MLP (row 7) against ``serving_sa1_mlp_pallas`` in interpret mode
on the same planes (the port's (R, M, ns, 8) layout mapped to the TPU's
slot-flattened channel-major one), within 1e-4 in float32 and 2e-2 in
bfloat16. Off the TPU the JAX cache build runs the XLA ball query, whose
|a|^2 + |b|^2 - 2ab expansion may pick other neighbours at the radius than
the kernels' direct difference; the cache tests therefore build the JAX
reference with the Pallas kernel in interpret mode (monkeypatched into
``or4d_tpu.serving``), and the SGPN test first checks that the XLA ball query
agrees with the scan-order reference on its inputs. The SA module with a
cache matches within 2e-5, SGPN serving log-probs within 2e-4 (the
tolerance of test_torch_sgpn.py), and the port's serving forward its own
cold unpaired forward within 1e-5 (tests/test_serving.py's contract).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from or4d_tpu import serving as jserving
from or4d_tpu.config import DatasetConfig as JDatasetConfig
from or4d_tpu.data.scene_batch import SlotPack as JSlotPack
from or4d_tpu.data.synthetic import make_scene_batch as j_make_scene_batch
from or4d_tpu.models import SGPN as JSGPN
from or4d_tpu.models.pointnet2 import SAScale as JSAScale, SetAbstractionMSG as JSA
from or4d_tpu.ops.ball_query import ball_query as j_ball_query
from or4d_tpu.ops.fps import furthest_point_sample as j_fps
from or4d_tpu.ops.pallas_ball_query import ball_query_multiscale_pallas
from or4d_tpu.ops.pallas_serving_mlp import serving_sa1_mlp_pallas
from tests.reference_impls import ball_query_np
from tests.test_torch_models import randomize
from tests.test_torch_cuda import eval_stages

from or4d_tpu_torch import serving
from or4d_tpu_torch.config import TINY, DatasetConfig
from or4d_tpu_torch.convert import from_jax_variables
from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack
from or4d_tpu_torch.data.synthetic import make_scene_batch, make_scene_sample
from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
from or4d_tpu_torch.models import SGPN
from or4d_tpu_torch.models.pointnet2 import SAScale, SetAbstractionMSG
from or4d_tpu_torch.ops.ball_query_multiscale import ball_query_multiscale
from or4d_tpu_torch.ops.serving_sa1_mlp import serving_sa1_mlp
from or4d_tpu_torch.train.loop import Trainer

SA_NPOINTS, SA_NSAMPLES = (32, 16), ((4, 8), (8, 8))
DS = dict(num_points_objects=96, num_points_relation=128, max_objects=4, max_edges=12, data_augmentation=False)
_FIELDS = ("obj_points", "rel_points", "edge_index", "rel_onehot", "gt_class", "gt_rels", "obj_mask",
           "edge_mask", "rel_hand_points")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _interpret_multiscale(scales, xyz, new_xyz):
    return ball_query_multiscale_pallas(tuple((float(r), int(ns)) for r, ns in scales), xyz, new_xyz, True)


@pytest.fixture
def jax_cache_with_kernel(monkeypatch):
    """The JAX cache build with the row-8 Pallas kernel (interpret mode) in
    place of its off-TPU XLA ball query."""
    monkeypatch.setattr(jserving, "ball_query_multiscale", _interpret_multiscale)


# --------------------------------------------------------------- row 8


def _query_set(seed, B=2, N=200, M=40):
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((B, N, 3)) * 0.4).astype(np.float32)
    q = xyz[:, rng.permutation(N)[:M]].copy()
    q[0, 3] = 50.0  # no hit at any radius: index 0 in every slot
    return xyz, q


@pytest.mark.parametrize("scales,N", [(((0.1, 16), (0.2, 32)), 200), (((0.3, 8),), 200),
                                      (((0.05, 4), (0.5, 64)), 48)],
                         ids=["two_scales", "one_scale", "nsample_over_N"])
def test_multiscale_ball_query_matches_pallas(scales, N):
    """Short scales leave slots to fill (first hit repeated); ns 64 > N 48
    fills past every support point; query 3 of cloud 0 has no hit."""
    xyz, q = _query_set(len(scales), N=N, M=24)
    want = _interpret_multiscale(scales, jnp.asarray(xyz), jnp.asarray(q))
    got = ball_query_multiscale(scales, t(xyz), t(q))
    assert len(got) == len(want)
    for (_r, ns), g, w in zip(scales, got, want):
        assert g.shape == (2, 24, ns) and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (g[0, 3] == 0).all()


# --------------------------------------------------------------- row 7


def _port_to_cm(planes: np.ndarray) -> np.ndarray:
    """(R, M, ns, 8) -> the TPU's slot-flattened channel-major (R, 8, ns*Mp)."""
    R, M, ns, c = planes.shape
    Mp = -(-M // 8) * 8
    g = np.zeros((R, c, ns, Mp), planes.dtype)
    g[..., :M] = planes.transpose(0, 3, 2, 1)
    return g.reshape(R, c, ns * Mp)


def _mlp_inputs(seed, R=3, M=12, ns=4, c0=7, C1=64, C2=128):
    rng = np.random.default_rng(seed)
    planes = np.zeros((R, M, ns, 8), np.float32)
    planes[..., :c0] = rng.standard_normal((R, M, ns, c0))
    return (planes, rng.standard_normal((R, M, C1)).astype(np.float32),
            (rng.standard_normal((c0, C1)) / np.sqrt(c0)).astype(np.float32),
            rng.uniform(0.5, 1.5, C1).astype(np.float32), (rng.standard_normal(C1) * 0.2).astype(np.float32),
            (rng.standard_normal((C1, C2)) / np.sqrt(C1)).astype(np.float32),
            rng.uniform(0.5, 1.5, C2).astype(np.float32), (rng.standard_normal(C2) * 0.2).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,ns,C2", [(12, 4, 128), (16, 16, 64)])
def test_serving_mlp_matches_pallas(dtype, M, ns, C2):
    planes, Bq, W0, a0, b0, W1, a1, b1 = _mlp_inputs(M + ns, M=M, ns=ns, C2=C2)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jv = lambda a: jnp.asarray(a).astype(jdt)
    tv = lambda a: t(a).to(tdt)
    want = serving_sa1_mlp_pallas(jv(_port_to_cm(planes)), jv(Bq), jv(W0), jnp.asarray(a0), jnp.asarray(b0), jv(W1),
                                  jnp.asarray(a1), jnp.asarray(b1), ns, True)
    got = serving_sa1_mlp(tv(planes), tv(Bq), tv(W0), t(a0), t(b0), tv(W1), t(a1), t(b1))
    assert got.shape == (3, M, C2) and got.dtype == tdt
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


# ------------------------------------------------------ cache and SA module


def _crops(seed, R=5, P=200, C=7):
    rng = np.random.default_rng(seed)
    pc = rng.standard_normal((R, P, C)).astype(np.float32)
    pc[..., :3] *= 0.5
    return pc


def test_build_sa1_cache_matches_jax(jax_cache_with_kernel):
    pc = _crops(3)
    scales = ((0.4, 4), (0.8, 8))
    want = jserving.build_sa1_cache(jnp.asarray(pc), 32, scales)
    got = serving.build_sa1_cache(t(pc), 32, scales)
    assert got.c0 == 7
    np.testing.assert_array_equal(got.new_xyz.numpy(), np.asarray(want.new_xyz))
    for g, w in zip(got.grouped, want.grouped):
        assert g.shape[-1] == 8 and not g[..., 7:].any()
        np.testing.assert_array_equal(g[..., :7].numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def sa_pair():
    kw = dict(npoint=32, scales=(JSAScale(0.4, 4, (8, 8)), JSAScale(0.8, 8, (8, 16))))
    jsa = JSA(**kw, kernel_interpret=True)
    pc = _crops(4)
    # shapes only: randomize replaces every leaf
    v = randomize(jax.eval_shape(lambda: jsa.init(jax.random.key(0), jnp.asarray(pc[..., :3]), jnp.asarray(pc[..., 3:]),
                                                  train=False)), 12)
    port = SetAbstractionMSG(7, 32, (SAScale(0.4, 4, (8, 8)), SAScale(0.8, 8, (8, 16))))
    port.load_state_dict(from_jax_variables(v, port))
    return jsa, v, port.requires_grad_(False), pc


def test_sa_module_cache_branch_matches_jax(sa_pair, jax_cache_with_kernel):
    """The JAX module's fused serving kernel (interpret mode) on its
    channel-major cache against the port's cache branch."""
    jsa, v, port, pc = sa_pair
    scales = ((0.4, 4), (0.8, 8))
    jcache = jserving.build_sa1_cache(jnp.asarray(pc), 32, scales, channel_major=True)
    want_xyz, want = jsa.apply(v, None, None, train=False, cache=jcache)
    got_xyz, got = port(None, None, cache=serving.build_sa1_cache(t(pc), 32, scales))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="eval"):
        port(None, None, train=True, cache=serving.build_sa1_cache(t(pc), 32, scales))


# ---------------------------------------------------------- SGPN serving


def _port_batch(jbatch) -> SceneBatch:
    return SceneBatch(**{f: np.asarray(getattr(jbatch, f)) for f in _FIELDS}, scan_ids=jbatch.scan_ids,
                      take_idxs=jbatch.take_idxs, slot_names=jbatch.slot_names)


def _ball_query_agrees(points):
    """The JAX XLA ball query equals the scan-order reference on every SA1
    and SA2 query of these crops (the JAX SA2 runs it off the TPU)."""
    rows = points.reshape(-1, *points.shape[2:])[:, :, :3]
    for npoint, radii, nsamples in zip(SA_NPOINTS, ((0.1, 0.2), (0.2, 0.4)), SA_NSAMPLES):
        idx = np.asarray(j_fps(jnp.asarray(rows), npoint)).astype(np.int64)
        q = np.take_along_axis(rows, idx[..., None], 1)
        for r, ns in zip(radii, nsamples):
            np.testing.assert_array_equal(np.asarray(j_ball_query(r, ns, jnp.asarray(rows), jnp.asarray(q))),
                                          ball_query_np(r, ns, rows, q))
        rows = q


@pytest.fixture(scope="module")
def sgpn_run():
    """JAX SGPN (randomized variables) serving and cold log-probs on a flat
    pack of two tiny scenes, and the port's SGPN with the same variables."""
    jbatch = j_make_scene_batch(2, seed=8, n_objects=4, ds=JDatasetConfig(**DS), points_per_obj=150)
    model = JSGPN(num_classes=12, num_relations=15, sa_npoints=SA_NPOINTS, sa_nsamples=SA_NSAMPLES)
    v = jax.eval_shape(lambda: model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, jbatch,
                                          train=False))
    v = randomize(v, seed=13)  # shapes only: randomize replaces every leaf
    pack = JSlotPack.build(jbatch)
    caches = jax.jit(lambda: jserving.build_sgpn_sa1_caches(model, jbatch, pack))()
    fast = jax.jit(lambda v, c: model.apply(v, jbatch, train=False, pack=pack, sa1_caches=c))(v, caches)
    port = SGPN(num_classes=12, num_relations=15, sa_npoints=SA_NPOINTS, sa_nsamples=SA_NSAMPLES, device="cpu")
    port.load_state_dict(from_jax_variables(v, port))
    return jbatch, np.asarray(fast.rel_logprobs), np.asarray(fast.obj_logprobs), port


def test_sgpn_serving_matches_jax(sgpn_run):
    jbatch, rel, obj, port = sgpn_run
    _ball_query_agrees(np.asarray(jbatch.obj_points))
    _ball_query_agrees(np.asarray(jbatch.rel_points))
    batch = _port_batch(jbatch)
    pack = SlotPack.build(batch).to("cpu")
    with torch.no_grad():
        caches = serving.build_sgpn_sa1_caches(port, batch.to("cpu"), pack)
        out = port(serving._strip_points(batch).to("cpu"), pack, sa1_caches=caches)
    em, om = np.asarray(jbatch.edge_mask), np.asarray(jbatch.obj_mask)
    np.testing.assert_allclose(out.rel_logprobs.numpy()[em], rel[em], atol=2e-4, rtol=0)
    np.testing.assert_allclose(out.obj_logprobs.numpy()[om], obj[om], atol=2e-4, rtol=0)


@pytest.mark.parametrize("with_pack", [True, False])
def test_serving_matches_cold_unpaired_forward(sgpn_run, with_pack):
    port = sgpn_run[3]
    batch = make_scene_batch(2 if with_pack else 1, seed=8, n_objects=4, ds=DatasetConfig(**DS),
                             points_per_obj=150)
    pack = SlotPack.build(batch).to("cpu") if with_pack else None
    b = batch.to("cpu")
    with torch.no_grad():
        cold = port(b, pack)
        fast = port(serving._strip_points(batch).to("cpu"), pack,
                    sa1_caches=serving.build_sgpn_sa1_caches(port, b, pack))
    for name in ("rel_logprobs", "obj_logprobs"):
        np.testing.assert_allclose(getattr(fast, name).numpy(), getattr(cold, name).numpy(), rtol=0, atol=1e-5)


def test_serving_and_cold_forward_stage_by_stage(sgpn_run):
    """The serving and the cold unpaired forward on the plain versions,
    stage by stage (``eval_stages``): SA1's centroids equal, every
    later stage within 1e-5 (the end-to-end contract), and a stage whose
    inputs are equal gives equal outputs; a second cold forward equals the
    first bit for bit. The card test of the same name holds the kernels to
    bit equality at every stage in float32."""
    port = sgpn_run[3]
    batch = make_scene_batch(2, seed=8, n_objects=4, ds=DatasetConfig(**DS), points_per_obj=150)
    pack = SlotPack.build(batch).to("cpu")
    b = batch.to("cpu")
    with torch.no_grad():
        caches = serving.build_sgpn_sa1_caches(port, b, pack)
    fast = eval_stages(port, serving._strip_points(batch).to("cpu"), pack, caches)
    cold = eval_stages(port, b, pack)
    again = eval_stages(port, b, pack)
    enc = [f"{k}_{s}" for k in ("obj", "rel") for s in ("sa1_xyz", "sa1", "sa2", "sa3")]
    assert list(fast) == list(cold) and set(fast) == {*enc, "gcn_in_obj", "gcn_in_rel", "gcn_out_obj",
                                                      "gcn_out_rel", "obj_head", "rel_head"}
    diff = {k: float((fast[k] - cold[k]).abs().max()) for k in fast}
    assert diff["obj_sa1_xyz"] == diff["rel_sa1_xyz"] == 0.0
    assert max(diff.values()) <= 1e-5, diff
    follows = {"obj_sa2": ("obj_sa1",), "rel_sa2": ("rel_sa1",), "obj_sa3": ("obj_sa2",), "rel_sa3": ("rel_sa2",),
               "gcn_out_obj": ("gcn_in_obj", "gcn_in_rel"), "gcn_out_rel": ("gcn_in_obj", "gcn_in_rel")}
    for stage, inputs in follows.items():
        if all(diff[i] == 0.0 for i in inputs):
            assert diff[stage] == 0.0, (stage, diff)
    assert all(torch.equal(again[k], cold[k]) for k in cold)


def test_serving_refuses_paired_packs_and_train(sgpn_run):
    port = sgpn_run[3]
    batch = make_scene_batch(1, seed=8, n_objects=4, ds=DatasetConfig(**DS), points_per_obj=150,
                             pair_shared=True)
    b = batch.to("cpu")
    with pytest.raises(ValueError, match="unpaired"):
        serving.build_sgpn_sa1_caches(port, b, SlotPack.build(batch, paired=True).to("cpu"))
    flat = SlotPack.build(batch).to("cpu")
    caches = serving.build_sgpn_sa1_caches(port, b, flat)
    with pytest.raises(ValueError, match="eval-only, unpaired packs"):
        port(b, flat, train=True, sa1_caches=caches)
    with pytest.raises(ValueError, match="eval-only, unpaired packs"):
        port(b, SlotPack.build(batch, paired=True).to("cpu"), sa1_caches=caches)


# -------------------------------------------------------------- evaluator

CFG = dataclasses.replace(TINY, model=dataclasses.replace(TINY.model, sa_npoints=SA_NPOINTS, sa_nsamples=SA_NSAMPLES),
                          dataset=DatasetConfig(**DS),
                          tpu=dataclasses.replace(TINY.tpu, scene_batch=2))


def _trainer(seed=0):
    return Trainer(CFG, DEFAULT_VOCAB, np.ones(12, np.float32), np.ones(15, np.float32), device="cpu", seed=seed)


def _batches(seeds=(8,)):
    """Two-scene batches with scan ids of their own (a persisted cache is
    keyed by scan id)."""
    return [SceneBatch.stack([make_scene_sample(10 * s + i, n_objects=4, ds=CFG.dataset, points_per_obj=150,
                                                scan_idx=10 * s + i) for i in range(2)]) for s in seeds]


@pytest.fixture(scope="module")
def evaluator_runs():
    tr = _trainer()
    batches = _batches((8, 9))
    return tr, batches, tr.evaluate(batches)


def test_evaluator_matches_trainer_evaluate(evaluator_runs):
    tr, batches, f1_cold = evaluator_runs
    ev = serving.ServingEvaluator(tr, batches, offload=False)
    assert not any(e[3] for e in ev.batches)
    assert abs(ev.evaluate() - f1_cold) < 1e-9
    for batch, _pack, _caches, _off, labels in ev.batches:  # 1-point stand-ins for the crops
        assert batch.obj_points.shape[2] == 1 and batch.rel_points.shape[2] == 1
        assert labels.obj_points.shape[2] == 1 and labels.rel_points.shape[2] == 1


@pytest.mark.parametrize("offload,budget", [(True, 4 << 30), ("auto", 1)])
def test_evaluator_offload(evaluator_runs, offload, budget):
    tr, batches, f1_cold = evaluator_runs
    ev = serving.ServingEvaluator(tr, batches, offload=offload, device_budget_bytes=budget)
    assert all(e[3] for e in ev.batches)  # every batch's cache in host memory
    assert all(e[2][0].grouped[0].device.type == "cpu" for e in ev.batches)
    assert abs(ev.evaluate() - f1_cold) < 1e-9


def test_evaluator_cache_dir_round_trip(evaluator_runs, tmp_path, monkeypatch):
    tr, batches, f1_cold = evaluator_runs
    f1_first = serving.ServingEvaluator(tr, batches, cache_dir=tmp_path).evaluate()
    assert len(sorted(tmp_path.glob("sa1_*.npz"))) == 2
    calls = []
    orig = serving.build_sgpn_sa1_caches
    monkeypatch.setattr(serving, "build_sgpn_sa1_caches", lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    f1_loaded = serving.ServingEvaluator(tr, batches, cache_dir=tmp_path).evaluate()
    assert calls == []  # loaded, never rebuilt
    assert f1_loaded == f1_first and abs(f1_first - f1_cold) < 1e-9


def test_cache_files_keep_bf16_bits_and_keys_discriminate(tmp_path):
    mags = torch.logspace(-30, 30, 300)  # many exponents, both signs, and zeros
    g = torch.cat([mags, -mags]).to(torch.bfloat16).reshape(1, 3, 25, 8)
    g[0, 0, 0] = 0.0
    c = serving.SA1Cache(new_xyz=torch.zeros(1, 3, 3), grouped=(g, g.float()), c0=6)
    serving._save_caches(tmp_path / "c.npz", (c, c))
    o, r = serving._load_caches(tmp_path / "c.npz")
    assert o.grouped[0].dtype == torch.bfloat16 and o.c0 == 6 and r.grouped[1].dtype == torch.float32
    assert torch.equal(o.grouped[0].view(torch.int16), g.view(torch.int16))
    assert torch.equal(r.grouped[1], g.float())

    model = _trainer().model
    b = _batches()[0]
    k = serving._cache_key(b, model)
    assert serving._cache_key(b, model) == k
    em = b.edge_mask.copy()
    em[0, 0] = ~em[0, 0]
    assert serving._cache_key(dataclasses.replace(b, edge_mask=em), model) != k
    om = b.obj_mask.copy()
    om[0, 0] = ~om[0, 0]
    assert serving._cache_key(dataclasses.replace(b, obj_mask=om), model) != k
    assert serving._cache_key(dataclasses.replace(b, scan_ids=("x",) + tuple(b.scan_ids[1:])), model) != k
    bf16 = SGPN(num_classes=12, num_relations=15, sa_npoints=SA_NPOINTS, sa_nsamples=SA_NSAMPLES,
                compute_dtype=torch.bfloat16, device="cpu")
    assert serving._cache_key(b, bf16) != k


def test_fit_serving_val_matches_cold_val():
    train_b, val_b = _batches((3,)), _batches((8,))

    def run(serving_val):
        tr = _trainer(seed=4)
        hist = tr.fit(train_b, val_batches=val_b, epochs=1, generator=torch.Generator().manual_seed(1),
                      log_every=0, serving_val=serving_val)
        return hist[-1]["val_macro_f1"]

    assert abs(run(True) - run(False)) < 1e-9
