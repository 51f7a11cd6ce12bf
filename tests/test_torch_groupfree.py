"""The port's Group-Free detector (``or4d_tpu_torch.models.groupfree``)
against the JAX package's on the CPU, in eval mode, from one set of flax
variables carried over by ``convert.groupfree_from_jax_variables``.

* ``three_nn`` / ``three_interpolate`` against ``or4d_tpu.ops`` (jitted, as
  the model runs them): indices and distances bit for bit, also where an
  unknown point coincides with a known one (there the expansion's rounding
  decides whether the distance is 0 or ~1e-3, and so the weights); values
  1e-6;
* each module (``SAVotes``, ``FPStage``, ``Backbone``, ``PositionEmbedding``,
  ``DecoderLayer``, ``PredictHead``) and the whole detector at the real
  config (128 proposals, 6 decoder layers, 20,000 -> 2048 ... 256 points
  replaced by N = 4096, B = 2) with random BN statistics: indices exact,
  outputs within 1e-4 of their largest;
* the SA stages' train-mode backward (SA1-SA4) against the JAX VJP on the
  same inputs and cotangent, 1e-3 of the largest gradient: in float64
  with the max over the slots routed as the port routes it, and in
  float32 where the two route alike (a max routed apart must be a tie
  within rounding);
* ``decode_boxes``, the NMS and the AP against the JAX functions;
* the decoder's attention dropout: live in train mode, drawn from the
  generator passed in, off at rate 0.

Trap guards, asserted on each test's own inputs: the JAX package's XLA
ball query (the |a|^2+|b|^2-2ab expansion) selects the same indices as the
port's direct difference at every SA level, the JAX FPS (XLA, contracted
FMAs) the same samples as the port's, and the gap between the 128th and
129th seed objectness logits is above twice the two sides' largest logit
difference, so that ``sample_inds`` must agree.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import or4d_tpu.models.layers as jlayers
from or4d_tpu import ops as jops
from or4d_tpu.models import groupfree as jgf
from or4d_tpu.ops.ball_query import ball_query as jax_ball_query
from or4d_tpu.ops.ball_query import pairwise_sqdist as jax_sqdist

from or4d_tpu_torch.convert import groupfree_from_jax_variables
from or4d_tpu_torch.models import groupfree as tgf
from or4d_tpu_torch.ops import interpolate as tint
from or4d_tpu_torch.ops.ball_query import ball_query
from or4d_tpu_torch.ops.fps import furthest_point_sample

TOL = 1e-4  # of the largest |value|
B, N = 2, 4096
SA_LEVELS = ((2048, 0.2, 64), (1024, 0.4, 32), (512, 0.8, 16), (256, 1.2, 16))


def scene(seed: int, B: int = B, N: int = N):
    """A room-sized random cloud (xyz in metres, centred colours) and mean
    sizes."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform([-2.5, 0.0, -2.5], [2.5, 2.0, 2.5], (B, N, 3))
    rgb = rng.uniform(-0.5, 0.5, (B, N, 3))
    msa = (np.abs(rng.standard_normal((4, 3))) * 0.5 + 0.3).astype(np.float32)
    return np.concatenate([xyz, rgb], -1).astype(np.float32), msa


def randomize_stats(variables: dict, seed: int) -> dict:
    """The variables as numpy with random BN running statistics (init's are
    0/1, which would hide a mean/var mix-up)."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)

    def walk(tree):
        for k, x in tree.items():
            if isinstance(x, dict):
                walk(x)
            elif k == "mean":
                tree[k] = (rng.standard_normal(x.shape) * 0.1).astype(np.float32)
            else:
                tree[k] = rng.uniform(0.5, 2.0, x.shape).astype(np.float32)

    walk(v["batch_stats"])
    return v


def close(got, want, what: str, tol: float = TOL) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    d = float(np.abs(got.astype(np.float64) - want).max())
    assert d <= tol * scale, f"{what}: max |diff| {d} of {scale}"


@pytest.fixture(scope="module")
def detector():
    """The JAX detector's jitted eval forward and variables, the port's
    model from the same variables, and the scene."""
    pc, msa = scene(0)
    jm = jgf.GroupFreeDetector()
    v = jax.jit(lambda k, x, m: jm.init(k, x, m, train=False))(jax.random.key(0), jnp.asarray(pc), jnp.asarray(msa))
    v = randomize_stats(v, 1)
    fwd = jax.jit(lambda v, x: jm.apply(v, x, jnp.asarray(msa), train=False))
    want = jax.tree_util.tree_map(np.asarray, fwd(v, jnp.asarray(pc)))
    tm = tgf.GroupFreeDetector(device="cpu")
    tm.load_state_dict(groupfree_from_jax_variables(v, tm))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(pc), torch.from_numpy(msa))
    return {"pc": pc, "msa": msa, "variables": v, "want": want, "got": got, "port": tm}


def sub(v: dict, *path) -> dict:
    """The variables of one submodule."""
    out = {}
    for col in ("params", "batch_stats"):
        node = v.get(col, {})
        for p in path:
            node = node.get(p, {})
        if node:
            out[col] = node
    return out



class SharedMLP64(jlayers.SharedMLP):
    """The JAX package's SharedMLP with its Dense layers in float64."""

    dtype: object = jnp.float64


@contextlib.contextmanager
def jax_float64():
    """The JAX package's Group-Free modules in float64: x64 on, ``SharedMLP``
    computing in float64, and the masked BN's float32 casts made float64
    (``or4d_tpu.models.layers``'s ``jnp`` rebound to a namespace whose
    ``float32`` is ``float64``), all restored on exit. The geometry stays
    float32 (``Backbone`` casts xyz itself; the stage tests pass float32
    xyz), so FPS, the ball queries and the 3-NN pick the float32 run's
    points."""
    f64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    f64.float32 = jnp.float64
    saved = jlayers.jnp, jgf.SharedMLP
    jlayers.jnp, jgf.SharedMLP = f64, SharedMLP64
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jlayers.jnp, jgf.SharedMLP = saved


def slot_routing(h) -> np.ndarray:
    """Where the cotangent of an SA stage's max over the slots goes, from
    the stage MLP's output h (B, M, ns, C), after its ReLU: split evenly
    over the slots equal to the max (PyTorch's ``amax`` and JAX's ``max``
    alike), nowhere where the max is 0."""
    h = np.asarray(h, np.float64)
    m = h.max(2, keepdims=True)
    tie = (h == m) & (m > 0)
    return tie / np.maximum(tie.sum(2, keepdims=True), 1)


def sa_interceptor(seen: dict, routes: dict | None = None):
    """A flax interceptor that records each SA stage's MLP output (before
    the max over the slots) in ``seen`` under the stage's name (None for a
    stage applied on its own). With ``routes`` ({name: slot_routing}) the
    max's cotangent follows that routing: the output becomes its
    stop-gradient plus (the routed sum over the slots minus its
    stop-gradient), which leaves every value as it was."""

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if context.method_name == "__call__" and isinstance(mod, jlayers.SharedMLP) and isinstance(
                mod.parent, jgf.SAVotes):
            seen[mod.parent.name] = out
            if routes is not None:
                routed = jnp.sum(jnp.asarray(routes[mod.parent.name], out.dtype) * out, axis=2, keepdims=True)
                out = jax.lax.stop_gradient(out) + (routed - jax.lax.stop_gradient(routed))
        return out

    return interceptor


def routing_margins(h64, route_a, route_b) -> list[float]:
    """For each slot max that two routings send differently, how far (of
    the largest |h64|) the float64 values of the slots either uses lie from
    the float64 max, or the max from 0 where either sends nothing: a
    difference made by rounding has a margin of a few float32 ulps."""
    h64 = np.asarray(h64, np.float64)
    scale = float(np.abs(h64).max())
    out = []
    for b, q, c in np.argwhere((route_a != route_b).any(2)):
        vals, ra, rb = h64[b, q, :, c], route_a[b, q, :, c], route_b[b, q, :, c]
        m = vals.max()
        margin = float((m - vals[(ra > 0) | (rb > 0)]).max())
        if not ra.any() or not rb.any():
            margin = max(margin, float(m))
        out.append(margin / scale)
    return out


def test_fps_and_ball_query_agree_with_the_jax_functions_at_every_sa_level(detector):
    """The trap guards of this file's scene: JAX's FPS (XLA) and ball query
    (the expansion) select what the port's do, level by level."""
    xyz = detector["pc"][..., :3]
    for npoint, radius, ns in SA_LEVELS:
        idx = furthest_point_sample(torch.from_numpy(np.ascontiguousarray(xyz)), npoint).numpy()
        np.testing.assert_array_equal(idx, np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), npoint)))
        new = np.take_along_axis(xyz, idx[..., None].astype(np.int64), 1)
        got = ball_query(radius, ns, torch.from_numpy(np.ascontiguousarray(xyz)), torch.from_numpy(new)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_ball_query(radius, ns, jnp.asarray(xyz), jnp.asarray(new))))
        xyz = new


def test_three_nn_and_interpolate_equal_the_jax_ops_at_coincident_points():
    rng = np.random.default_rng(3)
    unknown = rng.uniform(-2, 2, (2, 512, 3)).astype(np.float32)
    known = np.ascontiguousarray(unknown[:, ::2])  # every other unknown point is a known one
    feats = rng.standard_normal((2, 256, 16)).astype(np.float32)
    d2 = tint.pairwise_sqdist(torch.from_numpy(unknown), torch.from_numpy(known)).numpy()
    np.testing.assert_array_equal(d2, np.asarray(jax.jit(jax_sqdist)(unknown, known)))
    dist, idx = tint.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    jdist, jidx = jax.jit(jops.three_nn)(unknown, known)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    # coincident points: XLA's fused chains round |a|^2 and a.a alike, so
    # the distance is exactly 0 (weight ~1 on the point itself); the same
    # expansion with PyTorch's sums and batched product leaves noise up to
    # ~1.4e-3 at ~11% of them, which moves the weights by up to ~1%
    assert not dist.numpy()[:, ::2, 0].any() and not np.asarray(jdist)[:, ::2, 0].any()
    u, kn = torch.from_numpy(unknown), torch.from_numpy(known)
    naive = ((u * u).sum(-1)[:, :, None] + (kn * kn).sum(-1)[:, None, :]) - 2 * torch.bmm(u, kn.transpose(1, 2))
    assert naive[:, ::2].diagonal(dim1=1, dim2=2).clamp_min(0).sqrt().max() > 1e-4
    w = rng.uniform(0.1, 1.0, (2, 512, 3)).astype(np.float32)
    got = tint.three_interpolate(torch.from_numpy(feats), idx, torch.from_numpy(w)).numpy()
    want = np.asarray(jax.jit(jops.three_interpolate)(np.swapaxes(feats, 1, 2), jidx, w)).swapaxes(1, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ties_go_to_the_lowest_index():
    d = torch.tensor([[[1.0, 0.5, 0.5, 0.5, 2.0]]])
    _, idx = tint.three_nn(torch.zeros(1, 1, 3), torch.tensor([[[1.0, 0, 0], [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5],
                                                               [2.0, 0, 0]]]))
    assert idx.tolist() == [[[1, 2, 3]]]
    assert tgf.topk_stable(-d, 4).tolist() == [[[1, 2, 3, 0]]]
    _, jidx = jax.lax.top_k(-jnp.asarray(d.numpy()), 4)
    assert np.asarray(jidx).tolist() == [[[1, 2, 3, 0]]]


def test_sa_and_fp_stages_equal_the_jax_modules(detector):
    pc, v, tm = detector["pc"], detector["variables"], detector["port"]
    xyz, feats = pc[..., :3], pc[..., 3:]
    outs = {}
    for i, (npoint, radius, ns) in enumerate(SA_LEVELS, 1):
        width = (64, 64, 128) if i == 1 else (128, 128, 256)
        jmod = jgf.SAVotes(npoint, radius, ns, width)
        jx, jf, jidx = jax.jit(lambda v, a, b: jmod.apply(v, a, b, train=False))(
            sub(v, "backbone", f"sa{i}"), xyz, feats)
        with torch.no_grad():
            tx, tf, tidx = getattr(tm.backbone, f"sa{i}")(torch.from_numpy(np.ascontiguousarray(xyz)),
                                                          torch.from_numpy(np.ascontiguousarray(feats)))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        close(tf, jf, f"sa{i} features")
        xyz, feats = np.asarray(jx), np.asarray(jf)
        outs[i] = (xyz, feats)
    for name, (lo, hi), mlp in (("fp1", (3, 4), (256, 256)), ("fp2", (2, 3), (256, 288))):
        jmod = jgf.FPStage(mlp)
        args = (outs[lo][0], outs[hi][0], outs[lo][1], outs[hi][1])
        want = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(sub(v, "backbone", name), *args)
        with torch.no_grad():
            got = getattr(tm.backbone, name)(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args])
        close(got, want, name)


TIE_MARGIN = 1e-6  # of the largest |value|: a slot max decided by rounding


@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_sa_stage_train_gradients_equal_the_jax_vjp(detector, level):
    """The SA stages' backward (train-mode BN, the max over the slots) on
    the same inputs and cotangent as the JAX package's:

    * JAX's VJP in float64 with the max's cotangent routed as the port
      routes it (``slot_routing`` of the port's own values): every
      parameter gradient 1e-3 of the largest, and at SA2-SA4 the feature
      gradient (the previous stage's output cotangent) 1e-3 of its
      largest;
    * JAX's VJP in float32 (jitted, as its trainer runs): each slot max
      that it routes apart from the port is a tie within rounding (the
      float64 values concerned within TIE_MARGIN of one another or of 0);
      where the routings are the same, every gradient 1e-3 of the largest.
      At SA4 on this input one max has two slots that JAX's float32 rounds
      equal and the port's one ulp apart; JAX splits that cotangent, the
      port sends it to one slot, and dense_2's gradients differ by 2.7e-3
      of the largest, while the float64 VJP routed as the port routes is
      within 1e-6."""
    from or4d_tpu_torch.convert import from_jax_variables
    from tests.test_torch_groupfree_loss import ParamsOnly

    pc = detector["pc"]
    npoint, radius, ns = SA_LEVELS[level - 1]
    width = (64, 64, 128) if level == 1 else (128, 128, 256)
    rng = np.random.default_rng(10 + level)
    xyz = np.ascontiguousarray(pc[..., :3])
    feats = np.ascontiguousarray(pc[..., 3:])
    if level > 1:  # the earlier stages' centroids stand in, with random features of their width
        for m, _r, _ns in SA_LEVELS[:level - 1]:
            idx = furthest_point_sample(torch.from_numpy(np.ascontiguousarray(xyz)), m).numpy()
            xyz = np.ascontiguousarray(np.take_along_axis(xyz, idx[..., None].astype(np.int64), 1))
        feats = rng.standard_normal((B, SA_LEVELS[level - 2][0], 128 if level == 2 else 256)).astype(np.float32)
    jmod = jgf.SAVotes(npoint, radius, ns, width)
    v = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.key(level), xyz, feats, train=False))
    ct = rng.standard_normal((B, npoint, width[-1])).astype(np.float32)

    tm = tgf.SAVotes(npoint, radius, ns, feats.shape[-1], width, device="cpu")
    tm.load_state_dict(from_jax_variables(v, tm))
    port_h = {}
    tm.mlp.register_forward_hook(lambda _m, _a, out: port_h.update({None: out.detach().numpy()}))
    f = torch.from_numpy(feats).requires_grad_(True)
    _x, h, _i = tm(torch.from_numpy(xyz), f, train=True)
    (h * torch.from_numpy(ct)).sum().backward()
    routes = {None: slot_routing(port_h[None])}

    def vjp(dtype, routed):
        def loss(params, f):
            seen = {}
            with nn.intercept_methods(sa_interceptor(seen, routes if routed else None)):
                (_x, h, _i), _ = jmod.apply({"params": params, "batch_stats": cast(v["batch_stats"])}, xyz, f,
                                            train=True, mutable=["batch_stats"])
            return jnp.sum(h * jnp.asarray(ct, dtype)), seen[None]

        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)
        (gp, gf), mlp_out = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(cast(v["params"]),
                                                                                   jnp.asarray(feats, dtype))
        grads = from_jax_variables({"params": jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), gp)},
                                   ParamsOnly(tm))
        return grads, np.asarray(gf, np.float64), np.asarray(mlp_out)

    def worst(want):
        scale = max(float(w.abs().max()) for w in want.values())
        return max(float((p.grad.double() - want[name]).abs().max()) for name, p in tm.named_parameters()) / scale

    with jax_float64():
        g64, f64, h64 = vjp(jnp.float64, True)
    assert worst(g64) <= 1e-3, (level, worst(g64))
    if level > 1:  # the previous stage's output cotangent (SA1's own inputs are the data)
        close(f.grad, f64, f"sa{level} feature gradient", 1e-3)
    g32, f32, h32 = vjp(jnp.float32, False)
    margins = routing_margins(h64, slot_routing(h32), routes[None])
    assert all(m <= TIE_MARGIN for m in margins), (level, margins)
    if not margins:
        assert worst(g32) <= 1e-3, (level, worst(g32))
        if level > 1:
            close(f.grad, f32, f"sa{level} feature gradient (float32)", 1e-3)


def test_backbone_equals_the_jax_module(detector):
    pc, v, tm = detector["pc"], detector["variables"], detector["port"]
    jx, jf, jinds = jax.jit(lambda v, x: jgf.Backbone().apply(v, x, train=False))(sub(v, "backbone"), pc)
    with torch.no_grad():
        tx, tf, tinds = tm.backbone(torch.from_numpy(pc))
    np.testing.assert_array_equal(tinds.numpy(), np.asarray(jinds))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    close(tf, jf, "seed features")


def test_position_embedding_decoder_layer_and_predict_head_equal_the_jax_modules(detector):
    v, tm, msa = detector["variables"], detector["port"], detector["msa"]
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, 128, 288)).astype(np.float32)
    k = rng.standard_normal((B, 1024, 288)).astype(np.float32)
    qxyz = rng.uniform(-2, 2, (B, 128, 3)).astype(np.float32)
    kxyz = rng.uniform(-2, 2, (B, 1024, 3)).astype(np.float32)
    T = lambda a: torch.from_numpy(a)
    want = jax.jit(lambda v, x: jgf.PositionEmbedding().apply(v, x, train=False))(sub(v, "self_pos_2"), qxyz)
    with torch.no_grad():
        close(tm.self_pos_2(T(qxyz)), want, "position embedding")
        qpos, kpos = tm.self_pos_2(T(qxyz)).numpy(), tm.cross_pos_2(T(kxyz)).numpy()
    want = jax.jit(lambda v, *a: jgf.DecoderLayer().apply(v, *a, train=False))(sub(v, "decoder_3"), q, qpos, k, kpos)
    with torch.no_grad():
        close(tm.decoder_3(T(q), T(qpos), T(k), T(kpos)), want, "decoder layer")
    want = jax.jit(lambda v, f, b: jgf.PredictHead().apply(v, f, b, jnp.asarray(msa), train=False))(
        sub(v, "head_5"), q, qxyz)
    with torch.no_grad():
        got = tm.head_5(T(q), T(qxyz), T(msa))
    for key, w in want.items():
        close(got[key], w, f"head {key}")


def test_detector_equals_the_jax_detector(detector):
    want, got = detector["want"], detector["got"]
    np.testing.assert_array_equal(got["seed_inds"].numpy(), want["seed_inds"])
    np.testing.assert_array_equal(got["seed_xyz"].numpy(), want["seed_xyz"])
    logits = want["seeds_obj_cls_logits"]
    close(got["seeds_obj_cls_logits"], logits, "seed objectness")
    d_logits = float(np.abs(got["seeds_obj_cls_logits"].numpy() - logits).max())
    ranked = -np.sort(-logits, axis=1)
    gap = float((ranked[:, 127] - ranked[:, 128]).min())
    assert gap > 2 * d_logits, f"rank-128 gap {gap} within twice the logit difference {d_logits}: not this input"
    np.testing.assert_array_equal(got["sample_inds"].numpy(), want["sample_inds"])
    heads = [("proposal", got["proposal"], want["proposal"])] + [
        (f"layer {i}", g, w) for i, (g, w) in enumerate(zip(got["layers"], want["layers"]))]
    assert len(heads) == 7
    for name, g, w in heads:
        for key in w:
            close(g[key], w[key], f"{name} {key}")


def test_decode_nms_and_ap_equal_the_jax_functions(detector):
    want, got, msa = detector["want"], detector["got"], detector["msa"]
    jdec = [np.asarray(x) for x in jgf.decode_boxes(want["last"], msa)]
    # decode the JAX head outputs on both sides, then compare
    tdec = tgf.decode_boxes({k: torch.from_numpy(np.asarray(x)) for k, x in want["last"].items()}, msa)
    for name, a, b in zip(("center", "size", "heading", "class", "score"), tdec, jdec):
        if name == "class":
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6, err_msg=name)
    for (a, b) in zip(tgf.decode_boxes(got["last"], msa)[3:4], jdec[3:4]):
        np.testing.assert_array_equal(a.numpy(), b)
    center, size, heading, cls, score = (x[0] for x in jdec)
    for thr in (0.05, 0.25, 0.5):
        np.testing.assert_array_equal(
            tgf.nms_3d_samecls(center, size, score, headings=heading, classes=cls, iou_threshold=thr),
            jgf.nms_3d_samecls(center, size, score, headings=heading, classes=cls, iou_threshold=thr))
    rng = np.random.default_rng(6)
    gt, pred = {}, {}
    for s in range(3):
        gt[s] = [(int(rng.integers(4)), rng.uniform(-2, 2, 3), rng.uniform(0.3, 1.5, 3), float(rng.uniform(-3, 3)))
                 for _ in range(4)]
        pred[s] = [(c, ce + rng.normal(scale=0.1, size=3), sz * rng.uniform(0.8, 1.2, 3), h + rng.normal(scale=0.2),
                    float(rng.uniform())) for c, ce, sz, h in gt[s]]
        pred[s] += [(int(rng.integers(4)), rng.uniform(-2, 2, 3), rng.uniform(0.3, 1.5, 3), 0.0, float(rng.uniform()))
                    for _ in range(3)]
    for thr in (0.25, 0.5):
        assert tgf.eval_average_precision(pred, gt, thr) == jgf.eval_average_precision(pred, gt, thr)


def test_attention_dropout_is_live_in_train_mode_and_drawn_from_the_generator():
    torch.manual_seed(0)
    layer = tgf.DecoderLayer(device="cpu", generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(7)
    q, qp = (torch.from_numpy(rng.standard_normal((2, 16, 288)).astype(np.float32)) for _ in range(2))
    k, kp = (torch.from_numpy(rng.standard_normal((2, 40, 288)).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        ev = layer(q, qp, k, kp, train=False)
        a = layer(q, qp, k, kp, train=True, generator=torch.Generator().manual_seed(5))
        b = layer(q, qp, k, kp, train=True, generator=torch.Generator().manual_seed(5))
        c = layer(q, qp, k, kp, train=True, generator=torch.Generator().manual_seed(6))
        layer.self_attn.rate = layer.cross_attn.rate = 0.0
        off = layer(q, qp, k, kp, train=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.allclose(a, ev, atol=1e-3)
    assert torch.equal(off, ev)
