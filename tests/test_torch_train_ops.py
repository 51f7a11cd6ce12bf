"""Train-path grouping of the port vs the JAX package: TPU kernel rows 6
(``ball_query_group_pallas``) and 5 (``ball_query_group_pallas_gated_raw``),
forward and backward, and the SA train modules against the JAX module on
its TPU-default ``train_kernel`` path and on its ``train_raw=False`` path
(row 9; the row itself is tested in ``test_torch_train_gated.py``).

The same numpy inputs and cotangents go through ``jax.vjp`` of the Pallas
kernels in interpret mode and through the port's autograd Functions on CPU
tensors (their plain versions). Forwards must agree exactly. Backward
tolerances: dA to 1e-5 in float32 (summation order), dW0 to 1e-4 relative
in float32 (a sum over every slot), and in bfloat16 one bf16 ulp (the f32
sums round to bf16 once). SA modules to 1e-4 in float32 (BN statistics
reassociate).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from or4d_tpu.models.pointnet2 import SAScale as JSAScale, SetAbstractionMSG as JSA
from or4d_tpu.ops.pallas_ball_query import (
    _counts_to_bounds,
    ball_query_group_pallas,
    ball_query_group_pallas_gated_raw,
)
from or4d_tpu.ops.pallas_fps import furthest_point_sample_with_counts
from tests.test_torch_models import randomize

from or4d_tpu_torch.convert import from_jax_variables
from or4d_tpu_torch.ops import launch_counts, reset_launch_counts
from or4d_tpu_torch.ops.ball_query_group import ball_query_group, group_fwd
from or4d_tpu_torch.ops.ball_query_group_raw import ball_query_group_raw
from or4d_tpu_torch.ops.sa_group_mlp import counts_to_bounds
from or4d_tpu_torch.models.pointnet2 import SAScale, SetAbstractionMSG

SCALES = ((0.15, 4), (0.3, 8))
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_bwd_close(got, want, dtype, rel):
    """float32: |diff| <= rel * max|want|; bfloat16: one bf16 ulp of each
    value (2^-7 relative) plus rel * max|want|."""
    scale = float(np.abs(want).max())
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rel * scale)


def _cloud(rng, B, N):
    return (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row6_forward_and_backward_match_pallas_vjp(dtype):
    rng = np.random.default_rng(0)
    B, N, M, C = 3, 300, 64, 16
    xyz = _cloud(rng, B, N)
    q = xyz[:, :M].copy()
    q[0, 3] = 50.0  # no hit: zero rows and no gradient on both sides
    A = rng.standard_normal((B, N, C)).astype(np.float32)
    feats = tuple(jnp.asarray(A).astype(JDT[dtype]) for _ in SCALES)
    outs, vjp = jax.vjp(lambda f: ball_query_group_pallas(SCALES, jnp.asarray(xyz), jnp.asarray(q), f, True), feats)
    gs = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    dAs = vjp(tuple(jnp.asarray(g).astype(JDT[dtype]) for g in gs))[0]
    reset_launch_counts()
    for s, (r, ns) in enumerate(SCALES):
        At = torch.from_numpy(A).to(TDT[dtype]).requires_grad_(True)
        out = ball_query_group(torch.from_numpy(xyz), torch.from_numpy(q), r, ns, At)
        assert out.shape == (B, M, ns, C) and out.dtype == TDT[dtype]
        out.backward(torch.from_numpy(gs[s]).to(TDT[dtype]))
        np.testing.assert_array_equal(out.detach().float().numpy(), _f32(outs[s]))
        assert not out[0, 3].any() and At.grad.dtype == TDT[dtype]
        _assert_bwd_close(At.grad.float().numpy(), _f32(dAs[s]), dtype, 1e-5)
    assert all(v == 0 for v in launch_counts().values())  # plain versions on the CPU


def test_row6_indices_fill_and_no_hit():
    rng = np.random.default_rng(1)
    xyz = torch.from_numpy(_cloud(rng, 2, 200))
    q = xyz[:, :16].clone()
    q[1, 2] = 9.0
    A = torch.from_numpy(rng.standard_normal((2, 200, 8)).astype(np.float32))
    out, idx = group_fwd(xyz, q, 0.2, 32, A)
    assert idx.dtype == torch.int32 and (idx[1, 2] == -1).all()
    first = idx[..., :1].expand_as(idx)
    hit = idx >= 0
    # slots past the last hit repeat the first hit
    real = (torch.arange(32) == 0) | (idx != first)
    assert ((real.int().diff(dim=-1) <= 0) | ~hit[..., 1:]).all()
    torch.testing.assert_close(out[hit], A[torch.arange(2)[:, None, None].expand_as(idx)[hit], idx[hit].long()],
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row5_forward_and_dw0_match_pallas_vjp(dtype):
    """N = 1024 (two chunks) with the bounds from the FPS counts; the JAX
    output is slot-major (B, ns, M, C) and is transposed here."""
    rng = np.random.default_rng(2)
    B, N, M, C0 = 1, 1024, 64, 6
    xyz = _cloud(rng, B, N)
    idx, counts = furthest_point_sample_with_counts(jnp.asarray(xyz), M, tuple(r for r, _ in SCALES), True)
    q = np.take_along_axis(xyz, np.asarray(idx)[..., None].astype(np.int64), 1)
    bounds = _counts_to_bounds(SCALES, tuple(counts))
    needs = counts_to_bounds(SCALES, tuple(torch.from_numpy(np.array(c)) for c in counts))
    raw = rng.standard_normal((B, C0, N)).astype(np.float32)
    w0s = [(rng.standard_normal((C0, c)) / np.sqrt(C0)).astype(np.float32) for c in (16, 24)]
    jw = tuple(jnp.asarray(w).astype(JDT[dtype]) for w in w0s)
    outs, vjp = jax.vjp(
        lambda ws, rw, x, nx: ball_query_group_pallas_gated_raw(SCALES, x, nx, ws, rw, bounds, True, False),
        jw, jnp.asarray(raw).astype(JDT[dtype]), jnp.asarray(xyz), jnp.asarray(q))
    gs = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    dws, draw, dxyz, dq = vjp(tuple(jnp.asarray(g).astype(JDT[dtype]) for g in gs))
    assert not np.any(_f32(draw)) and not np.any(np.asarray(dxyz)) and not np.any(np.asarray(dq))
    traw = torch.from_numpy(raw).to(TDT[dtype])
    for s, (r, ns) in enumerate(SCALES):
        W = torch.from_numpy(w0s[s]).to(TDT[dtype]).requires_grad_(True)
        xt, qt = torch.from_numpy(xyz), torch.from_numpy(q)
        out = ball_query_group_raw(xt, qt, r, ns, W, traw, needs[s][0].int())
        out.backward(torch.from_numpy(np.ascontiguousarray(gs[s].transpose(0, 2, 1, 3))).to(TDT[dtype]))
        np.testing.assert_array_equal(out.detach().float().numpy(), _f32(outs[s]).transpose(0, 2, 1, 3))
        assert W.grad.dtype == TDT[dtype] and traw.grad is None and xt.grad is None and qt.grad is None
        _assert_bwd_close(W.grad.float().numpy(), _f32(dws[s]), dtype, 1e-4)


def test_row5_rejects_raw_that_requires_grad_and_bad_inputs():
    rng = np.random.default_rng(3)
    xyz = torch.from_numpy(_cloud(rng, 1, 600))
    q = xyz[:, :8].contiguous()
    W = torch.randn(6, 16)
    raw = torch.randn(1, 6, 600)
    with pytest.raises(ValueError, match="model inputs"):
        ball_query_group_raw(xyz, q, 0.2, 4, W, raw.requires_grad_(True))
    with pytest.raises(ValueError):  # raw and W0 in different dtypes
        ball_query_group_raw(xyz, q, 0.2, 4, W, raw.detach().bfloat16())
    with pytest.raises(ValueError):  # raw not channel-major
        ball_query_group_raw(xyz, q, 0.2, 4, W, raw.detach().transpose(1, 2).contiguous())
    with pytest.raises(ValueError):  # non-contiguous plane
        ball_query_group(xyz, q, 0.2, 4, torch.randn(1, 16, 600).transpose(1, 2))


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("case", ["sa1_raw_row5", "sa2_plane_row6", "sa1_plane_row9"])
def test_sa_train_module_matches_tpu_default_path(case):
    """The JAX module with the TPU defaults (raw mode, slot-pair packing,
    per-scale sorted gated kernels; interpret mode) against the port's SA
    train forward: output, every parameter's gradient (and, for SA2 and on
    the ``train_raw=False`` path, the features' gradient) and the updated
    running statistics, with a row mask that marks one cloud invalid."""
    rng = np.random.default_rng(4)
    train_raw = case != "sa1_plane_row9"
    features_grad = case != "sa1_raw_row5"
    if case.startswith("sa1"):
        B, N, C, npoint = 3, 600, 3, 32
        jscales = (JSAScale(0.15, 4, (16, 16)), JSAScale(0.3, 8, (16, 24)))
    else:
        B, N, C, npoint = 3, 256, 12, 32
        jscales = (JSAScale(0.3, 8, (16, 16)), JSAScale(0.5, 12, (16, 24)))
    xyz = _cloud(rng, B, N)
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    mod = JSA(npoint=npoint, scales=jscales, fused_mode="train_kernel", kernel_interpret=True, train_raw=train_raw,
              packed_slots=True, train_per_scale_sort=True)
    v = randomize(jax.eval_shape(lambda: mod.init(jax.random.key(0), jnp.asarray(xyz), jnp.asarray(feats),
                                                  train=False)), 11)
    width = sum(s.mlp[-1] for s in jscales)
    proj = rng.standard_normal((B, npoint, width)).astype(np.float32)

    def jloss(params, f):
        (nx, out), mut = mod.apply({**v, "params": params}, jnp.asarray(xyz), f, mask=jnp.asarray(mask), train=True,
                                   mutable=["batch_stats"])
        return jnp.sum(out * proj), (nx, out, mut["batch_stats"])

    (_, (jnx, jout, jstats)), (jgp, jgf) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(feats))

    port = SetAbstractionMSG(C + 3, npoint, tuple(SAScale(s.radius, s.nsample, s.mlp) for s in jscales),
                             train_raw=train_raw)
    port.load_state_dict(from_jax_variables(v, port))
    tf = torch.from_numpy(feats).requires_grad_(features_grad)
    reset_launch_counts()
    nx, out = port(torch.from_numpy(xyz), tf, mask=torch.from_numpy(mask), train=True)
    (out * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_array_equal(nx.numpy(), np.asarray(jnx))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    # the JAX gradients and updated statistics under the port's names
    want = from_jax_variables({"params": _to_numpy(jgp), "batch_stats": _to_numpy(jstats)}, port)
    for k, p in port.named_parameters():
        assert p.grad is not None, k
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
    for k, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
    if features_grad:
        assert np.abs(np.asarray(jgf)).max() > 0
        np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf), rtol=1e-4, atol=1e-4)
    assert all(v == 0 for v in launch_counts().values())
