"""Port modules vs the JAX package's flax modules on the same numpy inputs,
with the JAX variables carried over by ``or4d_tpu_torch.convert``.

Masked batch norm (running and masked batch statistics), the GCN MLP, the
TripletGCN, the heads, a fused eval SA stage (against the JAX module on its
``eval_kernel`` path with the Pallas kernels in interpret mode) and the
PointNet++ encoder, unpaired and paired. Float32 throughout; tolerances are
float reassociation (the port sums in another order).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from or4d_tpu.models import heads as jheads
from or4d_tpu.models.layers import MLP as JMLP, MaskedBatchNorm as JBN
from or4d_tpu.models.pointnet2 import PointNet2MSGEncoder as JEncoder, SAScale as JSAScale
from or4d_tpu.models.pointnet2 import SetAbstractionMSG as JSA
from or4d_tpu.models.triplet_gcn import TripletGCN as JGCN

from or4d_tpu_torch.convert import from_jax_variables
from or4d_tpu_torch.models import heads as theads
from or4d_tpu_torch.models.layers import MLP, MaskedBatchNorm
from or4d_tpu_torch.models.pointnet2 import PointNet2MSGEncoder, SAScale, SetAbstractionMSG
from or4d_tpu_torch.models.triplet_gcn import TripletGCN


def randomize(variables, seed=0):
    """Random values for every leaf, so BN affines and running statistics
    are not the identity: kernels ~ N(0, 1/fan_in), scales and variances in
    [0.5, 1.5], biases and means ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(x)
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.standard_normal(shape) * 0.1
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def load(module, variables):
    module.load_state_dict(from_jax_variables(variables, module))
    return module.requires_grad_(False)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


class TestLayers:
    def test_batchnorm_running_stats(self):
        x = np.random.default_rng(0).standard_normal((3, 5, 16)).astype(np.float32)
        bn = JBN(16)
        v = randomize(jax.eval_shape(lambda: bn.init(jax.random.key(0), jnp.asarray(x), train=False)), 1)
        want = bn.apply(v, jnp.asarray(x), train=False)
        got = load(MaskedBatchNorm(16), v)(t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_batchnorm_masked_batch_stats(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((3, 7, 16)).astype(np.float32) * 3.0
        mask = rng.uniform(size=(3, 7)) > 0.4
        bn = JBN(16, track_running_stats=False)
        v = randomize(jax.eval_shape(lambda: bn.init(jax.random.key(0), jnp.asarray(x), train=False)), 2)
        want = bn.apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=False)
        got = load(MaskedBatchNorm(16, track_running_stats=False), v)(t(x), t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("on_last", [False, True])
    def test_mlp(self, on_last):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 9, 24)).astype(np.float32)
        mask = rng.uniform(size=(2, 9)) > 0.3
        mlp = JMLP((32, 20), on_last=on_last)
        v = randomize(jax.eval_shape(lambda: mlp.init(jax.random.key(0), jnp.asarray(x), train=False)), 3)
        want = mlp.apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=False)
        got = load(MLP(24, (32, 20), on_last=on_last), v)(t(x), t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


class TestGCNAndHeads:
    def test_triplet_gcn(self):
        rng = np.random.default_rng(4)
        S, O, E, D, H = 2, 5, 20, 16, 24
        x = rng.standard_normal((S, O, D)).astype(np.float32)
        ef = rng.standard_normal((S, E, D)).astype(np.float32)
        ei = rng.integers(0, O, (S, E, 2)).astype(np.int32)
        om = rng.uniform(size=(S, O)) > 0.2
        em = rng.uniform(size=(S, E)) > 0.3
        gcn = JGCN(num_layers=2, dim_node=D, dim_edge=D, dim_hidden=H)
        args = tuple(jnp.asarray(a) for a in (x, ef, ei, om, em))
        v = randomize(jax.eval_shape(lambda: gcn.init(jax.random.key(0), *args, train=False)), 5)
        wx, we = gcn.apply(v, *args, train=False)
        gx, ge = load(TripletGCN(2, D, D, H), v)(t(x), t(ef), t(ei), t(om), t(em))
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(ge.numpy(), np.asarray(we), rtol=2e-4, atol=2e-4)

    def test_heads(self):
        rng = np.random.default_rng(6)
        x = rng.standard_normal((2, 7, 32)).astype(np.float32)
        onehot = (rng.uniform(size=(2, 7, 12)) > 0.8).astype(np.float32)
        oh = jheads.ObjectClsHead(12)
        v = randomize(jax.eval_shape(lambda: oh.init(jax.random.key(0), jnp.asarray(x), train=False)), 7)
        got = load(theads.ObjectClsHead(32, 12), v)(t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(oh.apply(v, jnp.asarray(x), train=False)),
                                   rtol=1e-5, atol=1e-5)
        rh = jheads.RelationClsHead(15)
        v = randomize(jax.eval_shape(lambda: rh.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(onehot),
                                                     train=False)), 8)
        want = rh.apply(v, jnp.asarray(x), jnp.asarray(onehot), train=False)
        got = load(theads.RelationClsHead(32, 15), v)(t(x), t(onehot))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


class TestPointNet2:
    def test_set_abstraction_msg_eval_kernel(self):
        """N > 512: the JAX module runs FPS-with-counts and the v4 raw-mode
        kernel (interpret mode); the port its plain versions."""
        rng = np.random.default_rng(41)
        B, N = 2, 1100
        pc = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
        feats = rng.standard_normal((B, N, 5)).astype(np.float32)
        jscales = (JSAScale(0.15, 4, (16, 24)), JSAScale(0.3, 6, (16, 16)))
        mod = JSA(npoint=128, scales=jscales, fused_mode="eval_kernel", kernel_interpret=True, eval_subtile=32)
        v = randomize(jax.eval_shape(lambda: mod.init(jax.random.key(0), jnp.asarray(pc), jnp.asarray(feats),
                                                      train=False)), 9)
        want_xyz, want = mod.apply(v, jnp.asarray(pc), jnp.asarray(feats), train=False)
        port = load(SetAbstractionMSG(8, 128, (SAScale(0.15, 4, (16, 24)), SAScale(0.3, 6, (16, 16)))), v)
        got_xyz, got = port(t(pc), t(feats))
        np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("paired", [False, True])
    def test_encoder(self, paired, dtype):
        """The encoder against the JAX kernel path (kwargs of
        test_paired_rel.py:129, N > 512 so SA1 reaches the v4 kernel). In
        bfloat16 both sides round at the same points; the tolerance is one
        bf16 ulp at these magnitudes (about 1)."""
        B, N = 2, 600
        rng = np.random.default_rng(6)
        xyz = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
        rgb = rng.uniform(0, 1, (B, N, 3)).astype(np.float32)
        mask_f = rng.integers(0, 3, (B, N, 1)).astype(np.float32)
        mask_r = np.where(mask_f > 0, 3.0 - mask_f, 0.0).astype(np.float32)
        pc = np.concatenate([xyz, rgb, mask_f, mask_r], -1) if paired else np.concatenate([xyz, rgb], -1)
        dim = 7 if paired else 6
        kw = dict(input_dim=dim, out_size=32, sa_npoints=(64, 16), sa_nsamples=((4, 8), (8, 8)))
        bf16 = dtype == "bfloat16"
        enc = JEncoder(fused_mode="eval_kernel", kernel_interpret=True,
                       dtype=jnp.bfloat16 if bf16 else jnp.float32, **kw)
        v = randomize(jax.eval_shape(lambda: enc.init(jax.random.key(0), jnp.asarray(pc[..., :dim]), train=False)), 10)
        want = enc.apply(v, jnp.asarray(pc), train=False, paired=paired).astype(jnp.float32)
        port = load(PointNet2MSGEncoder(dim, 32, sa_npoints=(64, 16), sa_nsamples=((4, 8), (8, 8)),
                                        dtype=torch.bfloat16 if bf16 else torch.float32), v)
        got = port(t(pc), paired=paired)
        assert got.shape == ((2 * B if paired else B), 32)
        assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
        tol = 2e-2 if bf16 else 1e-4
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want), rtol=tol, atol=tol)
