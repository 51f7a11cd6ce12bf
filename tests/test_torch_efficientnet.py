"""The port's image branch (``models/efficientnet.py``) against the JAX
package's flax modules, on the CPU, at full B5 width (stem 48, head 2048,
39 blocks): the trunk on 2 images of 64 x 64 and of 57 x 57 (odd sides:
flax "SAME" pads the extra pixel after, at every stride-2 convolution),
``ImageBranch`` on one scene's 6 cameras, "SAME" padding and the frozen
BN's eps on their own, the timm key map against the JAX package's
importer, and the frozen-parameter mask against ``sgpn_trainable_labels``.

Weights come from the JAX side (flax init, batch statistics drawn at
random) through ``convert.from_jax_variables``. Tolerance: 2e-5 of the
largest output (float32 through 39 blocks; measured ~1e-6).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from or4d_tpu.config import TINY as J_TINY
from or4d_tpu.data.synthetic import make_scene_batch as j_make_scene_batch
from or4d_tpu.models import efficientnet as jeff
from or4d_tpu.models.sgpn import SGPN as JSGPN

from or4d_tpu_torch.config import TINY
from or4d_tpu_torch.convert import from_jax_variables
from or4d_tpu_torch.models import efficientnet as eff
from or4d_tpu_torch.models.sgpn import SGPN
from or4d_tpu_torch.utils.torch_import import export_reference_state_dict, import_reference_state_dict

TOL = 2e-5


def _stats(variables, seed):
    """The flax variables with random BN statistics (means N(0, 0.1),
    variances in [0.5, 1.5]) and BN affines away from the identity."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32)
        if name in ("mean", "bias"):
            return (rng.standard_normal(np.shape(x)) * 0.1).astype(np.float32)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


@pytest.fixture(scope="module")
def branch():
    x = np.random.default_rng(0).standard_normal((1, 6, 64, 64, 3)).astype(np.float32)
    jm = jeff.ImageBranch()
    v = _stats(jm.init(jax.random.key(0), jnp.asarray(x)), 1)
    pm = eff.ImageBranch(device="cpu")
    pm.load_state_dict(from_jax_variables(v, pm))
    return jm, v, pm, x


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * float(np.abs(want).max()))


def test_image_branch_equals_jax(branch):
    jm, v, pm, x = branch
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 768)
    _close(got, want)


@pytest.mark.parametrize("side", [64, 57])
def test_trunk_equals_jax_on_even_and_odd_sides(branch, side):
    _jm, v, pm, _x = branch
    x = np.random.default_rng(side).standard_normal((2, side, side, 3)).astype(np.float32)
    tv = {"params": v["params"]["trunk"], "batch_stats": v["batch_stats"]["trunk"]}
    want = np.asarray(jeff.EfficientNetB5().apply(tv, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.trunk(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 2048)
    _close(got, want)


@pytest.mark.parametrize("n,k,s", [(16, 3, 2), (15, 3, 2), (16, 5, 2), (17, 5, 2), (9, 5, 1), (8, 3, 1)])
def test_same_padding_equals_flax(n, k, s):
    """A depthwise convolution with the port's padding against flax's
    ``padding="SAME"`` (total max((ceil(n/s) - 1) * s + k - n, 0), the odd
    pixel after)."""
    rng = np.random.default_rng(n * 10 + k)
    x = rng.standard_normal((1, n, n, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 1, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=4)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = F.conv2d(eff.same_pad(xt, k, s), torch.from_numpy(w).permute(3, 2, 0, 1), stride=s, groups=4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_frozen_bn_uses_eps_1e3():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 5, 8)).astype(np.float32)
    jm = jeff.FrozenBN(8)
    v = _stats(jm.init(jax.random.key(0), jnp.asarray(x)), 4)
    v["batch_stats"]["var"] = np.full(8, 1e-4, np.float32)  # where eps matters
    bn = eff.FrozenBN(8, device="cpu")
    bn.load_state_dict(from_jax_variables(v, bn))
    assert bn.eps == 1e-3
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_block_widths_and_squeeze_excite_follow_jax(branch):
    _jm, v, pm, _x = branch
    specs = eff.block_specs()
    assert len(specs) == 39 and specs[-1][2] == 512
    for name, cin, cout, expand, stride, k in specs:
        blk = getattr(pm.trunk, name)
        jp = v["params"]["trunk"][name]
        assert blk.se.reduce.weight.shape[0] == max(1, cin // 4) == jp["se"]["reduce"]["kernel"].shape[-1]
        assert blk.conv_dw.weight.shape == (cin * expand, 1, k, k)
        assert blk.residual == (stride == 1 and cin == cout)


def _random_timm_state_dict(trunk, seed):
    """A random state_dict under timm tf_efficientnet_b5_ns's key names (no
    timm, no pretrained file): the port trunk's shapes, as timm's are."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(t.shape) for k, t in trunk.state_dict().items()}
    sd = {timm: torch.from_numpy(rng.standard_normal(shapes[port]).astype(np.float32))
          for timm, port in eff.timm_parameter_mapping()}
    sd["bn1.num_batches_tracked"] = torch.tensor(0)
    return sd


def test_timm_key_map_equals_the_jax_importer(branch):
    _jm, v, pm, _x = branch
    pairs = list(eff.timm_parameter_mapping())
    jpairs = list(jeff.timm_parameter_mapping())
    assert [t for t, _ in pairs] == [t for t, *_ in jpairs]
    assert len({p for _, p in pairs}) == len(pairs) == len(pm.trunk.state_dict())
    sd = _random_timm_state_dict(pm.trunk, 5)
    want_vars = jeff.load_torch_efficientnet({k: v_.numpy() for k, v_ in sd.items()},
                                             {"params": v["params"]["trunk"], "batch_stats": v["batch_stats"]["trunk"]})
    want = from_jax_variables(jax.device_get(want_vars), pm.trunk)
    got = eff.import_timm_state_dict(sd, pm.trunk)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    with pytest.raises(KeyError, match="missing"):
        eff.import_timm_state_dict({k: t for k, t in sd.items() if k != "conv_head.weight"}, pm.trunk)
    with pytest.raises(KeyError, match="unmapped"):
        eff.import_timm_state_dict({**sd, "classifier.weight": torch.zeros(3)}, pm.trunk)


def test_reference_checkpoint_carries_the_image_branch():
    """The reference .pth layout's ``full_image_model.*`` (timm keys) and
    ``full_image_feature_reduction.*`` round-trip through the importer."""
    cfg = dataclasses.replace(TINY, image_input="full")
    a = SGPN.from_config(cfg, 12, 15, device="cpu", seed=1)
    b = SGPN.from_config(cfg, 12, 15, device="cpu", seed=2)
    ref = export_reference_state_dict(a)
    assert "full_image_model.blocks.6.0.conv_pwl.weight" in ref and "full_image_feature_reduction.weight" in ref
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # every reference key is mapped
        b.load_state_dict(import_reference_state_dict(ref, b))
    for k, t in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[k], t, rtol=0, atol=0, msg=k)


def test_trainable_mask_equals_sgpn_trainable_labels():
    cfg = dataclasses.replace(J_TINY, image_input="full", model=dataclasses.replace(J_TINY.model, image_size=32))
    jbatch = j_make_scene_batch(1, seed=1, n_objects=3, ds=cfg.dataset, points_per_obj=100)
    jbatch = dataclasses.replace(jbatch, images=np.zeros((1, 6, 32, 32, 3), np.float32))
    params = jax.eval_shape(lambda: JSGPN.from_config(cfg, 12, 15).init(jax.random.key(0), jbatch, train=False))
    labels = jeff.sgpn_trainable_labels(params["params"])
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): lab
            for path, lab in jax.tree_util.tree_flatten_with_path(labels)[0]}
    model = SGPN.from_config(dataclasses.replace(TINY, image_input="full"), 12, 15, device="cpu")
    names = {n: p.requires_grad for n, p in model.named_parameters()}
    assert sum(v == "train" for v in flat.values()) == sum(names.values())
    for path, lab in flat.items():
        parts = path.split("/")
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[parts[-1]]
        name = ".".join(parts[:-1] + [leaf])
        assert names[name] == (lab == "train") == eff.is_trainable(name), name
