"""The reference checkpoint layout -> the port's SGPN ``state_dict``
(``or4d_tpu_torch/utils/torch_import.py``) against the JAX package's
importer: a random reference-layout state_dict, built here independently of
both importers, imported directly into the port equals
``or4d_tpu.utils.torch_import.import_sgpn_state_dict`` followed by
``or4d_tpu_torch.convert.from_jax_variables``, key for key and exactly.
Unmapped keys (the image branch's included) warn on both sides; a wrong
shape raises; export then import gives the model's own state back.
"""

import jax
import numpy as np
import pytest
import torch

from or4d_tpu.config import DatasetConfig as JDatasetConfig
from or4d_tpu.data.synthetic import make_scene_batch as j_make_scene_batch
from or4d_tpu.models import SGPN as JSGPN
from or4d_tpu.utils.torch_import import import_sgpn_state_dict

from or4d_tpu_torch.convert import from_jax_variables
from or4d_tpu_torch.models.sgpn import SGPN
from or4d_tpu_torch.utils.torch_import import (export_reference_state_dict, import_reference_state_dict,
                                               load_reference_checkpoint)

SA = dict(sa_npoints=(32, 16), sa_nsamples=((4, 8), (8, 8)))


def reference_state_dict(seed=3, extras=True) -> dict:
    """A reference SGPNModelWrapper state_dict with random values: Conv2d 1x1
    + BatchNorm2d SA MLPs, the GCN's build_mlp Linear/BN (no running stats),
    the heads; with ``extras`` the wrapper's loss-weight buffers, BN
    counters and one image-branch key."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(shape, scale=0.1, offset=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + offset).astype(np.float32))

    def bn(prefix, c, running=True):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = t(c, 0.1, 1.0), t(c)
        if running:
            sd[f"{prefix}.running_mean"] = t(c)
            sd[f"{prefix}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
            if extras:
                sd[f"{prefix}.num_batches_tracked"] = torch.tensor(7)

    def linear(prefix, cin, cout):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = t((cout, cin)), t(cout)

    for enc, in_dim in (("obj_encoder", 6), ("rel_encoder", 7)):
        specs = {0: {0: [in_dim, 64, 64], 1: [in_dim, 64, 128]},
                 1: {0: [64 + 128 + 3, 128, 128], 1: [64 + 128 + 3, 128, 128]},
                 2: {0: [128 + 128 + 3, 256, 256]}}
        for s, ks in specs.items():
            for k, widths in ks.items():
                for l in range(len(widths) - 1):
                    sd[f"{enc}.backbone.SA_modules.{s}.mlps.{k}.{3 * l}.weight"] = t((widths[l + 1], widths[l], 1, 1))
                    bn(f"{enc}.backbone.SA_modules.{s}.mlps.{k}.{3 * l + 1}", widths[l + 1])
    for i in range(2):
        linear(f"gcn.gconvs.{i}.nn1.0", 256 * 2 + 256, 512)
        bn(f"gcn.gconvs.{i}.nn1.1", 512, running=False)
        linear(f"gcn.gconvs.{i}.nn1.3", 512, 512 * 2 + 256)
        bn(f"gcn.gconvs.{i}.nn1.4", 512 * 2 + 256, running=False)
        linear(f"gcn.gconvs.{i}.nn2.0", 512, 512)
        bn(f"gcn.gconvs.{i}.nn2.1", 512, running=False)
        linear(f"gcn.gconvs.{i}.nn2.3", 512, 256)
    for head, n in (("obj_predictor", 12), ("rel_predictor", 15)):
        linear(f"{head}.fc1", 256, 512)
        linear(f"{head}.fc2", 512, 256)
        linear(f"{head}.fc3", 256 + (12 if head == "rel_predictor" else 0), n)
    if extras:
        sd["weights_obj"], sd["weights_rel"] = t(12), t(15)
        sd["full_image_model.conv_stem.weight"] = t((48, 3, 3, 3))
    return sd


@pytest.fixture(scope="module")
def jax_variables():
    ds = JDatasetConfig(num_points_objects=96, num_points_relation=128, max_objects=4, max_edges=12)
    batch = j_make_scene_batch(1, seed=0, n_objects=3, ds=ds, points_per_obj=150)
    model = JSGPN(num_classes=12, num_relations=15, **SA)
    # the importer reads only the tree's structure, shapes and dtypes: take
    # them from an abstract init (seconds, where a real init takes ~30 s)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                                               batch, train=False))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_direct_import_equals_jax_import_then_convert(jax_variables):
    sd = reference_state_dict()
    port = SGPN(device="cpu", seed=0, **SA)
    with pytest.warns(UserWarning, match=r"1 reference keys were NOT mapped.*full_image_model"):
        got = import_reference_state_dict(sd, port)
    with pytest.warns(UserWarning, match=r"1 reference keys were NOT mapped.*full_image_model"):
        imported = import_sgpn_state_dict(sd, jax_variables)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, imported), port)
    assert set(got) == set(want) == set(port.state_dict())
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)
    # every leaf came from the checkpoint, none from either model's init
    init = port.state_dict()
    changed = [k for k in init if not torch.equal(got[k], init[k])]
    assert len(changed) == len(init)


def test_wrong_shape_raises():
    sd = reference_state_dict(extras=False)
    sd["rel_predictor.fc3.weight"] = sd["rel_predictor.fc3.weight"][:, :-1]
    with pytest.raises(ValueError, match="shape mismatch at rel_predictor.fc3.weight"):
        import_reference_state_dict(sd, SGPN(device="cpu", **SA))


def test_export_then_import_roundtrip_and_pth_file(tmp_path):
    src = SGPN(device="cpu", seed=4, **SA)
    ref = export_reference_state_dict(src)
    assert ref["obj_encoder.backbone.SA_modules.0.mlps.1.0.weight"].shape == (64, 6, 1, 1)
    assert set(ref) == set(reference_state_dict(extras=False))
    torch.save({"state_dict": ref, "epoch": 3}, tmp_path / "paper.ckpt")  # a Lightning-style wrapper
    dst = SGPN(device="cpu", seed=9, **SA)
    load_reference_checkpoint(tmp_path / "paper.ckpt", dst)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0, msg=k)
