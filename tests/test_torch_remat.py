"""``TPUConfig.remat`` and the row-chunked train BN backward, on the CPU:
the repair that lets the S=8 float32 step at the largest batch fit on an
80 GB card must not change a result.

One ``tiny`` Trainer step (augmentation on) with ``remat`` off and on, from
the same weights and draws: losses, every gradient, the parameters after
AdamW and the BN running statistics (updated once, from the forward's
moments, not again when the chain is recomputed) are equal. The remat
path's BN backward in chunks of a few rows against the plain step's one
pass: gradients within 1e-6 of their largest value (sums in another
order). The JSON key
``"TPU": {"remat": true}`` reaches both encoders' MSG stages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from or4d_tpu_torch.config import TINY, ExperimentConfig
from or4d_tpu_torch.data.synthetic import make_scene_batch
from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
from or4d_tpu_torch.models import layers
from or4d_tpu_torch.train.loop import Trainer

W = (np.linspace(0.5, 1.5, 12).astype(np.float32), np.linspace(0.5, 1.5, 15).astype(np.float32))


def _step(remat: bool, chunk: int | None = None, monkeypatch=None):
    if chunk is not None:
        monkeypatch.setattr(layers, "_BWD_CHUNK", chunk)
    cfg = dataclasses.replace(TINY, dataset=dataclasses.replace(TINY.dataset, data_augmentation=True),
                              tpu=dataclasses.replace(TINY.tpu, remat=remat))
    tr = Trainer(cfg, DEFAULT_VOCAB, *W, device="cpu", seed=4)
    batch = make_scene_batch(2, seed=5, n_objects=5, ds=cfg.dataset, points_per_obj=150)
    parts = tr.train_step(batch, torch.Generator().manual_seed(6))
    grads = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
    return parts, grads, {k: v.clone() for k, v in tr.model.state_dict().items()}, tr


def test_remat_step_equals_the_plain_step():
    parts0, grads0, state0, _ = _step(False)
    parts1, grads1, state1, tr = _step(True)
    assert all(m.remat for m in (tr.model.obj_encoder.sa1, tr.model.obj_encoder.sa2, tr.model.rel_encoder.sa1,
                                 tr.model.rel_encoder.sa2))
    for k in parts0:
        assert float(parts1[k]) == float(parts0[k]), k
    for n, g in grads0.items():
        torch.testing.assert_close(grads1[n], g, rtol=0, atol=0, msg=n)
    for k, v in state0.items():  # parameters after AdamW, running statistics updated once
        torch.testing.assert_close(state1[k], v, rtol=0, atol=0, msg=k)
    assert not torch.equal(state0["rel_encoder.sa1.mlp_0.bn_0.running_mean"], torch.zeros(64))


@pytest.mark.parametrize("chunk", [4096])
def test_chunked_bn_backward_equals_one_chunk(chunk, monkeypatch):
    """The remat path's row-chunked BN backward (many chunks at these
    sizes) against the one-pass backward of the plain step."""
    parts0, grads0, _, _ = _step(False)
    parts1, grads1, _, _ = _step(True, chunk, monkeypatch)
    assert float(parts1["loss"]) == float(parts0["loss"])
    scale = max(float(g.abs().max()) for g in grads0.values())
    for n, g in grads0.items():
        torch.testing.assert_close(grads1[n], g, rtol=0, atol=1e-6 * scale, msg=n)


def test_remat_comes_from_the_json_config():
    cfg = ExperimentConfig.from_reference_json({"TPU": {"remat": True}}, name="x")
    assert cfg.tpu.remat and not TINY.tpu.remat
