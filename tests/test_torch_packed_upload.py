"""The eval upload of only the crop rows a slot pack reads
(``SceneBatch.to(device, pack=...)``) against the full padded upload, on the
``tiny`` config: the same log-probs bit for bit through the model and every
eval entry point, the ``UPLOAD`` counter, and the forward's refusal of
pre-packed crops it cannot read. The pinned staging and back-to-back
uploads are checked on the card (``tests/test_torch_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from or4d_tpu_torch import infer
from or4d_tpu_torch.config import TINY
from or4d_tpu_torch.data import scene_batch
from or4d_tpu_torch.data.scene_batch import SlotPack, is_pair_shared
from or4d_tpu_torch.data.synthetic import make_scene_batch
from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
from or4d_tpu_torch.models import SGPN
from or4d_tpu_torch.train.loop import Trainer

CPU = torch.device("cpu")
# five scenes: 150 edge slots, more than one 128-row bucket, so the pack
# leaves rows on the host
DATA = dict(num_scenes=5, n_objects=4, ds=TINY.dataset, points_per_obj=150)


def _batch(paired: bool, seed: int = 3):
    return make_scene_batch(seed=seed, pair_shared=paired, **DATA)


def _trainer():
    return Trainer(TINY, DEFAULT_VOCAB, np.ones(12, np.float32), np.ones(15, np.float32), device="cpu", seed=2)


def _equal(got, want):
    assert torch.equal(got.rel_logprobs, want.rel_logprobs) and torch.equal(got.obj_logprobs, want.obj_logprobs)


@pytest.mark.parametrize("paired", [True, False])
def test_packed_upload_gives_the_full_uploads_logprobs_bit_for_bit(paired):
    batch = _batch(paired)
    assert is_pair_shared(batch) == paired
    plan = SlotPack.build(batch, bucket=8, paired=paired)
    model = SGPN.from_config(TINY, 12, 15, device="cpu", seed=1)
    packed = batch.to(CPU, pack=plan)
    rows = plan.pair_idx if paired else plan.edge_idx
    assert packed.obj_points.shape == (len(plan.obj_idx),) + batch.obj_points.shape[2:]
    assert packed.rel_points.shape == (len(rows),) + batch.rel_points.shape[2:]
    assert packed.obj_mask.shape == batch.obj_mask.shape and packed.edge_mask.shape == batch.edge_mask.shape
    with torch.no_grad():
        _equal(model(packed, plan.to(CPU)), model(batch.to(CPU), plan.to(CPU)))


def _old_eval(tr, batch):
    """``Trainer.eval_step`` as it ran before the packed upload: every padded
    crop sent, the pack gathered on the device."""
    plan = SlotPack.build(batch, paired=is_pair_shared(batch))
    with torch.no_grad():
        out = tr.model(batch.to(CPU), plan.to(CPU))
    return out.rel_logprobs, out.obj_logprobs


@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("entry", ["eval_step", "predict_relations", "infer.predict_relations"])
def test_eval_entries_are_unchanged_by_the_packed_upload(entry, paired):
    tr, batch = _trainer(), _batch(paired)
    rel, obj = _old_eval(tr, batch)
    calls = scene_batch.UPLOAD["packed_calls"]
    if entry == "eval_step":
        got = tr.eval_step(batch)
        assert torch.equal(got[0], rel) and torch.equal(got[1], obj)
    else:
        want = infer.relations_of(batch, rel, DEFAULT_VOCAB, False)
        run = tr.predict_relations if entry == "predict_relations" else (
            lambda bs: infer.predict_relations(tr.model, bs, DEFAULT_VOCAB))
        assert run([batch]) == want and any(want.values())
    assert scene_batch.UPLOAD["packed_calls"] == calls + 1


def test_upload_counter_splits_the_crop_bytes():
    """One packed eval call sends the pack's capacities of rows and counts
    the rest of the padded crops as skipped; the images go along unchanged.
    A train step sends every padded crop."""
    tr = _trainer()
    batch = dataclasses.replace(_batch(True), images=np.random.default_rng(0).standard_normal(
        (DATA["num_scenes"], 6, 8, 8, 3), dtype=np.float32))
    plan = tr._host_pack(batch, paired=True)
    before = dict(scene_batch.UPLOAD)
    packed = batch.to(CPU, pack=plan)
    delta = {k: scene_batch.UPLOAD[k] - before[k] for k in before}
    Po, Pr = batch.obj_points.shape[2], batch.rel_points.shape[2]
    sent = 4 * (len(plan.obj_idx) * Po * 6 + len(plan.pair_idx) * Pr * 7)
    assert delta == {"packed_calls": 1, "full_calls": 0, "bytes_sent": sent,
                     "bytes_skipped": batch.obj_points.nbytes + batch.rel_points.nbytes - sent}
    assert delta["bytes_skipped"] > 0
    assert torch.equal(packed.images, torch.from_numpy(batch.images))
    for f in ("edge_index", "rel_onehot", "gt_class", "gt_rels", "rel_hand_points"):
        assert getattr(packed, f).shape == getattr(batch, f).shape, f

    before = dict(scene_batch.UPLOAD)
    tr.train_step(_batch(False), torch.Generator().manual_seed(0))
    delta = {k: scene_batch.UPLOAD[k] - before[k] for k in before}
    assert delta == {"packed_calls": 0, "full_calls": 1,
                     "bytes_sent": batch.obj_points.nbytes + batch.rel_points.nbytes, "bytes_skipped": 0}


@pytest.mark.parametrize("case", ["no_pack", "train", "another_pack"])
def test_forward_refuses_packed_crops_it_cannot_read(case):
    batch = _batch(True)
    plan = SlotPack.build(batch, bucket=8, paired=True)
    packed = batch.to(CPU, pack=plan)
    model = SGPN.from_config(TINY, 12, 15, device="cpu", seed=1)
    args = {"no_pack": (None, False), "train": (plan.to(CPU), True),
            "another_pack": (SlotPack.build(batch, bucket=16, paired=True).to(CPU), False)}[case]
    keep = {"obj": torch.ones(5, 6, 256, dtype=torch.bool), "rel": torch.ones(5, 30, 256, dtype=torch.bool)}
    with torch.no_grad(), pytest.raises(ValueError, match="pack order"):
        model(packed, args[0], train=args[1], dropout_keep=keep)
