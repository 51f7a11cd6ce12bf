"""Graphormer role prediction of the port against the JAX package:
Floyd-Warshall and the multi-hop edge input, star expansion,
preprocessing and collation (exactly equal), the model at tiny and full
width (logits 1e-5 of their largest, parameter gradients 1e-4 of the
largest), train and FLAG steps at dropout 0 (parameters 1e-5), the LR
schedule, ``fit``'s sampling order, checkpoint resume, and the
``graphormer-roles`` CLI; the rest mirrors ``tests/test_graphormer.py`` and
FLAG's test in ``tests/test_pose_metrics_cameras.py`` on the port.

The port's parameters come from the JAX ones through
``convert.graphormer_from_jax_params``; the port runs on the CPU
(``device="cpu"``).
"""

import functools
import importlib
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or4d_tpu import cli as jcli
from or4d_tpu.models.graphormer import Graphormer as JGraphormer
from or4d_tpu.pipeline import role_dataset as jrd
from or4d_tpu.pipeline import role_graphormer as jrg
from or4d_tpu.train import graphormer_trainer as jgt
from tests.reference_impls import floyd_warshall_np

jfw = importlib.import_module("or4d_tpu.ops.floyd_warshall")  # or4d_tpu.ops exports the function under that name

from or4d_tpu_torch import cli
from or4d_tpu_torch.convert import graphormer_from_jax_params
from or4d_tpu_torch.models.graphormer import NEG_INF, Graphormer
from or4d_tpu_torch.ops import floyd_warshall as fw
from or4d_tpu_torch.pipeline import role_dataset as rd
from or4d_tpu_torch.pipeline.role_graphormer import (MAX_NODE, collate_track, node_name_to_id, preprocess_graph,
                                                     star_expand, track_to_batch)
from or4d_tpu_torch.train import checkpoint as ckpt
from or4d_tpu_torch.train import graphormer_trainer as gt

RELS = [
    ("human_0", "Assisting", "human_1"),
    ("human_1", "Sawing", "Patient"),
    ("Patient", "LyingOn", "operating_table"),
]
TINY = dict(n_layers=2, hidden=16, ffn=16, heads=4)
FIELDS = ("x", "attn_bias", "spatial_pos", "in_degree", "out_degree", "edge_input", "is_target")


def _batches_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


def _random_graph(rng, n, p, weighted):
    adj = (rng.random((n, n)) < p).astype(np.int64)
    if weighted:
        adj *= rng.integers(1, 5, (n, n))
    np.fill_diagonal(adj, 0)
    return adj


# --------------------------------------------------------------- Floyd-Warshall


@pytest.mark.parametrize("n,p,weighted", [(6, 0.4, False), (20, 0.15, False), (33, 0.08, True), (64, 0.04, False),
                                          (12, 0.0, False)])
def test_floyd_warshall_matches_jax_and_the_reference(n, p, weighted):
    """Random graphs, sparse ones with unreachable pairs, and no edges at all:
    distances and pivots exactly equal to the JAX op and the numpy
    re-statement of algos.pyx."""
    adj = _random_graph(np.random.default_rng(n), n, p, weighted)
    M, path = (t.numpy() for t in fw.floyd_warshall(torch.from_numpy(adj)))
    jM, jpath = (np.asarray(a) for a in jfw.floyd_warshall(jnp.asarray(adj)))
    rM, rpath = floyd_warshall_np(adj)
    np.testing.assert_array_equal(M, jM)
    np.testing.assert_array_equal(path, jpath)
    np.testing.assert_array_equal(M, rM)
    np.testing.assert_array_equal(path, rpath)
    assert M.dtype == path.dtype == np.int32
    if p < 0.1:
        assert (M == fw.MAX_DIST).any()  # unreachable pairs, clamped in both matrices
        np.testing.assert_array_equal(path[M == fw.MAX_DIST], fw.MAX_DIST)


@pytest.mark.parametrize("n,p,max_dist", [(10, 0.3, 5), (24, 0.1, 12)])
def test_gen_edge_input_matches_jax(n, p, max_dist):
    rng = np.random.default_rng(n)
    adj = _random_graph(rng, n, p, False)
    feat = rng.integers(0, 7, (n, n, 2))
    _, path = fw.floyd_warshall(torch.from_numpy(adj))
    got = fw.gen_edge_input(max_dist, path.numpy(), feat)
    np.testing.assert_array_equal(got, jfw.gen_edge_input(max_dist, path.numpy(), feat))
    assert (got == -1).any() and got.dtype == np.int64
    reachable = [(i, j) for i in range(n) for j in range(n) if i != j and path[i, j] != fw.MAX_DIST]
    assert reachable and all(fw.get_all_edges(path.numpy(), i, j) == jfw.get_all_edges(path.numpy(), i, j)
                             for i, j in reachable)


# ----------------------------------------------------------- preprocessing


class TestStarExpansion:
    def test_star_graph_structure(self):
        g = star_expand(RELS, target_name="human_1")
        assert len(g.node_ids) == 7
        assert g.edge_index.shape == (6, 2)
        assert g.is_target.sum() == 1
        assert node_name_to_id("$_Sawing_1") == 20
        assert node_name_to_id("TARGET") == 8
        assert node_name_to_id("human_5") == 7
        assert node_name_to_id("Patient") == 7
        want = jrg.star_expand(RELS, target_name="human_1")
        for f in ("node_ids", "edge_index", "is_target"):
            np.testing.assert_array_equal(getattr(g, f), getattr(want, f))

    def test_empty_returns_none(self):
        assert star_expand([], None) is None

    def test_rename_both_positions(self):
        g = star_expand([("human_0", "CloseTo", "human_0")], target_name="human_0")
        assert g.is_target.sum() == 1


class TestPreprocess:
    def test_wrapper_offsets_and_degrees(self):
        g = star_expand(RELS, target_name="human_1")
        item = preprocess_graph(g)
        assert item["x"].min() >= 2
        assert (np.diag(item["spatial_pos"]) == 0).all()
        ei = g.edge_index
        assert (item["attn_edge_type"][ei[:, 0], ei[:, 1]] == 3).all()
        assert item["spatial_pos"][ei[0, 0], ei[1, 1]] in (1, 2, 12)
        want = jrg.preprocess_graph(jrg.star_expand(RELS, target_name="human_1"))
        assert set(item) == set(want)
        for k in want:
            np.testing.assert_array_equal(item[k], np.asarray(want[k]), err_msg=k)

    def test_collate_padding(self):
        item = preprocess_graph(star_expand(RELS, target_name="human_1"))
        batch = collate_track([item, None], max_graphs=3)
        assert batch.x.shape == (3, MAX_NODE)
        n = len(item["x"])
        np.testing.assert_array_equal(batch.x[0, :n].numpy(), item["x"] + 1)
        assert (batch.x[0, n:] == 0).all() and (batch.x[1:] == 0).all()
        assert batch.attn_bias[2, 0, 0] == 0.0
        assert (batch.attn_bias[2, :, 1:] == NEG_INF).all()
        assert batch.is_target[0, :n].max() == 2
        jitem = jrg.preprocess_graph(jrg.star_expand(RELS, target_name="human_1"))
        _batches_equal(batch, jrg.collate_track([jitem, None], max_graphs=3))

    def test_track_to_batch(self):
        b = track_to_batch([RELS, RELS[:1], []], ["human_1", "human_0", None], max_graphs=4)
        assert b.x.shape[0] == 4
        assert (b.is_target == 2).sum() >= 1


@pytest.mark.parametrize("case", ["synthetic take", "truncated", "over max_node", "far pairs"])
def test_batches_equal_jax(case):
    """Whole tracks exactly equal to the JAX chain: a synthetic take's five
    tracks, a track cut to max_graphs, a graph over 64 nodes dropped, and a
    chain graph whose far pairs pass spatial_pos_max."""
    if case == "synthetic take":
        _, f2r, _ = rd.make_synthetic_role_take(1, n_frames=3, max_graphs=4)
        frames = sorted(f2r)
        args = [([f2r[f] for f in frames], [f"human_{i}"] * len(frames), 4) for i in range(5)]
    elif case == "truncated":
        args = [([RELS, RELS[:2], RELS[1:], RELS], ["human_1", "human_0", "Patient", None], 2)]
    elif case == "over max_node":
        big = [(f"human_{i % 9}", "CloseTo", "instrument_table") for i in range(40)]
        args = [([big, RELS], ["human_1", "human_1"], 3)]
    else:
        chain = [(f"human_{i}", "CloseTo", f"human_{i + 1}") for i in range(12)]
        args = [([chain, RELS], ["human_0", "human_1"], None)]
    for rels, targets, g in args:
        _batches_equal(track_to_batch(rels, targets, max_graphs=g), jrg.track_to_batch(rels, targets, max_graphs=g))


# ------------------------------------------------------------------- model


def _jax_model(kw, batch, seed=0):
    model = JGraphormer(**kw)
    variables = model.init({"params": jax.random.key(seed), "dropout": jax.random.key(1)}, batch, train=False)
    return model, jax.device_get(variables["params"])


def _port_model(kw, params):
    m = Graphormer(**kw, device="cpu")
    m.load_state_dict(graphormer_from_jax_params(params, m))
    return m


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_model_matches_jax(width):
    """Logits of a 2-graph track to 1e-5 of their largest and every
    parameter's gradient of the CE loss to 1e-4 of the largest gradient,
    from the same (converted) parameters."""
    kw = TINY if width == "tiny" else {}
    rels, targets = [RELS, RELS[:2]], ["human_1", "human_1"]
    jb = jrg.track_to_batch(rels, targets, max_graphs=2)
    model, params = _jax_model(kw, jb)
    m = _port_model(kw, params)
    label = 1

    def loss(p):
        return -jax.nn.log_softmax(model.apply({"params": p}, jb, train=False))[label]

    want = np.asarray(model.apply({"params": params}, jb, train=False))
    jgrads = jax.device_get(jax.grad(loss)(params))
    logits = m(track_to_batch(rels, targets, max_graphs=2))
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    (-torch.log_softmax(logits, -1)[label]).backward()
    wgrad = graphormer_from_jax_params(jgrads, m)
    scale = max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(jgrads))
    for k, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), wgrad[k].numpy(), rtol=0, atol=1e-4 * scale, err_msg=k)
    if width == "full":
        assert sum(p.numel() for p in m.parameters()) == 486_805


def test_converter_raises_on_missing_and_extra_keys():
    jb = jrg.track_to_batch([RELS], ["human_1"], max_graphs=1)
    _, params = _jax_model(TINY, jb)
    m = Graphormer(**TINY, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        graphormer_from_jax_params({k: v for k, v in params.items() if k != "graph_token"}, m)
    with pytest.raises(KeyError, match="extra"):
        graphormer_from_jax_params({**params, "layer_9": params["layer_0"]}, m)


class TestGraphormerModel:
    @pytest.fixture(scope="class")
    def model(self):
        return Graphormer(**TINY, device="cpu", seed=0)

    def test_forward_shape(self, model):
        logits = model(track_to_batch([RELS, RELS[:2]], ["human_1", "human_1"], max_graphs=2))
        assert logits.shape == (5,) and torch.isfinite(logits).all()

    def test_padding_graph_invariance(self, model):
        b1 = track_to_batch([RELS], ["human_1"], max_graphs=1)
        b2 = track_to_batch([RELS], ["human_1"], max_graphs=3)
        np.testing.assert_allclose(model(b1).detach().numpy(), model(b2).detach().numpy(), atol=1e-5)

    def test_grad_flows(self, model):
        model.zero_grad()
        (-torch.log_softmax(model(track_to_batch([RELS], ["human_1"], max_graphs=1)), -1)[1]).backward()
        assert sum(float(p.grad.abs().sum()) for p in model.parameters() if p.grad is not None) > 0

    def test_dropout_draws_from_the_generator(self, model):
        b = track_to_batch([RELS], ["human_1"], max_graphs=1)
        draws = [model(b, train=True, generator=torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
        assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])


# ----------------------------------------------------------------- trainer

TRAIN = dict(TINY, dropout=0.0, peak_lr=1e-3, warmup_updates=2, tot_updates=50)


def _pair(**kw):
    """A JAX trainer and state and the port's trainer from the same parameters."""
    jt = jgt.GraphormerTrainer(**{**TRAIN, **kw})
    data = jrd.make_synthetic_role_dataset(tracks_per_role=1, n_frames=2, max_graphs=2)
    state = jt.init_state(jax.random.key(0), data[0][0])
    t = gt.GraphormerTrainer(**{**TRAIN, **kw}, device="cpu")
    t.model.load_state_dict(graphormer_from_jax_params(jax.device_get(state["params"]), t.model))
    return jt, state, t


def _params_close(t, state, atol):
    want = graphormer_from_jax_params(jax.device_get(state["params"]), t.model)
    for k, v in t.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=atol, err_msg=k)


def test_train_and_flag_steps_match_jax():
    """Three train steps, then one FLAG step (m = 3) from JAX's first
    perturbation, at dropout 0: losses and parameters to 1e-5."""
    jt, state, t = _pair()
    data = jrd.make_synthetic_role_dataset(tracks_per_role=1, n_frames=2, max_graphs=2)
    port_data = rd.make_synthetic_role_dataset(tracks_per_role=1, n_frames=2, max_graphs=2)
    for i in range(3):
        (jb, label), (b, _) = data[i], port_data[i]
        state, jloss = jt.train_step(state, jb, label, jax.random.key(10 + i))
        loss = t.train_step(b, label)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
        _params_close(t, state, 1e-5)
    assert t.step == int(state["step"]) == 3
    (jb, label), (b, _) = data[3], port_data[3]
    key = jax.random.key(21)
    _, pk = jax.random.split(key)
    shape = (*jb.x.shape, TRAIN["hidden"])
    perturb = jax.random.uniform(pk, shape, minval=-1.0, maxval=1.0) * (1e-3 / np.sqrt(TRAIN["hidden"]))
    state, jloss = jt.flag_train_step(state, jb, label, key, m=3)
    loss = t.flag_train_step(b, label, m=3, perturb=torch.from_numpy(np.asarray(perturb)))
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, atol=1e-6)
    _params_close(t, state, 1e-5)


def test_flag_step_runs_and_updates():
    """tests/test_pose_metrics_cameras.py's FLAG test on the port, its own
    perturbation drawn (dropout on)."""
    t = gt.GraphormerTrainer(n_layers=1, hidden=16, ffn=16, heads=4, peak_lr=1e-3, warmup_updates=2, tot_updates=50,
                             device="cpu")
    (batch, label), *_ = rd.make_synthetic_role_dataset(tracks_per_role=1, n_frames=2, max_graphs=2)
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    loss = t.flag_train_step(batch, label, torch.Generator().manual_seed(1), m=2)
    assert np.isfinite(float(loss))
    assert any(not torch.allclose(before[k], v) for k, v in t.model.state_dict().items())


def test_lr_schedule_equals_jax():
    for args in ((2e-4, 1e-9, 40_000, 400_000), (1.0, 0.1, 10, 100), (1e-3, 1e-9, 2, 50)):
        port, jax_sched = gt.polynomial_decay_lr(*args), jgt.polynomial_decay_lr(*args)
        for step in range(101):
            assert np.float32(port(step)) == np.float32(jax_sched(step)), (args, step)


def test_fit_samples_in_the_jax_order(monkeypatch):
    """The balanced draw (with replacement) and the plain permutation give
    the JAX fit's track order over three epochs."""
    jt, state, t = _pair()
    data = jrd.make_synthetic_role_dataset(tracks_per_role=1, n_frames=2, max_graphs=2)
    data = data + data[:2]  # unbalanced roles
    port_data = rd.make_synthetic_role_dataset(tracks_per_role=1, n_frames=2, max_graphs=2)
    port_data = port_data + port_data[:2]
    for balance in (True, False):
        seen_j, seen_t = [], []
        monkeypatch.setattr(jt, "train_step",
                            lambda s, b, label, k: (seen_j.append(next(i for i, d in enumerate(data) if d[0] is b)),
                                                    (s, jnp.float32(0.0)))[1])
        monkeypatch.setattr(t, "train_step",
                            lambda b, label, g=None: (seen_t.append(next(i for i, d in enumerate(port_data)
                                                                         if d[0] is b)), torch.tensor(0.0))[1])
        jt.fit(state, data, epochs=3, balance=balance)
        t.fit(port_data, epochs=3, balance=balance)
        assert seen_t == seen_j and len(seen_j) == 21


# ------------------------------------------------------------ roles format


class TestRoleInterchangeFormat:
    @pytest.fixture(scope="class")
    def predictions(self):
        from or4d_tpu_torch.pipeline.roles_heuristic import predict_roles_for_take

        tracks, frame_to_relations, data = rd.make_synthetic_role_take(1, n_frames=3, max_graphs=3)
        trainer = gt.GraphormerTrainer(**TINY, device="cpu")
        trainer.fit(data, epochs=1)
        scores = {tr.track_idx: trainer.score_track(b) for tr, (b, _l) in zip(tracks, data)}
        assign_tracks = [{"timestamp_to_human_pose": tr.timestamp_to_human_pose} for tr in tracks]
        return predict_roles_for_take(1, assign_tracks, frame_to_relations, scores), frame_to_relations

    def test_format_matches_heuristic_writer(self, predictions):
        from or4d_tpu_torch.pipeline.roles_heuristic import ROLE_LABEL_NAMES

        preds, frame_to_relations = predictions
        assert set(preds) == {f"1_{f}" for f in frame_to_relations}
        for humans in preds.values():
            assert all(h.startswith("human_") and r in ROLE_LABEL_NAMES for h, r in humans.items())
            assert len(set(humans.values())) == len(humans)

    def test_phases_consumes_graphormer_roles(self, predictions, tmp_path):
        from or4d_tpu_torch.pipeline.phases import recognize_phases

        preds, frame_to_relations = predictions
        p = tmp_path / "graphormer_based_role_predictions.json"
        p.write_text(json.dumps(preds))
        scan_relations = {f"1_{f}": rels for f, rels in frame_to_relations.items()}
        assert isinstance(recognize_phases(scan_relations, json.loads(p.read_text())), dict)

    def test_eval_role_prediction_perf(self, predictions):
        from or4d_tpu_torch.pipeline.roles_heuristic import eval_role_prediction_perf

        preds, frame_to_relations = predictions
        names = ["Patient", "head-surgeon", "assistant-surgeon", "circulating-nurse", "anaesthetist"]
        gt_scans = [{"scan": f, "objects": {"1": "human_0"},
                     "human_idx_to_name": {f"human_{i}": r for i, r in enumerate(names)}} for f in frame_to_relations]
        per_take, overall = eval_role_prediction_perf({1: gt_scans}, preds)
        assert 1 in per_take and 0.0 <= overall.macro_f1 <= 1.0

    def test_unscored_track_gets_default_guess(self):
        from or4d_tpu_torch.pipeline.roles_heuristic import DEFAULT_GUESS, assign_roles_in_frame

        tracks = [{"timestamp_to_human_pose": {"000000": ("human_0", np.zeros((14, 3)))}}]
        roles, _ = assign_roles_in_frame("000000", tracks, {})
        assert roles == {"human_0": max(DEFAULT_GUESS.items(), key=lambda x: x[1])[0]}


# ----------------------------------------------------- checkpoints and CLI


class TestCheckpointResume:
    def test_fit_saves_and_restore_reproduces_scores(self, tmp_path):
        _, _, data = rd.make_synthetic_role_take(1, n_frames=3, max_graphs=3)
        trainer = gt.GraphormerTrainer(**TINY, device="cpu")
        trainer.fit(data, epochs=2, checkpoint_dir=tmp_path / "gck")
        assert ckpt.latest_step(tmp_path / "gck") == 1  # one save per epoch, last wins
        fresh = gt.GraphormerTrainer(**TINY, device="cpu", seed=1)
        assert fresh.restore(tmp_path / "gck") == 1 and fresh.step == trainer.step == 10
        for b, _l in data:
            assert trainer.score_track(b) == fresh.score_track(b)

    def test_cli_second_invocation_skips_training(self, tmp_path, monkeypatch, capsys):
        monkeypatch.setattr(gt, "GraphormerTrainer", functools.partial(gt.GraphormerTrainer, **TINY))
        monkeypatch.chdir(tmp_path)
        argv = ["graphormer-roles", "--epochs", "1", "--seed", "0", "--device", "cpu",
                "--checkpoint-dir", str(tmp_path / "ck"), "--output", str(tmp_path / "roles.json"),
                "--data-root", str(tmp_path / "nodata")]
        assert cli.main(argv) == 0
        first = json.loads((tmp_path / "roles.json").read_text())
        capsys.readouterr()
        assert cli.main(argv) == 0
        assert "skipping training" in capsys.readouterr().out
        assert json.loads((tmp_path / "roles.json").read_text()) == first


def test_cli_json_equals_the_jax_cli(tmp_path, monkeypatch, capsys):
    """``graphormer-roles`` on the synthetic take at tiny width, dropout 0,
    from the JAX CLI's initial parameters: the same role JSON and the same
    prints."""
    inits = {}

    class JTrainer(jgt.GraphormerTrainer):
        def init_state(self, rng, sample):
            state = super().init_state(rng, sample)
            inits["params"] = jax.device_get(state["params"])
            return state

    class PortTrainer(gt.GraphormerTrainer):
        def __post_init__(self):
            super().__post_init__()
            self.model.load_state_dict(graphormer_from_jax_params(inits["params"], self.model))

    kw = dict(TINY, dropout=0.0, peak_lr=1e-3, warmup_updates=3, tot_updates=100)
    monkeypatch.setattr(jgt, "GraphormerTrainer", functools.partial(JTrainer, **kw))
    monkeypatch.setattr(gt, "GraphormerTrainer", functools.partial(PortTrainer, **kw))
    monkeypatch.chdir(tmp_path)
    base = ["graphormer-roles", "--epochs", "3", "--seed", "0", "--data-root", str(tmp_path / "nodata")]
    assert jcli.main([*base, "--output", str(tmp_path / "jax.json")]) == 0
    jout = capsys.readouterr().out
    assert cli.main([*base, "--output", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == want and len(want) == 4
    # the loss line's rounding may move in the last digit; every other line is the same
    strip = lambda s: [line.replace("jax.json", "X").replace("port.json", "X") for line in s.splitlines()
                       if not line.startswith("trained on")]
    assert strip(out) == strip(jout)


def test_tracks_path_raises_a_value_error_where_the_jax_cli_raises_index_error(tmp_path):
    """With --tracks and --relations no GT humans reach the labelling, so no
    track is labelled: the JAX CLI fails with an IndexError on the empty
    track list, the port with a ValueError that says why."""
    rels = {"1_000000": [list(r) for r in RELS], "1_000001": [list(r) for r in RELS[:2]]}
    (tmp_path / "rels.json").write_text(json.dumps(rels))
    tracks = [{"timestamp_to_human_pose": {f: (h, np.zeros((14, 3))) for f in ("000000", "000001")}}
              for h in ("human_0", "human_1")]
    (tmp_path / "tracks.pickle").write_bytes(pickle.dumps(tracks))
    argv = ["graphormer-roles", "--relations", str(tmp_path / "rels.json"), "--tracks", str(tmp_path / "tracks.pickle"),
            "--output", str(tmp_path / "out.json"), "--data-root", str(tmp_path)]
    with pytest.raises(IndexError):
        jcli.main(argv)
    with pytest.raises(ValueError, match="no GT humans were given"):
        cli.main([*argv, "--device", "cpu"])
    assert not (tmp_path / "out.json").exists()
