"""CLI of the PyTorch port — the pipeline from disk to JSON behind one
command (the counterpart of ``or4d_tpu/cli.py``).

  python -m or4d_tpu_torch.cli instance-labels --data-root D   # L2 pred labels
  python -m or4d_tpu_torch.cli train    --config no_gt --data-root D --checkpoint-dir C
  python -m or4d_tpu_torch.cli evaluate --config no_gt --data-root D --checkpoint-dir C [--serving]
  python -m or4d_tpu_torch.cli infer    --config no_gt --data-root D --checkpoint-dir C \\
      --split test  # writes scan_relations_{config}_{split}.json
  python -m or4d_tpu_torch.cli roles    --relations scan_relations_*.json --output roles.json
  python -m or4d_tpu_torch.cli graphormer-roles --data-root D --checkpoint-dir G  # Graphormer roles
  python -m or4d_tpu_torch.cli phases   --relations scan_relations_*.json \\
      --roles roles.json --output-dir phases_to_frames
  python -m or4d_tpu_torch.cli phases-eval --gt-dir G --pred-dir P
  python -m or4d_tpu_torch.cli visualize --relations scan_relations_*.json --output-dir V
  python -m or4d_tpu_torch.cli perception --task detect-train --data-root D --checkpoint-dir G
  python -m or4d_tpu_torch.cli perception --task detect-infer --data-root D --checkpoint-dir G \\
      --split test  # writes D/group_free_predictions/{take}_{scan}.npz

``train``, ``evaluate``, ``infer``, ``instance-labels``,
``graphormer-roles`` and ``perception`` run on the card unless given
``--device cpu``, and raise without one. Interchange formats are the
reference contracts: scan_relations json (main.py:111-115), role json
(heuristic_based_role_prediction.py:392), phase_to_frames json
(recognize_surgery_phase.py:182-189), Group-Free box npz
(ap_helper.py:263-322). Of ``perception``'s tasks the Group-Free ones
(``detect-train``, ``detect-infer``) are ported; the pose tasks are refused.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

# perception tasks of the JAX CLI that the port does not have yet, and the
# ROADMAP Queue 1 items that bring them
_POSE_ITEMS = "Queue 1 item 5b (HigherHRNet, VoxelPose) and item 5c (their trainers and inference)"
_NOT_PORTED_TASKS = {task: _POSE_ITEMS for task in ("pose2d-train", "pose2d-infer", "pose3d-train", "pose3d-infer")}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="or4d_tpu_torch", description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=["train", "evaluate", "infer", "roles", "graphormer-roles", "phases",
                                    "phases-eval", "instance-labels", "visualize", "perception"])
    p.add_argument("--task", default=None, choices=["pose2d-train", "pose2d-infer", "pose3d-train", "pose3d-infer",
                                                    "detect-train", "detect-infer"],
                   help="perception mode: which L1 stage to run")
    p.add_argument("--config", default="no_gt", help="builtin config name or JSON path")
    p.add_argument("--data-root", default="data")
    p.add_argument("--cache-dir", default=None,
                   help="ORDataset sample cache base dir (default: or4d_torch_cache under the temp dir); "
                        "perception detect-*: the ret-dict cache (default: <data-root>/preprocessed_ret_dicts)")
    p.add_argument("--strict-data", action="store_true",
                   help="fail instead of synthesizing geometry for scans whose raw files are missing")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference .pth state_dict (e.g. paper_model_no_gt_no_images.pth) to evaluate/infer "
                        "with (scene_graph_prediction/main.py:74-79); takes precedence over --checkpoint-dir")
    p.add_argument("--split", default=None, help="infer/evaluate split (default: val for evaluate, test for infer)")
    p.add_argument("--serving", action="store_true",
                   help="evaluate: cache each batch's SA1 geometry once and run the serving path "
                        "(or4d_tpu_torch/serving.py). train: the per-epoch validation the same way")
    p.add_argument("--serving-cache-dir", default=None,
                   help="persist the serving geometry caches here (one npz per batch)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--limit", type=int, default=None, help="limit scans (smoke runs)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", default=None, help="output json path")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    # downstream stages
    p.add_argument("--relations", default=None, help="scan_relations json (roles/phases input)")
    p.add_argument("--tracks", default=None, help="tracks pickle ({take}_scene_graph_track_*.pickle format)")
    p.add_argument("--roles", default=None, help="role predictions json (phases input)")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--gt-dir", default=None, help="phases-eval: GT phase_to_frames_{take}.json dir")
    p.add_argument("--pred-dir", default=None, help="phases-eval: predicted *_phase_to_frames_{take}.json dir")
    p.add_argument("--pred-stem", default=None, help="phases-eval: prediction filename stem (default: any match)")
    # instance-labels stage
    p.add_argument("--from-gt", action="store_true", help="L2: GT objects (registered scans) + annotation-json humans")
    p.add_argument("--boxes-dir", default=None, help="group_free_predictions npz dir")
    p.add_argument("--poses-dir", default=None, help="voxelpose pred_{take}_{frame}.npy dir")
    p.add_argument("--pcd-dir", default=None, help="fused point cloud dir ({take}_{scan}.pcd)")
    return p


def _load_scan_relations(path: str) -> dict[str, list]:
    raw = json.loads(Path(path).read_text())
    # reference keys may carry a _{split} suffix (get_take_rels strips it)
    out = {}
    for k, v in raw.items():
        parts = k.split("_")
        key = "_".join(parts[:2]) if len(parts) > 2 else k
        out[key] = [tuple(r) for r in v]
    return out


def run_roles(args) -> int:
    """Heuristic role prediction over predicted scene graphs
    (role_prediction/heuristic_based_role_prediction.py main path). The
    tracks pickle is read with ``pickle``: pass only files this pipeline
    or the reference wrote."""
    import pickle

    from or4d_tpu_torch.pipeline.roles_heuristic import predict_roles_for_take, write_role_json

    scan_relations = _load_scan_relations(args.relations)
    takes = sorted({int(k.split("_")[0]) for k in scan_relations})
    all_roles: dict[str, dict] = {}
    for take_idx in takes:
        frame_to_relations = {
            k.split("_", 1)[1]: v for k, v in scan_relations.items() if int(k.split("_")[0]) == take_idx
        }
        if args.tracks:
            tracks = pickle.loads(Path(args.tracks).read_bytes())
        else:
            # without tracking data, every human name becomes a one-name track
            # spanning the frames it appears in (degenerate but well-defined)
            names: dict[str, dict] = {}
            for frame, rels in frame_to_relations.items():
                for s, _r, o in rels:
                    for n in (s, o):
                        if "human" in n or n == "Patient":
                            names.setdefault(n, {"timestamp_to_human_pose": {}})[
                                "timestamp_to_human_pose"
                            ][frame] = (n, np.zeros((14, 3)))
            tracks = list(names.values())
        all_roles.update(predict_roles_for_take(take_idx, tracks, frame_to_relations))
    out = args.output or "rule_based_role_predictions.json"
    write_role_json(out, all_roles)
    print(f"wrote {out} ({len(all_roles)} frames)")
    return 0


def run_graphormer_roles(args, device: torch.device) -> int:
    """Graphormer role prediction: train on tracks (a tracks pickle with
    --relations, or synthetic role-behavior tracks), score every track with
    the temperature-4 softmax, assign roles greedily per frame, and write
    graphormer_based_role_predictions.json in the {"{take}_{scan}":
    {human_name: role}} format (role_prediction_helpers.output_role_predictions
    :211-251) that the heuristic writer and the phases stage use. A
    checkpoint dir holding a state is restored and training skipped. When
    GT scans are under --data-root a classification report's macro F1 is
    printed (eval_role_prediction_perf :142-208). The tracks pickle is read
    with ``pickle``: pass only files this pipeline or the reference wrote."""
    import pickle

    from or4d_tpu_torch.data.dataset import load_relationship_scans
    from or4d_tpu_torch.pipeline import role_dataset
    from or4d_tpu_torch.pipeline.roles_heuristic import (eval_role_prediction_perf, predict_roles_for_take,
                                                         write_role_json)
    from or4d_tpu_torch.train import checkpoint as ckpt
    from or4d_tpu_torch.train import graphormer_trainer

    trainer = graphormer_trainer.GraphormerTrainer(device=device, seed=args.seed)
    if args.tracks and args.relations:
        scan_relations = _load_scan_relations(args.relations)
        raw_tracks = pickle.loads(Path(args.tracks).read_bytes())
        take_idx = min(int(k.split("_")[0]) for k in scan_relations)
        frame_to_relations = {k.split("_", 1)[1]: v for k, v in scan_relations.items()}
        # role labels come from the GT humans nearest to each track; the
        # JAX CLI passes none (or4d_tpu/cli.py:169) and then fails on an
        # empty track list
        tracks = role_dataset.build_tracks(take_idx, raw_tracks, frame_to_relations, {})
        if not tracks:
            raise ValueError(f"graphormer-roles: none of the {len(raw_tracks)} tracks in {args.tracks} received a "
                             "role label: labels come from the GT humans of each frame, and no GT humans were given")
        data = [(t.to_batch(frame_to_relations, max_graphs=8), t.role_label) for t in tracks]
        assign_tracks = raw_tracks
    else:
        print("no --tracks/--relations given: training on synthetic role-behavior tracks")
        take_idx = 1
        tracks, frame_to_relations, data = role_dataset.make_synthetic_role_take(take_idx)
        assign_tracks = [{"timestamp_to_human_pose": t.timestamp_to_human_pose} for t in tracks]
    # reference auto-resume (entry.py:105-107): a checkpoint dir with a saved
    # state means the model is trained; restore it and skip training
    if args.checkpoint_dir and ckpt.latest_step(args.checkpoint_dir) is not None:
        trainer.restore(args.checkpoint_dir)
        print(f"restored graphormer checkpoint from {args.checkpoint_dir}; skipping training")
    else:
        losses = trainer.fit(data, epochs=args.epochs or 3, checkpoint_dir=args.checkpoint_dir)
        print(f"trained on {len(data)} tracks: loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    # scores keyed by RAW track index (unscored tracks fall back to the
    # reference's default guess inside the assignment)
    scores = {t.track_idx: trainer.score_track(b) for t, (b, _l) in zip(tracks, data)}
    predictions = predict_roles_for_take(take_idx, assign_tracks, frame_to_relations, scores)
    out = args.output or "graphormer_based_role_predictions.json"
    write_role_json(out, predictions)
    print(f"wrote {out} ({len(predictions)} frames)")

    for split in ("train", "val", "test"):
        gt_scans = [s for s in load_relationship_scans(args.data_root, split) if s["take_idx"] == take_idx]
        if gt_scans:
            _, overall = eval_role_prediction_perf({take_idx: gt_scans}, predictions)
            if overall is not None:
                print(f"role eval vs GT ({split}): macro F1 {overall.macro_f1:.3f}")
            break
    return 0


def run_visualize(args) -> int:
    """L5: predicted scene graphs to HTML (the reference's pyvis
    visualize_scene_graph_predictions.py) and, with --pcd-dir and
    instance-label npz files under --boxes-dir, labeled clouds to PNG
    (visualize_instance_labels.py; needs matplotlib)."""
    from or4d_tpu_torch.utils.visualize import instance_labels_to_png, scene_graph_to_html

    outdir = Path(args.output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    count = 0
    if args.relations:
        scan_relations = _load_scan_relations(args.relations)
        nonempty = [(k, v) for k, v in sorted(scan_relations.items()) if v]
        for scan_id, rels in nonempty[: args.limit or 20]:
            scene_graph_to_html(rels, outdir / f"sg_{scan_id}.html", title=f"scene graph {scan_id}")
            count += 1
    if args.pcd_dir and args.boxes_dir:
        from or4d_tpu_torch.data.pcd_io import read_pcd

        for pcd_path in sorted(Path(args.pcd_dir).glob("*.pcd"))[: args.limit or 5]:
            lab_path = Path(args.boxes_dir) / f"{pcd_path.stem}.npz"
            if not lab_path.exists():
                continue
            pts = read_pcd(pcd_path)
            labels = np.load(lab_path)["arr_0"]
            instance_labels_to_png(pts[:, :3], labels, outdir / f"labels_{pcd_path.stem}.png", title=pcd_path.stem)
            count += 1
    print(f"wrote {count} visualizations to {outdir}")
    return 0


def run_phases(args) -> int:
    """Surgery-phase recognition over predicted scene graphs + roles
    (surgery_phase_recognition/recognize_surgery_phase.py)."""
    from or4d_tpu_torch.pipeline.phases import recognize_phases, write_phase_json

    scan_relations = _load_scan_relations(args.relations)
    role_predictions = json.loads(Path(args.roles).read_text()) if args.roles else {}
    takes = sorted({int(k.split("_")[0]) for k in scan_relations})
    outdir = Path(args.output_dir or "phases_to_frames")
    outdir.mkdir(parents=True, exist_ok=True)
    stem = Path(args.relations).stem
    for take_idx in takes:
        take_sgs = {k: v for k, v in scan_relations.items() if int(k.split("_")[0]) == take_idx}
        phases = recognize_phases(take_sgs, role_predictions)
        out = outdir / f"{stem}_phase_to_frames_{take_idx}.json"
        write_phase_json(out, phases)
        print(f"take {take_idx}: {list(phases)} -> {out}")
    return 0


def run_phases_eval(args) -> int:
    """Phase-recognition evaluation: per-take and per-split classification
    reports of predicted vs GT phase ranges (the reference's
    evaluate_surgery_phase_recognition.py:11-49 printout)."""
    from or4d_tpu_torch.config import TAKE_SPLIT
    from or4d_tpu_torch.pipeline.phases import evaluate_phase_dirs

    gt_dir = args.gt_dir or "phases_to_frames"
    pred_dir = args.pred_dir or args.output_dir or "phases_to_frames"
    reports = evaluate_phase_dirs(gt_dir, pred_dir, pred_stem=args.pred_stem)
    if not reports:
        print(f"no (GT, prediction) phase-json pairs found under {gt_dir} / {pred_dir}")
        return 1
    for split in ("train", "val", "test"):
        for take_idx in TAKE_SPLIT[split]:
            key = f"take_{take_idx}"
            if key in reports:
                print(f"\nTake {take_idx}\n\n{reports[key].to_text()}")
        if split in reports:
            print(f"\n{split}\n\n{reports[split].to_text()}")
    return 0


def run_instance_labels(args, device: torch.device) -> int:
    """L2: project object poses + 3D human poses onto the fused clouds
    (compute_instance_labels). Two modes:

    * dataset mode (default when --data-root has export_holistic_take*
      dirs): per take, writes instance_labels{,_pred}/{take}_{scan}.npz
      and human_name_to_3D_joints/{take}_GT_{bool}.npz; --from-gt uses
      registered object scans + annotation-json humans (:139-156, :205-230),
      otherwise Group-Free boxes + VoxelPose poses;
    * loose-directory mode (--pcd-dir): label each pcd from npz boxes/poses.
    """
    from or4d_tpu_torch.data.pcd_io import read_pcd
    from or4d_tpu_torch.pipeline.instance_labels import (boxes_from_npz, compute_instance_labels_for_scan,
                                                         poses_from_npy, process_take)

    data_root = Path(args.data_root)
    takes = sorted(
        int(p.name.replace("export_holistic_take", "").replace("_processed", ""))
        for p in data_root.glob("export_holistic_take*_processed")
    )
    if takes and not args.pcd_dir:
        out_root = Path(args.output_dir) if args.output_dir else data_root
        total = 0
        for take_idx in takes:
            n = process_take(data_root, take_idx, from_gt=args.from_gt, out_root=out_root,
                             boxes_dir=args.boxes_dir, poses_dir=args.poses_dir, device=device)
            print(f"take {take_idx}: {n} scans labeled (from_gt={args.from_gt})")
            total += n
        print(f"wrote {total} instance-label npz files under {out_root}")
        return 0

    pcd_dir = Path(args.pcd_dir or ".")
    outdir = Path(args.output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    count = 0
    for pcd_path in sorted(pcd_dir.glob("*.pcd")):
        scan_id = pcd_path.stem
        points = read_pcd(pcd_path)[:, :3]
        boxes = boxes_from_npz(Path(args.boxes_dir) / f"{scan_id}.npz") if args.boxes_dir else None
        human_poses = {}
        if args.poses_dir:
            take_idx, frame = scan_id.split("_")
            human_poses = poses_from_npy(Path(args.poses_dir) / f"pred_{take_idx}_{frame}.npy")
        labels = compute_instance_labels_for_scan(points, boxes=boxes, human_poses=human_poses, device=device)
        np.savez_compressed(outdir / f"{scan_id}.npz", labels)
        count += 1
    print(f"wrote {count} instance-label npz files to {outdir}")
    return 0


def run_perception(args, device: torch.device) -> int:
    """L1 Group-Free detection (train_OR.py, infer.py): ``detect-train``
    trains ``--epochs`` epochs of batches of ``--batch-size`` scans in the
    order ``np.random.default_rng(seed + epoch)`` shuffles them to, and
    saves a checkpoint after each epoch; ``detect-infer`` writes
    ``{take}_{scan}.npz`` box files for every scan of ``--split``. Both
    resume from ``--checkpoint-dir`` when it holds a state. The
    checkpoint's step is the update count (the JAX CLI names it by epoch)."""
    from or4d_tpu_torch.data.groupfree_dataset import GroupFreeDetectionDataset
    from or4d_tpu_torch.train import checkpoint as ckpt
    from or4d_tpu_torch.train.perception_trainers import GroupFreeTrainer

    split = args.split or "train"
    ds = GroupFreeDetectionDataset(args.data_root, split, cache_dir=args.cache_dir)
    tr = GroupFreeTrainer(device=device, seed=args.seed)
    msa = ds.mean_size_arr()
    restored = bool(args.checkpoint_dir) and ckpt.latest_step(args.checkpoint_dir) is not None
    if restored:
        tr.step = ckpt.restore(args.checkpoint_dir, tr.model, tr.optimizer)
    if args.task == "detect-infer":
        from or4d_tpu_torch.pipeline.perception_infer import run_detection_inference

        if not restored:
            where = args.checkpoint_dir or "(no --checkpoint-dir given)"
            print(f"WARNING: no checkpoint found under {where}; detect-infer will run from RANDOM INITIALIZATION")
        out_dir = Path(args.output_dir or (Path(args.data_root) / "group_free_predictions"))
        n = run_detection_inference(tr.model, ds, out_dir)
        print(f"wrote {n} box npz files -> {out_dir}")
        return 0
    bs = args.batch_size or 2
    order = np.arange(len(ds))
    for epoch in range(args.epochs or 1):
        np.random.default_rng(args.seed + epoch).shuffle(order)
        sel = order[: args.limit] if args.limit else order
        losses = []
        for i in range(0, len(sel), bs):
            loss, _parts = tr.train_step_from_batch(ds.batch([int(j) for j in sel[i : i + bs]]), msa)
            losses.append(float(loss))
        print(f"detect epoch {epoch}: loss={np.mean(losses):.4f} ({len(losses)} steps)")
        if args.checkpoint_dir:
            ckpt.save(args.checkpoint_dir, tr.model, tr.optimizer, tr.step)
    return 0


def run_sgpn(args, device: torch.device) -> int:
    """train / evaluate / infer of the SGPN scene-graph model from disk."""
    from or4d_tpu_torch.config import load_config
    from or4d_tpu_torch.data.dataset import ORDataset
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB, Vocab
    from or4d_tpu_torch.train import checkpoint as ckpt
    from or4d_tpu_torch.train.loop import Trainer

    cfg = load_config(args.config)
    # vocab from data files when shipped, embedded defaults otherwise
    vocab = Vocab.from_files(args.data_root) if (Path(args.data_root) / "classes.txt").exists() else DEFAULT_VOCAB
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    print(f"device: {device} ({name})")

    ds_kw = dict(data_root=args.data_root, cache_dir=args.cache_dir, synthetic_fallback=not args.strict_data)
    train_ds = ORDataset(cfg, "train", vocab, **ds_kw)
    w_obj, w_rel = train_ds.weights()
    trainer = Trainer(cfg, vocab, w_obj, w_rel, device=device, seed=args.seed)
    batch_size = args.batch_size or cfg.tpu.scene_batch

    restored = False
    if args.torch_checkpoint:
        # paper-weight path (reference main.py:74-79: raw load_state_dict of
        # paper_model_no_gt_no_images.pth); also accepts a Lightning .ckpt
        from or4d_tpu_torch.utils.torch_import import load_reference_checkpoint

        load_reference_checkpoint(args.torch_checkpoint, trainer.model)
        print(f"imported reference torch checkpoint {args.torch_checkpoint}")
        restored = True
    elif args.checkpoint_dir:
        step = ckpt.latest_step(args.checkpoint_dir)
        if step is not None:
            print(f"restoring checkpoint step {step} from {args.checkpoint_dir}")
            trainer.step = ckpt.restore(args.checkpoint_dir, trainer.model, trainer.optimizer)
            restored = True
    if not restored and args.mode in ("evaluate", "infer"):
        where = args.checkpoint_dir or "(no --checkpoint-dir given)"
        print(f"WARNING: no checkpoint found under {where}; "
              f"{args.mode} will run from RANDOM INITIALIZATION")

    if args.mode == "train":
        # val batches only feed the eval forward -> pair-shared crops (paired
        # path); with --serving the per-epoch validation instead goes through
        # a ServingEvaluator built once (unpaired SA1 geometry cached)
        val_ds = ORDataset(cfg, "val", vocab, pair_shared=not args.serving, **ds_kw)
        history = trainer.fit(
            list(train_ds.batches(batch_size, shuffle=True, seed=args.seed, limit=args.limit)),
            val_batches=list(val_ds.batches(batch_size, limit=args.limit)),
            epochs=args.epochs,
            generator=torch.Generator().manual_seed(args.seed),
            checkpoint_dir=args.checkpoint_dir,
            serving_val=args.serving,
        )
        print(json.dumps(history[-1]))
    elif args.mode == "evaluate":
        split = args.split or "val"
        # pair_shared: eval crops are direction-invariant by construction, so
        # the paired rel-encoder path runs (one encode per pair). Serving mode
        # instead caches SA1 geometry of unpaired crops.
        eval_ds = ORDataset(cfg, split, vocab, pair_shared=not args.serving, **ds_kw)
        if args.serving:
            from or4d_tpu_torch.serving import ServingEvaluator

            ev = ServingEvaluator(trainer, eval_ds.batches(batch_size, limit=args.limit),
                                  cache_dir=args.serving_cache_dir)
            f1 = ev.evaluate(verbose=True)
        else:
            f1 = trainer.evaluate(eval_ds.batches(batch_size, limit=args.limit), verbose=True)
        print(json.dumps({"split": split, "relation_macro_f1": f1}))
    else:  # infer
        split = args.split or "test"
        eval_ds = ORDataset(cfg, split, vocab, for_eval=True, **ds_kw)
        scan_relations = trainer.predict_relations(eval_ds.batches(batch_size, limit=args.limit))
        out = args.output or f"scan_relations_{cfg.name}_{split}.json"
        Path(out).write_text(json.dumps(scan_relations))
        print(f"wrote {out} ({len(scan_relations)} scans)")
    return 0


def main(argv: list[str] | None = None) -> int:
    from or4d_tpu_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    if args.mode == "perception":
        if args.task is None:
            raise SystemExit("perception mode requires --task")
        if args.task in _NOT_PORTED_TASKS:
            raise SystemExit(f"or4d_tpu_torch: perception task {args.task!r} is not ported yet: "
                             f"{_NOT_PORTED_TASKS[args.task]}")
    if args.mode == "roles":
        return run_roles(args)
    if args.mode == "phases":
        return run_phases(args)
    if args.mode == "phases-eval":
        return run_phases_eval(args)
    if args.mode == "visualize":
        return run_visualize(args)
    device = resolve_device(args.device)
    if args.mode == "instance-labels":
        return run_instance_labels(args, device)
    if args.mode == "graphormer-roles":
        return run_graphormer_roles(args, device)
    if args.mode == "perception":
        return run_perception(args, device)
    return run_sgpn(args, device)


if __name__ == "__main__":
    raise SystemExit(main())
