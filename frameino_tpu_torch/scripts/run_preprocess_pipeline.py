"""Dataset-curation pipeline: raw video folder -> training CSV + ID crops
(counterpart of ``scripts/run_preprocess_pipeline.py``; its flags, its
``--allow_classical`` gate, backend manifest, sharding, summary JSON and
CSV schema).

    python -m frameino_tpu_torch.scripts.run_preprocess_pipeline \
        --video_folder raw_videos/ --output_folder FrameINO_data/ \
        [--panoptic_checkpoint oneformer.pth] [--camera_checkpoint vggt.pt] \
        [--cotracker_checkpoint cotracker3.pth] \
        [--id_refine sam2 --sam2_checkpoint sam2.1_hiera_large.pt] \
        [--caption_backend qwen_checkpoint --caption_model QWEN_DIR] \
        [--device cuda|cpu] [--allow_classical]

The reference's 9-step chain (``preprocess/README.md:17-115``):

  1. validity filter            (filter_basic.py)
  2. shot-boundary scoring      (histogram detector)
  3. image-quality scoring      (classical IQA)
  4. panoptic -> object points  (the port's OneFormer Swin-L with
                                 ``--panoptic_checkpoint``, its deformable
                                 sampling on K13; else the motion-residual
                                 segmenter)
  5. camera-motion pruning      (the port's VGGT-1B with
                                 ``--camera_checkpoint``, its attention on
                                 K3; else the two-view gate)
  6. captioning                 (Qwen2.5-VL; template opt-in)
  7. point tracking             (the port's CoTracker3 with
                                 ``--cotracker_checkpoint``; else the
                                 pyramidal-LK cycle)
  8. FrameINO labeling          (region boxes + ID crops; SAM2.1 refine
                                 with ``--id_refine sam2``)

Emits the new-schema training CSV (video_path, height, width,
valid_duration, Panoptic_Segmentation, Structured_Text_Prompt, Track_Traj,
Obj_Info, ID_info) that ``FrameINODataset`` loads directly.

Differences from the JAX script: ``--caption_backend qwen_checkpoint``
(the port's Qwen2.5-VL from a local checkpoint directory, on ``--device``)
stands for JAX's ``qwen_jax``; the learned models run on ``--device``
(``cuda`` by default). The summary JSON also holds each learned backend's
calls, seconds and (on CUDA) peak memory, and each kept clip's seconds per
step.
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def _dumps(obj):
    """json.dumps tolerating numpy scalars (box coords, areas)."""
    return json.dumps(obj, default=lambda o: o.item())


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--video_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--csv_name", default="curated.csv")
    p.add_argument("--num_shards", type=int, default=1,
                   help="data-parallel curation: split the video list "
                        "across N independent processes (reference "
                        "*_multi.py pattern); each writes "
                        "<csv_name>.shardK.csv")
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--min_frames", type=int, default=49)
    p.add_argument("--min_size", type=int, default=64)
    p.add_argument("--max_aspect", type=float, default=2.5)
    p.add_argument("--cut_threshold", type=float, default=0.5)
    p.add_argument("--min_clarity", type=float, default=5.0)
    p.add_argument("--min_motion", type=float, default=2.0)
    p.add_argument("--num_points", type=int, default=10)
    p.add_argument("--keep_boxes", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the learned models run (cuda or cpu)")
    p.add_argument("--allow_classical", action="store_true",
                   help="opt in to the classical fallbacks for the "
                        "learned curation steps (motion-residual "
                        "panoptic, two-view camera gate, pyramidal-LK "
                        "tracking). Without this flag the script exits "
                        "when any of --panoptic_checkpoint / "
                        "--camera_checkpoint / --cotracker_checkpoint "
                        "is missing — a forgotten flag must not "
                        "silently yield moving_N pseudo-labels instead "
                        "of semantics (same loudness standard as "
                        "captioning's 'template' opt-in)")
    p.add_argument("--caption_backend", default="qwen",
                   choices=["qwen", "qwen_checkpoint", "http", "template"],
                   help="VLM captioner. 'template' is the offline smoke "
                        "opt-in (deterministic content-derived strings, "
                        "NOT real captions); 'qwen_checkpoint' runs the "
                        "port's Qwen2.5-VL from the --caption_model "
                        "directory on --device")
    p.add_argument("--caption_model",
                   default="Qwen/Qwen2.5-VL-32B-Instruct")
    p.add_argument("--vlm_endpoint", default=None,
                   help="OpenAI-compatible endpoint for "
                        "--caption_backend http")
    p.add_argument("--panoptic_checkpoint", default=None,
                   help="released OneFormer COCO Swin-L .pth; when set, "
                        "step 4 runs the port's OneFormer with semantic "
                        "labels (reference filter_panoptic_multi.py) "
                        "instead of the motion segmenter")
    p.add_argument("--id_refine", default="none",
                   choices=["none", "sam2"],
                   help="step-8 ID refinement: 'sam2' runs the "
                        "reference SAM2_Refine protocol (video-"
                        "propagated masks from track points, aux "
                        "references, point validation) via the SAM2 "
                        "adapter in evaluation.perception")
    p.add_argument("--sam2_checkpoint", default=None,
                   help="released sam2.1_hiera_large.pt weights; with "
                        "--id_refine sam2, runs the port's SAM2.1 video "
                        "predictor (models/sam2_video.py) instead of "
                        "the external sam2 package")
    p.add_argument("--cotracker_checkpoint", default=None,
                   help="released CoTracker3-offline weights; when set, "
                        "step 7 tracks with the port's CoTracker3 "
                        "(forward+backward, the reference "
                        "track_regular_motion_cycle.py protocol) "
                        "instead of the pyramidal-LK cycle tracker")
    p.add_argument("--camera_checkpoint", default=None,
                   help="released VGGT4Track weights; when set, step 5 "
                        "runs the port's VGGT 3D camera estimator and "
                        "prunes by the reference's fraction-ranked "
                        "rotation/translation/focal delete lists "
                        "(make_delete_lists_camera.py) instead of the "
                        "two-view keep_by_camera_motion gate")
    return p.parse_args(argv)


def build_captioner(args, processor=None):
    """Resolve --caption_backend to a vlm callable (or None for the
    explicit template opt-in). ``processor`` stands in for the checkpoint
    directory's transformers processor (``qwen_checkpoint``)."""
    from frameino_tpu_torch.preprocess import captioning
    if args.caption_backend == "qwen":
        return captioning.load_qwen_captioner(args.caption_model)
    if args.caption_backend == "qwen_checkpoint":
        # --caption_model is a local checkpoint dir here (the port's graph
        # reads its safetensors, models/qwen_vl.py)
        return captioning.load_qwen_captioner_checkpoint(
            args.caption_model, device=args.device, processor=processor)
    if args.caption_backend == "http":
        if not args.vlm_endpoint:
            raise SystemExit("--caption_backend http needs --vlm_endpoint")
        return captioning.load_captioner_http(args.vlm_endpoint)
    print("WARNING: --caption_backend template — captions are "
          "deterministic offline stand-ins, not VLM output")
    return None


class Backend:
    """A learned backend's callable, counting its calls and seconds and,
    on CUDA, the largest peak of device memory over its calls."""

    def __init__(self, fn, device: str):
        self.fn = fn
        self.cuda = str(device).startswith("cuda")
        self.calls = 0
        self.seconds = 0.0
        self.peak_gib = 0.0

    def __call__(self, *a, **kw):
        import torch
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = self.fn(*a, **kw)
        if self.cuda:
            torch.cuda.synchronize()
            self.peak_gib = max(self.peak_gib,
                                torch.cuda.max_memory_allocated() / 2 ** 30)
        self.seconds += time.time() - t0
        self.calls += 1
        return out

    def report(self):
        return {"calls": self.calls, "seconds": self.seconds,
                "peak_gib": self.peak_gib if self.cuda else None}


class _StepClock:
    """Seconds of each step of one clip (``steps``), in the order run."""

    def __init__(self):
        self.steps = {}
        self.t = time.time()

    def __call__(self, step):
        now = time.time()
        self.steps[step] = self.steps.get(step, 0.0) + now - self.t
        self.t = now


def process_video(name, video_folder, id_out_folder, args, vlm=None,
                  oneformer=None, camera_estimator=None,
                  id_segmenter=None, point_tracker=None, step_seconds=None):
    """One raw video -> ((row, camera_info), None), or (None, the step that
    dropped it). ``step_seconds``: a dict that receives the seconds of each
    step run."""
    import cv2

    from frameino_tpu_torch.data.video_io import decode_video
    from frameino_tpu_torch.preprocess.basic_filter import filter_basic
    from frameino_tpu_torch.preprocess.camera_pose import \
        keep_by_camera_motion
    from frameino_tpu_torch.preprocess.captioning import caption_segments
    from frameino_tpu_torch.preprocess.frameino_labeling import (
        crop_id_reference, find_region_boxes, object_bbox, sam2_refine)
    from frameino_tpu_torch.preprocess.image_scoring import score_images
    from frameino_tpu_torch.preprocess.lk_tracker import make_lk_tracker
    from frameino_tpu_torch.preprocess.motion_tracking import (
        motion_magnitude, track_step)
    from frameino_tpu_torch.preprocess.panoptic import (
        connected_component_panoptic, motion_segmenter, run_panoptic_step)
    from frameino_tpu_torch.preprocess.scene_cut import (longest_clean_span,
                                                         score_scene_cuts)

    clock = _StepClock()
    frames = decode_video(os.path.join(video_folder, name))
    F, H, W = frames.shape[:3]
    clock("decode")
    try:
        # 1. validity
        kept, _ = filter_basic([{"height": H, "width": W, "num_frames": F}],
                               min_frames=args.min_frames,
                               min_height=args.min_size,
                               min_width=args.min_size,
                               max_aspect_ratio=args.max_aspect)
        if not kept:
            return None, "basic_filter"

        # 2. shot boundaries -> valid_duration
        scores = score_scene_cuts(frames)
        v0, v1 = longest_clean_span(scores, args.cut_threshold)
        clock("scene_cut")
        if v1 - v0 < args.min_frames:
            return None, "scene_cut"
        clip = frames[v0:v1]

        # 3. image quality on the first frame
        iqa = score_images(clip[0])
        clock("image_scoring")
        if iqa["clarity"] < args.min_clarity:
            return None, "image_scoring"

        # 5. camera motion (before the expensive per-object tracking).
        # With a VGGT estimator: record the 3D camera_info for the
        # dataset-level fraction-ranked pruning (reference semantics);
        # otherwise gate per-clip on two-view stats.
        camera_info = None
        if camera_estimator is not None:
            camera_info = camera_estimator(clip)
        elif not keep_by_camera_motion(clip):
            clock("camera_pose")
            return None, "camera_pose"
        clock("camera_pose")

        # 4. panoptic -> per-object first-frame points + masks.
        # Preferred: OneFormer with semantic labels (reference step 4);
        # offline fallback: camera-compensated motion segmentation
        # (independent movers are the Frame-In/Out candidates), then
        # appearance-based connected components for static starts.
        rng = np.random.default_rng(args.seed)
        segments = oneformer(clip[0]) if oneformer is not None else []
        if not segments:
            segments = motion_segmenter(clip)
        if not segments:
            segments = connected_component_panoptic(clip[0])
        obj_info_payload, seg_payload = run_panoptic_step(
            clip, lambda f: segments, frame_idx=0,
            num_points=args.num_points, rng=rng)
        obj_info, seg_points = obj_info_payload[0], seg_payload[0]
        clock("panoptic")
        if not obj_info:
            return None, "panoptic"

        # 6. caption — one caption per panoptic segment start (here the
        # single frame-0 group), the reference protocol
        captions = caption_segments(
            clip, [0], vlm=vlm,
            allow_template=args.caption_backend == "template")
        clock("caption")

        # 7. point tracking of the panoptic points: CoTracker3 when a
        # checkpoint was given, pyramidal-LK cycle tracker offline
        tracker = point_tracker or make_lk_tracker()
        track_traj = track_step(clip, seg_points, tracker)
        magnitudes = [motion_magnitude(np.asarray(t)) for t in track_traj]
        clock("tracking")
        if max(magnitudes) < args.min_motion:
            return None, "motion_filter"

        # 8. FrameINO labeling: main object = largest mask among movers
        masks = {label: m for label, m in segments}
        order = np.argsort([-int(masks[obj_info[i][0]].sum())
                            if obj_info[i][0] in masks else 0
                            for i in range(len(obj_info))])
        id_info = [[] for _ in obj_info]
        labeled = False
        for oi in order:
            label = obj_info[oi][0]
            if magnitudes[oi] < args.min_motion or label not in masks:
                continue
            mask = masks[label].astype(np.uint8)
            boxes = find_region_boxes(mask, keep_n=args.keep_boxes)
            if not boxes:
                continue
            if id_segmenter is not None:
                # reference SAM2_Refine: video-propagated masks, point
                # validation, aux references, mask-overlap box filtering
                seg_info, useful, valid, crops = sam2_refine(
                    clip, track_traj[oi], id_segmenter, boxes)
                if not seg_info:
                    continue
                os.makedirs(id_out_folder, exist_ok=True)
                stem = os.path.splitext(name)[0]
                ref_name = f"{stem}_{label}.png"
                cv2.imwrite(os.path.join(id_out_folder, ref_name),
                            cv2.cvtColor(crops[0], cv2.COLOR_RGB2BGR))
                other_names = []
                for j, ci in enumerate(seg_info[2]):
                    on = f"{stem}_{label}_other{j}.png"
                    cv2.imwrite(os.path.join(id_out_folder, on),
                                cv2.cvtColor(crops[ci], cv2.COLOR_RGB2BGR))
                    other_names.append(on)
                id_info[oi] = [[list(seg_info[0]), ref_name, other_names],
                               [[int(b[0]), list(b[1]), list(b[2])]
                                for b in useful]]
                labeled = True
                break
            crop = crop_id_reference(clip[0], mask)
            if crop is None or crop.size == 0:
                continue
            ref_name = f"{os.path.splitext(name)[0]}_{label}.png"
            os.makedirs(id_out_folder, exist_ok=True)
            cv2.imwrite(os.path.join(id_out_folder, ref_name),
                        cv2.cvtColor(crop, cv2.COLOR_RGB2BGR))
            bbox = object_bbox(mask)
            id_info[oi] = [[list(bbox), ref_name, []],
                           [[int(b[0]), list(b[1]), list(b[2])]
                            for b in boxes]]
            labeled = True
            break
        clock("frameino_labeling")
        if not labeled:
            return None, "frameino_labeling"
    finally:
        if step_seconds is not None:
            step_seconds.update(clock.steps)

    # valid_duration is in FULL-video frame indices (the dataset crops
    # the decoded video with it); tracks/points are relative to the
    # cropped clip, matching the dataset's indexing contract.
    row = [name, H, W, _dumps([v0, v1]),
           _dumps([seg_points]),
           _dumps(captions),
           _dumps([track_traj]),
           _dumps([obj_info]),
           _dumps([id_info])]
    return (row, camera_info), None


def backend_manifest(args):
    """Every learned step and what runs it."""
    return {
        "panoptic": ("oneformer" if args.panoptic_checkpoint
                     else "classical:motion-residual"),
        "camera": ("vggt4track" if args.camera_checkpoint
                   else "classical:two-view-gate"),
        "tracking": ("cotracker3" if args.cotracker_checkpoint
                     else "classical:pyramidal-lk"),
        "id_refine": ("sam2" if args.id_refine == "sam2"
                      else "classical:mask-crop"),
        "caption": args.caption_backend,
    }


def load_learned_backends(args, processor=None):
    """{step: Backend} for every learned model the flags ask for, loaded
    through ``evaluation/perception.py`` onto ``--device``."""
    from frameino_tpu_torch.evaluation import perception
    fns = {}
    vlm = build_captioner(args, processor)
    if vlm is not None:
        fns["caption"] = vlm
    if args.panoptic_checkpoint:
        fns["panoptic"] = perception.load_oneformer_checkpoint(
            args.panoptic_checkpoint, device=args.device,
            motionable_only=True)
    if args.camera_checkpoint:
        fns["camera"] = perception.load_vggt_checkpoint(
            args.camera_checkpoint, device=args.device)
    if args.id_refine == "sam2":
        fns["id_refine"] = (
            perception.load_sam2_checkpoint(args.sam2_checkpoint,
                                            device=args.device)
            if args.sam2_checkpoint else perception.load_sam2(
                device=args.device))
    if args.cotracker_checkpoint:
        fns["tracking"] = perception.load_cotracker_checkpoint(
            args.cotracker_checkpoint, backward_tracking=True,
            device=args.device)
    return {k: Backend(fn, args.device) for k, fn in fns.items()}


def main(argv=None, processor=None):
    """Run the chain; returns the summary (as the summary JSON holds it)
    and exits the process's way: 0 when rows were kept. ``processor``
    stands in for the Qwen checkpoint directory's transformers processor."""
    args = parse_args(argv)
    from frameino_tpu_torch.preprocess.csv_io import write_csv
    csv_folder = os.path.join(args.output_folder, "dataset_csv_files")
    id_folder = os.path.join(args.output_folder, "video_dataset",
                             "train_ID_FrameIn")
    rows, dropped = [], {}
    camera_infos = {}
    # backend manifest: every learned step states what actually ran;
    # classical fallbacks require the explicit --allow_classical opt-in
    # (captioning's loudness standard — template already opts in there)
    backends = backend_manifest(args)
    classical = [f"{step}={b}" for step, b in backends.items()
                 if b.startswith("classical:")]
    if classical and not args.allow_classical:
        raise SystemExit(
            "classical fallbacks would run for: " + ", ".join(classical)
            + ". Pass the released checkpoints (--panoptic_checkpoint / "
            "--camera_checkpoint / --cotracker_checkpoint / --id_refine "
            "sam2) or opt in explicitly with --allow_classical.")
    for step, b in backends.items():
        line = f"backend {step}={b}"
        if b.startswith("classical:"):
            line += ("  WARNING: classical fallback, not the reference's "
                     "learned model (--allow_classical)")
        print(line)
    if str(args.device).startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu")
        from frameino_tpu_torch import serve
        serve.configure_cuda_numerics()
    learned = load_learned_backends(args, processor)
    names = sorted(n for n in os.listdir(args.video_folder)
                   if n.endswith((".mp4", ".avi", ".mkv", ".webm")))
    if args.num_shards > 1:
        # reference curation parallelism (the *_multi.py scripts shard
        # the video list across processes by index); each shard writes
        # its own CSV, concatenated downstream
        names = names[args.shard_index::args.num_shards]
    step_seconds = {}
    for name in names:
        step_seconds[name] = {}
        out, reason = process_video(
            name, args.video_folder, id_folder, args,
            vlm=learned.get("caption"), oneformer=learned.get("panoptic"),
            camera_estimator=learned.get("camera"),
            id_segmenter=learned.get("id_refine"),
            point_tracker=learned.get("tracking"),
            step_seconds=step_seconds[name])
        if out is None:
            dropped[name] = reason
            print(f"drop {name}: {reason}")
        else:
            row, cam = out
            if cam is not None:
                camera_infos[name] = cam
            rows.append(row)
            print(f"keep {name}")
    if camera_infos:
        # reference step-5 pruning: delete the top fraction of each
        # rotation/translation/focal ranking (make_delete_lists_camera)
        from frameino_tpu_torch.preprocess.camera_pose import \
            make_camera_delete_list
        delete = make_camera_delete_list(camera_infos)
        kept = []
        for row in rows:
            if row[0] in delete:
                dropped[row[0]] = "camera_pose"
                print(f"drop {row[0]}: camera_pose (ranked)")
            else:
                kept.append(row)
        rows = kept
    os.makedirs(csv_folder, exist_ok=True)
    if args.num_shards > 1:
        stem, ext = os.path.splitext(args.csv_name)
        args.csv_name = f"{stem}.shard{args.shard_index}{ext}"
    write_csv(os.path.join(csv_folder, args.csv_name),
              ["video_path", "height", "width", "valid_duration",
               "Panoptic_Segmentation", "Structured_Text_Prompt",
               "Track_Traj", "Obj_Info", "ID_info"], rows)
    # NOT in csv_folder: the dataset reads every *.csv there
    summary_path = os.path.join(
        args.output_folder,
        os.path.splitext(args.csv_name)[0] + ".summary.json")
    summary = {"backends": backends, "kept": len(rows), "total": len(names),
               "dropped": dropped,
               "backend_runs": {k: b.report() for k, b in learned.items()},
               "step_seconds": step_seconds}
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"curated {len(rows)}/{len(names)} videos -> "
          f"{os.path.join(csv_folder, args.csv_name)}")
    if dropped:
        print("drop reasons:", json.dumps(dropped))
    return summary


if __name__ == "__main__":
    sys.exit(0 if main()["kept"] else 1)
