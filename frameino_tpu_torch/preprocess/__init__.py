"""Dataset-curation ("preprocess") steps (counterpart of
``frameino_tpu/preprocess/``), driven end to end by
``scripts/run_preprocess_pipeline.py``.

Step map (reference script -> this package):
  0 csv_prepare                -> csv_io.build_initial_csv
  1 filter_basic.py            -> basic_filter.filter_basic
  2 scoring_scene_cut_autoshot -> scene_cut.score_scene_cuts (+ span)
  3 scoring_img.py             -> image_scoring.score_images
  4 filter_panoptic_multi.py   -> panoptic.run_panoptic_step on
                                  panoptic_oneformer.OneFormerSegmenter
  5 track_camera_pose_*        -> camera_pose (models/vggt.py's estimator
                                  ranked by make_camera_delete_list)
  6 caption_qwen_multi.py      -> captioning.caption_segments
  7 track_regular_motion_cycle -> motion_tracking.track_step
  8 track_FrameINO.py          -> frameino_labeling (+ sam2_refine)
"""
