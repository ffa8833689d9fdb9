from frameino_tpu_torch.evaluation.artifacts import (read_instance_frames,
                                                     write_instance_artifacts)
from frameino_tpu_torch.evaluation.mass_evaluation import (FRAME_IN_METRICS,
                                                           FRAME_OUT_METRICS,
                                                           mass_evaluation)
from frameino_tpu_torch.evaluation.metrics import (cosine_similarity,
                                                   region_scaled_canvas,
                                                   relative_dino_from_sims,
                                                   traj_error_from_tracks,
                                                   vlm_success_rate,
                                                   vseg_mae_from_masks)
