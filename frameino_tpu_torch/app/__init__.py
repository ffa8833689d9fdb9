from frameino_tpu_torch.app.core import (build_canvas, CanvasSpec,
                                         prepare_id_reference,
                                         tracks_to_traj_tensor, crop_padding,
                                         InteractiveSession)
