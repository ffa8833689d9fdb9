"""Step 3: image quality scoring (the port's own copy of
``frameino_tpu/preprocess/image_scoring.py``; reference
``preprocess/scoring_img.py``).

The reference scores five criteria per first frame: Text_Area (easyocr
polygons -> area ratio, ``scoring_img.py:225-241``),
Image_Quality_Assessment (pyiqa clipiqa+), Aesthetic (pyiqa nima),
Image_Complexity (ICNet ``auxiliary/ICNet.py``), and First_Frame_Clarity.
Here every criterion has a real offline implementation plus a pluggable
slot for the learned model:

- text_area: MSER + stroke-geometry text detector (easyocr stand-in;
  same polygon-area-ratio contract, pluggable ``ocr_reader``);
- aesthetic: colorfulness/exposure/rule-of-thirds composite (NIMA
  stand-in, same 1..10 scale);
- complexity: edge-density × compression-ratio composite in [0,1];
  the JAX package's ``preprocess.icnet`` holds the full IC9600 ICNet,
  not ported yet (ROADMAP queue 1), for when the released ``ck.pth``
  is present;
- clarity/brightness/contrast: classical scores as before.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import cv2
import numpy as np


def polygon_area(coordinates) -> float:
    """Shoelace area (reference ``scoring_img.py:31-39``)."""
    n = len(coordinates)
    area = 0.0
    for i in range(n):
        j = (i + 1) % n
        area += coordinates[i][0] * coordinates[j][1]
        area -= coordinates[j][0] * coordinates[i][1]
    return abs(area) / 2.0


def clarity_score(image: np.ndarray) -> float:
    """Laplacian variance — standard sharpness proxy."""
    gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
    return float(cv2.Laplacian(gray, cv2.CV_64F).var())


def brightness_score(image: np.ndarray) -> float:
    return float(image.mean() / 255.0)


def contrast_score(image: np.ndarray) -> float:
    return float(image.std() / 255.0)


def detect_text_regions(image: np.ndarray) -> list:
    """Classical text-line detector: morphological gradient (strokes
    have dense edges) -> Otsu binarize -> horizontal close (characters
    merge into lines) -> contours filtered by line geometry (wide, thin,
    partially filled with strokes). Returns quad polygons [[x,y]x4] —
    the same shape easyocr's ``readtext`` bounds carry (reference
    ``:228-236``)."""
    gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
    H, W = gray.shape
    grad = cv2.morphologyEx(gray, cv2.MORPH_GRADIENT,
                            cv2.getStructuringElement(cv2.MORPH_RECT,
                                                      (3, 3)))
    if grad.max() == 0:
        return []
    _, bw = cv2.threshold(grad, 0, 255,
                          cv2.THRESH_BINARY | cv2.THRESH_OTSU)
    # connect characters along the reading direction
    kw = max(9, W // 40)
    connected = cv2.morphologyEx(
        bw, cv2.MORPH_CLOSE,
        cv2.getStructuringElement(cv2.MORPH_RECT, (kw, 1)))
    contours, _ = cv2.findContours(connected, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    polys = []
    for c in contours:
        x, y, w, h = cv2.boundingRect(c)
        if h < 8 or h > H // 3 or w < 2 * h:
            continue            # text lines are wide and thin
        fill = float(bw[y:y + h, x:x + w].mean()) / 255.0
        if not (0.15 <= fill <= 0.9):
            continue            # strokes partially fill the line box
        # stroke oscillation: character edges cross the centerline often
        mid = bw[y + h // 2, x:x + w]
        transitions = int(np.count_nonzero(np.diff(mid) != 0))
        if transitions < 6:
            continue
        polys.append([[x, y], [x + w, y], [x + w, y + h], [x, y + h]])
    return polys


def text_area_score(image: np.ndarray,
                    ocr_reader: Optional[Callable] = None) -> float:
    """Text area ratio in [0,1] (reference ``:225-241``): sum of
    detected text polygon areas / image area. ``ocr_reader(image) ->
    [(coordinates, content, confidence), ...]`` plugs in easyocr."""
    H, W = image.shape[:2]
    if ocr_reader is not None:
        bounds = ocr_reader(image)
        total = sum(polygon_area(b[0]) for b in bounds)
    else:
        total = sum(polygon_area(p) for p in detect_text_regions(image))
    return float(total / (H * W))


def colorfulness(image: np.ndarray) -> float:
    """Hasler–Süsstrunk colorfulness metric."""
    rgb = image.astype(np.float32)
    rg = rgb[..., 0] - rgb[..., 1]
    yb = 0.5 * (rgb[..., 0] + rgb[..., 1]) - rgb[..., 2]
    return float(np.sqrt(rg.std() ** 2 + yb.std() ** 2)
                 + 0.3 * np.sqrt(rg.mean() ** 2 + yb.mean() ** 2))


def aesthetic_score(image: np.ndarray,
                    model: Optional[Callable] = None) -> float:
    """NIMA-scale (1..10) aesthetic stand-in: exposure balance +
    colorfulness + rule-of-thirds edge placement + sharpness. A real
    pyiqa ``nima`` callable plugs in via ``model`` (reference ``:92``)."""
    if model is not None:
        return float(model(image))
    gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY).astype(np.float32)
    H, W = gray.shape
    # exposure: peak at mid-gray, falls off toward clipped ends
    exposure = 1.0 - min(1.0, abs(gray.mean() - 118.0) / 118.0)
    clipped = float(((gray < 8) | (gray > 247)).mean())
    # colorfulness saturates around 60
    color = min(1.0, colorfulness(image) / 60.0)
    # rule of thirds: edge mass near the third lines vs center/borders
    edges = cv2.Canny(gray.astype(np.uint8), 50, 150).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    tx = np.minimum(np.abs(xs - W / 3.0), np.abs(xs - 2 * W / 3.0)) / W
    ty = np.minimum(np.abs(ys - H / 3.0), np.abs(ys - 2 * H / 3.0)) / H
    w = np.exp(-12.0 * np.minimum(tx, ty))
    thirds = float((edges * w).sum() / (edges.sum() + 1e-6))
    sharp = min(1.0, clarity_score(image) / 300.0)
    composite = (0.3 * exposure + 0.25 * color + 0.25 * thirds
                 + 0.2 * sharp - 0.3 * clipped)
    return float(1.0 + 9.0 * np.clip(composite, 0.0, 1.0))


def complexity_score(image: np.ndarray,
                     model: Optional[Callable] = None) -> float:
    """IC9600-scale [0,1] complexity stand-in: edge density × PNG
    compression ratio. A learned complexity model (the IC9600 ICNet)
    plugs in via ``model``."""
    if model is not None:
        return float(model(image))
    gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
    edge_density = float(cv2.Canny(gray, 50, 150).mean() / 255.0)
    small = cv2.resize(image, (256, 256))
    ok, png = cv2.imencode(".png", small)
    comp_ratio = min(1.0, len(png) / float(small.size))
    return float(np.clip(0.5 * np.sqrt(edge_density) + 0.5 * comp_ratio,
                         0.0, 1.0))


def score_images(first_frame: np.ndarray,
                 extra_scorers: Optional[Dict[str, Callable]] = None,
                 full: bool = False,
                 ocr_reader: Optional[Callable] = None,
                 aesthetic_model: Optional[Callable] = None,
                 complexity_model: Optional[Callable] = None
                 ) -> Dict[str, float]:
    """All per-frame criteria. ``full=True`` adds the three heavier
    scores (text area, aesthetic, complexity) the reference computes in
    its scoring pass; the fast trio stays the default for the pruning
    loop."""
    scores = {
        "clarity": clarity_score(first_frame),
        "brightness": brightness_score(first_frame),
        "contrast": contrast_score(first_frame),
    }
    if full:
        scores["text_area"] = text_area_score(first_frame, ocr_reader)
        scores["aesthetic"] = aesthetic_score(first_frame,
                                              aesthetic_model)
        scores["complexity"] = complexity_score(first_frame,
                                                complexity_model)
    for name, fn in (extra_scorers or {}).items():
        scores[name] = float(fn(first_frame))
    return scores


def prune_by_scores(rows_scores, min_clarity: float = 20.0,
                    brightness_range=(0.08, 0.95),
                    max_text_area: float = 0.05):
    """Keep/reject rows by scores; ``max_text_area`` mirrors the
    reference's text-ratio pruning (subtitled/watermarked clips)."""
    kept, rejected = [], []
    for row, s in rows_scores:
        ok = (s["clarity"] >= min_clarity and
              brightness_range[0] <= s["brightness"] <= brightness_range[1]
              and s.get("text_area", 0.0) <= max_text_area)
        (kept if ok else rejected).append(row)
    return kept, rejected
