"""Gradio front end for the FrameINO interactive demo (the port's
counterpart of ``frameino_tpu/app/gradio_app.py``; reference ``app.py``
UI: the canvas, per-object trajectory clicks with realtime colored
preview + legend, multi-line objects, SAM ID segmentation, generation).

Every event handler is a plain function built by ``make_handlers``, so
the whole event flow runs headless (``tests/test_torch_app.py``, and
``chip_smoke.py`` on the card at 704x1280x81). ``launch`` needs
``gradio``, which is imported only there.
"""

from __future__ import annotations

import os
import tempfile

from frameino_tpu_torch.app.core import (CanvasSpec, InteractiveSession,
                                         color_legend_html,
                                         prepare_id_reference,
                                         segment_at_point,
                                         visualize_trajectories)


def make_handlers(session: InteractiveSession, text_encoder_fn):
    """Build the UI-framework-free event handlers around a session.

    Each handler takes/returns plain values (numpy images, strings), so
    the Gradio wiring below is one line per event and the tests call the
    exact functions the UI calls. ``text_encoder_fn([prompt])`` returns
    the prompt embeddings (``serve.make_text_encoder_fn``)."""
    state = {"visual": None, "id_mask": None}

    def on_build(img, ch, cw, ox, oy):
        """-> (visual_canvas, rounded_h, rounded_w, hint_message)."""
        h32, w32, hint = CanvasSpec.round_dims(ch, cw)
        spec = CanvasSpec(h32, w32, img.shape[0], img.shape[1],
                          int(ox), int(oy))
        visual = session.set_canvas(img, spec)
        state["visual"] = visual
        return visual, h32, w32, hint

    def _preview():
        base = state["visual"] if state["visual"] is not None \
            else session.inference_canvas
        return visualize_trajectories(base, session.polylines,
                                      object_ids=session.line_obj)

    def on_click(x, y):
        """Realtime per-object colored polyline preview (reference
        ``add_traj_point`` + ``fn_vis_realtime_traj``, app.py:401-445).
        -> (canvas_with_trajs, legend_html)."""
        session.add_traj_point(x, y)
        return _preview(), color_legend_html(session.num_objects)

    def on_new_object():
        """-> (hint, legend). Errors past the color-code limit
        (reference ``traj_instance_update``)."""
        session.new_object()
        return (f"object {session.num_objects}: click to add points",
                color_legend_html(session.num_objects))

    def on_new_line():
        session.new_line()
        return (f"new line for object {session.num_objects}",
                color_legend_html(session.num_objects))

    def on_clear():
        session.clear_traj_points()
        return state["visual"], color_legend_html(0)

    def on_segment(id_img, point=None):
        if id_img is None or session.segmenter is None:
            state["id_mask"] = None
            return None
        mask = segment_at_point(id_img, session.segmenter, point)
        state["id_mask"] = mask
        spec = session.spec
        return prepare_id_reference(
            id_img, mask,
            spec.canvas_height if spec else id_img.shape[0],
            spec.canvas_width if spec else id_img.shape[1])

    def on_run(prompt_text, id_img):
        """-> the path of an mp4 of the generated, cropped frames."""
        from frameino_tpu_torch.data.video_io import write_video
        embeds = text_encoder_fn([prompt_text])
        frames = session.run(embeds, id_image=id_img,
                             id_mask=state["id_mask"])
        fd, path = tempfile.mkstemp(suffix=".mp4")
        os.close(fd)
        write_video(path, frames)
        return path

    return {"build": on_build, "click": on_click,
            "new_object": on_new_object, "new_line": on_new_line,
            "clear": on_clear, "segment": on_segment, "run": on_run,
            "state": state}


def launch(pipeline, text_encoder_fn, segmenter=None, **launch_kwargs):
    """The Gradio UI around ``make_handlers`` (defaults: a 704x1280 canvas,
    81 frames, 50 steps, guidance 5.0); ``launch_kwargs`` go to
    ``demo.launch``."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is required for the demo UI: pip install gradio; the "
            "UI-free InteractiveSession in frameino_tpu_torch.app.core "
            "exposes the same functionality programmatically") from e

    session = InteractiveSession(pipeline, segmenter=segmenter)
    h = make_handlers(session, text_encoder_fn)

    with gr.Blocks(title="FrameINO") as demo:
        gr.Markdown("## Frame In-N-Out demo")
        with gr.Row():
            image_in = gr.Image(label="Input image", type="numpy")
            canvas_view = gr.Image(label="Canvas (click to add trajectory)")
        with gr.Row():
            canvas_h = gr.Number(value=704, label="Canvas height (x32)")
            canvas_w = gr.Number(value=1280, label="Canvas width (x32)")
            off_x = gr.Number(value=0, label="Image offset x")
            off_y = gr.Number(value=0, label="Image offset y")
        hint = gr.Markdown()
        legend = gr.HTML(label="Objects")
        prompt = gr.Textbox(label="Prompt")
        with gr.Row():
            id_image = gr.Image(label="ID reference (optional; click to "
                                      "point-prompt the segmenter)",
                                type="numpy")
            id_preview = gr.Image(label="Segmented ID (background-zeroed)")
        with gr.Row():
            build_btn = gr.Button("Build canvas")
            new_obj_btn = gr.Button("New object")
            new_line_btn = gr.Button("New line (same object)")
            clear_btn = gr.Button("Clear trajectories")
        segment_btn = gr.Button("Segment ID (center prompt)")
        run_btn = gr.Button("Generate")
        video_out = gr.Video(label="Result")

        def ui_click(evt: "gr.SelectData"):
            return h["click"](evt.index[0], evt.index[1])

        def ui_segment(id_img, evt: "gr.SelectData" = None):
            return h["segment"](id_img,
                                tuple(evt.index) if evt else None)

        build_btn.click(h["build"], [image_in, canvas_h, canvas_w,
                                     off_x, off_y],
                        [canvas_view, canvas_h, canvas_w, hint])
        canvas_view.select(ui_click, [], [canvas_view, legend])
        new_obj_btn.click(h["new_object"], [], [hint, legend])
        new_line_btn.click(h["new_line"], [], [hint, legend])
        clear_btn.click(h["clear"], [], [canvas_view, legend])
        segment_btn.click(ui_segment, [id_image], id_preview)
        id_image.select(ui_segment, [id_image], id_preview)
        run_btn.click(h["run"], [prompt, id_image], video_out)

    demo.launch(**launch_kwargs)
    return demo
