"""Web demo of the port (gradio); counterpart of app.py.

Draw keypoints and skeleton edges on a support image, upload a query, get
predictions with learned edge weights rendered as line widths. gradio is
imported inside build_interface and main, so the module imports without
it; the inference behind the UI is cli/demo.py run_inference. Without
gradio, main serves the stdlib web page of cli/serve.py (GET /: click
keypoints and edges in the browser) on port 8300 instead, as app.py does.

    python -m edgecape_tpu_torch.cli.app [CHECKPOINT] [--device cpu]

Runs on the CUDA device and raises without one; `--device cpu` is the
only way onto the CPU.
"""

from __future__ import annotations

import argparse


def build_interface(checkpoint=None, backbone_ckpt=None, size=256,
                    device="cuda"):
    import gradio as gr

    from . import demo

    state = {"points": [], "edges": []}

    def add_point(img, evt: "gr.SelectData"):
        state["points"].append([evt.index[0], evt.index[1]])
        return f"{len(state['points'])} keypoints"

    def add_edge(i, j):
        state["edges"].append([int(i), int(j)])
        return f"{len(state['edges'])} edges"

    def reset():
        state["points"], state["edges"] = [], []
        return "cleared"

    def infer(support_img, query_img):
        ann = {"keypoints": state["points"], "skeleton": state["edges"]}
        return demo.run_inference(support_img, query_img, ann,
                                  checkpoint=checkpoint,
                                  backbone_ckpt=backbone_ckpt, size=size,
                                  device=device)

    with gr.Blocks(title="EdgeCape") as demo_ui:
        gr.Markdown("# EdgeCape: one-shot keypoint transfer\n"
                    "Click keypoints on the support image, add skeleton "
                    "edges by index, then run on a query image.")
        with gr.Row():
            support = gr.Image(label="support", type="numpy")
            query = gr.Image(label="query", type="numpy")
            out = gr.Image(label="result")
        status = gr.Textbox(label="status")
        with gr.Row():
            i_box = gr.Number(label="edge i", value=0)
            j_box = gr.Number(label="edge j", value=1)
            edge_btn = gr.Button("add edge")
            reset_btn = gr.Button("reset")
            run_btn = gr.Button("run")
        support.select(add_point, [support], [status])
        edge_btn.click(add_edge, [i_box, j_box], [status])
        reset_btn.click(reset, [], [status])
        run_btn.click(infer, [support, query], [out])
    return demo_ui


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edgecape_tpu_torch.cli.app",
        description="EdgeCape web demo (PyTorch + CUDA port)")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="checkpoint file of the port's trainer")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..api import resolve_device

    device = resolve_device(args.device)
    try:
        import gradio  # noqa: F401
    except ImportError:
        # the dependency-free web page of cli/serve.py (GET /); the same
        # inference path, no gradio required
        print("gradio is not installed; starting the stdlib web UI "
              "(cli/serve.py) instead — open http://localhost:8300/")
        from . import serve
        serve.main(["--port", "8300", "--batch-window-ms", "0",
                    "--device", str(device)]
                   + (["--checkpoint", args.checkpoint]
                      if args.checkpoint else []))
        return
    build_interface(checkpoint=args.checkpoint, device=device).launch()


if __name__ == "__main__":
    main()
