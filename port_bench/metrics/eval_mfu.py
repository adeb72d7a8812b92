"""The val pass's share of the card's bf16 peak: the forward FLOPs of
every window, view and scale per image (``torch.utils.flop_counter`` over
the plain reference) over the window's time per image times the peak."""

from port_bench import flops

UNIT = "%"


def read(run):
    if run.loop != "eval" or not run.window_images or run.device_name == "cpu":
        return None
    cfg = run.cell.config["config"]
    passes = [("fwd", n, h, w) for n, h, w in
              flops.eval_windows(cfg, tuple(run.cell.traffic["canvas"]))]
    work = flops.model_flops(cfg["model"], cfg["data"]["num_classes"], passes)
    image_s = run.window_ms / 1e3 / run.window_images
    return 100.0 * work / (image_s * flops.peaks(run.device_name)[1])
