"""The whole training step's share of the card's bf16 peak: the model's
FLOPs per step (``torch.utils.flop_counter`` over the plain reference at
the cell's shapes: the teacher's forward, the student's forward and
backward; no recomputation) over the window's time per step (the
unprofiled steps of the run) times the peak."""

from port_bench import flops

UNIT = "%"


def read(run):
    if run.loop != "train" or not run.attempted or run.device_name == "cpu":
        return None
    cfg = run.cell.config["config"]
    work = flops.model_flops(cfg["model"], cfg["data"]["num_classes"], flops.train_passes(cfg))
    step_s = run.window_ms / 1e3 / run.attempted
    return 100.0 * work / (step_s * flops.peaks(run.device_name)[1])
