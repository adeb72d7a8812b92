"""HRNet's branch convs (kernel D of ``ops/branch_conv.py``) in the val
pass: the least time of the forward of every fused branch conv of every
window, view and scale of a batch (``flops.branch_conv_work``), over the
device time per profiled batch of the kernels named here."""

from port_bench import flops

UNIT = "%"
KERNELS = ("conv_d48_kernel", "conv_d96_kernel", "conv_fwd_kernel", "pack_wg_kernel",
           "reduce_rows_kernel")


def read(run):
    t = run.trace
    cfg = run.cell.config["config"]
    if run.loop != "eval" or t is None or not t.device_s(KERNELS):
        return None
    n = cfg["train"]["eval_batch_size"]
    work = []
    for count, h, w in flops.eval_windows(cfg, tuple(run.cell.traffic["canvas"])):
        for ch, bh, bw in flops.hrnet_branch_shapes(cfg["model"], 1, h, w):
            work.append(flops.branch_conv_work(n * count, ch, bh, bw, "fwd"))
    return 100.0 * flops.seconds(work, run.device_name) / (t.device_s(KERNELS) / t.units)
