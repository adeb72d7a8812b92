"""HRNet's branch convs (kernels D and E of ``ops/branch_conv.py``) in a
training step: the least time of every fused branch conv the step needs
(the teacher's forward, the student's forward, dx and dW; the remat re-run
not counted; ``flops.branch_conv_work``), over the device time per step
of the kernels named here."""

from port_bench import flops

UNIT = "%"
KERNELS = ("conv_d48_kernel", "conv_d96_kernel", "conv_fwd_kernel", "conv_dw_kernel",
           "conv_dw48_kernel", "conv_dw96_kernel", "pack_wg_kernel", "reduce_rows_kernel",
           "reduce_dk_kernel")


def read(run):
    t = run.trace
    cfg = run.cell.config["config"]
    if run.loop != "train" or t is None or not t.device_s(KERNELS):
        return None
    tr, c = cfg["train"], cfg["data"]["crop_size"]
    nl, nu = tr["labeled_batch_size"], tr["unlabeled_batch_size"]
    work = []
    for i, (ch, h, w) in enumerate(flops.hrnet_branch_shapes(cfg["model"], 1, c, c)):
        work.append(flops.branch_conv_work(nu, ch, h, w, "fwd"))
        work.append(flops.branch_conv_work(nl + nu, ch, h, w, "fwd"))
        work.append(flops.branch_conv_work(nl + nu, ch, h, w, "dw"))
        # each block's first conv takes its input as is, the second the first's BatchNorm-ReLU
        work.append(flops.branch_conv_work(nl + nu, ch, h, w, "dx_post" if i % 2 else "dx"))
    return 100.0 * flops.seconds(work, run.device_name) / (t.device_s(KERNELS) / t.units)
