"""ResNet's stem (kernels B and C of ``ops/stem.py``): the least time of the
stem conv's forward with its BatchNorm statistics on the teacher's and the
student's batch, and of its weight gradient (``flops.stem_work``), per
step, over the device time per step of the kernels named here."""

from port_bench import flops

UNIT = "%"
KERNELS = ("stem_fwd_kernel", "stem_dw_kernel", "reduce_partials_kernel")


def read(run):
    t = run.trace
    cfg = run.cell.config["config"]
    if run.loop != "train" or t is None or not t.device_s(KERNELS):
        return None
    tr, c = cfg["train"], cfg["data"]["crop_size"]
    nl, nu = tr["labeled_batch_size"], tr["unlabeled_batch_size"]
    work = flops.stem_work(nu, c, False) + flops.stem_work(nl + nu, c, True)
    return 100.0 * flops.seconds(work, run.device_name) / (t.device_s(KERNELS) / t.units)
