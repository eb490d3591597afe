"""``motion_kernel_roofline`` (kernels, ``ops/fused.py`` ``motion_block``
-> ``csrc/motion.cu``): the least time of the profiled job's motion
passes (``cardbench.roofline``) over the device time of the kernels below,
in percent.  Nothing where the profile's count of either kernel differs
from the wrapper's launches."""

WRAPPER = "motion_block"
KERNELS = ("motion_bricks", "motion_finish")


def read(run):
    return run.kernel_roofline(WRAPPER, KERNELS)
