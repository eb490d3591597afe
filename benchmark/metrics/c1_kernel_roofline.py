"""``c1_kernel_roofline`` (kernels, ``ops/fused.py`` ``c1_block`` ->
``csrc/c1.cu``): the least time of the profiled job's c1 passes
(``cardbench.roofline``) over the device time of the kernels below, in
percent.  Nothing where the profile's count of either kernel differs from
the wrapper's launches."""

WRAPPER = "c1_block"
KERNELS = ("c1_bricks", "c1_finish")


def read(run):
    return run.kernel_roofline(WRAPPER, KERNELS)
