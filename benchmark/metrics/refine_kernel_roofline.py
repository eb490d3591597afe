"""``refine_kernel_roofline`` (kernels, ``ops/fused.py`` ``refine_block`` ->
``csrc/refine.cu``): the least time of the profiled job's refine launches
(``cardbench.roofline``: one launch per epoch over all the frames, the
work counted at the job's per-frame positions) over the device time of
the kernels below, in percent.  Nothing where the job has no refinement,
or where the profile's count of either kernel differs from the wrapper's
launches."""

WRAPPER = "refine_block"
KERNELS = ("refine_bricks", "refine_finish")


def read(run):
    return run.kernel_roofline(WRAPPER, KERNELS, tracked=True)
