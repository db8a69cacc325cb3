"""``marked_walk_ranges``' share (%) of its roofline (csrc/backstep.cu's
range-fed marked walk through ``locate.count_locate_capped_t``): the frozen
bound of the walks its requests take over the profiled kernels' time."""

from fmbench import rooflines

KERNEL = "marked_walk_ranges"  # the wrapper in awry_tpu_torch.ops.kernels whose calls are recorded
bound = rooflines.marked_walk_ranges_bound


def read(rec: dict) -> float | None:
    return rooflines.kernel_share(rec, "marked_walk_roofline", r"\bwalk_kernel<\d+, [^,]*Stop\)1, [^,]*Feed\)0, false>")
