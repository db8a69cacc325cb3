"""``occ_pair``'s share (%) of its roofline (csrc/occ_pair.cu through
``rank.update_range``): the frozen bound of the requests the wrapper received
over the profiled kernels' time."""

from fmbench import rooflines

KERNEL = "occ_pair"  # the wrapper in awry_tpu_torch.ops.kernels whose calls are recorded
bound = rooflines.occ_pair_bound


def read(rec: dict) -> float | None:
    return rooflines.kernel_share(rec, "occ_pair_roofline", r"\bocc_pair_kernel<\d+, false>")
