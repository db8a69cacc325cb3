"""``window_read``'s share (%) of its roofline (csrc/window_read.cu: the
k-mer seed pair, the SA word and the text window): the frozen bound of the
requests the wrapper received over the profiled kernels' time."""

from fmbench import rooflines

KERNEL = "window_read"  # the wrapper in awry_tpu_torch.ops.kernels whose calls are recorded
bound = rooflines.window_read_bound


def read(rec: dict) -> float | None:
    return rooflines.kernel_share(rec, "window_read_roofline", r"\bwindow_read_(fixed|any)<")
