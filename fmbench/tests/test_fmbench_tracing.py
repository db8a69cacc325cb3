"""The device-interval union and the trace summary, on made-up events."""

import numpy as np
import torch

from fmbench import tracing


class Event:
    def __init__(self, name, cuda, start, end):
        self._n, self._c, self._s, self._e = name, cuda, start, end

    def name(self):
        return self._n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


def test_union_of_overlapping_intervals():
    iv = np.asarray([[20, 30], [0, 10], [5, 15], [25, 26], [30, 31], [40, 41]], dtype=np.int64)
    assert tracing._union(iv).tolist() == [[0, 15], [20, 31], [40, 41]]


def test_two_clients_busy_and_gaps():
    # Client A's kernels [0, 4e8) and [6e8, 7e8); client B's kernel overlaps
    # A's first, and a copy [8e8, 9e8); the host sits in one op across the
    # gap [4e8, 6e8).
    events = [
        Event("void k_a(int)", True, 0, 400_000_000),
        Event("void k_b(int)", True, 200_000_000, 350_000_000),
        Event("void k_a(int)", True, 600_000_000, 700_000_000),
        Event("Memcpy DtoH (Device -> Pinned)", True, 800_000_000, 900_000_000),
        Event("cudaEventSynchronize", False, 380_000_000, 650_000_000),
        Event("aten::copy_", False, 0, 1_000_000_000),
    ]
    s = tracing.summarize(events, batches=2, window_s=1.0)
    assert abs(s["busy_s"] - 0.6) < 1e-12  # 0.4 + 0.1 + 0.1
    assert abs(s["summed_s"] - 0.75) < 1e-12  # overlap counted twice
    assert s["kernels"]["void k_a(int)"][0] == 2 and "Memcpy DtoH (Device -> Pinned)" not in s["kernels"]
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0][0] == "cudaEventSynchronize" and abs(gaps[0][1] - 0.2) < 1e-12
    assert abs(gaps[1][1] - 0.1) < 1e-12
