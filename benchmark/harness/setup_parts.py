"""The seconds of each part of a run's set-up, printed beside the result
so that PERF.md can split setup_s (the card is synchronised at each
mark; set-up is outside the measured window)."""

from __future__ import annotations

import time

import torch


class Parts:
    def __init__(self, device):
        self.device, self.t, self.seconds = device, time.perf_counter(), {}

    def mark(self, name):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        self.t = now
