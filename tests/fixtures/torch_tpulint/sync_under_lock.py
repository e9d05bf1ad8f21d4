"""Layer-3 fixture in PyTorch's idiom: a device wait while a mutex is
held stalls every thread queued on it. Never imported — analyzed only."""

import threading

import torch

TPULINT_LOCK_ORDER = {"Engine": ("_lock",)}


class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self.done = torch.cuda.Event()

    def fetch(self, out):
        with self._lock:
            torch.cuda.synchronize()  # PLANT: TPU403
            self.done.synchronize()  # PLANT: TPU403
            return out

    def fetch_outside(self, out):
        self.done.synchronize()  # no lock held: fine
        with self._lock:
            return out
