"""Layer-1 fixture in PyTorch's idiom: the programs the factories below
return run inside a CUDA graph capture (the file declares them, as the
package's serve/graphs.py declares its own). Never imported — analyzed
only (tests/test_torch_analysis.py). Every violation line carries a
``# PLANT: <RULE>`` marker; nothing else may fire."""

import random
import time

import numpy as np
import torch

TPULINT_CAPTURED = ("make_program", "make_grouped", "make_configured")


def make_program(model):
    def run(params, x, mask):
        total = x.sum().item()  # PLANT: TPU101
        rows = x.tolist()  # PLANT: TPU101
        host = x.cpu()  # PLANT: TPU101
        arr = x.numpy()  # PLANT: TPU101
        torch.cuda.synchronize()  # PLANT: TPU101
        back = np.asarray(x)  # PLANT: TPU101
        scale = float(x)  # PLANT: TPU101
        idx = torch.nonzero(mask)  # PLANT: TPU101
        where = torch.where(mask)  # PLANT: TPU101
        moved = x.to("cpu")  # PLANT: TPU101
        fixed = torch.nonzero_static(mask, size=4)  # a static size: no sync
        picked = torch.where(mask, x, 0.0)  # the masked form: no sync
        noise = random.random()  # PLANT: TPU102
        jitter = np.random.rand()  # PLANT: TPU102
        stamp = time.perf_counter()  # PLANT: TPU102
        if x.sum() > 0:  # PLANT: TPU103
            x = x * 2
        while mask.any():  # PLANT: TPU103
            mask = mask[1:]
        if x.shape[0] > 8:  # metadata: static under capture
            x = x[:8]
        if params is None:  # identity: static
            return x
        return (total, rows, host, arr, back, scale, idx, where, moved, fixed,
                picked, noise, jitter, stamp)

    return run


def make_grouped(model):
    def grouped(params, x, mask):
        def inner(v):
            return v.item()  # PLANT: TPU101

        return inner(x) + torch.where(mask, x, x).sum()

    return grouped


def make_configured():
    def run(x, config):  # PLANT: TPU104
        return x * config.scale

    return run


def host_code(x, mask):
    # Not captured: syncs, clocks and branches are all fine here.
    if x.sum().item() > 0:
        x = x.cpu().numpy()
    return x, time.perf_counter(), torch.nonzero(mask)
