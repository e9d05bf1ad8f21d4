"""TPU203 fixture in PyTorch's idiom: program and kernel sites under a
serve/ path outside ops/cuda_build.py, serve/graphs.py and the factories
they route. Never imported — analyzed only. The directory name is the
point: TPU203 keys on the serve/ path segment."""

import ctypes

import torch
import triton
from torch.utils import cpp_extension


@triton.jit
def scale_kernel(x_ptr, n):  # PLANT: TPU203
    pass


def compiled_scorer(fn):
    return torch.compile(fn)  # PLANT: TPU203


def own_graph(run, x):
    graph = torch.cuda.CUDAGraph()  # PLANT: TPU203
    with torch.cuda.graph(graph):  # PLANT: TPU203
        run(x)
    return graph


def own_library(path):
    return ctypes.CDLL(path)  # PLANT: TPU203


def own_extension(src):
    return cpp_extension.load_inline("ext", src)  # PLANT: TPU203


def make_chunk_scorer(run):
    # A routed factory (serve/graphs.py TPULINT_ROUTED_FACTORIES): its
    # sites go through the package's graph and kernel machinery.
    return torch.compile(run)


def justified(fn):
    return torch.compile(fn)  # tpulint: disable=TPU203
