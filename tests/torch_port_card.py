"""Helpers for the port's card tests (``-m cuda``): what one call puts on
the card, from the nodes of a CUDA graph that captures it."""

import ctypes

import torch

KERNEL_NODE = 0   # cudaGraphNodeTypeKernel


def graph_node_types(fn):
    """cudaGraphNodeType of every node of a CUDA graph that captures one
    fn() call, after a warm-up call outside the capture (one-time set-up
    stays out of the count)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    with open("/proc/self/maps") as maps:
        path = next(line.split()[-1] for line in maps
                    if "libcudart.so" in line)
    rt = ctypes.CDLL(path)
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types
