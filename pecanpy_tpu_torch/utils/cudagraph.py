"""CUDA-graph capture, shared by the port's replays: the SGNS step body
(``models/sgns.py:_GraphedBody``) and the queued hub engine's blocks of
rounds (``models/engine.py:_GraphedRounds``)."""
import functools

import torch


@functools.lru_cache(maxsize=None)
def _capture_stream(device) -> "torch.cuda.Stream":
    """The side stream every capture on ``device`` records on. One stream
    a device: cuBLAS keeps a workspace per stream, allocated at the first
    capture on it from that graph's pool, so a new stream for each
    capture would leave a workspace behind with each graph."""
    return torch.cuda.Stream(device)


def capture(fn, device, generators=()):
    """Capture ``fn()`` on ``device``'s capture stream into a new
    ``torch.cuda.CUDAGraph`` that advances ``generators`` on each replay.
    Returns the graph and ``fn``'s result (its static outputs).

    Calls ``CUDAGraph.capture_begin`` / ``capture_end`` itself and not
    ``torch.cuda.graph``, whose entry synchronizes the device and empties
    the allocator's cache: a blocking sync in every capture, and fresh
    device allocations for the work after it. A capture waits on nothing.
    """
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.stream(_capture_stream(device)):
        graph.capture_begin()
        try:
            out = fn()
        finally:
            graph.capture_end()
    return graph, out
