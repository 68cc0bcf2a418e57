"""CUDA graphs with static buffers: the port's counterpart of the JAX
package's compiled programs, one per shape (``Synthesizer.prewarm`` and the
train driver's ``prewarm``).

A :class:`GraphSet` owns one memory pool for its graphs, which run one at a
time on one stream.  :meth:`GraphSet.capture` takes a function and example
tensor arguments (or None), and:

1. copies the arguments into static buffers of its own;
2. runs the function once on them on the set's side stream (the warm-up),
   which makes the lazy state that must not be made inside a capture: the
   device constants uploaded from numpy, the kernel libraries loaded with
   ``ctypes``, cuBLAS handles and workspaces, cuFFT plans;
3. captures a second call into a ``torch.cuda.CUDAGraph`` in the set's pool,
   with the given generators registered, so a generator re-seeded before a
   replay draws what an eager call would draw after the same seeding.

No autograd graph of an earlier call may still be alive at a capture that
runs a backward (a loss kept from an eager step, say): its gradient
accumulators stay bound to the stream they were made on, and the capture
fails on the dependency.  Nor may a graph be destroyed during a capture:
that invalidates it.  A :class:`Graphed` keeps no reference to its function
on CUDA, so an owner's graphs sit in no reference cycle with the owner and
go with it.  For cycles made elsewhere, the prewarms run the collector once
before their captures, where ``torch.cuda.graph`` collects before each.

A :class:`Graphed` call copies its arguments into the static buffers,
replays and returns the static outputs, which the next replay of any graph
of the set may overwrite: the caller copies out what it keeps first.  The
graph keeps the addresses it was captured on, so the buffers, and every
tensor the function reads or updates in place, must outlive it unmoved.

The kernel wrappers count the launches they make (``launches``); a replay
launches the captured kernels without them, so those counts do not see
replays.  A replay's kernels are counted in a trace of it.

On the CPU the same bookkeeping holds without a graph: the warm-up runs
on the static buffers and its outputs become the static outputs; a call
copies in, calls the function on the buffers and copies its results into
the static outputs, so they are overwritten by the next call as a replay's
are.  A capture or replay failure on CUDA raises; nothing falls back to the
eager function.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch


def _map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every tensor of a tuple, list or dict of tensors."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    if tree is None:
        return None
    raise TypeError(f"unsupported output {type(tree).__name__}")


def _copy_into(dst: Any, src: Any) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


def arg_key(args: Sequence[Optional[torch.Tensor]]) -> Tuple:
    """The shapes and dtypes of ``args`` (None stays None): what a graph
    captured on such arguments needs of a call."""
    return tuple(None if a is None else (tuple(a.shape), a.dtype)
                 for a in args)


class Graphed:
    """One function captured on static buffers (``graph``), or on the CPU
    called on them (``fn``, None on CUDA).  ``replays`` counts the calls."""

    def __init__(self, inputs: List[Optional[torch.Tensor]], outputs: Any,
                 graph=None, fn: Optional[Callable] = None):
        self.inputs = inputs
        self.key = arg_key(inputs)
        self.outputs = outputs
        self.graph = graph
        self.fn = fn
        self.replays = 0

    def __call__(self, *args: Optional[torch.Tensor]) -> Any:
        if arg_key(args) != self.key:
            raise ValueError(f"arguments {arg_key(args)} do not match the "
                             f"captured {self.key}")
        for buf, x in zip(self.inputs, args):
            if buf is not None:
                buf.copy_(x)
        self.replays += 1
        if self.graph is None:
            _copy_into(self.outputs, self.fn(*self.inputs))
            return self.outputs
        self.graph.replay()
        return self.outputs


class GraphSet:
    """The graphs of one owner on ``device``: one memory pool, replayed one
    at a time on the current stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        # the warm-ups and the captures run here, off the current stream
        self.stream = torch.cuda.Stream(self.device) if cuda else None

    def capture(self, fn: Callable, *args: Optional[torch.Tensor],
                generators: Sequence[torch.Generator] = ()) -> Graphed:
        """``fn(*args)`` warmed up and captured on static copies of
        ``args``; see the module docstring."""
        inputs = [None if a is None else
                  a.detach().to(self.device, copy=True) for a in args]
        if self.device.type != "cuda":
            return Graphed(inputs, _map(torch.clone, fn(*inputs)), fn=fn)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn(*inputs)
        current.wait_stream(self.stream)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        # capture_begin/end on the set's stream, without the garbage
        # collection and cache flush ``torch.cuda.graph`` runs before every
        # capture (a prewarm captures dozens of graphs and collects once)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                outputs = fn(*inputs)
            finally:
                graph.capture_end()
        return Graphed(inputs, outputs, graph)
